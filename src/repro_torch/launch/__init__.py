"""Process groups and device meshes on ``torch.distributed``:
``launch.mesh`` (the JAX package's mesh definitions) and ``launch.world``
(starting ranks on one host)."""
