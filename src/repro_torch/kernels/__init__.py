"""Hand-written CUDA kernels for the SC_RB hot spots, with their plain
PyTorch versions.

- ``rb_binning``    hashed Random Binning features (Alg. 1)
- ``z_matmul`` / ``zt_matmul`` / ``gram_matmul``
                    ELL products driving the eigensolver (Alg. 2 step 3)
- ``kmeans_assign`` fused distance + argmin of the final k-means

``ops.py`` holds the wrappers that dispatch by device, ``ref.py`` the plain
versions, ``csrc/`` the CUDA sources and ``_build.py`` their build.
"""
from repro_torch.kernels import ops, ref  # noqa: F401
