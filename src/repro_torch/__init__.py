"""PyTorch + CUDA port of the SC_RB system (``repro``), for an NVIDIA H100.

It keeps the JAX package's module layout and public names, imports
neither JAX nor ``repro``, and runs its entry points on the card unless
the caller passes ``device="cpu"``. See ``repro_torch.core``.
"""
