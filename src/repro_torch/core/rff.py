"""Random Fourier Features: the RF baselines' map (SC_RF, SV_RF, KK_RF).

Two kernels, as in the JAX package:
  - gaussian:  w ~ N(0, 1/σ²)      for k(x, y) = exp(−‖x−y‖²/2σ²)
  - laplacian: w ~ Cauchy(0, 1/σ)  for k(x, y) = exp(−‖x−y‖₁/σ)
the latter matching Random Binning's kernel for the Fig. 2 comparison.
The draws come from a CPU generator seeded with ``seed``; torch cannot
replay ``jax.random``, so parity tests inject the reference's ``w``, ``b``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils import make_generator, map_row_tiles


@dataclasses.dataclass(frozen=True)
class RFFParams:
    w: torch.Tensor   # (d, R) float32
    b: torch.Tensor   # (R,) float32

    @property
    def n_features(self) -> int:
        return self.w.shape[1]

    @property
    def dim(self) -> int:
        return self.w.shape[0]

    def to(self, device) -> "RFFParams":
        return RFFParams(self.w.to(device), self.b.to(device))


def make_rff_params(seed: int, n_features: int, dim: int, sigma: float,
                    kernel: str = "laplacian") -> RFFParams:
    """Gaussian or Cauchy frequencies w (d, R) and uniform phases b in
    [0, 2π), drawn on the CPU from a generator seeded with ``seed``."""
    g = make_generator(seed)
    shape = (dim, n_features)
    if kernel == "gaussian":
        w = torch.randn(shape, generator=g, dtype=torch.float32) / sigma
    elif kernel == "laplacian":
        w = torch.empty(shape, dtype=torch.float32).cauchy_(
            generator=g) / sigma
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    b = torch.rand((n_features,), generator=g,
                   dtype=torch.float32) * (2.0 * math.pi)
    return RFFParams(w, b)


def rff_transform(x: torch.Tensor, params: RFFParams) -> torch.Tensor:
    """z(x) = sqrt(2/R) cos(xW + b): dense (N, R), E[z zᵀ] = k. A plain
    product and elementwise work (the JAX package runs it outside any
    Pallas kernel), in fixed row tiles (``utils.map_row_tiles``)."""
    scale = float(torch.sqrt(torch.tensor(2.0 / params.n_features,
                                          dtype=torch.float32)))
    w, b = params.w, params.b
    return map_row_tiles(lambda xt: scale * torch.cos(xt @ w + b),
                         x.to(torch.float32).contiguous())
