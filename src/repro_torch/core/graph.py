"""Implicit similarity graph and normalized Laplacian built on RB features.

Never materializes W = Z Zᵀ. Degrees come from two sparse mat-vecs (Eq. 6):
``deg = Z (Zᵀ 1)``; with Z values 1/√R in ELL form this reduces to bin-count
lookups. The normalized operator ``Ẑ = D̂^{-1/2} Z`` is represented by
(idx, rowscale) where ``rowscale_i = 1/sqrt(R·deg_i)`` — one fused per-row
scalar for both the 1/√R value and the degree normalization.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ops


def _sqrt_r(r: int) -> tuple[float, float]:
    """(√R, 1/√R) rounded in float32 as the JAX package computes them."""
    r32 = torch.tensor(float(r), dtype=torch.float32)
    return torch.sqrt(r32).item(), (1.0 / torch.sqrt(r32)).item()


def rb_degrees_and_counts(
    idx: torch.Tensor, *, d: int, d_g: int, impl: str = "auto",
    csc: Optional[ops.EllCSC] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 6 via two ELL products, also returning the (D,) bin occupancies
    (Zᵀ1 — the fitted-model degree dual) that the first product computes
    anyway."""
    n, r = idx.shape
    sqrt_r, inv_sqrt_r = _sqrt_r(r)
    ones = torch.ones((n, 1), dtype=torch.float32, device=idx.device)
    scale = torch.full((n,), inv_sqrt_r, dtype=torch.float32,
                       device=idx.device)
    counts = ops.zt_matmul(idx, ones, scale, d, d_g=d_g, impl=impl,
                           csc=csc)                                 # Zᵀ1
    deg = ops.z_matmul(idx, counts, scale, d_g=d_g, impl=impl)      # Z(Zᵀ1)
    # undo the 1/√R value folding: raw occupancies (exact up to ~2 ulp)
    return deg[:, 0], counts[:, 0] * sqrt_r


def degrees_from_counts(idx: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """deg_i = (1/R) Σ_g counts[idx[i,g]] from the fitted bin occupancies.

    Row-local, so a row's degree does not depend on the rows around it."""
    r = idx.shape[1]
    return torch.sum(counts[idx.long()].to(torch.float32), dim=1) / r


@dataclasses.dataclass(frozen=True)
class NormalizedAdjacency:
    """Â = Ẑ Ẑᵀ = D̂^{-1/2} Z Zᵀ D̂^{-1/2}, applied implicitly.

    The K largest eigenpairs of Â are the K smallest of L̂ = I − Â; its top-K
    left singular vectors of Ẑ are the spectral embedding (paper Eq. 7).
    ``csc`` is the column-sorted copy of ``idx`` that the CUDA ``zt``
    kernel reduces, built once per fit (None on the CPU, whose plain
    version does not use it).
    """

    idx: torch.Tensor        # (N, R) int32 ELL columns
    rowscale: torch.Tensor   # (N,) float32 = 1/sqrt(R·deg)
    deg: torch.Tensor        # (N,) float32 degrees (diagnostics)
    d: int                   # feature columns D
    d_g: int
    impl: str = "auto"
    counts: Optional[torch.Tensor] = None   # (D,) bin occupancies Zᵀ1
    csc: Optional[ops.EllCSC] = None

    @property
    def n(self) -> int:
        return self.idx.shape[0]

    def rmatmat(self, u: torch.Tensor) -> torch.Tensor:
        """Ẑᵀ u : (N, K) → (D, K)."""
        return ops.zt_matmul(self.idx, u.contiguous(), self.rowscale, self.d,
                             d_g=self.d_g, impl=self.impl, csc=self.csc)

    def matmat(self, v: torch.Tensor) -> torch.Tensor:
        """Ẑ v : (D, K) → (N, K)."""
        return ops.z_matmul(self.idx, v.contiguous(), self.rowscale,
                            d_g=self.d_g, impl=self.impl)

    def gram_matvec(self, u: torch.Tensor) -> torch.Tensor:
        """(Ẑ Ẑᵀ) u — the eigensolver operator. PSD, ‖Â‖ ≤ 1."""
        return ops.gram_matmul(self.idx, u.contiguous(), self.rowscale,
                               self.d, d_g=self.d_g, impl=self.impl,
                               csc=self.csc)


def build_normalized_adjacency(
    idx: torch.Tensor, *, d: int, d_g: int, impl: str = "auto",
    eps: float = 1e-8, normalize: bool = True,
) -> NormalizedAdjacency:
    n, r = idx.shape
    csc = ops.ell_csc(idx, d) if idx.is_cuda else None
    deg, counts = rb_degrees_and_counts(idx, d=d, d_g=d_g, impl=impl, csc=csc)
    if normalize:
        # deg_i ≥ 1/R·counts of own bin ≥ 1/R > 0 always (a point collides
        # with itself); eps guards degenerate all-padded rows only.
        rowscale = 1.0 / torch.sqrt(float(r) * torch.clamp_min(deg, eps))
    else:
        # plain Z (values 1/√R), no Laplacian normalization (SV-style runs)
        rowscale = torch.full((n,), _sqrt_r(r)[1], dtype=torch.float32,
                              device=idx.device)
    return NormalizedAdjacency(idx, rowscale.contiguous(), deg, d=d, d_g=d_g,
                               impl=impl, counts=counts, csc=csc)
