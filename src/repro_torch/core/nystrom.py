"""Dense kernel blocks for the landmark feature maps and exact SC.

The Nyström features Φ = K_nm · K_mm^{-1/2} and the LSC anchor affinities
live as maps in ``repro_torch.core.featuremap`` (``NystromMap``,
``LSCMap``); this module keeps the kernel block they, and the exact-SC
baseline's N × N affinity, are built on.

The JAX package broadcasts the Laplacian block over (n, m, d) at once: at
covtype's N = 581,012 against m = 256 landmarks that is 32 GB. Here the
rows go in blocks (``utils.map_row_tiles``) whose (rows, m, d) difference
block holds at most ``BLOCK_BYTES``: 4,096 rows at m = 256, d = 54 (226
MB), 128 rows for exact SC's 8,192 × 8,192 block. A block's row count
depends on (m, d) alone, so a row's value does not depend on the batch.
"""
from __future__ import annotations

import torch

from repro_torch.utils import ROW_TILE, map_row_tiles

#: Bytes of the (rows, m, d) float32 difference block of the Laplacian
#: kernel.
BLOCK_BYTES = 256 * 2**20
KERNELS = ("gaussian", "laplacian")


def kernel_tile_rows(m: int, d: int, kernel: str) -> int:
    """Rows of one kernel block against m points of dimension d: the
    largest power of two ≤ ``ROW_TILE`` whose Laplacian difference block
    fits ``BLOCK_BYTES`` (``ROW_TILE`` for the Gaussian kernel, whose block
    is a product)."""
    if kernel != "laplacian":
        return ROW_TILE
    fit = BLOCK_BYTES // max(1, 4 * m * d)
    return max(1, min(ROW_TILE, 1 << max(fit.bit_length() - 1, 0)))


def _kernel_block(x: torch.Tensor, y: torch.Tensor, sigma: float,
                  kernel: str) -> torch.Tensor:
    if kernel == "gaussian":
        sq = (torch.sum(x * x, -1)[:, None] - (2.0 * x) @ y.T
              + torch.sum(y * y, -1)[None, :])
        return torch.exp(-torch.clamp_min(sq, 0.0) / (2.0 * sigma**2))
    l1 = torch.sum(torch.abs(x[:, None, :] - y[None, :, :]), -1)
    return torch.exp(-l1 / sigma)


def pairwise_kernel(x: torch.Tensor, y: torch.Tensor, sigma: float,
                    kernel: str) -> torch.Tensor:
    """Dense kernel block k(x_i, y_j), (n, m) float32: Gaussian
    exp(−‖x−y‖²/2σ²) or Laplacian exp(−‖x−y‖₁/σ), in row blocks of
    ``kernel_tile_rows(m, d, kernel)``."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; options {KERNELS}")
    x = x.to(torch.float32).contiguous()
    y = y.to(device=x.device, dtype=torch.float32).contiguous()
    return map_row_tiles(lambda xt: _kernel_block(xt, y, sigma, kernel), x,
                         rows=kernel_tile_rows(y.shape[0], x.shape[1],
                                               kernel))
