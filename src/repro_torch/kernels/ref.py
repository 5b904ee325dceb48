"""Plain PyTorch versions of the hand-written CUDA kernels.

Each function computes what its kernel computes, with ordinary tensor
operations. ``ops.py`` takes them for CPU tensors (the CPU tests), and
``chip_smoke.py`` holds each kernel against them on the card. They repeat
the kernels' arithmetic and are no yardstick of speed.

Integer hashing note: PyTorch on the CPU implements neither ``+`` nor
``>>`` on ``torch.uint32``, so the hash runs in int64 holding 32-bit values,
masked with ``& 0xFFFFFFFF`` after every add. Products of two 32-bit
values are split into 16-bit halves (``_mulmod32``) so no int64 product
overflows. Hash parameters are stored as int32 tensors holding the uint32
bit patterns; ``_u32`` recovers the unsigned value.
"""
from __future__ import annotations

import torch

# Knuth multiplicative-hash constant (2^32 / golden ratio, odd).
HASH_MIX = 2654435769
_MASK = 0xFFFFFFFF

# Elements per temporary block of the chunked plain versions: bounds their
# memory at the main path's sizes (a single (N, R, d) block would be 32 GB).
_CHUNK_ELEMS = 1 << 24


def _u32(t: torch.Tensor) -> torch.Tensor:
    """uint32 value of 32-bit integers, as int64 in [0, 2^32)."""
    return t.to(torch.int64) & _MASK


def _mulmod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a · b) mod 2^32 for int64 tensors holding values in [0, 2^32)."""
    lo = a * (b & 0xFFFF)                        # < 2^48
    hi = (a * (b >> 16)) & 0xFFFF                # low 16 bits of the high part
    return (lo + (hi << 16)) & _MASK


def _row_chunk(n: int, per_row: int) -> int:
    return max(1, min(n, _CHUNK_ELEMS // max(per_row, 1)))


def rb_binning_ref(
    x: torch.Tensor,        # (N, d) float32
    widths: torch.Tensor,   # (R, d) float32
    biases: torch.Tensor,   # (R, d) float32
    hash_a: torch.Tensor,   # (R, d) int32 holding uint32 odd multipliers
    hash_c: torch.Tensor,   # (R,) int32 holding uint32 mixing constants
    d_g: int,
) -> torch.Tensor:
    """Hashed Random Binning: one feature column per (row, grid).

    Returns idx int32 (N, R) with ``idx[i, g] in [g*d_g, (g+1)*d_g)``.
    The bin is ``floor((x − b) / w)``, cast float32 → int32 → uint32; the
    hash is ``((Σ_d bin·a + c) · HASH_MIX) mod 2^32 >> (32 − log2 d_g)``.
    """
    if d_g & (d_g - 1):
        raise ValueError(f"d_g must be a power of two, got {d_g}")
    n, d = x.shape
    r = widths.shape[0]
    shift = 32 - int(d_g).bit_length() + 1
    a = _u32(hash_a)[None]                                   # (1, R, d)
    c = _u32(hash_c)[None]                                   # (1, R)
    offsets = (torch.arange(r, dtype=torch.int32, device=x.device)
               * d_g)[None]
    out = torch.empty((n, r), dtype=torch.int32, device=x.device)
    step = _row_chunk(n, r * d)
    for s in range(0, n, step):
        xc = x[s:s + step]
        bins = torch.floor((xc[:, None, :] - biases[None]) / widths[None])
        h = _mulmod32(_u32(bins.to(torch.int32)), a).sum(-1) & _MASK
        h = _mulmod32((h + c) & _MASK, torch.full_like(h, HASH_MIX))
        local = (h >> shift).to(torch.int32) if shift < 32 \
            else torch.zeros_like(h, dtype=torch.int32)
        out[s:s + step] = local + offsets
    return out


def z_matmul_ref(
    idx: torch.Tensor,       # (N, R) int32
    v: torch.Tensor,         # (D, K) float32 or bfloat16
    rowscale: torch.Tensor,  # (N,) float32
) -> torch.Tensor:
    """y = diag(rowscale) · Z_pattern · v with Z_pattern[i, idx[i, g]] = 1.

    Accumulates in float32 and returns ``v.dtype``. (N, K)."""
    n, r = idx.shape
    k = v.shape[1]
    vf = v.float()
    out = torch.empty((n, k), dtype=torch.float32, device=v.device)
    step = _row_chunk(n, r * k)
    for s in range(0, n, step):
        rows = vf[idx[s:s + step].long()].sum(dim=1)
        out[s:s + step] = rows * rowscale[s:s + step, None]
    return out.to(v.dtype)


def zt_matmul_ref(
    idx: torch.Tensor,       # (N, R) int32
    u: torch.Tensor,         # (N, K) float32
    rowscale: torch.Tensor,  # (N,) float32
    d: int,
) -> torch.Tensor:
    """q = Z_patternᵀ · diag(rowscale) · u.  (D, K) float32.

    One ``index_add_`` per grid column of the ELL matrix. On a CUDA tensor
    ``index_add_`` adds with float atomics, so this version's summation
    order there changes from run to run; the kernel's does not."""
    us = u * rowscale[:, None]
    q = torch.zeros((d, u.shape[1]), dtype=torch.float32, device=u.device)
    for g in range(idx.shape[1]):
        q.index_add_(0, idx[:, g].long(), us)
    return q


def kmeans_assign_ref(
    x: torch.Tensor,          # (N, d) float32
    centroids: torch.Tensor,  # (K, d) float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment: (labels int32 (N,), sqdist (N,)).

    d² = ‖x‖² − 2x·c + ‖c‖², first index on ties, distance clamped ≥ 0."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(centroids * centroids, dim=-1)
    d2 = x2 - 2.0 * (x @ centroids.T) + c2[None, :]
    best, labels = torch.min(d2, dim=-1)
    return labels.to(torch.int32), torch.clamp_min(best, 0.0)
