"""Public wrappers of the hand-written CUDA kernels.

Dispatch goes by the tensors' device, and by nothing else:

  - a CPU tensor takes the kernel's plain PyTorch version (``ref.py``);
  - a CUDA tensor launches the kernel, or raises.

There is no fallback from one to the other and no switch. ``impl`` is
accepted for signature parity with the JAX package, whose values
``"auto"``, ``"pallas"`` and ``"xla"`` all mean "dispatch by device" here.

Each CUDA wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on ``torch.cuda.current_stream()``
without synchronising, and adds one to ``LAUNCHES[<kernel>]`` per launch —
the count a run reads to show that it went through the kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build, ref

IMPLS = ("auto", "pallas", "xla")

#: Kernel launches since the last :func:`reset_launch_counts`.
LAUNCHES: Dict[str, int] = {"rb_binning": 0, "z_matmul": 0, "zt_matmul": 0,
                            "kmeans_assign": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; options {IMPLS} (all "
                         "dispatch by the tensors' device)")


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True if the tensors lie on one CUDA device, False if all on the CPU;
    raises on a mix."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"tensors on different devices: {sorted(map(str, devices))}")
    return next(iter(devices)).type == "cuda"


def _require(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must have dtype in {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(lib: str, fn: str, tensor: torch.Tensor, *args) -> None:
    with torch.cuda.device(tensor.device):
        code = getattr(_build.library(lib), fn)(*args, _stream(tensor))
    _build.check(code, fn)


_I32_MAX = 2**31 - 1

# --------------------------------------------------------------------------
# RB binning
# --------------------------------------------------------------------------


def rb_binning(
    x: torch.Tensor,
    widths: torch.Tensor,
    biases: torch.Tensor,
    hash_a: torch.Tensor,
    hash_c: torch.Tensor,
    *,
    d_g: int,
    impl: str = "auto",
) -> torch.Tensor:
    """ELL column indices of the hashed RB feature matrix: int32 (N, R).

    ``hash_a`` (R, d) and ``hash_c`` (R,) are int32 tensors holding the
    uint32 hash parameters' bits."""
    _check_impl(impl)
    if d_g < 1 or d_g & (d_g - 1):
        raise ValueError(f"d_g must be a power of two, got {d_g}")
    if not _on_cuda(x, widths, biases, hash_a, hash_c):
        return ref.rb_binning_ref(x, widths, biases, hash_a, hash_c, d_g)
    _require(x, "x", (torch.float32,), 2)
    _require(widths, "widths", (torch.float32,), 2)
    _require(biases, "biases", (torch.float32,), 2)
    _require(hash_a, "hash_a", (torch.int32,), 2)
    _require(hash_c, "hash_c", (torch.int32,), 1)
    n, d = x.shape
    r = widths.shape[0]
    if not (widths.shape == biases.shape == hash_a.shape == (r, d)
            and hash_c.shape == (r,)):
        raise ValueError("grid parameters must be (R, d) and (R,) with "
                         f"d = {d}")
    if r * d_g > _I32_MAX or n > _I32_MAX:
        raise ValueError(f"N = {n} or D = R·d_g = {r * d_g} does not fit "
                         "int32")
    out = torch.empty((n, r), dtype=torch.int32, device=x.device)
    if n == 0 or r == 0:
        return out
    _launch("rb_binning", "rb_binning_launch", x,
            x.data_ptr(), widths.data_ptr(), biases.data_ptr(),
            hash_a.data_ptr(), hash_c.data_ptr(), out.data_ptr(),
            n, d, r, d_g)
    LAUNCHES["rb_binning"] += 1
    return out


# --------------------------------------------------------------------------
# ELL products: y = diag(s)·Z·v, q = Zᵀ·diag(s)·u, and the Gram y = ẐẐᵀu
# --------------------------------------------------------------------------


#: Nonzeros one warp of the ``zt`` kernel reduces: columns longer than this
#: are cut into chunks, whose sums a second pass adds in order.
ZT_CHUNK = 2048


@dataclasses.dataclass(frozen=True)
class EllCSC:
    """Column-sorted copy of a fixed ELL pattern, for the ``zt`` kernel.

    ``rows[colptr[c]:colptr[c+1]]`` are the rows with a nonzero in column
    ``c``, ascending (the sort is stable), so the kernel's summation order
    is fixed. Each column's segment is cut into chunks of at most
    ``ZT_CHUNK`` nonzeros: column ``c`` owns chunks
    ``chunk_ptr[c]:chunk_ptr[c+1]`` and ``chunk_col`` maps a chunk back to
    its column. Built once per fit (``graph.build_normalized_adjacency``)."""

    rows: torch.Tensor        # (N·R,) int32
    colptr: torch.Tensor      # (D+1,) int64
    chunk_ptr: torch.Tensor   # (D+1,) int64
    chunk_col: torch.Tensor   # (n_chunks,) int32
    n: int
    d: int


def ell_csc(idx: torch.Tensor, d: int) -> EllCSC:
    """Build the CSC permutation of ``idx`` (N, R) and its chunk table: a
    stable sort by column, a search for the column bounds, a cumulative
    sum. This is index preparation, done once per fit; the products
    themselves run in the hand-written kernel."""
    n, r = idx.shape
    flat = idx.reshape(-1)
    cols, perm = torch.sort(flat, stable=True)
    rows = torch.div(perm, r, rounding_mode="floor").to(torch.int32)
    del perm
    bounds = torch.arange(d + 1, dtype=cols.dtype, device=idx.device)
    colptr = torch.searchsorted(cols, bounds).to(torch.int64)
    per_col = (colptr[1:] - colptr[:-1] + ZT_CHUNK - 1) // ZT_CHUNK
    chunk_ptr = torch.zeros(d + 1, dtype=torch.int64, device=idx.device)
    chunk_ptr[1:] = torch.cumsum(per_col, 0)
    chunk_col = torch.repeat_interleave(
        torch.arange(d, dtype=torch.int32, device=idx.device), per_col)
    return EllCSC(rows=rows, colptr=colptr, chunk_ptr=chunk_ptr,
                  chunk_col=chunk_col, n=n, d=d)


def z_matmul(
    idx: torch.Tensor,
    v: torch.Tensor,
    rowscale: torch.Tensor,
    *,
    d_g: int,
    impl: str = "auto",
) -> torch.Tensor:
    """y = diag(rowscale) · Z_pattern · v.  (N, K), dtype of ``v``
    (float32 or bfloat16), accumulated in float32."""
    _check_impl(impl)
    if not _on_cuda(idx, v, rowscale):
        return ref.z_matmul_ref(idx, v, rowscale)
    _require(idx, "idx", (torch.int32,), 2)
    _require(v, "v", (torch.float32, torch.bfloat16), 2)
    _require(rowscale, "rowscale", (torch.float32,), 1)
    n, r = idx.shape
    k = v.shape[1]
    if rowscale.shape != (n,):
        raise ValueError(f"rowscale must be ({n},), got {tuple(rowscale.shape)}")
    out = torch.empty((n, k), dtype=v.dtype, device=v.device)
    if n == 0 or k == 0:
        return out
    _launch("ell_spmm", "z_matmul_launch", v,
            idx.data_ptr(), v.data_ptr(), rowscale.data_ptr(), out.data_ptr(),
            n, r, k, int(v.dtype == torch.bfloat16))
    LAUNCHES["z_matmul"] += 1
    return out


def zt_matmul(
    idx: torch.Tensor,
    u: torch.Tensor,
    rowscale: torch.Tensor,
    d: int,
    *,
    d_g: int,
    impl: str = "auto",
    csc: Optional[EllCSC] = None,
) -> torch.Tensor:
    """q = Z_patternᵀ · diag(rowscale) · u.  (D, K) float32.

    On CUDA the kernel reduces the column-sorted copy ``csc`` of ``idx``
    (chunk sums, then their sum per column, in a fixed order); without one
    it builds it first (the one-shot form)."""
    _check_impl(impl)
    if not _on_cuda(idx, u, rowscale):
        return ref.zt_matmul_ref(idx, u, rowscale, d)
    _require(idx, "idx", (torch.int32,), 2)
    _require(u, "u", (torch.float32,), 2)
    _require(rowscale, "rowscale", (torch.float32,), 1)
    n, k = u.shape
    if idx.shape[0] != n or rowscale.shape != (n,):
        raise ValueError("idx, u and rowscale must have the same rows")
    if csc is None:
        csc = ell_csc(idx, d)
    if csc.n != n or csc.d != d or csc.rows.device != u.device:
        raise ValueError("csc does not describe this idx")
    q = torch.empty((d, k), dtype=torch.float32, device=u.device)
    if d == 0 or k == 0:
        return q
    n_chunks = csc.chunk_col.shape[0]
    partial = torch.empty((n_chunks, k), dtype=torch.float32, device=u.device)
    _launch("ell_spmm", "zt_matmul_launch", u,
            csc.rows.data_ptr(), csc.colptr.data_ptr(),
            csc.chunk_ptr.data_ptr(), csc.chunk_col.data_ptr(), u.data_ptr(),
            rowscale.data_ptr(), partial.data_ptr(), q.data_ptr(), n_chunks,
            d, k, ZT_CHUNK)
    LAUNCHES["zt_matmul"] += 1
    return q


def gram_matmul(
    idx: torch.Tensor,
    u: torch.Tensor,
    rowscale: torch.Tensor,
    d: int,
    *,
    d_g: int,
    impl: str = "auto",
    csc: Optional[EllCSC] = None,
) -> torch.Tensor:
    """y = Ẑ Ẑᵀ u, the eigensolver's Gram mat-vec: the ``zt`` kernel into a
    (D, K) float32 buffer, then the ``z`` kernel on it. (A fused kernel
    waits for a measured gain.)"""
    q = zt_matmul(idx, u, rowscale, d, d_g=d_g, impl=impl, csc=csc)
    return z_matmul(idx, q, rowscale, d_g=d_g, impl=impl)


# --------------------------------------------------------------------------
# k-means assignment
# --------------------------------------------------------------------------

_SMEM_LIMIT = 48 * 1024


def kmeans_assign(
    x: torch.Tensor, centroids: torch.Tensor, *, impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels int32 (N,), squared distance to nearest centroid (N,))."""
    _check_impl(impl)
    if not _on_cuda(x, centroids):
        return ref.kmeans_assign_ref(x, centroids)
    _require(x, "x", (torch.float32,), 2)
    _require(centroids, "centroids", (torch.float32,), 2)
    n, d = x.shape
    k = centroids.shape[0]
    if centroids.shape[1] != d or k == 0:
        raise ValueError(f"centroids must be (K ≥ 1, {d}), got "
                         f"{tuple(centroids.shape)}")
    if (k * d + k) * 4 > _SMEM_LIMIT:
        raise ValueError(f"{k} centroids of width {d} exceed the kernel's "
                         "48 KB of shared memory")
    labels = torch.empty((n,), dtype=torch.int32, device=x.device)
    dist = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return labels, dist
    _launch("kmeans_assign", "kmeans_assign_launch", x,
            x.data_ptr(), centroids.data_ptr(), labels.data_ptr(),
            dist.data_ptr(), n, d, k)
    LAUNCHES["kmeans_assign"] += 1
    return labels, dist
