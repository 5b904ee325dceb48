"""Public wrappers of the hand-written CUDA kernels.

Dispatch goes by the tensors' device, and by nothing else:

  - a CPU tensor takes the kernel's plain PyTorch version (``ref.py``);
  - a CUDA tensor launches the kernel, or raises;
  - a tensor without data (on ``"meta"``, or a dry run's ``FakeTensor``)
    takes the kernel's ``torch.library`` op (``repro_torch::<name>``),
    whose fake gives the output's shape and launches nothing.

There is no fallback from one to the other and no switch. ``impl`` is
accepted for signature parity with the JAX package, whose values
``"auto"``, ``"pallas"`` and ``"xla"`` all mean "dispatch by device" here.

Each CUDA wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on ``torch.cuda.current_stream()``
without synchronising, and adds one to ``LAUNCHES[<kernel>]`` per launch —
the count a run reads to show that it went through the kernel (under a
lock: worker threads of a partitioned fit launch at once).
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

IMPLS = ("auto", "pallas", "xla")

#: Kernel launches since the last :func:`reset_launch_counts`.
#: ``z_matmul`` counts the strip kernel, ``z_matmul_gather`` the gather
#: kernel (the other shapes' route, see :func:`z_strip_plan`);
#: ``gram_matmul`` the fused Gram product (one per launch of its chained
#: pre-scale, scatter and strip kernels), and ``gram_matmul_composed`` the
#: Gram products of the other shapes, each a ``zt_matmul`` then a
#: ``z_matmul`` launch (counted under those).
LAUNCHES: Dict[str, int] = {"rb_binning": 0, "z_matmul": 0,
                            "z_matmul_gather": 0, "zt_matmul": 0,
                            "gram_matmul": 0, "gram_matmul_composed": 0,
                            "bin_counts": 0, "kmeans_assign": 0,
                            "kmeans_assign_stats": 0, "flash_attention": 0}


#: Guards ``LAUNCHES``: a partitioned fit launches from several worker
#: threads, and ``+=`` on a dict entry is a read and a write.
_LAUNCHES_LOCK = threading.Lock()


def _count(name: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    with _LAUNCHES_LOCK:
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


def _shape_only(t: torch.Tensor) -> bool:
    """A tensor without data: on ``"meta"``, or a ``FakeTensor`` (the dry
    run's, ``launch.dryrun``). A kernel's wrapper gives it the kernel's
    shape-only implementation, a ``torch.library`` fake."""
    from torch._subclasses.fake_tensor import is_fake
    return t.device.type == "meta" or is_fake(t)


def _require(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must have dtype in {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


#: Entry points resolved once: (library, function) → ctypes function.
_FNS: Dict[tuple, object] = {}


def _launch(lib: str, fn: str, tensor: torch.Tensor, *args) -> None:
    """Call entry point ``fn`` of library ``lib`` on ``tensor``'s device and
    current stream; raise if it reports a CUDA error."""
    dev = tensor.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(lib, fn, tensor, *args)
    f = _FNS.get((lib, fn))
    if f is None:
        f = _FNS[(lib, fn)] = getattr(_build.library(lib), fn)
    _build.check(f(*args, torch.cuda.current_stream(dev).cuda_stream), fn)


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
    if _shape_only(x):
        return torch.ops.repro_torch.rb_binning(x, widths, biases, hash_a,
                                                hash_c, d_g)
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
    # per (grid, dim): the two reciprocals that bracket 1/w in the kernel's
    # fast step (csrc/rb_binning.cu)
    consts = torch.empty((r, d, 2), dtype=torch.float32, device=x.device)
    _launch("rb_binning", "rb_binning_launch", x,
            x.data_ptr(), widths.data_ptr(), biases.data_ptr(),
            hash_a.data_ptr(), hash_c.data_ptr(), consts.data_ptr(),
            out.data_ptr(), n, d, r, d_g)
    _count("rb_binning")
    return out


# --------------------------------------------------------------------------
# ELL products: y = diag(s)·Z·v, q = Zᵀ·diag(s)·u, and the Gram y = ẐẐᵀu
# --------------------------------------------------------------------------


#: Nonzeros one warp of the ``zt`` kernel reduces: columns longer than this
#: are cut into chunks, whose sums a second pass adds in order. Chosen on
#: the card among 1,024, 2,048 and 4,096 (PERF.md).
ZT_CHUNK = 2048


@dataclasses.dataclass(frozen=True)
class EllCSC:
    """Column-sorted copy of a fixed ELL pattern, for the ``zt`` kernel.

    ``rows[colptr[c]:colptr[c+1]]`` are the rows with a nonzero in column
    ``c``, ascending (the sort is stable), so the kernel's summation order
    is fixed. Columns of more than ``ZT_CHUNK`` nonzeros are the
    ``long_cols``; each is cut into chunks of at most ``ZT_CHUNK``
    nonzeros: long column ``long_cols[j]`` owns chunks
    ``long_chunk_ptr[j]:long_chunk_ptr[j+1]`` and ``chunk_long`` maps a
    chunk back to ``j``. Built once per fit
    (``graph.build_normalized_adjacency``)."""

    rows: torch.Tensor            # (N·R,) int32
    colptr: torch.Tensor          # (D+1,) int64
    long_cols: torch.Tensor       # (n_long,) int32
    long_chunk_ptr: torch.Tensor  # (n_long+1,) int64
    chunk_long: torch.Tensor      # (n_chunks,) int32
    n: int
    d: int


def ell_csc(idx: torch.Tensor, d: int) -> EllCSC:
    """Build the CSC permutation of ``idx`` (N, R) and its tables: a stable
    sort by column, a search for the column bounds, the list of long
    columns and their chunks. This is index preparation, done once per
    fit; the products themselves run in the hand-written kernel."""
    n, r = idx.shape
    flat = idx.reshape(-1)
    cols, perm = torch.sort(flat, stable=True)
    rows = torch.div(perm, r, rounding_mode="floor").to(torch.int32)
    del perm
    bounds = torch.arange(d + 1, dtype=cols.dtype, device=idx.device)
    colptr = torch.searchsorted(cols, bounds).to(torch.int64)
    nnz = colptr[1:] - colptr[:-1]
    long_cols = torch.nonzero(nnz > ZT_CHUNK).reshape(-1)
    per_col = (nnz[long_cols] + ZT_CHUNK - 1) // ZT_CHUNK
    long_chunk_ptr = torch.zeros(long_cols.shape[0] + 1, dtype=torch.int64,
                                 device=idx.device)
    long_chunk_ptr[1:] = torch.cumsum(per_col, 0)
    chunk_long = torch.repeat_interleave(
        torch.arange(long_cols.shape[0], dtype=torch.int32,
                     device=idx.device), per_col)
    return EllCSC(rows=rows, colptr=colptr,
                  long_cols=long_cols.to(torch.int32),
                  long_chunk_ptr=long_chunk_ptr, chunk_long=chunk_long,
                  n=n, d=d)


#: Shared memory one block may use on the H100 (227 KB).
_SMEM_MAX = 232_448
#: The strip kernel's idx buffer: 4,096 rows of 8 int32 (csrc/ell_spmm.cu).
_STRIP_IDX_BYTES = 4096 * 32
#: Fewest rows the strip route takes: every block streams all R strips
#: whatever its rows, so a small batch is faster through the gather kernel
#: (on the H100 at R 256, d_g 2,048, K 11: gather faster at 65,536 rows,
#: strip faster at 131,072; PERF.md).
Z_STRIP_MIN_ROWS = 131_072


def z_strip_plan(n: int, r: int, d_g: int, k: int,
                 dtype: torch.dtype) -> Optional[tuple[int, int]]:
    """The strip route's ``(kc, stages)`` for this shape, or None for the
    gather route.

    The strip kernel keeps each grid's strip ``v[g·d_g:(g+1)·d_g, cols]``
    in shared memory and gathers from there, for tiles of 4,096 rows. It
    takes a shape when N ≥ ``Z_STRIP_MIN_ROWS``, R is a multiple of 8 (idx
    is read 8 grids at a time), d_g is a power of two, and two strips of
    ``d_g·kc`` elements (a 16-byte multiple) fit beside the 128 KB idx
    buffer. ``kc``, the column group (4 for K ≥ 3, else K), is halved until
    they fit; up to 6 strip stages are used. So float32 strips of d_g ≥
    16,384 (bfloat16 ≥ 32,768) take the gather route, as does any other
    shape."""
    esize = 2 if dtype == torch.bfloat16 else 4
    if n < max(Z_STRIP_MIN_ROWS, 1) or r % 8 or k < 1 or d_g < 1 \
            or d_g & (d_g - 1):
        return None
    kc = min(4, 1 << (k - 1).bit_length())
    while kc >= 1:
        strip = d_g * kc * esize
        stride = -(-strip // 128) * 128
        # 2 KB: the launch's alignment slack and the barriers
        stages = min(6, (_SMEM_MAX - 2048 - _STRIP_IDX_BYTES) // stride)
        if strip % 16 == 0 and stages >= 2:
            return kc, stages
        kc //= 2
    return None


#: Fewest outputs (rows · K) for which the gather route takes its register
#: form (a thread per output, 32 grids in flight); below, the staged form
#: (a warp per row, every gather in flight, the fold from shared memory).
#: On the H100 SXM at R = 256 the staged form was faster up to 7,168
#: outputs (1,024 × K 7; 4,096 × K 1) and the register form from 14,336
#: (2,048 × K 7; PERF.md); 10,240 is where the staged form's time at K 7,
#: interpolated linearly between 1,024 and 2,048 rows, meets the register
#: form's (not measured there). At R ≤ 32 the register form holds every
#: grid in flight anyway and takes every shape.
Z_GATHER_ROWS_MIN_OUTPUTS = 10_240
#: Grids a thread of the register form has in flight (csrc/ell_spmm.cu).
_ROWS_AHEAD = 32
#: Grids the staged form holds per pass at most (csrc/ell_spmm.cu): R =
#: 256 is one pass while K ≤ 10.
Z_GATHER_CHUNK = 256
#: Shared memory one warp of the staged form may use: a block of at most
#: four warps stays within the 48 KB a launch gets without an attribute
#: (nothing to set before a CUDA graph capture).
_GATHER_WARP_BYTES = 12 * 1024
_GATHER_MAX_WARPS = 4
#: The H100 SXM's streaming multiprocessors: the gather plan spreads a
#: small batch over them. The plan is tuned for that card and right on any
#: other (only its spread of a small batch depends on the count); a
#: constant keeps it a function of the shape alone, which the CPU tests
#: check and a graph capture needs no device query for.
_SMS = 132


@dataclasses.dataclass(frozen=True)
class ZGatherPlan:
    """Launch geometry of the gather route (csrc/ell_spmm.cu,
    ``z_gather_launch``). ``route`` 1 is the register form: a thread per
    (row, column), ``warps`` warps a block. ``route`` 0 is the staged form:
    a warp owns ``rows`` rows and a column group of ``kc`` columns
    (``groups`` groups cover K); ``warps`` warps form a block; the grids go
    in passes of ``chunk``, each staged column padded to ``stride`` floats.
    ``smem`` bytes a block, ``blocks`` blocks."""

    route: int
    kc: int
    groups: int
    rows: int
    warps: int
    chunk: int
    stride: int
    smem: int
    blocks: int


def _gather_stride(chunk: int) -> int:
    """Floats between two staged columns: ≥ chunk, 4 mod 8, so that the
    16-byte reads of 8 lanes' columns meet no bank conflict."""
    stride = -(-chunk // 4) * 4
    return stride + 4 if stride // 4 % 2 == 0 else stride


def _gather_warp_ints(rows: int, chunk: int, kc: int) -> int:
    return -(-rows * chunk // 4) * 4 + rows * kc * _gather_stride(chunk)


def _gather_warps(items: int) -> int:
    """Warps a block: 4, unless that leaves fewer blocks than SMs."""
    warps = _GATHER_MAX_WARPS
    while warps > 1 and -(-items // warps) < _SMS:
        warps //= 2
    return warps


def z_gather_plan(n: int, r: int, k: int, dtype: torch.dtype) -> ZGatherPlan:
    """The gather route's geometry for y (n, k) = diag(s)·Z·v at R = r.

    A function of the shape alone (V's dtype changes nothing), tuned for
    the H100 SXM's 132 SMs and correct on any card. From ``Z_GATHER_ROWS_MIN_OUTPUTS`` outputs (n·k), or
    at R ≤ 32, the register form: one thread per output, ``warps`` warps a
    block. Otherwise the staged form: a warp folds at most 32 columns, so
    K is cut into ``groups`` = ⌈K/32⌉ balanced column groups (each
    re-gathers its rows' V entries, so fewer is better); the grids go in
    the fewest passes of even length whose staged columns fit a warp's 12
    KB beside its idx (at most 256 grids a pass: one pass at R = 256 for K
    ≤ 10). ``rows`` is 1
    unless a warp would otherwise issue fewer than about 8 gathers a lane
    (R·kc small), and then no more than keeps ≥ 2 warps an SM. Blocks
    have 4 warps unless that leaves fewer blocks than SMs: a 64-row batch
    is 64 blocks of one warp. Every y[i, k] is summed by one thread in
    grid order, whatever the plan."""
    del dtype
    if n < 1 or r < 1 or k < 1:
        raise ValueError(f"no gather plan for n={n}, r={r}, k={k}")
    if n * k >= Z_GATHER_ROWS_MIN_OUTPUTS or r <= _ROWS_AHEAD:
        warps = _gather_warps(-(-n * k // 32))
        return ZGatherPlan(route=1, kc=k, groups=1, rows=1, warps=warps,
                           chunk=r, stride=r, smem=0,
                           blocks=-(-n * k // (32 * warps)))
    budget = _GATHER_WARP_BYTES // 4
    groups = -(-k // 32)
    kc = -(-k // groups)
    chunk = min(r, Z_GATHER_CHUNK)
    while _gather_warp_ints(1, chunk, kc) > budget:
        chunk -= 4
    passes = -(-r // chunk)
    chunk = -(-r // passes)               # passes of even length
    rows = 1
    if r <= chunk:
        while (rows * 2 * kc <= 32 and rows * 2 * r * kc <= 256
               and _gather_warp_ints(rows * 2, chunk, kc) <= budget
               and -(-n // (rows * 2)) * groups >= 2 * _SMS):
            rows *= 2
    items = -(-n // rows) * groups
    warps = _gather_warps(items)
    return ZGatherPlan(route=0, kc=kc, groups=groups, rows=rows,
                       warps=warps, chunk=chunk,
                       stride=_gather_stride(chunk),
                       smem=warps * _gather_warp_ints(rows, chunk, kc) * 4,
                       blocks=-(-items // warps))


def _z_args(idx: torch.Tensor, v: torch.Tensor, rowscale: torch.Tensor,
            d_g: int) -> bool:
    """Check a z product's operands; True if they lie on the card."""
    if idx.dim() != 2 or v.dim() != 2 or v.shape[0] != idx.shape[1] * d_g:
        raise ValueError(
            f"v must have R·d_g = {idx.shape[-1]}·{d_g} rows for idx (N, R) "
            f"= {tuple(idx.shape)}; got v {tuple(v.shape)}")
    if not _on_cuda(idx, v, rowscale):
        return False
    _require(idx, "idx", (torch.int32,), 2)
    _require(v, "v", (torch.float32, torch.bfloat16), 2)
    _require(rowscale, "rowscale", (torch.float32,), 1)
    if rowscale.shape != (idx.shape[0],):
        raise ValueError(f"rowscale must be ({idx.shape[0]},), got "
                         f"{tuple(rowscale.shape)}")
    return True


def z_matmul(
    idx: torch.Tensor,
    v: torch.Tensor,
    rowscale: torch.Tensor,
    *,
    d_g: int,
    impl: str = "auto",
) -> torch.Tensor:
    """y = diag(rowscale) · Z_pattern · v.  (N, K), dtype of ``v``
    (float32 or bfloat16), accumulated in float32.

    ``v`` has R·d_g rows and ``idx`` keeps the strip contract
    ``idx[i, g] ∈ [g·d_g, (g+1)·d_g)``, as the JAX entry point asserts. On
    CUDA the shape picks the kernel (:func:`z_strip_plan`): the strip
    kernel, or else :func:`z_matmul_gather`'s. Both sum each output over
    the grids in order and scale it once, so they give the same bits."""
    _check_impl(impl)
    if _shape_only(v):
        return torch.ops.repro_torch.z_matmul(idx, v, rowscale, d_g)
    if not _z_args(idx, v, rowscale, d_g):
        return ref.z_matmul_ref(idx, v, rowscale)
    n, r = idx.shape
    k = v.shape[1]
    plan = z_strip_plan(n, r, d_g, k, v.dtype)
    if plan is None:
        return z_matmul_gather(idx, v, rowscale, d_g=d_g)
    kc, stages = plan
    if idx.data_ptr() % 16:
        raise ValueError("idx must be 16-byte aligned for the strip kernel")
    out = torch.empty((n, k), dtype=v.dtype, device=v.device)
    vp = torch.empty((-(-k // kc) * r * d_g * kc,), dtype=v.dtype,
                     device=v.device)            # V in column groups
    _launch("ell_spmm", "z_strip_launch", v,
            idx.data_ptr(), v.data_ptr(), rowscale.data_ptr(), vp.data_ptr(),
            out.data_ptr(), n, r, d_g, k, kc, stages,
            int(v.dtype == torch.bfloat16))
    _count("z_matmul")
    return out


def z_matmul_gather(
    idx: torch.Tensor,
    v: torch.Tensor,
    rowscale: torch.Tensor,
    *,
    d_g: int,
) -> torch.Tensor:
    """:func:`z_matmul` through the gather route, whatever the shape: the
    route of the shapes the strip kernel does not take. :func:`z_gather_plan`
    picks its form by shape: for large batches a thread per output with
    32 grids in flight; for small ones a warp per row that stages every
    gather in shared memory at once and folds each column in grid order.
    Safe inside
    a CUDA graph capture: the launch allocates nothing but ``out`` and sets
    no attribute."""
    if _shape_only(v):
        return torch.ops.repro_torch.z_matmul_gather(idx, v, rowscale, d_g)
    if not _z_args(idx, v, rowscale, d_g):
        return ref.z_matmul_ref(idx, v, rowscale)
    n, r = idx.shape
    k = v.shape[1]
    out = torch.empty((n, k), dtype=v.dtype, device=v.device)
    if n == 0 or k == 0:
        return out
    if r == 0:                          # no grid: each y[i, k] is 0 · s[i]
        return out.copy_((rowscale * 0.0)[:, None].expand(n, k))
    p = z_gather_plan(n, r, k, v.dtype)
    _launch("ell_spmm", "z_gather_launch", v,
            idx.data_ptr(), v.data_ptr(), rowscale.data_ptr(), out.data_ptr(),
            n, r, k, p.route, p.kc, p.rows, p.warps, p.chunk, p.stride,
            int(v.dtype == torch.bfloat16))
    _count("z_matmul_gather")
    return out


def zt_matmul(
    idx: Optional[torch.Tensor],
    u: torch.Tensor,
    rowscale: torch.Tensor,
    d: int,
    *,
    d_g: int,
    impl: str = "auto",
    csc: Optional[EllCSC] = None,
) -> torch.Tensor:
    """q = Z_patternᵀ · diag(rowscale) · u.  (D, K) float32.

    On CUDA the kernel reduces the column-sorted copy ``csc`` of ``idx`` in
    a fixed order (one warp per column, chunk sums for the long columns);
    without one it builds it first (the one-shot form). The kernel reads
    ``csc`` alone, so on CUDA ``idx`` may be None when ``csc`` is given (the
    streaming sweep uploads a chunk's CSC, not its idx)."""
    _check_impl(impl)
    if _shape_only(u):
        return torch.ops.repro_torch.zt_matmul(idx, u, rowscale, d, d_g)
    if idx is None and (csc is None or not u.is_cuda):
        raise ValueError("zt_matmul needs idx, or on CUDA its csc")
    if not _on_cuda(*(t for t in (idx, u, rowscale) if t is not None)):
        return ref.zt_matmul_ref(idx, u, rowscale, d)
    if idx is not None:
        _require(idx, "idx", (torch.int32,), 2)
    _require(u, "u", (torch.float32,), 2)
    _require(rowscale, "rowscale", (torch.float32,), 1)
    n, k = u.shape
    if (idx is not None and idx.shape[0] != n) or rowscale.shape != (n,):
        raise ValueError("idx, u and rowscale must have the same rows")
    if csc is None:
        csc = ell_csc(idx, d)
    if csc.n != n or csc.d != d or csc.rows.device != u.device:
        raise ValueError("csc does not describe this idx")
    q = torch.empty((d, k), dtype=torch.float32, device=u.device)
    if d == 0 or k == 0:
        return q
    kp = -(-k // 4) * 4
    su = torch.empty((n, kp), dtype=torch.float32, device=u.device)
    n_chunks = csc.chunk_long.shape[0]
    partial = torch.empty((n_chunks, k), dtype=torch.float32, device=u.device)
    _launch("ell_spmm", "zt_matmul_launch", u,
            csc.rows.data_ptr(), csc.colptr.data_ptr(),
            csc.long_cols.data_ptr(), csc.long_chunk_ptr.data_ptr(),
            csc.chunk_long.data_ptr(), u.data_ptr(), rowscale.data_ptr(),
            su.data_ptr(), partial.data_ptr(), q.data_ptr(), n, d, k, kp,
            csc.long_cols.shape[0], n_chunks, ZT_CHUNK)
    _count("zt_matmul")
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
    """y = Ẑ Ẑᵀ u, the eigensolver's Gram mat-vec.  (N, K) float32.

    On CUDA, a shape that the strip route takes (:func:`z_strip_plan`)
    goes through the fused Gram product: one entry point whose kernels (the
    pre-scale, a scatter that writes q straight into the strip kernel's
    layout, the strip kernel) start as programmatic dependents of each
    other, with the bits of :func:`zt_matmul` then :func:`z_matmul` and no
    repack pass. Any other shape takes that composition. ``csc`` as for
    :func:`zt_matmul`."""
    _check_impl(impl)
    if _shape_only(u):
        return torch.ops.repro_torch.gram_matmul(idx, u, rowscale, d, d_g)
    n, r = idx.shape
    if not _on_cuda(idx, u, rowscale) or d != r * d_g:
        # the plain versions; z_matmul raises on d ≠ R·d_g
        q = zt_matmul(idx, u, rowscale, d, d_g=d_g, impl=impl, csc=csc)
        return z_matmul(idx, q, rowscale, d_g=d_g, impl=impl)
    _require(idx, "idx", (torch.int32,), 2)
    _require(u, "u", (torch.float32,), 2)
    _require(rowscale, "rowscale", (torch.float32,), 1)
    k = u.shape[1]
    if u.shape[0] != n or rowscale.shape != (n,):
        raise ValueError("idx, u and rowscale must have the same rows")
    plan = z_strip_plan(n, r, d_g, k, torch.float32)
    if plan is None:
        q = zt_matmul(idx, u, rowscale, d, d_g=d_g, impl=impl, csc=csc)
        _count("gram_matmul_composed")
        return z_matmul(idx, q, rowscale, d_g=d_g, impl=impl)
    if csc is None:
        csc = ell_csc(idx, d)
    if csc.n != n or csc.d != d or csc.rows.device != u.device:
        raise ValueError("csc does not describe this idx")
    if idx.data_ptr() % 16:
        raise ValueError("idx must be 16-byte aligned for the strip kernel")
    kc, stages = plan
    kp = -(-k // 4) * 4
    dev = u.device
    y = torch.empty((n, k), dtype=torch.float32, device=dev)
    su = torch.empty((n, kp), dtype=torch.float32, device=dev)
    n_chunks = csc.chunk_long.shape[0]
    partial = torch.empty((n_chunks, k), dtype=torch.float32, device=dev)
    qp = torch.empty((-(-k // kc) * d * kc,), dtype=torch.float32,
                     device=dev)                      # q in column groups
    _launch("ell_spmm", "gram_matmul_launch", u,
            csc.rows.data_ptr(), csc.colptr.data_ptr(),
            csc.long_cols.data_ptr(), csc.long_chunk_ptr.data_ptr(),
            csc.chunk_long.data_ptr(), idx.data_ptr(), u.data_ptr(),
            rowscale.data_ptr(), su.data_ptr(), partial.data_ptr(),
            qp.data_ptr(), y.data_ptr(), n, r, d_g, k, kp, kc, stages,
            csc.long_cols.shape[0], n_chunks, ZT_CHUNK)
    _count("gram_matmul")
    return y


def bin_counts(
    idx: torch.Tensor,
    *,
    d: int,
    d_g: int,
    impl: str = "auto",
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact column occupancy Zᵀ1 of the ELL pattern: int32 (D,).

    With ``out`` (an int32 (D,) tensor on ``idx``'s device) the counts are
    added into it and it is returned: a sweep over row chunks accumulates
    into one buffer. On CUDA, an integer histogram (``csrc/bin_counts.cu``:
    per-block counters for a group of up to 32 grids in shared memory, each
    lane of a warp on its own grid with 16 rows in flight, one global
    atomic per nonzero counter); integer adds do not
    depend on their order, so the counts are exact and the same on every
    run."""
    _check_impl(impl)
    if out is not None and (out.dtype != torch.int32 or out.shape != (d,)):
        raise ValueError(f"out must be int32 ({d},), got {out.dtype} "
                         f"{tuple(out.shape)}")
    if _shape_only(idx):
        return out if out is not None else \
            torch.ops.repro_torch.bin_counts(idx, d, d_g)
    if not _on_cuda(idx, *(() if out is None else (out,))):
        counts = ref.bin_counts_ref(idx, d)
        return counts if out is None else out.add_(counts)
    _require(idx, "idx", (torch.int32,), 2)
    if out is not None and not out.is_contiguous():
        raise ValueError("out must be contiguous")
    if d > _I32_MAX or d < 0:
        raise ValueError(f"D = {d} does not fit int32")
    n, r = idx.shape
    accumulate = out is not None
    if out is None:
        out = torch.empty((d,), dtype=torch.int32, device=idx.device)
    if n * r == 0 or d == 0:
        return out if accumulate else out.zero_()
    _launch("bin_counts", "bin_counts_launch", idx,
            idx.data_ptr(), out.data_ptr(), n, r, d_g, d, int(accumulate))
    _count("bin_counts")
    return out


# --------------------------------------------------------------------------
# k-means assignment
# --------------------------------------------------------------------------

_SMEM_LIMIT = 48 * 1024
#: The statistics form's scratch bytes per (device, d, k): the kernel's own
#: query (csrc/kmeans_assign.cu owns its grid and scratch layout).
_STATS_SCRATCH: Dict[tuple, int] = {}


def _kmeans_args(x: torch.Tensor, centroids: torch.Tensor) -> tuple:
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
    if n > _I32_MAX:
        raise ValueError(f"N = {n} does not fit int32")
    return n, d, k


def kmeans_assign(
    x: torch.Tensor, centroids: torch.Tensor, *, impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels int32 (N,), squared distance to nearest centroid (N,))."""
    _check_impl(impl)
    if _shape_only(x):
        return torch.ops.repro_torch.kmeans_assign(x, centroids)
    if not _on_cuda(x, centroids):
        return ref.kmeans_assign_ref(x, centroids)
    n, d, k = _kmeans_args(x, centroids)
    labels = torch.empty((n,), dtype=torch.int32, device=x.device)
    dist = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return labels, dist
    _launch("kmeans_assign", "kmeans_assign_launch", x,
            x.data_ptr(), centroids.data_ptr(), labels.data_ptr(),
            dist.data_ptr(), n, d, k)
    _count("kmeans_assign")
    return labels, dist


def kmeans_assign_stats(
    x: torch.Tensor, centroids: torch.Tensor, *, impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One assignment pass plus the Lloyd step's statistics: (labels int32
    (N,), counts float32 (k,), sums float32 (k, d), inertia float32 ()).

    The JAX package's ``ops.kmeans_assign_stats``. On CUDA it is the
    ``kmeans_assign`` kernel with a second epilogue: per-warp sums in a
    fixed order and one partial per block, which a two-level tree of
    ticket counters adds in a fixed order (the last block of each group of
    32, then the last of those) — no float atomics, so the bits are the
    same on every run (the grid depends on the shape and the card
    alone)."""
    _check_impl(impl)
    if _shape_only(x):
        return torch.ops.repro_torch.kmeans_assign_stats(x, centroids)
    if not _on_cuda(x, centroids):
        return ref.kmeans_assign_stats_ref(x, centroids)
    n, d, k = _kmeans_args(x, centroids)
    dev = x.device
    key = (dev.index, d, k)
    nbytes = _STATS_SCRATCH.get(key)
    if nbytes is None:
        out = ctypes.c_longlong()
        with torch.cuda.device(dev):
            code = _build.library("kmeans_assign").kmeans_assign_stats_scratch(
                d, k, ctypes.byref(out))
        if code:
            raise ValueError(f"{k} centroids of width {d}: the statistics "
                             "form does not fit a block's shared memory "
                             f"(cudaError {code})")
        nbytes = _STATS_SCRATCH[key] = out.value
    labels = torch.empty((n,), dtype=torch.int32, device=dev)
    stats = torch.empty((k * (d + 1) + 1,), dtype=torch.float32, device=dev)
    counts, sums, inertia = stats[:k], stats[k:k + k * d].view(k, d), stats[-1]
    if n == 0:
        stats.zero_()
        return labels, counts, sums, inertia
    # the launch's own scratch, from the stream's pool: its ticket counters
    # are zeroed by the launch, so launches on other streams never share
    # them and a failed launch leaves nothing behind
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    _launch("kmeans_assign", "kmeans_assign_stats_launch", x,
            x.data_ptr(), centroids.data_ptr(), labels.data_ptr(),
            counts.data_ptr(), sums.data_ptr(), inertia.data_ptr(),
            scratch.data_ptr(), nbytes, n, d, k)
    _count("kmeans_assign_stats")
    return labels, counts, sums, inertia


# --------------------------------------------------------------------------
# the kernels as torch.library ops: each op's CUDA implementation is its
# wrapper above (the launch), its fake the output's shape alone. A wrapper
# calls its op only for tensors without data (``_shape_only``: a dry run's
# FakeTensors), so the launches on the card keep their direct path.
# --------------------------------------------------------------------------

_OP = dict(mutates_args=(), device_types="cuda")


@torch.library.custom_op("repro_torch::rb_binning", **_OP)
def _rb_binning_op(x: torch.Tensor, widths: torch.Tensor,
                   biases: torch.Tensor, hash_a: torch.Tensor,
                   hash_c: torch.Tensor, d_g: int) -> torch.Tensor:
    return rb_binning(x, widths, biases, hash_a, hash_c, d_g=d_g)


@_rb_binning_op.register_fake
def _(x, widths, biases, hash_a, hash_c, d_g):
    return x.new_empty((x.shape[0], widths.shape[0]), dtype=torch.int32)


@torch.library.custom_op("repro_torch::z_matmul", **_OP)
def _z_matmul_op(idx: torch.Tensor, v: torch.Tensor, rowscale: torch.Tensor,
                 d_g: int) -> torch.Tensor:
    return z_matmul(idx, v, rowscale, d_g=d_g)


@_z_matmul_op.register_fake
def _(idx, v, rowscale, d_g):
    return v.new_empty((idx.shape[0], v.shape[1]))


@torch.library.custom_op("repro_torch::z_matmul_gather", **_OP)
def _z_matmul_gather_op(idx: torch.Tensor, v: torch.Tensor,
                        rowscale: torch.Tensor, d_g: int) -> torch.Tensor:
    return z_matmul_gather(idx, v, rowscale, d_g=d_g)


@_z_matmul_gather_op.register_fake
def _(idx, v, rowscale, d_g):
    return v.new_empty((idx.shape[0], v.shape[1]))


@torch.library.custom_op("repro_torch::zt_matmul", **_OP)
def _zt_matmul_op(idx: Optional[torch.Tensor], u: torch.Tensor,
                  rowscale: torch.Tensor, d: int, d_g: int) -> torch.Tensor:
    return zt_matmul(idx, u, rowscale, d, d_g=d_g)


@_zt_matmul_op.register_fake
def _(idx, u, rowscale, d, d_g):
    return u.new_empty((d, u.shape[1]), dtype=torch.float32)


@torch.library.custom_op("repro_torch::gram_matmul", **_OP)
def _gram_matmul_op(idx: torch.Tensor, u: torch.Tensor,
                    rowscale: torch.Tensor, d: int, d_g: int) -> torch.Tensor:
    return gram_matmul(idx, u, rowscale, d, d_g=d_g)


@_gram_matmul_op.register_fake
def _(idx, u, rowscale, d, d_g):
    return u.new_empty(u.shape, dtype=torch.float32)


@torch.library.custom_op("repro_torch::bin_counts", **_OP)
def _bin_counts_op(idx: torch.Tensor, d: int, d_g: int) -> torch.Tensor:
    return bin_counts(idx, d=d, d_g=d_g)


@_bin_counts_op.register_fake
def _(idx, d, d_g):
    return idx.new_empty((d,), dtype=torch.int32)


@torch.library.custom_op("repro_torch::kmeans_assign", **_OP)
def _kmeans_assign_op(x: torch.Tensor, centroids: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    return kmeans_assign(x, centroids)


@_kmeans_assign_op.register_fake
def _(x, centroids):
    n = x.shape[0]
    return (x.new_empty((n,), dtype=torch.int32),
            x.new_empty((n,), dtype=torch.float32))


@torch.library.custom_op("repro_torch::kmeans_assign_stats", **_OP)
def _kmeans_assign_stats_op(x: torch.Tensor, centroids: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    # an op's outputs may not alias each other: the statistics are views
    # of one buffer in the wrapper
    labels, counts, sums, inertia = kmeans_assign_stats(x, centroids)
    return labels, counts.clone(), sums.clone(), inertia.clone()


@_kmeans_assign_stats_op.register_fake
def _(x, centroids):
    n, k, d = x.shape[0], centroids.shape[0], x.shape[1]
    f32 = dict(dtype=torch.float32)
    return (x.new_empty((n,), dtype=torch.int32), x.new_empty((k,), **f32),
            x.new_empty((k, d), **f32), x.new_empty((), **f32))


# --------------------------------------------------------------------------
# flash attention: the LM stack's prefill and training forward
# --------------------------------------------------------------------------

#: Head dims the kernel is instantiated for: those of the dense configs
#: (128, 160) and of the tests.
FLASH_HEAD_DIMS = (16, 32, 64, 128, 160)
_MAX_GRID_Y = 65535
#: Query rows a step of the attention's plain backward recomputes: every
#: config's ``attn_chunk`` (the JAX package's chunk of the same
#: recompute); (B·H, 512, T) float32 scores are 512 MiB at (4, 16, 4,096).
FLASH_BWD_CHUNK = 512


def flash_attention(
    q: torch.Tensor,          # (B, S, H, hd)
    k: torch.Tensor,          # (B, T, Hkv, hd), Hkv divides H
    v: torch.Tensor,          # (B, T, Hkv, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Online-softmax attention; the scores never reach device memory.

    The JAX package's signature and layout. K and V may also hold fewer
    heads than Q (grouped-query attention: head ``h`` reads kv head
    ``h // (H // Hkv)``), which saves the prefill a repeated copy.

    Gradients: on a CUDA tensor that needs one, the call goes through
    ``_FlashAttention``: the forward is the kernel's launch, the backward
    ``ref.flash_attention_bwd_ref`` (plain PyTorch, recomputing the
    probabilities ``FLASH_BWD_CHUNK`` query rows at a time, as the JAX
    package's ``jax.checkpoint``-ed attention does by ``attn_chunk``; the
    JAX package has no backward kernel). Without a gradient the kernel launches and nothing is saved.
    On a CPU tensor the plain version is differentiable by autograd."""
    _check_impl(impl)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, S, H, hd) and k, v (B, T, Hkv, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or hkv == 0 or h % hkv:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    shape_only = _shape_only(q)
    if not shape_only and not _on_cuda(q, k, v):
        return ref.flash_attention_bshd_ref(q, k, v, causal=causal,
                                            window=window)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _require(x, name, (torch.float32, torch.bfloat16), 4)
        if not shape_only and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {hd} has no kernel; options "
                         f"{FLASH_HEAD_DIMS}")
    if t == 0:
        raise ValueError("attention over no keys")
    if -(-s // 32) > _MAX_GRID_Y or b * h > _I32_MAX:
        raise ValueError(f"S = {s} or B·H = {b * h} is too large")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _flash_launch(q, k, v, causal, window)


def _flash_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: Optional[int]) -> torch.Tensor:
    """The kernel on checked tensors, through the ``torch.library`` op
    ``repro_torch::flash_attention``: the launch on CUDA tensors, the
    op's fake (the output's shape) on tensors without data."""
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, window)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: Optional[int]) -> torch.Tensor:
    """The kernel's launch on checked CUDA tensors."""
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if b * s * h == 0:
        return out
    _launch("flash_attention", "flash_attention_launch", q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, hkv, hd, int(causal), window or 0,
            int(q.dtype == torch.bfloat16))
    _count("flash_attention")
    if window is not None and s >= t + window:
        _fill_keyless_rows(out, v, t + window - 1)
    return out


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, window):
    return torch.empty_like(q)


def flash_flops(b: int, s: int, t: int, h: int, hd: int, causal: bool,
                window: Optional[int]) -> int:
    """Multiply-adds × 2 of the kernel's two products (QKᵀ, PV) over the
    (query, key) pairs its mask lets through: 4 · hd · pairs · B · H."""
    import numpy as np     # host arithmetic: counted inside fake modes too
    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(s, np.int64)
    pairs = int(np.clip(hi - lo + 1, 0, None).sum())
    return 4 * hd * pairs * b * h


class _FlashAttention(torch.autograd.Function):
    """The flash kernel's forward with a plain PyTorch backward: dq, and dk
    and dv summed over each kv head's group, from q, k, v and the output's
    gradient (the probabilities are recomputed, never stored)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, chunk=FLASH_BWD_CHUNK)
        return _flash_launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, dout, **ctx.opts)
        return dq, dk, dv, None, None


def _fill_keyless_rows(out: torch.Tensor, v: torch.Tensor, row0: int) -> None:
    """Rows ``row0:`` of a windowed attention see no key. The reference
    (and the plain version) masks all T scores to -1e30, so its softmax is
    uniform and such a row is mean(V) over all T keys: p = 1/T rounded to
    V's dtype, times the float32 sum of V, in ``out``'s dtype."""
    t, rep = v.shape[1], out.shape[2] // v.shape[2]
    p = (torch.ones((), dtype=torch.float32) / t).to(v.dtype).float()
    mean = (v.float().sum(dim=1) * p).repeat_interleave(rep, dim=1)
    out[:, row0:] = mean[:, None].to(out.dtype)
