"""Chunked / streaming data structures for out-of-core N.

The storage layer behind the ``residency="host_chunked"`` plans
(``repro_torch.core.rowmatrix.HostChunkedRows``): the device holds
O(chunk · R) of the ELL matrix, whatever N is, and the fit computes the
paper's exact algorithm (no landmark approximation).

  - ``ChunkedELL``    row chunks of ``idx``/``rowscale`` kept on the host
    (pinned when the fit runs on the card); each sweep uploads one chunk
    at a time, double-buffered (``utils.prefetch_to_device``).
  - two-pass degrees (Eq. 6): ``counts = Σ_c Z_cᵀ1`` accumulated as int32
    bin occupancies by ``ops.bin_counts`` into one (D,) buffer (order-
    invariant, so the same for any chunking), then ``deg_i = (1/R) Σ_g
    counts[idx[i, g]]`` row-locally per chunk (``graph.degrees_from_counts``).
  - the blocked Gram product ``u ↦ Ẑ(Ẑᵀu)``: a zt sweep over the chunks
    into one (D, K) accumulator (``q = q + zt(chunk)`` in chunk order), then
    a z sweep. q needs every chunk before any row of Ẑq can be formed, so
    the fused Gram kernel of the device path does not serve here.
  - ``ChunkedDense``  host row chunks of a dense (N, K) matrix (the LOBPCG
    iterates, the embedding, the k-means input), so no stage allocates an
    O(N) device array.

On the card the ``zt`` kernel reads a column-sorted copy of each chunk
(``ops.EllCSC``), never its idx. Each chunk's copy is built once, on the
card, in the degree pass and kept on the host beside the chunk's idx: the
zt sweep uploads the CSC (chunk·R int32 row ids and a (D+1) int64 column
pointer), the z sweep uploads idx. The uploaded bytes are those of
uploading idx twice; the host holds the pattern twice.

The JAX package's ``lax.scan`` products (``chunked_zt_matmul``,
``chunked_z_matmul``, ``chunked_gram_matvec``) are loops over row chunks of
device tensors here: the within-shard chunking of the mesh placement
(``core.distributed``), one (D, K) accumulator added to in chunk order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import graph, rb
from repro_torch.kernels import ops
from repro_torch.utils import (
    DeviceLike, prefetch_to_device, resolve_device, to_host, tree_map,
)


def _as_host(a) -> torch.Tensor:
    """A CPU tensor of ``a`` (a view where ``a`` is already on the host)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.asarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _pinned(t: torch.Tensor, pin: bool) -> torch.Tensor:
    return t.pin_memory() if pin and not t.is_pinned() else t


def _csc_to_host(csc: ops.EllCSC) -> ops.EllCSC:
    return tree_map(
        lambda t: to_host(t) if isinstance(t, torch.Tensor) else t, csc)


def as_row_chunks(x, chunk_size: Optional[int]) -> list[torch.Tensor]:
    """Split data into host row chunks (views, no copy, for a host array or
    tensor). An already-chunked sequence (e.g. memory-mapped blocks) passes
    through, so a caller with a true out-of-core source never
    concatenates."""
    if isinstance(x, (list, tuple)):
        chunks = [_as_host(c) for c in x]
        if not chunks:
            raise ValueError("empty chunk sequence")
        return chunks
    xs = _as_host(x)
    if chunk_size is None or chunk_size >= xs.shape[0]:
        return [xs]
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    return [xs[i:i + chunk_size] for i in range(0, xs.shape[0], chunk_size)]


@dataclasses.dataclass(frozen=True)
class ChunkedDense:
    """Host row chunks of a dense (N, K) float32 matrix.

    The streaming fit's format for everything dense and O(N) tall: the
    LOBPCG block iterates, the Ritz embedding and the row-normalized k-means
    input. Only one chunk at a time is uploaded."""

    chunks: Tuple[torch.Tensor, ...]    # each (rows_c, K) float32, CPU

    @property
    def n(self) -> int:
        return sum(c.shape[0] for c in self.chunks)

    @property
    def k(self) -> int:
        return self.chunks[0].shape[1]

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @property
    def chunk_sizes(self) -> Tuple[int, ...]:
        return tuple(c.shape[0] for c in self.chunks)

    def to_array(self) -> np.ndarray:
        """The whole matrix on the host, as numpy."""
        return np.concatenate([c.numpy() for c in self.chunks], axis=0)

    def take_cols(self, k: int) -> "ChunkedDense":
        """The first k columns, chunk by chunk."""
        return ChunkedDense(tuple(c[:, :k].contiguous() for c in self.chunks))

    @classmethod
    def from_array(cls, x, sizes=None) -> "ChunkedDense":
        """Chunk a dense array; ``sizes`` is a chunk size or the row counts
        of each chunk (to align with a ``ChunkedELL``)."""
        xs = _as_host(x).to(torch.float32)
        if sizes is None or isinstance(sizes, int):
            return cls(tuple(as_row_chunks(xs, sizes)))
        out, start = [], 0
        for s in sizes:
            out.append(xs[start:start + s])
            start += s
        if start != xs.shape[0]:
            raise ValueError(f"sizes sum to {start}, array has "
                             f"{xs.shape[0]} rows")
        return cls(tuple(out))

    @classmethod
    def random_normal(cls, generator: torch.Generator, sizes: Sequence[int],
                      k: int) -> "ChunkedDense":
        """Standard-normal chunks drawn one after another from ``generator``
        (a CPU generator), never an (N, k) array."""
        return cls(tuple(torch.randn((s, k), generator=generator,
                                     dtype=torch.float32) for s in sizes))

    @classmethod
    def random_rademacher(cls, generator: torch.Generator,
                          sizes: Sequence[int], k: int) -> "ChunkedDense":
        """±1 chunks drawn one after another from ``generator`` (a CPU
        generator), never an (N, k) array."""
        return cls(tuple(rademacher((s, k), generator) for s in sizes))


def rademacher(shape, generator: torch.Generator) -> torch.Tensor:
    """±1 float32 entries, equally likely, from ``generator`` on its own
    device."""
    bits = torch.randint(0, 2, shape, generator=generator,
                         dtype=torch.float32, device=generator.device)
    return bits.mul_(2.0).sub_(1.0)


@dataclasses.dataclass(frozen=True)
class ChunkedELL:
    """Row-chunked Ẑ = D̂^{-1/2}·Z: host ELL chunks and their row scales.

    The dense factors ((D, K) projections) stay on ``device``; only the
    (N, R) pattern (and on the card each chunk's CSC copy) is streamed."""

    idx_chunks: Tuple[torch.Tensor, ...]       # each (rows_c, R) int32
    rowscale_chunks: Tuple[torch.Tensor, ...]  # each (rows_c,) float32
    d: int                                     # feature columns D = R·d_g
    d_g: int
    impl: str = "auto"
    deg: Optional[torch.Tensor] = None         # (N,) float32, host
    prefetch: bool = True                      # double-buffered uploads
    h2d_stats: dict = dataclasses.field(default_factory=dict, compare=False)
    # ^ measured uploads (utils.prefetch_to_device), updated by every sweep
    counts: Optional[torch.Tensor] = None      # (D,) int32 bin occupancies
    csc_chunks: Optional[Tuple[ops.EllCSC, ...]] = None   # card: zt's copy
    device: torch.device = torch.device("cpu")

    @property
    def n(self) -> int:
        return sum(c.shape[0] for c in self.idx_chunks)

    @property
    def r(self) -> int:
        return self.idx_chunks[0].shape[1]

    @property
    def n_chunks(self) -> int:
        return len(self.idx_chunks)

    @property
    def max_chunk_rows(self) -> int:
        return max(c.shape[0] for c in self.idx_chunks)

    @property
    def chunk_sizes(self) -> Tuple[int, ...]:
        return tuple(c.shape[0] for c in self.idx_chunks)

    @property
    def ell_device_bytes_peak(self) -> int:
        """Device residency of the ELL pattern: one chunk (twice this while
        the double buffering holds two in flight)."""
        return self.max_chunk_rows * self.r * 4

    def _stream(self, *extra_chunk_seqs):
        """Prefetched device iterator over (idx, rowscale, *extras)."""
        return prefetch_to_device(
            zip(self.idx_chunks, self.rowscale_chunks, *extra_chunk_seqs),
            device=self.device, enabled=self.prefetch,
            measure=self.h2d_stats)

    def _zt_sweep(self, u_chunks, k: int) -> torch.Tensor:
        """Ẑᵀu over the chunks into one (D, K) accumulator, in chunk order.
        On the card each chunk's CSC copy is uploaded instead of its idx."""
        pattern = self.csc_chunks if self.csc_chunks is not None \
            else self.idx_chunks
        q = torch.zeros((self.d, k), dtype=torch.float32, device=self.device)
        for pc, sc, uc in prefetch_to_device(
                zip(pattern, self.rowscale_chunks, u_chunks),
                device=self.device, enabled=self.prefetch,
                measure=self.h2d_stats):
            csc = pc if self.csc_chunks is not None else None
            q = q + ops.zt_matmul(None if csc else pc, uc.contiguous(), sc,
                                  self.d, d_g=self.d_g, impl=self.impl,
                                  csc=csc)
        return q

    def matmat_chunked(self, v: torch.Tensor) -> ChunkedDense:
        """Ẑ v : (D, K) → host row chunks (N, K); one ELL chunk and the
        (D, K) operand on the device at a time."""
        v = v.contiguous()
        return ChunkedDense(tuple(
            to_host(ops.z_matmul(ic, v, sc, d_g=self.d_g, impl=self.impl))
            for ic, sc in self._stream()))

    def _check_aligned(self, u: ChunkedDense) -> None:
        if u.chunk_sizes != self.chunk_sizes:
            raise ValueError(f"chunking mismatch: u has {u.chunk_sizes}, "
                             f"ELL has {self.chunk_sizes}")

    def rmatmat_chunked(self, u: ChunkedDense) -> torch.Tensor:
        """Ẑᵀ u with host row chunks u aligned to the ELL chunking: the
        pass that gives a fitted model its right singular subspace."""
        self._check_aligned(u)
        return self._zt_sweep(u.chunks, u.k)

    def gram_matvec_chunked(self, u: ChunkedDense) -> ChunkedDense:
        """(Ẑ Ẑᵀ) u with host-chunked input and output: the operator of
        ``eigensolver.lobpcg_host_chunked``. Device residency is one pattern
        chunk (two in flight), one u chunk and the (D, K) accumulator,
        whatever N is."""
        return self.matmat_chunked(self.rmatmat_chunked(u))

    @classmethod
    def from_dense(cls, idx, rowscale, chunk_size: Optional[int], *, d: int,
                   d_g: int, impl: str = "auto", prefetch: bool = True,
                   device: DeviceLike = "cuda") -> "ChunkedELL":
        """Chunk an existing (N, R) ELL matrix and its row scales (tests)."""
        dev = resolve_device(device)
        pin = dev.type == "cuda"
        ics = tuple(_pinned(c.contiguous(), pin)
                    for c in as_row_chunks(idx, chunk_size))
        scs = tuple(_pinned(c.to(torch.float32).contiguous(), pin)
                    for c in as_row_chunks(rowscale, chunk_size))
        csc = _csc_chunks(ics, d, dev, prefetch, {}) if pin else None
        return cls(ics, scs, d=d, d_g=d_g, impl=impl, prefetch=prefetch,
                   csc_chunks=csc, device=dev)


def _csc_chunks(idx_chunks, d: int, dev: torch.device, prefetch: bool,
                measure: dict) -> Tuple[ops.EllCSC, ...]:
    """Each chunk's CSC copy, built on the card, kept in pinned host
    memory."""
    return tuple(_csc_to_host(ops.ell_csc(ic, d))
                 for ic in prefetch_to_device(idx_chunks, device=dev,
                                              enabled=prefetch,
                                              measure=measure))


def chunked_transform(transform, x_chunks, *, device: DeviceLike = "cuda",
                      prefetch: bool = True, measure: Optional[dict] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """A row-local feature ``transform`` over host row chunks: each chunk
    uploaded, transformed on ``device`` and brought back (pinned on the
    card), so the result is the single-shot transform's for any
    chunking."""
    device = resolve_device(device)
    rows = (_as_host(c).to(torch.float32).contiguous() for c in x_chunks)
    return tuple(
        to_host(transform(xc))
        for xc in prefetch_to_device(rows, device=device, enabled=prefetch,
                                     measure=measure))


def chunked_rb_transform(x_chunks, params: rb.RBParams, *,
                         impl: str = "auto", device: DeviceLike = "cuda",
                         prefetch: bool = True,
                         measure: Optional[dict] = None
                         ) -> Tuple[torch.Tensor, ...]:
    """Alg. 1 over row chunks: the ELL indices of each chunk."""
    device = resolve_device(device)
    params = params.to(device)
    return chunked_transform(
        lambda xc: rb.rb_transform(xc, params, impl=impl), x_chunks,
        device=device, prefetch=prefetch, measure=measure)


def chunked_bin_counts(idx_chunks, *, d: int, d_g: int, impl: str = "auto",
                       device: DeviceLike = "cuda", prefetch: bool = True,
                       measure: Optional[dict] = None) -> torch.Tensor:
    """Global int32 bin occupancies Σ_c Z_cᵀ1, on ``device``: one
    ``ops.bin_counts`` launch per chunk, each adding into the same (D,)
    buffer. Exact for any chunking."""
    device = resolve_device(device)
    counts = torch.zeros((d,), dtype=torch.int32, device=device)
    for ic in prefetch_to_device(idx_chunks, device=device, enabled=prefetch,
                                 measure=measure):
        ops.bin_counts(ic, d=d, d_g=d_g, impl=impl, out=counts)
    return counts


def chunked_degrees(idx_chunks, *, d: int, d_g: int, impl: str = "auto",
                    device: DeviceLike = "cuda",
                    prefetch: bool = True) -> torch.Tensor:
    """Streaming two-pass degrees (Eq. 6), (N,) float32 on the host: the
    same bits for any chunking. Pass 1 adds integer bin counts; pass 2
    reduces each row against them, row-locally."""
    device = resolve_device(device)
    counts = chunked_bin_counts(idx_chunks, d=d, d_g=d_g, impl=impl,
                                device=device, prefetch=prefetch)
    return torch.cat([
        to_host(graph.degrees_from_counts(ic, counts))
        for ic in prefetch_to_device(idx_chunks, device=device,
                                     enabled=prefetch)])


def build_chunked_adjacency(idx_chunks, *, d: int, d_g: int,
                            impl: str = "auto", eps: float = 1e-8,
                            prefetch: bool = True, normalize: bool = True,
                            device: DeviceLike = "cuda") -> ChunkedELL:
    """Streaming counterpart of ``graph.build_normalized_adjacency``: the
    degree pass over host chunks. On the card it also builds each chunk's
    CSC copy for the zt sweeps."""
    dev = resolve_device(device)
    pin = dev.type == "cuda"
    idx_chunks = tuple(_pinned(_as_host(ic).contiguous(), pin)
                       for ic in idx_chunks)
    h2d_stats: dict = {}
    counts = chunked_bin_counts(idx_chunks, d=d, d_g=d_g, impl=impl,
                                device=dev, prefetch=prefetch,
                                measure=h2d_stats)
    r = idx_chunks[0].shape[1]
    deg_chunks, scale_chunks, csc_chunks = [], [], []
    for ic in prefetch_to_device(idx_chunks, device=dev, enabled=prefetch,
                                 measure=h2d_stats):
        deg_c = graph.degrees_from_counts(ic, counts)
        if normalize:
            scale = 1.0 / torch.sqrt(float(r) * torch.clamp_min(deg_c, eps))
        else:
            scale = torch.full_like(deg_c, graph._sqrt_r(r)[1])
        deg_chunks.append(to_host(deg_c))
        scale_chunks.append(to_host(scale))
        if pin:
            csc_chunks.append(_csc_to_host(ops.ell_csc(ic, d)))
    return ChunkedELL(
        idx_chunks, tuple(scale_chunks), d=d, d_g=d_g, impl=impl,
        deg=torch.cat(deg_chunks), prefetch=prefetch, h2d_stats=h2d_stats,
        counts=to_host(counts), csc_chunks=tuple(csc_chunks) if pin else None,
        device=dev)


# --------------------------------------------------------------------------
# Row-chunked products of device-resident operands (the JAX package's
# lax.scan forms): the mesh placement chunks within each row shard, so the
# kernels' temporaries are O(chunk · R) whatever the shard's size.
# --------------------------------------------------------------------------

def row_chunk_bounds(n: int, chunk_size: Optional[int]) -> list:
    """``(start, stop)`` of consecutive row chunks of ``chunk_size`` rows
    (one chunk of all ``n`` rows without one)."""
    c = n if chunk_size is None else max(1, min(int(chunk_size), n))
    return [(s, min(s + c, n)) for s in range(0, max(n, 1), max(c, 1))]


def chunked_zt_matmul(idx: torch.Tensor, u: torch.Tensor,
                      rowscale: torch.Tensor, *, d: int, d_g: int,
                      chunk_size: Optional[int], impl: str = "auto",
                      cscs: Optional[Sequence[ops.EllCSC]] = None
                      ) -> torch.Tensor:
    """q = Ẑᵀu, one ``ops.zt_matmul`` a row chunk added into one (D, K)
    accumulator in chunk order. ``cscs`` are the chunks' CSC copies
    (built once by the caller on the card; else each launch builds its
    own)."""
    q = torch.zeros((d, u.shape[1]), dtype=torch.float32, device=u.device)
    for j, (s, e) in enumerate(row_chunk_bounds(idx.shape[0], chunk_size)):
        q.add_(ops.zt_matmul(idx[s:e], u[s:e].contiguous(), rowscale[s:e],
                             d, d_g=d_g, impl=impl,
                             csc=None if cscs is None else cscs[j]))
    return q


def chunked_z_matmul(idx: torch.Tensor, v: torch.Tensor,
                     rowscale: torch.Tensor, *, d_g: int,
                     chunk_size: Optional[int],
                     impl: str = "auto") -> torch.Tensor:
    """y = Ẑv, one ``ops.z_matmul`` a row chunk; row-local, so each row
    has the bits of the unchunked product."""
    v = v.contiguous()
    return torch.cat([
        ops.z_matmul(idx[s:e], v, rowscale[s:e], d_g=d_g, impl=impl)
        for s, e in row_chunk_bounds(idx.shape[0], chunk_size)])


def chunked_gram_matvec(idx: torch.Tensor, u: torch.Tensor,
                        rowscale: torch.Tensor, *, d: int, d_g: int,
                        chunk_size: Optional[int], impl: str = "auto",
                        cscs: Optional[Sequence[ops.EllCSC]] = None
                        ) -> torch.Tensor:
    """(Ẑ Ẑᵀ)u over row chunks: the two products above."""
    q = chunked_zt_matmul(idx, u, rowscale, d=d, d_g=d_g,
                          chunk_size=chunk_size, impl=impl, cscs=cscs)
    return chunked_z_matmul(idx, q, rowscale, d_g=d_g,
                            chunk_size=chunk_size, impl=impl)
