"""Distributed SC_RB: the mesh placement's collectives and the SPMD entry
point, on ``torch.distributed``.

The placement layer under the executor (``core.executor``): the factories
here are the only place collectives appear, so the communication schedule
stays explicit — per eigensolver iteration exactly one all-reduce of the
(D, K) projected block:

  rows of X / Z.idx / U    → this rank's contiguous row shard (the one
                             ``P("data")`` gives in the JAX package)
  q = Ẑᵀ·u                 → local ``zt_matmul`` + ``all_reduce`` over the
                             data group
  y = Ẑ·q                  → purely local (q replicated after the reduce)
  degrees                  → local ``bin_counts`` + ``all_reduce`` of the
                             (D,) int32 counts, then local degrees
  k-means statistics       → local chunk sweep + one ``all_reduce`` a step

SPMD: every rank calls the entry point with the same global x and keeps
its shard; RB grids come from the seed, so every rank draws the same ones
with no communication. ``chunk_size`` chunks within each shard: the local
products and the k-means sweeps run over row chunks (``core.streaming``'s
``chunked_*`` loops), so the kernels' temporaries stay O(chunk).

``sc_rb_distributed`` is a wrapper over ``SCRBModel.fit`` with a
``placement="mesh"`` plan; the stages live in the executor and
``core.rowmatrix.MeshRows``. The JAX package's ``lower_clustering_cell``
(an AOT lowering for its roofline benchmark) is not ported.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import graph, streaming
from repro_torch.core.kmeans import KMeansResult, _plusplus_init
from repro_torch.kernels import ops
from repro_torch.launch.mesh import data_group, data_rank, data_shards
from repro_torch.utils import StageTimer, fold_seed, make_generator


def all_reduce_sum(t: torch.Tensor, group, *,
                   compress: bool = False) -> torch.Tensor:
    """Σ over the group's ranks of ``t``, on ``t``'s device; with
    ``compress`` the payload travels (and is added) in bfloat16 and comes
    back float32."""
    if compress:
        tb = t.to(torch.bfloat16)
        dist.all_reduce(tb, group=group)
        return tb.to(torch.float32)
    dist.all_reduce(t, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The row shards of equal height of the group's ranks, stacked in rank
    order: the global tall array on every rank."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def make_gram_matvec(mesh, idx: torch.Tensor, rowscale: torch.Tensor,
                     d: int, d_g: int, impl: str = "auto",
                     compress: bool = False,
                     chunk_size: Optional[int] = None,
                     cscs: Optional[Sequence[ops.EllCSC]] = None):
    """Row-sharded Â·u: local zt, ``all_reduce`` of q over the data group,
    local z. ``compress=True`` sends the (D, K) payload in bfloat16 (the
    local sums and the gather stay float32: only the reduction is rounded).
    ``chunk_size`` runs the local products over row chunks with one (D, K)
    accumulator; ``cscs`` are the chunks' CSC copies on the card."""
    group = data_group(mesh)

    def gram(u: torch.Tensor) -> torch.Tensor:
        q = streaming.chunked_zt_matmul(idx, u, rowscale, d=d, d_g=d_g,
                                        chunk_size=chunk_size, impl=impl,
                                        cscs=cscs)
        q = all_reduce_sum(q, group, compress=compress)   # THE collective
        return streaming.chunked_z_matmul(idx, q, rowscale, d_g=d_g,
                                          chunk_size=chunk_size, impl=impl)

    return gram


def make_degree_pass(mesh, idx: torch.Tensor, d: int, d_g: int,
                     impl: str = "auto", chunk_size: Optional[int] = None):
    """The Eq. 6 degree pass: local int32 ``bin_counts`` (a launch a row
    chunk, adding into one (D,) buffer), an ``all_reduce`` of the counts —
    integers, so exact and the same on every rank whatever the shards —
    then each row's degree locally (``graph.degrees_from_counts``, the bits
    of the single placement's streaming pass). Returns a function giving
    (degrees of this shard (n_local,), replicated counts (D,) int32)."""
    group = data_group(mesh)

    def degpass() -> Tuple[torch.Tensor, torch.Tensor]:
        bounds = streaming.row_chunk_bounds(idx.shape[0], chunk_size)
        counts = torch.zeros((d,), dtype=torch.int32, device=idx.device)
        for s, e in bounds:
            ops.bin_counts(idx[s:e], d=d, d_g=d_g, impl=impl, out=counts)
        dist.all_reduce(counts, group=group)
        deg = torch.cat([graph.degrees_from_counts(idx[s:e], counts)
                         for s, e in bounds])
        return deg, counts

    return degpass


def make_zt_matvec(mesh, idx: torch.Tensor, rowscale: torch.Tensor,
                   d: int, d_g: int, impl: str = "auto",
                   chunk_size: Optional[int] = None,
                   cscs: Optional[Sequence[ops.EllCSC]] = None):
    """Row-sharded Ẑᵀ·u → replicated (D, K): local zt + ``all_reduce``."""
    group = data_group(mesh)

    def zt(u: torch.Tensor) -> torch.Tensor:
        q = streaming.chunked_zt_matmul(idx, u, rowscale, d=d, d_g=d_g,
                                        chunk_size=chunk_size, impl=impl,
                                        cscs=cscs)
        return all_reduce_sum(q, group)

    return zt


def make_sharded_reduce(mesh, fn: Callable, *,
                        chunk_size: Optional[int] = None):
    """``RowMatrix.reduce`` on a mesh: ``acc = fn(acc, *chunks)`` over the
    row chunks of this rank's shard, in order, then an ``all_reduce`` of
    each tensor of the accumulator. ``fn`` must be additive with ``init``
    its identity (zeros)."""
    group = data_group(mesh)

    def run(init, *tall):
        acc = init
        for s, e in streaming.row_chunk_bounds(tall[0].shape[0], chunk_size):
            acc = fn(acc, *(t[s:e] for t in tall))
        leaves = acc if isinstance(acc, (tuple, list)) else (acc,)
        for leaf in leaves:
            dist.all_reduce(leaf, group=group)
        return acc

    return run


def distributed_kmeans(
    seed: int,
    u: torch.Tensor,
    k: int,
    mesh,
    *,
    n: int,
    n_iters: int = 25,
    n_replicates: int = 10,
    impl: str = "auto",
    chunk_size: Optional[int] = None,
) -> Tuple[KMeansResult, dict]:
    """Lloyd k-means over a row-sharded embedding, consumed in row chunks
    of this rank's shard ``u`` (n_local, dim) of the global (``n``, dim).

      1. Seeding: a pool of ``min(n, max(4k, 64))`` rows is gathered by
         global index (each rank fills the rows it owns, one
         ``all_reduce`` of the zero-filled pool: the only gather of
         embedding rows); k-means++ runs on the pool once per replicate
         (the same draws on every rank).
      2. Updates: Lloyd steps for all replicates at once, their centroids
         one (r, K, dim) tensor. A step sweeps the shard's chunks with
         ``ops.kmeans_assign_stats`` for every replicate and sends the
         (r, K) counts, (r, K, dim) sums and (r,) inertia in one
         ``all_reduce``.
      3. The best replicate's assignment is local (``ops.kmeans_assign``
         a chunk); only the int32 labels are ``all_gather``ed.

    Returns the result (centroids on the device, the global (n,) labels on
    the CPU) and the residency diagnostics of the JAX package."""
    group = data_group(mesh)
    shards = data_shards(mesh)
    if n % shards:
        raise ValueError(
            f"distributed k-means needs N divisible by the data shards: "
            f"N={n}, shards={shards}")
    if k > n:
        raise ValueError(f"k={k} exceeds row count n={n}")
    shard_rows = n // shards
    lo = data_rank(mesh) * shard_rows
    dev, dim = u.device, u.shape[1]
    u = u.to(torch.float32).contiguous()
    bounds = streaming.row_chunk_bounds(u.shape[0], chunk_size)
    rows_seen = max(e - s for s, e in bounds)

    pool_size = min(n, max(4 * k, 64))
    pool_idx = torch.randperm(n, generator=make_generator(
        fold_seed(seed, "pool")))[:pool_size]
    mine = (pool_idx >= lo) & (pool_idx < lo + u.shape[0])
    pool = torch.zeros((pool_size, dim), dtype=torch.float32, device=dev)
    pool[mine.to(dev)] = u[(pool_idx[mine] - lo).to(dev)]
    pool = all_reduce_sum(pool, group)                  # 0 + x is exact
    gen = make_generator(seed, dev)
    cents = torch.stack([_plusplus_init(gen, pool, k)
                         for _ in range(n_replicates)])

    def stats(cents_r: torch.Tensor) -> torch.Tensor:
        """[(r, K) counts | (r, K, dim) sums | (r,) inertia], summed over
        the group: one payload, one collective."""
        r = cents_r.shape[0]
        counts = torch.zeros((r, k), dtype=torch.float32, device=dev)
        sums = torch.zeros((r, k, dim), dtype=torch.float32, device=dev)
        inertia = torch.zeros((r,), dtype=torch.float32, device=dev)
        for s, e in bounds:
            uc = u[s:e]
            for rep in range(r):
                _, cnt, sm, iner = ops.kmeans_assign_stats(
                    uc, cents_r[rep].contiguous(), impl=impl)
                counts[rep] += cnt
                sums[rep] += sm
                inertia[rep] += iner
        flat = torch.cat([counts.reshape(-1), sums.reshape(-1), inertia])
        return all_reduce_sum(flat, group)

    def unpack(flat: torch.Tensor, r: int):
        counts = flat[:r * k].reshape(r, k)
        sums = flat[r * k:r * k * (dim + 1)].reshape(r, k, dim)
        return counts, sums, flat[r * k * (dim + 1):]

    r = cents.shape[0]
    for _ in range(n_iters):
        counts, sums, _ = unpack(stats(cents), r)
        new = sums / torch.clamp_min(counts, 1.0)[..., None]
        # keep the previous centroid for empty clusters
        cents = torch.where((counts > 0)[..., None], new, cents)
    _, _, inertia = unpack(stats(cents), r)
    best = int(torch.argmin(inertia))
    best_cents = cents[best].contiguous()
    local = torch.cat([ops.kmeans_assign(u[s:e], best_cents, impl=impl)[0]
                       for s, e in bounds])
    labels = all_gather_rows(local, group).cpu()
    diag = {
        # the tallest row block that reached the assignment kernels: the
        # chunk, unless an O(N/shards) sweep creeps back in
        "kmeans_chunk_rows": rows_seen,
        "kmeans_shard_rows": shard_rows,
        "kmeans_pool_rows": pool_size,
        "kmeans_replicates_batched": n_replicates,
        # per-device live set of one assignment step: the (rows, dim) row
        # block and its (rows, K) distances
        "kmeans_device_bytes_peak": rows_seen * (dim + k) * 4,
        "kmeans_single_shard_bytes": shard_rows * (dim + k) * 4,
    }
    return KMeansResult(best_cents, labels, inertia[best]), diag


def sc_rb_distributed(x, config, mesh, *, device="cuda"
                      ) -> Tuple[np.ndarray, StageTimer]:
    """Algorithm 2 on a mesh; returns (labels, stage timer). Every rank
    calls it with the same x and gets the global labels. A thin wrapper
    over ``SCRBModel.fit`` with a ``placement="mesh"`` plan;
    ``config.chunk_size`` turns on within-shard chunking."""
    from repro_torch.core.model import SCRBModel
    model = SCRBModel.fit(x, config, mesh=mesh, keep_embedding=False,
                          device=device)
    return model.fit_result.labels, model.fit_result.timer
