"""Lloyd k-means with k-means++ seeding and replicates (Alg. 2 step 5).

Matches the paper's protocol (Matlab kmeans, 10 replicates): best-of-r
restarts by inertia. A Lloyd step takes its cluster counts and sums from
``ops.kmeans_assign_stats``, as the JAX step takes them from its
``segment_sum``s: on the card one launch of the hand-written
``kmeans_assign`` kernel with its statistics epilogue, with no host sync.
The last assignment of a replicate is ``ops.kmeans_assign``.

The centroid update is deterministic: the kernel adds the sums in a fixed
order with no float atomics (``index_add_``/``scatter_add_`` on CUDA use
them), and on the CPU the plain version takes ``bincount`` and a one-hot
(N, K)ᵀ·x product; so two fits on the same data give the same labels.

The host-chunked fit's k-means is ``streaming_kmeans``, as in the JAX
package: a reservoir sample of the chunks seeds k-means++, Sculley
mini-batch steps take one uploaded chunk at a time (``_minibatch_update``
on ``ops.kmeans_assign_stats``), and a last chunked sweep assigns every
row. ``minibatch_kmeans`` is the same update on a device-resident x.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.utils import (
    DeviceLike, prefetch_to_device, resolve_device, to_host,
)


class KMeansResult(NamedTuple):
    centroids: torch.Tensor  # (k, d)
    labels: torch.Tensor     # (n,) int32
    inertia: torch.Tensor    # scalar


def _plusplus_init(generator: torch.Generator, x: torch.Tensor,
                   k: int) -> torch.Tensor:
    """k-means++ seeding (D² weighting); draws from ``generator``, which
    lies on ``x``'s device."""
    n = x.shape[0]
    first = torch.randint(0, n, (1,), generator=generator,
                          device=generator.device).to(x.device)
    cents = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    c = x[first]                                             # (1, d)
    cents[0] = c[0]
    mindist = torch.sum((x - c) ** 2, dim=-1)
    for i in range(1, k):
        pick = torch.multinomial(torch.clamp_min(mindist, 1e-30), 1,
                                 generator=generator)
        c = x[pick]
        cents[i] = c[0]
        mindist = torch.minimum(mindist, torch.sum((x - c) ** 2, dim=-1))
    return cents


def _lloyd(x: torch.Tensor, cents: torch.Tensor, n_iters: int,
           impl: str = "auto") -> KMeansResult:
    cents = cents.to(x.dtype).contiguous()
    for _ in range(n_iters):
        _, counts, sums, _ = ops.kmeans_assign_stats(x, cents, impl=impl)
        new = sums / torch.clamp_min(counts, 1.0)[:, None]
        # keep the previous centroid for empty clusters
        cents = torch.where((counts > 0)[:, None], new, cents).contiguous()
    labels, dists = ops.kmeans_assign(x, cents, impl=impl)
    return KMeansResult(cents, labels, torch.sum(dists))


def kmeans(
    generator: torch.Generator,
    x: torch.Tensor,
    k: int,
    *,
    n_iters: int = 25,
    n_replicates: int = 10,
    impl: str = "auto",
    init: Optional[torch.Tensor] = None,
) -> KMeansResult:
    """Best-of-``n_replicates`` Lloyd runs with k-means++ seeding.

    ``init`` injects the replicates' seed centroids, a (n_replicates, k, d)
    stack, instead of drawing them. Replicates run one after another; the
    first of equal inertia wins."""
    x = x.to(torch.float32).contiguous()
    if init is not None:
        init = _init_stack(init, k, x.shape[1], x.device)
        n_replicates = init.shape[0]
    best = None
    for rep in range(n_replicates):
        cents0 = init[rep] if init is not None \
            else _plusplus_init(generator, x, k)
        res = _lloyd(x, cents0, n_iters, impl)
        if best is None or float(res.inertia) < float(best.inertia):
            best = res
    return best


def row_normalize(u: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize each spectral-embedding row to unit ℓ₂ norm (Alg. 2
    step 4)."""
    norms = torch.linalg.vector_norm(u, dim=1, keepdim=True)
    return u / torch.clamp_min(norms, eps)


def _init_stack(init, k: int, dim: int, device) -> torch.Tensor:
    """Injected seed centroids as a (replicates, k, dim) float32 stack."""
    init = torch.as_tensor(init, dtype=torch.float32, device=device)
    if init.dim() != 3 or init.shape[1:] != (k, dim):
        raise ValueError(f"init must be (r, {k}, {dim}), got "
                         f"{tuple(init.shape)}")
    return init


def _minibatch_update(xb: torch.Tensor, cents: torch.Tensor,
                      counts: torch.Tensor, *, impl: str = "auto"):
    """One Sculley step from a batch: per-center 1/count learning rates,
    from ``ops.kmeans_assign_stats``' counts and sums."""
    _, add, sums, _ = ops.kmeans_assign_stats(xb, cents, impl=impl)
    counts_new = counts + add
    lr = add / torch.clamp_min(counts_new, 1.0)
    target = sums / torch.clamp_min(add, 1.0)[:, None]
    cents = torch.where((add > 0)[:, None],
                        cents + lr[:, None] * (target - cents), cents)
    return cents.contiguous(), counts_new


def minibatch_kmeans(
    generator: torch.Generator,
    x: torch.Tensor,
    k: int,
    *,
    batch_size: int = 4_096,
    n_steps: int = 100,
    impl: str = "auto",
) -> KMeansResult:
    """Mini-batch k-means (Sculley 2010) on a device-resident x: k-means++
    on a sample of max(4k, 64) rows, then ``n_steps`` steps of
    ``batch_size`` rows drawn with replacement from ``generator`` (on x's
    device)."""
    x = x.to(torch.float32).contiguous()
    n = x.shape[0]
    pool = min(n, max(4 * k, 64))
    sel = torch.randperm(n, generator=generator,
                         device=generator.device)[:pool].to(x.device)
    cents = _plusplus_init(generator, x[sel].contiguous(), k)
    counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
    for _ in range(n_steps):
        rows = torch.randint(0, n, (batch_size,), generator=generator,
                             device=generator.device).to(x.device)
        cents, counts = _minibatch_update(x[rows].contiguous(), cents,
                                          counts, impl=impl)
    labels, dists = ops.kmeans_assign(x, cents, impl=impl)
    return KMeansResult(cents, labels, torch.sum(dists))


# --------------------------------------------------------------------------
# Out-of-core k-means over host row chunks (the streaming fit's stages 4-5)
# --------------------------------------------------------------------------

def _as_chunk_list(chunks) -> list[torch.Tensor]:
    """Host float32 chunks of a ``ChunkedDense`` or a sequence of arrays."""
    if hasattr(chunks, "chunks"):                # streaming.ChunkedDense
        chunks = chunks.chunks
    return [c.to(torch.float32) if isinstance(c, torch.Tensor)
            else torch.from_numpy(np.asarray(c, np.float32)) for c in chunks]


def row_normalize_chunks(chunks, *, device: DeviceLike = "cuda",
                         prefetch: bool = True,
                         measure: Optional[dict] = None):
    """Chunked Alg. 2 step 4: unit-ℓ₂ rows, one chunk on the device at a
    time. Row-local: the same bits as ``row_normalize`` on each chunk."""
    device = resolve_device(device)
    from repro_torch.core.streaming import ChunkedDense
    return ChunkedDense(tuple(
        to_host(row_normalize(c))
        for c in prefetch_to_device(_as_chunk_list(chunks), device=device,
                                    enabled=prefetch, measure=measure)))


def _reservoir_sample_chunks(chunks: Sequence, pool_size: int,
                             rng: np.random.Generator) -> np.ndarray:
    """Uniform reservoir (Algorithm R) over streamed row chunks: one pass,
    O(pool_size) host memory; the JAX package's draws from the same
    ``rng``."""
    chunks = [c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c)
              for c in chunks]
    dim = chunks[0].shape[1]
    pool = np.empty((pool_size, dim), np.float32)
    seen = 0
    for c in chunks:
        rows = c.shape[0]
        gidx = seen + np.arange(rows)
        head = gidx < pool_size                  # fill phase
        pool[gidx[head]] = c[head]
        tail = ~head
        if np.any(tail):
            draws = rng.integers(0, gidx[tail] + 1)
            replace = draws < pool_size
            # later rows overwrite earlier ones on collision, as in the
            # sequential algorithm (numpy keeps the last write)
            pool[draws[replace]] = c[tail][replace]
        seen += rows
    return pool


def streaming_kmeans(
    generator: Optional[torch.Generator],
    chunks,
    k: int,
    *,
    n_steps: int = 100,
    n_replicates: int = 4,
    impl: str = "auto",
    prefetch: bool = True,
    measure: Optional[dict] = None,
    device: DeviceLike = "cuda",
    init: Optional[torch.Tensor] = None,
) -> KMeansResult:
    """k-means over host row chunks, with no O(N) device array.

      1. Seeding: a uniform reservoir sample of max(4k, 64) rows (one
         streamed pass, numpy's generator seeded from ``generator``, which
         lies on ``device``) stands in for the data; k-means++ runs on it
         once per replicate. ``init`` injects the replicates' seeds
         instead, a (replicates, k, dim) stack.
      2. Updates: ``n_steps`` Sculley steps, one per uploaded chunk, in
         chunk order, cycling; every replicate takes each chunk.
      3. A last chunked sweep assigns every row for every replicate
         (``ops.kmeans_assign``), adds up each one's inertia and keeps its
         labels on the host; the best replicate's are returned (labels a
         CPU tensor).

    Device residency: one chunk (two in flight) and the centroids."""
    dev = resolve_device(device)
    chunk_list = _as_chunk_list(chunks)
    n = sum(c.shape[0] for c in chunk_list)
    dim = chunk_list[0].shape[1]
    if k > n:
        raise ValueError(f"k={k} exceeds row count n={n}")
    if init is not None:
        stack = _init_stack(init, k, dim, dev)
        cents = [stack[i].contiguous() for i in range(stack.shape[0])]
    else:
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                 device=generator.device))
        rng = np.random.default_rng(seed)
        pool_size = min(n, max(4 * k, 64))
        pool = torch.as_tensor(
            _reservoir_sample_chunks(chunk_list, pool_size, rng), device=dev)
        cents = [_plusplus_init(generator, pool, k)
                 for _ in range(n_replicates)]
    counts = [torch.zeros((k,), dtype=torch.float32, device=dev)
              for _ in cents]
    step = 0
    while step < n_steps:
        for xb in prefetch_to_device(chunk_list, device=dev, enabled=prefetch,
                                     measure=measure):
            if step >= n_steps:
                break
            for rep in range(len(cents)):
                cents[rep], counts[rep] = _minibatch_update(
                    xb, cents[rep], counts[rep], impl=impl)
            step += 1

    inertia = np.zeros((len(cents),))
    label_chunks: list = [[] for _ in cents]
    for xb in prefetch_to_device(chunk_list, device=dev, enabled=prefetch,
                                 measure=measure):
        for rep, c in enumerate(cents):
            labels_c, dists = ops.kmeans_assign(xb, c, impl=impl)
            inertia[rep] += float(torch.sum(dists))
            label_chunks[rep].append(to_host(labels_c))
    best = int(np.argmin(inertia))
    return KMeansResult(cents[best], torch.cat(label_chunks[best]),
                        torch.tensor(inertia[best], dtype=torch.float32))
