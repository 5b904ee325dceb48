"""Lloyd k-means with k-means++ seeding and replicates (Alg. 2 step 5).

Matches the paper's protocol (Matlab kmeans, 10 replicates): best-of-r
restarts by inertia. The assignment step is the hand-written
``kmeans_assign`` kernel on the card.

The centroid update is deterministic: integer counts come from
``bincount`` and the float sums from a one-hot (N, K)ᵀ·x product, never
from float atomics (``index_add_``/``scatter_add_`` on CUDA are), so two
fits on the same data give the same labels.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


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
    k = cents.shape[0]
    cents = cents.to(x.dtype).contiguous()
    for _ in range(n_iters):
        labels, _ = ops.kmeans_assign(x, cents, impl=impl)
        counts = torch.bincount(labels, minlength=k).to(x.dtype)
        onehot = F.one_hot(labels.long(), k).to(x.dtype)      # (N, k)
        new = (onehot.T @ x) / torch.clamp_min(counts, 1.0)[:, None]
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
        init = torch.as_tensor(init, dtype=torch.float32, device=x.device)
        if init.dim() != 3 or init.shape[1:] != (k, x.shape[1]):
            raise ValueError(f"init must be (r, {k}, {x.shape[1]}), got "
                             f"{tuple(init.shape)}")
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
