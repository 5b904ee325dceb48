"""Compressive spectral clustering — the ``solver="compressive"`` plan cell.

The JAX package's ``core.compressive`` in PyTorch. Every eigensolver
iterates a dense (N, K + buffer) block; compressive SC (Tremblay, Puy,
Gribonval & Vandergheynst, ICML 2016) needs none:

  1. **λ_K estimation by eigencount dichotomy** — one Chebyshev moment
     sweep against a small Rademacher probe block prices the Jackson-damped
     eigencount ``tr h_t(Â)`` at every threshold t (a dot product of damped
     step coefficients with the cached moments), so the dichotomy locating
     λ_K / λ_{K+1} is host arithmetic.
  2. **Jackson–Chebyshev filtering** — d = O(log K) random signals are
     pushed through h(Â) ≈ the spectral projector onto span(U_K). Each
     recurrence step is one Gram product ``(ẐẐᵀ)u``: the fused Gram kernel
     on device rows, a zt sweep then a z sweep on host chunks.
  3. **Random-subset k-means** — centroids from an O(n_sub · d) row sample
     of the row-normalized filtered signals (``kmeans.kmeans``), then one
     nearest-centroid sweep (``ops.kmeans_assign``) labels every row.
  4. **Out-of-sample factorization** — the filtered block is re-expressed
     through the feature space as E = Ẑ q with q = Ẑᵀ h(Â) R (a (D, d)
     matrix), so ``SCRBModel``'s serving path reproduces the fit
     embedding: ``predict`` on training rows returns the fit labels.

The working set is the d-wide tall block in the representation's own type
(a device tensor, or ``streaming.ChunkedDense`` host chunks). Requires
``laplacian_normalize=True``: the filter maps spec(Â) ⊂ [0, 1] onto
[-1, 1] via y = 2λ − 1.

The random draws (probe block, signal block, subset rows, k-means seeds)
come from generators seeded by ``fold_seed``; ``compressive_embed`` and
``subset_cluster`` take them as keywords too, so a test can hand both
packages the same draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import eigensolver, streaming
from repro_torch.core.kmeans import KMeansResult, kmeans as _kmeans
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace
from repro_torch.utils import fold_seed, make_generator

SOLVER_NAME = "compressive"

COUNT_DEGREE = 40    # Chebyshev degree of the eigencount moment sweep
# Rademacher probes behind the trace estimates: the Hutchinson error on
# the small plateau counts (≈ K) is shared across thresholds for a given
# probe draw, so the lever against a mis-bracketed λ_K is the probe count
COUNT_PROBES = 32

# feature-space round trips after the filter (q, E, and the Ritz/residual
# Grams), charged to the reported iteration count as Gram-equivalents
_PROJECTION_SWEEPS = 3


# ---------------------------------------------------------------------------
# Jackson-damped Chebyshev step filters (host numpy)
# ---------------------------------------------------------------------------

def jackson_damping(degree: int) -> np.ndarray:
    """Jackson smoothing factors g_0..g_degree (g_0 = 1, g_degree ≈ 0): the
    damping that turns the truncated Chebyshev step into a monotone
    transition with no Gibbs overshoot (Weiße et al., KPM)."""
    mp1 = degree + 1
    j = np.arange(degree + 1, dtype=np.float64)
    alpha = np.pi / mp1
    return ((mp1 - j) * np.cos(j * alpha)
            + np.sin(j * alpha) / np.tan(alpha)) / mp1


def step_coeffs(cutoff: float, degree: int, *, damped: bool = True
                ) -> np.ndarray:
    """Chebyshev coefficients of the spectral step ``1{λ ≥ cutoff}`` for
    λ ∈ [0, 1], expanded in T_j(y) with y = 2λ − 1 (Jackson-damped by
    default)."""
    a = float(np.clip(2.0 * cutoff - 1.0, -1.0, 1.0))
    th = float(np.arccos(a))
    j = np.arange(1, degree + 1, dtype=np.float64)
    c = np.empty(degree + 1, np.float64)
    c[0] = th / np.pi
    c[1:] = 2.0 * np.sin(j * th) / (np.pi * j)
    if damped:
        c = c * jackson_damping(degree)
    return c


def step_eval(coeffs: np.ndarray, lam) -> np.ndarray:
    """The filter's scalar response h(λ)."""
    y = 2.0 * np.asarray(lam, np.float64) - 1.0
    return np.polynomial.chebyshev.chebval(y, coeffs)


# ---------------------------------------------------------------------------
# tall-block algebra on device tensors and on host chunks
# ---------------------------------------------------------------------------

def _tall_scale(a: float, x):
    if isinstance(x, streaming.ChunkedDense):
        return streaming.ChunkedDense(tuple(a * c for c in x.chunks))
    return a * x


def _tall_axpby(a: float, x, b: float, y):
    """a·x + b·y on tall operands (host chunks stay on the host)."""
    if isinstance(x, streaming.ChunkedDense):
        return streaming.ChunkedDense(tuple(
            a * cx + b * cy for cx, cy in zip(x.chunks, y.chunks)))
    return a * x + b * y


def _tall_inner(z, x, y) -> float:
    """Σ_ij x_ij·y_ij over the whole tall block: host float64 over chunks,
    one float32 dot product (read to the host) on the device; under a mesh
    the rank's own dot product summed over the ranks (``z.reduce``), so
    every rank reads the same value."""
    if isinstance(x, streaming.ChunkedDense):
        return float(sum(float(torch.dot(cx.reshape(-1).double(),
                                         cy.reshape(-1).double()))
                         for cx, cy in zip(x.chunks, y.chunks)))
    if z.kind == "mesh":
        return float(z.reduce(
            lambda acc, a, b: acc + torch.dot(a.reshape(-1), b.reshape(-1)),
            torch.zeros((), dtype=torch.float32, device=x.device), x, y))
    return float(torch.dot(x.reshape(-1), y.reshape(-1)))


# ---------------------------------------------------------------------------
# the Chebyshev recurrence (shared by the moment sweep and the filter)
# ---------------------------------------------------------------------------

def chebyshev_sweep(z, r, degree: int, *, coeffs: Optional[np.ndarray] = None,
                    moments: bool = False):
    """Three-term recurrence of T_j(2Â − I) against a tall block, driven by
    the representation's Gram product ``z.gram``.

    Returns ``(filtered, mu, matvecs)``: ``filtered = Σ_j coeffs[j]·T_j r``
    when ``coeffs`` is given, ``mu[j] = ⟨r, T_j r⟩`` (summed over probe
    columns) when ``moments``. Exactly ``degree`` Gram products; the only
    live state is three tall blocks whatever the degree. In moments mode
    each step reads one scalar to the host, as the JAX package does."""
    acc = _tall_scale(float(coeffs[0]), r) if coeffs is not None else None
    mu = np.zeros(degree + 1, np.float64) if moments else None
    if moments:
        mu[0] = _tall_inner(z, r, r)
    if degree == 0:
        return acc, mu, 0
    t_prev, t_cur = r, _tall_axpby(2.0, z.gram(r), -1.0, r)   # T_0 r, T_1 r
    nmv = 1
    for j in range(1, degree + 1):
        if coeffs is not None:
            acc = _tall_axpby(1.0, acc, float(coeffs[j]), t_cur)
        if moments:
            mu[j] = _tall_inner(z, r, t_cur)
        if j < degree:
            # T_{j+1} = 2(2Â − I)T_j − T_{j-1}
            nxt = _tall_axpby(4.0, z.gram(t_cur), -2.0, t_cur)
            t_prev, t_cur = t_cur, _tall_axpby(1.0, nxt, -1.0, t_prev)
            nmv += 1
    return acc, mu, nmv


# ---------------------------------------------------------------------------
# λ_K estimation — eigencount dichotomy over cached moments
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LambdaEstimate:
    lambda_k: float        # smoothed-count crossing of K − 1/2 (≈ λ_K)
    lambda_k1: float       # smoothed-count crossing of K + 1/2 (≈ λ_{K+1})
    cutoff: float          # mid-gap filter threshold
    moments: np.ndarray    # (degree+1,) raw probe moments ⟨r, T_j r⟩
    probes: int
    degree: int


def eigencount(moments: np.ndarray, probes: int, cutoff: float) -> float:
    """Jackson-damped estimate of #{λ_i(Â) ≥ cutoff} from cached moments."""
    c = step_coeffs(cutoff, len(moments) - 1)
    return float(c @ moments) / probes


def _bisect_count(moments, probes, target: float, *, iters: int = 48) -> float:
    """Largest threshold whose smoothed eigencount still reaches ``target``
    (the count is decreasing in the threshold)."""
    lo, hi = 0.0, 1.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if eigencount(moments, probes, mid) >= target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _as_tall(z, block):
    """An injected (N, w) array or tensor in ``z``'s tall type: host chunks
    aligned with a host-chunked ``z``, this rank's rows under a mesh, else
    a float32 tensor on ``z``'s device."""
    if z.kind == "host_chunked":
        return streaming.ChunkedDense.from_array(block, z.store.chunk_sizes)
    if z.kind == "mesh":
        block = torch.as_tensor(block)[z.rows]
    return torch.as_tensor(block, dtype=torch.float32, device=z.device)


def estimate_lambda_k(z, k: int, seed: int, *, probes: int = COUNT_PROBES,
                      degree: int = COUNT_DEGREE, probe_block=None
                      ) -> Tuple[LambdaEstimate, int]:
    """λ_K / λ_{K+1} by eigencount dichotomy using polynomial-filter traces.

    One moment sweep (``degree`` Gram products against a ``probes``-wide
    Rademacher block, drawn from ``seed`` or given as ``probe_block``)
    prices every threshold: the damped step is ≈ 1/2 at its own cutoff, so
    the smoothed count crosses K − 1/2 near λ_K and K + 1/2 near λ_{K+1};
    the filter cutoff is their midpoint."""
    if probe_block is None:
        r = z.random_tall(make_generator(seed), probes, dist="rademacher")
    else:
        r, probes = _as_tall(z, probe_block), int(probe_block.shape[1])
    _, mu, nmv = chebyshev_sweep(z, r, degree, moments=True)
    lam_k = _bisect_count(mu, probes, k - 0.5)
    lam_k1 = _bisect_count(mu, probes, k + 0.5)
    est = LambdaEstimate(lambda_k=lam_k, lambda_k1=lam_k1,
                         cutoff=0.5 * (lam_k + lam_k1), moments=mu,
                         probes=probes, degree=degree)
    return est, nmv


def default_filter_degree(est: LambdaEstimate) -> int:
    """Filter degree from the estimated spectral gap: the Jackson
    transition width is O(1/m) in λ-units, so m ≈ 3/gap puts the
    pass-to-stop transition inside the gap (clamped to [24, 96])."""
    gap = max(est.lambda_k - est.lambda_k1, 1e-3)
    return int(np.clip(np.ceil(3.0 / gap), 24, 96))


def default_signals(k: int) -> int:
    """d = O(log K) filtered random signals."""
    return int(max(4, np.ceil(4.0 * np.log2(k + 1))))


def default_subset(n: int, k: int) -> int:
    """Rows sampled for the compressive k-means: O(K log K), capped at N."""
    return int(min(n, max(64, 32 * k * max(1, int(np.ceil(np.log2(k + 1)))))))


# ---------------------------------------------------------------------------
# the embedding: filter d signals, factor through the feature space
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompressiveEmbedding:
    embedding: Any          # tall (N, d) = Ẑ q, before row normalization
    proj: torch.Tensor      # (D, d) q = Ẑᵀ h(Â) R on the fit's device
    theta: np.ndarray       # (d,) Ritz values of Â on span(embedding), desc
    resnorms: np.ndarray    # (d,) ‖Â v − θ v‖ of the unit Ritz vectors
    iterations: int         # Gram products consumed (count + filter + proj)
    estimate: LambdaEstimate
    filter_degree: int
    signals: int


def compressive_embed(z, k: int, seed: int, cfg, *,
                      laplacian_normalize: bool = True, probe_block=None,
                      signal_block=None) -> CompressiveEmbedding:
    """Observability wrapper over :func:`_compressive_embed_impl`: the solve
    runs under an ``eigensolve`` span (``solver="compressive"``) and feeds
    the iterative solvers' series (``eigensolver.record_solve``)."""
    with obs_trace.span("eigensolve", solver="compressive", n=z.n,
                        k=k) as sp:
        out = _compressive_embed_impl(
            z, k, seed, cfg, laplacian_normalize=laplacian_normalize,
            probe_block=probe_block, signal_block=signal_block)
        res = np.asarray(out.resnorms[:k])
        resnorm_max = float(res.max()) if res.size else 0.0
        sp.set(iterations=int(out.iterations), resnorm_max=resnorm_max,
               filter_degree=out.filter_degree, signals=out.signals)
    eigensolver.record_solve(SOLVER_NAME, int(out.iterations), resnorm_max)
    return out


def _compressive_embed_impl(z, k: int, seed: int, cfg, *,
                            laplacian_normalize: bool = True,
                            probe_block=None, signal_block=None
                            ) -> CompressiveEmbedding:
    """The eigendecomposition-free spectral embedding (steps 1–2 and 4 of
    the module docstring); :func:`subset_cluster` is step 3.

    ``cfg.compressive_options``: ``probes`` / ``degree`` / ``signals``
    (None → gap- and K-derived defaults) and ``lambdas`` (a known
    (λ_K, λ_{K+1}) bracket, which skips the eigencount sweep). The probe
    and signal blocks are drawn from ``fold_seed(seed, "count")`` and
    ``fold_seed(seed, "signals")`` unless given."""
    if not laplacian_normalize:
        raise ValueError(
            "solver='compressive' requires laplacian_normalize=True: the "
            "Chebyshev filter maps spec(Â) onto [-1, 1] via y = 2λ - 1, "
            "which needs the degree normalization's λ ∈ [0, 1]")
    co = cfg.compressive_options
    if co.lambdas is not None:
        # a caller-supplied (λ_K, λ_{K+1}) bracket replaces the sweep
        lam_k, lam_k1 = (float(v) for v in co.lambdas)
        est = LambdaEstimate(
            lambda_k=lam_k, lambda_k1=lam_k1,
            cutoff=0.5 * (lam_k + lam_k1), moments=None, probes=0, degree=0)
        nmv_count = 0
    else:
        est, nmv_count = estimate_lambda_k(
            z, k, fold_seed(seed, "count"), probes=co.probes,
            probe_block=probe_block)
    degree = co.degree or default_filter_degree(est)
    if signal_block is None:
        d = min(co.signals or default_signals(k), z.n)
        r = z.random_tall(make_generator(fold_seed(seed, "signals")), d)
    else:
        r, d = _as_tall(z, signal_block), int(signal_block.shape[1])
    coeffs = step_coeffs(est.cutoff, degree)
    s, _, nmv_filter = chebyshev_sweep(z, r, degree, coeffs=coeffs)
    # factor the filtered block through the feature space: q = Ẑᵀ h(Â)R is
    # the (D, d) out-of-sample projection, E = Ẑ q the in-sample embedding
    q = z.rmatvec(s)
    e = z.matvec_tall(q)
    # Rayleigh–Ritz diagnostics from feature-space Grams, in host float64:
    # with qe = ẐᵀE, EᵀE = qᵀqe, EᵀÂE = qeᵀqe, and ‖ÂE·‖² needs qee = ẐᵀẐqe
    qe_t = z.rmatvec(e)
    qee = z.rmatvec(z.matvec_tall(qe_t)).cpu().numpy().astype(np.float64)
    qe = qe_t.cpu().numpy().astype(np.float64)
    gram_m = q.cpu().numpy().astype(np.float64).T @ qe
    gram_a = qe.T @ qe
    gram_h2 = 0.5 * (qe.T @ qee + qee.T @ qe)
    theta, cvec = eigensolver._whitened_rayleigh_ritz_grams_np(
        gram_m, gram_a, min(d, gram_m.shape[0]))
    # residuals of the unit Ritz vectors v_i = E c_i (cᵀ(EᵀE)c = 1):
    # r_i² = cᵢᵀH₂cᵢ − 2θᵢ·cᵢᵀAcᵢ + θᵢ²
    r2 = (np.einsum("ji,jk,ki->i", cvec, gram_h2, cvec)
          - 2.0 * theta * np.einsum("ji,jk,ki->i", cvec, gram_a, cvec)
          + theta ** 2)
    resnorms = np.sqrt(np.maximum(r2, 0.0)).astype(np.float32)
    return CompressiveEmbedding(
        embedding=e, proj=q, theta=np.asarray(theta, np.float32),
        resnorms=resnorms,
        iterations=nmv_count + nmv_filter + _PROJECTION_SWEEPS,
        estimate=est, filter_degree=degree, signals=d)


# ---------------------------------------------------------------------------
# random-subset k-means + full-N assignment sweep
# ---------------------------------------------------------------------------

def _gather_rows(z, u_hat, idx: np.ndarray, device) -> torch.Tensor:
    """An O(n_sub · d) device block of the requested (sorted) rows, by
    global index. Under a mesh each rank fills the rows its shard holds
    into a zero block and ``z.reduce`` sums the blocks over the ranks
    (0 + x is exact): every rank gets the same block."""
    if z.kind == "mesh":
        sel = torch.as_tensor(idx)
        mine = (sel >= z.row0) & (sel < z.row0 + z.n_local)
        block = torch.zeros((idx.shape[0], u_hat.shape[1]),
                            dtype=u_hat.dtype, device=u_hat.device)
        block[mine.to(u_hat.device)] = u_hat[(sel[mine] - z.row0)
                                             .to(u_hat.device)]
        return z.reduce(lambda acc, b: acc + b, torch.zeros_like(block),
                        block)
    if isinstance(u_hat, streaming.ChunkedDense):
        offsets = np.concatenate([[0], np.cumsum(u_hat.chunk_sizes)])
        parts = [c[torch.from_numpy(idx[(idx >= lo) & (idx < hi)] - lo)]
                 for c, lo, hi in zip(u_hat.chunks, offsets, offsets[1:])]
        return torch.cat(parts).to(device)
    return u_hat[torch.as_tensor(idx, device=u_hat.device)].contiguous()


def subset_rows(n: int, k: int, seed: int, cfg) -> np.ndarray:
    """The sorted rows :func:`subset_cluster` samples, drawn without
    replacement from ``fold_seed(seed, "subset")``."""
    n_sub = int(min(n, max(k, cfg.compressive_options.subset
                           or default_subset(n, k))))
    rng = np.random.default_rng(fold_seed(seed, "subset"))
    return np.sort(rng.choice(n, size=n_sub, replace=False))


def subset_cluster(z, u_hat, seed: int, cfg, *, rows=None,
                   init=None) -> Tuple[KMeansResult, dict]:
    """Step 3: k-means on a random row subset of the normalized filtered
    signals, then one nearest-centroid sweep labels every row.

    ``rows`` (sorted row indices) and ``init`` (the k-means seeds, as
    ``kmeans.kmeans(init=...)``) replace the draws from ``seed``. The
    assignment sweep runs through ``z.map_row_chunks``, so host chunks are
    uploaded one at a time; only the (N, 2) label/distance table leaves
    (under a mesh, gathered from every rank: the global labels)."""
    n, k = z.n, cfg.n_clusters
    idx = subset_rows(n, k, seed, cfg) if rows is None \
        else np.sort(np.asarray(rows, np.int64))
    sub = _gather_rows(z, u_hat, idx, z.device)
    km = _kmeans(make_generator(fold_seed(seed, "centroids"), z.device), sub,
                 k, n_iters=cfg.kmeans_iters,
                 n_replicates=cfg.kmeans_replicates, impl=cfg.impl, init=init)
    cents = km.centroids.contiguous()

    def assign(u):
        labels, d2 = ops.kmeans_assign(u.contiguous(), cents, impl=cfg.impl)
        # label ids are exact in float32 (k ≪ 2^24)
        return torch.stack([labels.to(torch.float32), d2], dim=1)

    out = z.map_row_chunks(assign, u_hat)
    if z.kind == "mesh":
        out = z.gather_rows(out)
    arr = out.to_array() if isinstance(out, streaming.ChunkedDense) \
        else out.cpu().numpy()
    res = KMeansResult(centroids=cents,
                       labels=torch.from_numpy(arr[:, 0].astype(np.int32)),
                       inertia=torch.tensor(float(arr[:, 1].sum())))
    return res, {"kmeans_subset_rows": int(idx.shape[0])}
