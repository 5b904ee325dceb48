"""Blocked iterative eigensolvers for the implicit operator Â = Ẑ Ẑᵀ.

The JAX package's solvers, as plain loops on tensors. The block mat-vec is
the Gram operator (hand-written kernels on the card); the dense algebra
around it (QR, eigh, GEMM) runs on ``torch.linalg`` and ``torch.matmul``,
in full float32 — the fit turns TF32 off. The Rayleigh–Ritz Grams that the
JAX package solves in host float64 stay host float64 here.

  - ``lobpcg``: the main path's solver. A fixed-shape [X|W|P] subspace,
    whitened Rayleigh–Ritz (rank-deficiency safe), soft locking by
    residual masking, one block mat-vec per iteration, diagonal (degree)
    preconditioning, warm starts and the adaptive ``stable_tol`` stop.
  - ``lobpcg_host``: ``lobpcg`` with the convergence read only every
    ``check_every`` iterations (the JAX package's host-driven driver).
  - ``lobpcg_host_chunked``: the host-chunked residency's driver; the
    block iterates live as host row chunks (``streaming.ChunkedDense``),
    only the Gram product touches the device (one chunk at a time), and
    the (3b, 3b) Rayleigh–Ritz algebra runs in host float64 with numpy.
  - ``lobpcg_sharded``: the mesh placement's solver; the same algorithm
    on this rank's row shard, on the device, its tall inner products
    float64 Grams summed over the ranks (Cholesky-QR in place of the
    tall QR, which cannot be split).
  - ``lanczos``: single-vector Lanczos with full reorthogonalisation (the
    paper's "svds" stand-in), ``subspace_iteration`` (block power method):
    the comparison baselines.
  - ``randomized``: a block-Krylov sketch of depth 2 (three block
    mat-vecs, one whitened Rayleigh–Ritz), on device blocks or host
    chunks; ``solver="auto"`` runs it first and continues with a
    warm-started, preconditioned LOBPCG only if the sketch misses ``tol``.

``top_k_eigenpairs`` dispatches by solver and residency, under an
``eigensolve`` span, and feeds ``repro_eigensolves_total``,
``repro_solver_iterations`` and ``repro_solver_resnorm_max``.
``solver="compressive"`` is not an eigensolver (``core.compressive``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

Matvec = Callable[[torch.Tensor], torch.Tensor]

_SOLVES_TOTAL = obs_metrics.REGISTRY.counter(
    "repro_eigensolves_total", "Completed top-k eigensolves.", ("solver",))
_SOLVER_ITERS = obs_metrics.REGISTRY.histogram(
    "repro_solver_iterations", "Block mat-vec iterations per eigensolve.",
    ("solver",), buckets=obs_metrics.log_buckets(1.0, 1e4))
_SOLVER_RESNORM = obs_metrics.REGISTRY.gauge(
    "repro_solver_resnorm_max", "Worst top-k residual of the last eigensolve.",
    ("solver",))


class EigResult(NamedTuple):
    theta: torch.Tensor      # (k,) eigenvalues, descending
    vectors: "torch.Tensor | object"   # (n, k); a ChunkedDense on chunks
    resnorms: torch.Tensor   # (k,) final residual norms
    iterations: int          # mat-vec blocks used


def _orthonormalize(x: torch.Tensor) -> torch.Tensor:
    q, _ = torch.linalg.qr(x)
    return q


def degree_precond(deg: torch.Tensor) -> torch.Tensor:
    """Jacobi preconditioner for L̂ = I − Â from the RB degrees.

    diag(Â)_i = 1/deg_i exactly (a point collides with itself in every
    grid), so diag(L̂)_i = 1 − 1/deg_i and the Jacobi weight is
    deg_i/(deg_i − 1). Computed in float64 on the host, as the JAX package
    does (O(N) once per fit), and returned on ``deg``'s device."""
    d = deg.detach().cpu().numpy().astype(np.float64)
    t = d / np.maximum(d - 1.0, 0.25)
    t = np.minimum(t, 10.0 * max(float(np.median(t)), 1e-12))
    return torch.as_tensor((t / np.max(t)).astype(np.float32),
                           device=deg.device)


def _whitened_rayleigh_ritz(s, a_s, k, rcond=3e-4):
    """Rayleigh–Ritz on span(S) robust to rank deficiency.

    Whitens with M = SᵀS via eigh, clamping directions with λ ≤ rcond·λmax
    to zero weight (locked/zero columns), then solves the projected problem
    and returns the top-k combination C (m, k) with CᵀMC = I."""
    m = s.shape[1]
    gram_m = s.T @ s
    gram_a = s.T @ a_s
    gram_a = 0.5 * (gram_a + gram_a.T)
    lam, v = torch.linalg.eigh(gram_m)
    keep = lam > rcond * torch.max(lam)
    inv_sqrt = torch.where(keep, 1.0 / torch.sqrt(torch.clamp_min(lam, 1e-30)),
                           torch.zeros_like(lam))
    wh = v * inv_sqrt[None, :]
    t = wh.T @ gram_a @ wh
    t = 0.5 * (t + t.T)
    # push dropped directions below the (PSD) spectrum so top-k skips them
    t = t - (1.0 - keep.to(t.dtype))[:, None] * torch.eye(
        m, dtype=t.dtype, device=t.device)
    evals, evecs = torch.linalg.eigh(t)              # ascending
    top = torch.arange(m - 1, m - k - 1, -1, device=t.device)
    return evals[top], wh @ evecs[:, top]


def _lobpcg_residual_block(x, ax, tol, tvec):
    """Ritz values, relative residuals, and the soft-locked search block W."""
    theta = torch.sum(x * ax, dim=0)
    r = ax - x * theta[None, :]
    res = torch.linalg.vector_norm(r, dim=0) / torch.clamp_min(theta, 1e-12)
    active = (res > tol).to(x.dtype)
    w = r * active[None, :]                          # soft lock
    if tvec is not None:
        w = w * tvec[:, None]
    w = w - x @ (x.T @ w)                            # project against X
    wn = torch.linalg.vector_norm(w, dim=0)
    w = w / torch.clamp_min(wn, 1e-12)[None, :] * (wn > 1e-10).to(w.dtype)
    return theta, res, w


def _lobpcg_rr_update(x, ax, p, ap, w, aw, k):
    """One [X|W|P] Rayleigh–Ritz step: new (X, AX, P, AP)."""
    s = torch.cat([x, w, p], dim=1)                  # (n, 3k)
    a_s = torch.cat([ax, aw, ap], dim=1)
    _, c = _whitened_rayleigh_ritz(s, a_s, k)
    x_new = s @ c
    ax_new = a_s @ c
    # float32 drift control: re-orthonormalize X by QR and keep AX
    # consistent through the triangular factor (X = QR ⇒ AQ = AX·R⁻¹).
    # All-or-nothing: mixing QR columns with raw Rayleigh–Ritz columns would
    # break XᵀX = I whenever any single diagonal of R is unsafe.
    q, rfac = torch.linalg.qr(x_new)
    rdiag = torch.abs(torch.diagonal(rfac))
    all_safe = torch.all(rdiag > 1e-6 * torch.max(rdiag))
    # AX·R⁻¹ as a GEMM with the (b, b) inverse: torch's triangular solve
    # with the N right-hand sides of the transposed form took seconds per
    # call at N = 581,012 on an H100 (chip_smoke.py's svd stage fell from
    # 223 s to 0.63 s with this form)
    eye = torch.eye(rfac.shape[0], dtype=rfac.dtype, device=rfac.device)
    ax_q = ax_new @ torch.linalg.solve_triangular(rfac, eye, upper=True)
    ax_q = torch.where(torch.isfinite(ax_q), ax_q, torch.zeros_like(ax_q))
    x_new = torch.where(all_safe, q, x_new)
    ax_new = torch.where(all_safe, ax_q, ax_new)
    # implicit P: the W/P component of the update direction
    c_p = c.clone()
    c_p[:k, :] = 0.0
    p_new = s @ c_p
    ap_new = a_s @ c_p
    pn = torch.linalg.vector_norm(p_new, dim=0)
    pscale = torch.where(pn > 1e-10, 1.0 / torch.clamp_min(pn, 1e-12),
                         torch.zeros_like(pn))
    return x_new, ax_new, p_new * pscale[None, :], ap_new * pscale[None, :]


def _subspace_alignment(x_prev, x_cur, sk: int) -> torch.Tensor:
    """cos of the largest principal angle between the leading-``sk`` column
    spans of two orthonormal blocks (√λmin of the (sk, sk) Gram)."""
    g = x_prev[:, :sk].T @ x_cur[:, :sk]
    lam = torch.linalg.eigvalsh(g.T @ g)
    return torch.sqrt(torch.clamp_min(lam[0], 0.0))


def _lobpcg_finalize(x, ax, it) -> EigResult:
    theta = torch.sum(x * ax, dim=0)
    order = torch.argsort(-theta)
    r = ax - x * theta[None, :]
    res = torch.linalg.vector_norm(r, dim=0) / torch.clamp_min(theta, 1e-12)
    return EigResult(theta[order], x[:, order], res[order], int(it))


def lobpcg(
    matvec: Matvec,
    x0: torch.Tensor,
    *,
    max_iters: int = 200,
    tol: float = 1e-5,
    precond: Optional[torch.Tensor] = None,
    stable_tol: Optional[float] = None,
    stable_k: Optional[int] = None,
    check_every: int = 4,
    conv_k: Optional[int] = None,
    read_every: int = 1,
) -> EigResult:
    """Top-k eigenpairs of a symmetric PSD operator. x0: (n, k) start block.

    The JAX package's ``lax.while_loop`` as a Python loop with the same
    semantics: convergence is tested on the leading ``conv_k`` columns
    (one scalar read), AX is recomputed exactly every 16 iterations, and a
    converged ``x0`` exits with ``iterations == 0``. ``stable_tol`` adds
    the adaptive stop: every ``check_every`` iterations the leading
    ``stable_k`` Ritz columns are compared with the last checkpoint, and
    the solve stops when 1 − cos(largest principal angle) < ``stable_tol``.

    ``read_every`` is the convergence read's cadence. At 1 the read sees
    the residual computed before the last update, as the ``while_loop``
    carries it; at more (:func:`lobpcg_host`) it sees the current
    iterate's."""
    n, k = x0.shape
    if 3 * k > n:
        raise ValueError(f"block too large: need 3k ≤ n, got k={k}, n={n}")
    tvec = None if precond is None else precond.to(torch.float32)
    sk = min(stable_k or k, k)
    ck = min(conv_k or k, k)

    x = _orthonormalize(x0.to(torch.float32))
    ax = matvec(x)
    _, res, _ = _lobpcg_residual_block(x, ax, tol, tvec)
    p = torch.zeros_like(x)
    ap = torch.zeros_like(x)
    x_chk = x
    it = 0
    while it < max_iters:
        if read_every > 1:
            _, res, w = _lobpcg_residual_block(x, ax, tol, tvec)
        if it % read_every == 0 and float(torch.max(res[:ck])) <= tol:
            break
        if read_every == 1:
            _, res, w = _lobpcg_residual_block(x, ax, tol, tvec)
        aw = matvec(w)
        x, ax, p, ap = _lobpcg_rr_update(x, ax, p, ap, w, aw, k)
        it += 1
        if it % 16 == 0:             # exact refresh kills recombination drift
            ax = matvec(x)
        if stable_tol is not None and it % check_every == 0:
            align = float(_subspace_alignment(x_chk, x, sk))
            x_chk = x
            if 1.0 - align < stable_tol:
                break
    return _lobpcg_finalize(x, ax, it)


def lobpcg_host(matvec: Matvec, x0: torch.Tensor, *, check_every: int = 4,
                **options) -> EigResult:
    """The JAX package's host-driven LOBPCG: :func:`lobpcg` reading
    convergence back only every ``check_every`` iterations (and at
    iteration 0, so a converged ``x0`` still exits with ``iterations ==
    0``), the stable-subspace stop tested at the same checkpoints."""
    return lobpcg(matvec, x0, check_every=check_every,
                  read_every=check_every, **options)


def lobpcg_block_width(n: int, k: int, buffer: int) -> int:
    """Width of the LOBPCG iterate block X: k + buffer, capped so [X|W|P]
    fits (3·b ≤ n)."""
    return max(1, min(k + buffer, n // 3))


def _dense_exact(matvec, n, k, device, chunk_sizes=None) -> EigResult:
    """Exact dense eigensolve for n < 3k (no [X|W|P] subspace fits): one
    mat-vec against the identity materializes the tiny operator (as host
    chunks with ``chunk_sizes``)."""
    if chunk_sizes is not None:
        from repro_torch.core.streaming import ChunkedDense
        eye = ChunkedDense.from_array(np.eye(n, dtype=np.float32),
                                      chunk_sizes)
        a = matvec(eye).to_array().astype(np.float64)
    else:
        a = matvec(torch.eye(n, dtype=torch.float32, device=device))
        a = a.detach().cpu().numpy().astype(np.float64)
    a = 0.5 * (a + a.T)
    evals, evecs = np.linalg.eigh(a)
    kk = min(k, n)
    theta = np.pad(evals[::-1][:kk], (0, k - kk)).astype(np.float32)
    vecs = np.zeros((n, k), np.float32)
    vecs[:, :kk] = evecs[:, ::-1][:, :kk]
    if chunk_sizes is not None:
        return EigResult(torch.as_tensor(theta),
                         ChunkedDense.from_array(vecs, chunk_sizes),
                         torch.zeros((k,), dtype=torch.float32), 1)
    as_t = lambda a: torch.as_tensor(a, device=device)
    return EigResult(as_t(theta), as_t(vecs),
                     torch.zeros((k,), dtype=torch.float32, device=device), 1)


def prepare_start_block(x0, n: int, b: int,
                        generator: torch.Generator,
                        device) -> torch.Tensor:
    """Normalize a warm start to an (n, b) block on ``device``.

    ``x0`` may be an ``EigResult``, an (n, kx) array/tensor or a
    ``ChunkedDense``; extra columns are truncated, missing columns are
    padded with Gaussian columns drawn from ``generator`` (the QR keeps the
    warm columns first)."""
    if hasattr(x0, "vectors"):                       # EigResult
        x0 = x0.vectors
    if hasattr(x0, "to_array"):                      # ChunkedDense
        x0 = x0.to_array()
    if isinstance(x0, torch.Tensor):
        arr = x0.detach().to(device=device, dtype=torch.float32)
    else:
        arr = torch.as_tensor(np.array(x0, np.float32), device=device)
    if arr.dim() != 2 or arr.shape[0] != n:
        raise ValueError(
            f"warm start must be (n, k) with n={n}, got {tuple(arr.shape)}")
    if arr.shape[1] >= b:
        return arr[:, :b].contiguous()
    pad = torch.randn((n, b - arr.shape[1]), generator=generator,
                      dtype=torch.float32, device=generator.device)
    return torch.cat([arr, pad.to(device)], dim=1)


# --------------------------------------------------------------------------
# Chunked LOBPCG: the block iterates live as host row chunks
# (streaming.ChunkedDense); only the Gram product touches the device, one
# chunk at a time. The small (3b, 3b) block algebra runs in host float64.
# --------------------------------------------------------------------------

def _chunks_inner(a: Sequence[np.ndarray],
                  b: Sequence[np.ndarray]) -> np.ndarray:
    """Σ_c A_cᵀ B_c in float64: the tall inner products of LOBPCG."""
    out = None
    for ac, bc in zip(a, b):
        g = ac.astype(np.float64).T @ bc.astype(np.float64)
        out = g if out is None else out + g
    return out


def _chunks_col_dots(a: Sequence[np.ndarray],
                     b: Sequence[np.ndarray]) -> np.ndarray:
    """diag(AᵀB) without the full Gram: Σ_c colsum(A_c ∘ B_c)."""
    return sum(
        np.sum(ac.astype(np.float64) * bc.astype(np.float64), axis=0)
        for ac, bc in zip(a, b))


def _chunks_resnorms(x, ax, theta) -> np.ndarray:
    """Relative residual norms ‖AX − XΘ‖_col / Θ, over the chunks."""
    rnorm2 = sum(
        np.sum((axc.astype(np.float64) - xc.astype(np.float64)
                * theta[None, :]) ** 2, axis=0)
        for xc, axc in zip(x, ax))
    return np.sqrt(rnorm2) / np.maximum(theta, 1e-12)


def _chunks_cholqr(x: Sequence[np.ndarray],
                   ax: Optional[Sequence[np.ndarray]] = None):
    """Cholesky-QR of a chunked tall-skinny block: X ← X·L⁻ᵀ chunk by
    chunk, with AX kept consistent through the same factor. X is (near-)
    orthonormal at every call site, so one Cholesky pass suffices; on a
    breakdown the factorization is skipped."""
    m = _chunks_inner(x, x)
    m = 0.5 * (m + m.T)
    try:
        lfac = np.linalg.cholesky(
            m + 1e-12 * max(np.trace(m) / m.shape[0], 1.0)
            * np.eye(m.shape[0]))
    except np.linalg.LinAlgError:
        return list(x), None if ax is None else list(ax)
    xq = [np.linalg.solve(lfac, c.astype(np.float64).T).T.astype(np.float32)
          for c in x]
    if ax is None:
        return xq, None
    axq = [np.linalg.solve(lfac, c.astype(np.float64).T).T.astype(np.float32)
           for c in ax]
    return xq, axq


def _whitened_rayleigh_ritz_grams_np(gram_m, gram_a, k, rcond=3e-4):
    """Host-float64 :func:`_whitened_rayleigh_ritz` from the (3b, 3b) Gram
    matrices (the chunked driver adds them up chunk by chunk and never
    forms S)."""
    m = gram_m.shape[0]
    gram_a = 0.5 * (gram_a + gram_a.T)
    lam, v = np.linalg.eigh(0.5 * (gram_m + gram_m.T))
    keep = lam > rcond * np.max(lam)
    inv_sqrt = np.where(keep, 1.0 / np.sqrt(np.maximum(lam, 1e-30)), 0.0)
    wh = v * inv_sqrt[None, :]
    t = wh.T @ gram_a @ wh
    t = 0.5 * (t + t.T)
    t = t - (1.0 - keep.astype(t.dtype))[:, None] * np.eye(m)
    evals, evecs = np.linalg.eigh(t)
    top = np.arange(m - k, m)[::-1]
    return evals[top], wh @ evecs[:, top]


def _split_chunks(vec, sizes: Sequence[int]):
    """Split an (N,) host vector into row chunks aligned with ``sizes``."""
    if vec is None:
        return None
    if isinstance(vec, torch.Tensor):
        vec = vec.detach().cpu().numpy()
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    v = np.asarray(vec, np.float32)
    return [v[offsets[i]:offsets[i + 1]] for i in range(len(sizes))]


def _compressed_width(n_active: int) -> int:
    """Active-column counts rounded up to a multiple of 4: the width the
    compressed mat-vec streams once Ritz pairs lock."""
    return max(4, -(-n_active // 4) * 4)


def lobpcg_host_chunked(
    matvec: Callable,
    x0,
    *,
    max_iters: int = 200,
    tol: float = 1e-5,
    precond=None,
    stable_tol: Optional[float] = None,
    stable_k: Optional[int] = None,
    check_every: int = 4,
    conv_k: Optional[int] = None,
) -> EigResult:
    """LOBPCG whose block iterates never exist as O(N) device arrays.

    ``x0`` is a ``streaming.ChunkedDense`` start block; ``matvec`` maps a
    ``ChunkedDense`` to one of the same chunking (``ChunkedELL.
    gram_matvec_chunked``: one chunk and the (D, K) accumulator on the
    device). X, AX, W, P and AP stay on the host as numpy row chunks; the
    Rayleigh–Ritz algebra runs in host float64. The JAX package's driver,
    line for line: converged columns of W are exactly zero, so they are
    compressed out of the mat-vec (its cost shrinks as pairs lock) and
    scattered back as zero columns. Returns the Ritz vectors as a
    ``ChunkedDense`` and the values as CPU tensors."""
    from repro_torch.core.streaming import ChunkedDense

    n, k = x0.n, x0.k
    if 3 * k > n:
        raise ValueError(f"block too large: need 3k ≤ n, got k={k}, n={n}")
    wrap = lambda chunks: ChunkedDense(tuple(
        torch.from_numpy(np.ascontiguousarray(c)) for c in chunks))
    mv = lambda chunks: [c.numpy() for c in matvec(wrap(chunks)).chunks]
    tchunks = _split_chunks(precond, x0.chunk_sizes)
    sk = min(stable_k or k, k)
    ck = min(conv_k or k, k)

    x, _ = _chunks_cholqr([c.numpy().astype(np.float32) for c in x0.chunks])
    ax = mv(x)
    p = [np.zeros_like(c) for c in x]
    ap = [np.zeros_like(c) for c in x]
    it = 0
    x_chk = None
    res = np.full((k,), np.inf)
    while it < max_iters:
        theta = _chunks_col_dots(x, ax)                  # Ritz values
        res = _chunks_resnorms(x, ax, theta)
        # converged on the leading-theta conv_k columns only (the buffer
        # columns help; they need not converge)
        if float(np.max(res[np.argsort(-theta)][:ck])) <= tol:
            break
        if stable_tol is not None and it % check_every == 0:
            if x_chk is not None:
                g = _chunks_inner(
                    [c[:, :sk] for c in x_chk], [c[:, :sk] for c in x])
                lam_min = float(np.linalg.eigvalsh(g.T @ g)[0])
                if 1.0 - np.sqrt(max(lam_min, 0.0)) < stable_tol:
                    break
            x_chk = [c.copy() for c in x]
        active = (res > tol).astype(np.float32)
        thetaf = theta.astype(np.float32)
        w = [(axc - xc * thetaf[None, :]) * active[None, :]
             for xc, axc in zip(x, ax)]
        proj = _chunks_inner(x, w).astype(np.float32)    # W ⊥ X
        w = [wc - xc @ proj for xc, wc in zip(x, w)]
        if tchunks is not None:
            w = [wc * tc[:, None] for wc, tc in zip(w, tchunks)]
            # re-project: the preconditioner brings X components back
            proj = _chunks_inner(x, w).astype(np.float32)
            w = [wc - xc @ proj for xc, wc in zip(x, w)]
        wn = np.sqrt(np.maximum(_chunks_col_dots(w, w), 0.0))
        wscale = (np.where(wn > 1e-10, 1.0 / np.maximum(wn, 1e-12), 0.0)
                  .astype(np.float32))
        w = [wc * wscale[None, :] for wc in w]

        # soft-lock compression: only the still-active columns of W go
        # through the mat-vec (locked columns are exactly zero)
        act_idx = np.nonzero(wn > 1e-10)[0]
        if len(act_idx) < k:
            m = min(_compressed_width(len(act_idx)), k)
            w_cmp = [np.ascontiguousarray(
                np.pad(wc[:, act_idx], ((0, 0), (0, m - len(act_idx)))))
                for wc in w]
            aw_cmp = mv(w_cmp)
            aw = [np.zeros_like(wc) for wc in w]
            for awc, cc in zip(aw, aw_cmp):
                awc[:, act_idx] = cc[:, :len(act_idx)]
        else:
            aw = mv(w)

        # [X|W|P] Rayleigh–Ritz from (3b, 3b) Grams added up over the
        # chunks, block by block (3 × 3 of b × b)
        gram_m = np.zeros((3 * k, 3 * k))
        gram_a = np.zeros((3 * k, 3 * k))
        s_blocks, a_blocks = (x, w, p), (ax, aw, ap)
        for i in range(3):
            for j in range(3):
                bi, bj = slice(i * k, (i + 1) * k), slice(j * k, (j + 1) * k)
                if i <= j:                               # SᵀS is symmetric
                    gram_m[bi, bj] = _chunks_inner(s_blocks[i], s_blocks[j])
                    gram_m[bj, bi] = gram_m[bi, bj].T
                gram_a[bi, bj] = _chunks_inner(s_blocks[i], a_blocks[j])
        _, c = _whitened_rayleigh_ritz_grams_np(gram_m, gram_a, k)
        cf = c.astype(np.float32)
        cx, cw, cp = cf[:k], cf[k:2 * k], cf[2 * k:]
        x_new, ax_new, p_new, ap_new = [], [], [], []
        for xc, wc, pc, axc, awc, apc in zip(x, w, p, ax, aw, ap):
            x_new.append(xc @ cx + wc @ cw + pc @ cp)
            ax_new.append(axc @ cx + awc @ cw + apc @ cp)
            # implicit P: the W/P component only
            p_new.append(wc @ cw + pc @ cp)
            ap_new.append(awc @ cw + apc @ cp)
        # drift control: re-orthonormalize X, AX kept consistent (chol-QR)
        x, ax = _chunks_cholqr(x_new, ax_new)
        pn = np.sqrt(np.maximum(_chunks_col_dots(p_new, p_new), 0.0))
        pscale = (np.where(pn > 1e-10, 1.0 / np.maximum(pn, 1e-12), 0.0)
                  .astype(np.float32))
        p = [pc * pscale[None, :] for pc in p_new]
        ap = [apc * pscale[None, :] for apc in ap_new]
        it += 1
        if it % 16 == 0:
            ax = mv(x)      # exact refresh kills recombination drift

    theta = _chunks_col_dots(x, ax)
    order = np.argsort(-theta)
    res_final = _chunks_resnorms(x, ax, theta)
    vectors = wrap([c[:, order] for c in x])
    return EigResult(torch.as_tensor(theta[order], dtype=torch.float32),
                     vectors,
                     torch.as_tensor(res_final[order], dtype=torch.float32),
                     it)


# --------------------------------------------------------------------------
# Sharded LOBPCG: the mesh placement's solver. Each rank holds its row
# shard of every block on its device; the tall inner products are local
# float64 Grams summed over the ranks, the (3b, 3b) algebra is that of
# lobpcg_host_chunked, in host float64, the same on every rank.
# --------------------------------------------------------------------------

def lobpcg_sharded(
    matvec: Matvec,
    x0: torch.Tensor,
    *,
    reduce: Callable[[torch.Tensor], torch.Tensor],
    max_iters: int = 200,
    tol: float = 1e-5,
    precond: Optional[torch.Tensor] = None,
    stable_tol: Optional[float] = None,
    stable_k: Optional[int] = None,
    check_every: int = 4,
    conv_k: Optional[int] = None,
) -> EigResult:
    """LOBPCG on a row-sharded operator: :func:`lobpcg_host_chunked`'s
    algorithm with this rank's shard of the rows as its one chunk, on the
    device.

    ``x0`` and ``precond`` are this rank's rows of the start block and of
    the diagonal; ``matvec`` maps this rank's rows of u to its rows of Âu
    (the collective is inside it). ``reduce`` sums a float64 tensor over
    the ranks (an ``all_reduce``). Every tall inner product is a local
    float64 Gram on the device, summed by ``reduce`` — the [X|W|P] Grams
    of an iteration in one call — so every rank solves the same (3b, 3b)
    Rayleigh–Ritz problem in host float64
    (:func:`_whitened_rayleigh_ritz_grams_np`) and re-orthonormalises X by
    Cholesky-QR, a Gram and a (b, b) factor, where :func:`lobpcg`'s
    Householder QR of the tall block cannot be split over ranks. Returns
    this rank's rows of the Ritz vectors."""
    dev = x0.device
    n_local, k = x0.shape
    f64 = lambda a: a.to(torch.float64)
    to_dev = lambda a: torch.as_tensor(a, device=dev)

    def inner(a, b) -> np.ndarray:
        return reduce(f64(a).T @ f64(b)).cpu().numpy()

    def col_dots(a, b) -> np.ndarray:
        return reduce(torch.sum(f64(a) * f64(b), dim=0)).cpu().numpy()

    def resnorms(x, ax, theta) -> np.ndarray:
        r = f64(ax) - f64(x) * to_dev(theta)[None, :]
        rn2 = reduce(torch.sum(r * r, dim=0)).cpu().numpy()
        return np.sqrt(rn2) / np.maximum(theta, 1e-12)

    def cholqr(x, ax=None):
        m = inner(x, x)
        m = 0.5 * (m + m.T)
        try:
            lfac = np.linalg.cholesky(
                m + 1e-12 * max(np.trace(m) / m.shape[0], 1.0)
                * np.eye(m.shape[0]))
        except np.linalg.LinAlgError:
            return x, ax
        lit = to_dev(np.linalg.inv(lfac).T)              # X ← X·L⁻ᵀ
        xq = (f64(x) @ lit).to(torch.float32)
        return xq, None if ax is None else (f64(ax) @ lit).to(torch.float32)

    tvec = None if precond is None else precond.to(torch.float32)
    sk = min(stable_k or k, k)
    ck = min(conv_k or k, k)
    x, _ = cholqr(x0.to(torch.float32))
    ax = matvec(x)
    p = torch.zeros_like(x)
    ap = torch.zeros_like(x)
    it = 0
    x_chk = None
    while it < max_iters:
        theta = col_dots(x, ax)                          # Ritz values
        res = resnorms(x, ax, theta)
        if float(np.max(res[np.argsort(-theta)][:ck])) <= tol:
            break
        if stable_tol is not None and it % check_every == 0:
            if x_chk is not None:
                g = inner(x_chk[:, :sk], x[:, :sk])
                lam_min = float(np.linalg.eigvalsh(g.T @ g)[0])
                if 1.0 - np.sqrt(max(lam_min, 0.0)) < stable_tol:
                    break
            x_chk = x.clone()
        active = to_dev((res > tol).astype(np.float32))
        thetaf = to_dev(theta.astype(np.float32))
        w = (ax - x * thetaf[None, :]) * active[None, :]
        w = w - x @ to_dev(inner(x, w).astype(np.float32))      # W ⊥ X
        if tvec is not None:
            w = w * tvec[:, None]
            # re-project: the preconditioner brings X components back
            w = w - x @ to_dev(inner(x, w).astype(np.float32))
        wn = np.sqrt(np.maximum(col_dots(w, w), 0.0))
        wscale = np.where(wn > 1e-10, 1.0 / np.maximum(wn, 1e-12), 0.0)
        w = w * to_dev(wscale.astype(np.float32))[None, :]
        aw = matvec(w)

        # [X|W|P] Rayleigh–Ritz: both (3b, 3b) Grams in one reduce
        s = f64(torch.cat([x, w, p], dim=1))
        a_s = f64(torch.cat([ax, aw, ap], dim=1))
        grams = reduce(torch.stack([s.T @ s, s.T @ a_s])).cpu().numpy()
        del s, a_s
        _, c = _whitened_rayleigh_ritz_grams_np(grams[0], grams[1], k)
        cf = to_dev(c.astype(np.float32))
        cx, cw, cp = cf[:k], cf[k:2 * k], cf[2 * k:]
        x_new = x @ cx + w @ cw + p @ cp
        ax_new = ax @ cx + aw @ cw + ap @ cp
        p_new = w @ cw + p @ cp                          # implicit P
        ap_new = aw @ cw + ap @ cp
        x, ax = cholqr(x_new, ax_new)                    # drift control
        pn = np.sqrt(np.maximum(col_dots(p_new, p_new), 0.0))
        pscale = to_dev(np.where(pn > 1e-10, 1.0 / np.maximum(pn, 1e-12),
                                 0.0).astype(np.float32))
        p = p_new * pscale[None, :]
        ap = ap_new * pscale[None, :]
        it += 1
        if it % 16 == 0:
            ax = matvec(x)      # exact refresh kills recombination drift

    theta = col_dots(x, ax)
    order = np.argsort(-theta)
    res_final = resnorms(x, ax, theta)
    return EigResult(torch.as_tensor(theta[order], dtype=torch.float32),
                     x[:, to_dev(order)].contiguous(),
                     torch.as_tensor(res_final[order], dtype=torch.float32),
                     it)


#: Solvers that run on the row shards themselves under the mesh placement;
#: the others run against the global mat-vec
#: (:func:`top_k_eigenpairs_sharded`).
SHARDED_SOLVERS = ("lobpcg", "lobpcg_host")


def top_k_eigenpairs_sharded(
    matvec: Matvec,
    n: int,
    k: int,
    generator: torch.Generator,
    *,
    rows: slice,
    device,
    reduce: Callable[[torch.Tensor], torch.Tensor],
    global_matvec: Matvec,
    solver: str = "lobpcg",
    max_iters: int = 200,
    tol: float = 1e-5,
    buffer: int = 4,
    x0=None,
    precond: Optional[torch.Tensor] = None,
    stable_tol: Optional[float] = None,
) -> EigResult:
    """Top-k eigenpairs of a row-sharded operator; returns this rank's
    ``rows`` of the vectors. ``matvec`` maps this rank's rows of u to its
    rows of Âu and ``reduce`` sums a tensor over the ranks;
    ``global_matvec`` maps the global (n, b) block, the same on every rank,
    to the global Âv; ``precond`` is the global (n,) diagonal.

    ``"lobpcg"`` and ``"lobpcg_host"`` (at 3k ≤ n) run
    :func:`lobpcg_sharded` on the shard, under an ``eigensolve`` span. Every
    other solver, and the n < 3k dense fallback, run
    :func:`top_k_eigenpairs` against ``global_matvec``, as the JAX package
    drives them against its global arrays: every rank holds the (n, b)
    block and runs the same algebra on the same bits, so every host
    decision (a stop, a restart, ``auto``'s switch) is the same on every
    rank. The start block is the single placement's either way — the
    global (n, b) Gaussian draw from ``generator`` on the CPU, or ``x0``."""
    if solver not in SHARDED_SOLVERS or 3 * k > n:
        out = top_k_eigenpairs(
            global_matvec, n, k, generator, device=device, solver=solver,
            max_iters=max_iters, tol=tol, buffer=buffer, x0=x0,
            precond=precond, stable_tol=stable_tol)
        return EigResult(out.theta, out.vectors[rows].contiguous(),
                         out.resnorms, out.iterations)
    b = lobpcg_block_width(n, k, buffer)
    with obs_trace.span("eigensolve", solver=solver, n=n, k=k,
                        streaming=False, sharded=True) as sp:
        if x0 is not None:
            start = prepare_start_block(x0, n, b, generator, "cpu")
        else:
            start = torch.randn((n, b), generator=generator,
                                dtype=torch.float32,
                                device=generator.device)
        x0_local = start[rows].to(device).contiguous()
        del start
        out = lobpcg_sharded(matvec, x0_local, reduce=reduce,
                             max_iters=max_iters, tol=tol,
                             precond=None if precond is None
                             else precond[rows],
                             stable_tol=stable_tol, stable_k=k, conv_k=k)
        out = EigResult(out.theta[:k], out.vectors[:, :k].contiguous(),
                        out.resnorms[:k], out.iterations)
        resnorm_max = float(out.resnorms.max()) if out.resnorms.numel() \
            else 0.0
        sp.set(iterations=int(out.iterations), resnorm_max=resnorm_max)
    record_solve(solver, int(out.iterations), resnorm_max)
    return out


def lanczos(
    matvec: Matvec,
    v0: torch.Tensor,
    k: int,
    *,
    max_iters: int = 100,
    tol: float = 0.0,
) -> EigResult:
    """Symmetric Lanczos with full reorthogonalisation (svds stand-in).

    Single-vector Krylov. The (m, N) basis is float64, as in the JAX
    package, and lives on ``v0``'s device: on the card one reorthogonalised
    step reads it from HBM, where the host copy of the JAX package's would
    cross host memory four times a step (m = 300 rows of 581,012 are
    1.39 GB; ``tools/fit_study.py lanczos-step`` times one step both
    ways). The mat-vec is the float32 Gram product at width 1.
    ``iterations`` is the true basis size: the recurrence exits when the
    Krylov space exhausts (β → 0) or, with ``tol > 0``, when the
    tridiagonal residual bounds β_j·|s_{j,i}| of the top-k Ritz pairs all
    drop below ``tol`` (checked every 5 steps)."""
    n = v0.shape[0]
    dev = v0.device
    m = min(max_iters, n)
    v = (v0[:, 0] if v0.dim() == 2 else v0).to(torch.float64)
    v = v / torch.linalg.vector_norm(v)
    basis = torch.zeros((m, n), dtype=torch.float64, device=dev)
    alphas: list = []
    betas: list = []
    j = 0
    while j < m:
        av = matvec(v.to(torch.float32)[:, None].contiguous())[:, 0] \
            .to(torch.float64)
        alpha = float(v @ av)
        basis[j] = v
        # full reorthogonalisation, twice, against the stored basis: after
        # exhaustion w → 0 and cannot regrow
        bj = basis[:j + 1]
        w = av - bj.T @ (bj @ av)
        w = w - bj.T @ (bj @ w)
        beta = float(torch.linalg.vector_norm(w))
        alphas.append(alpha)
        betas.append(beta)
        j += 1
        if beta <= 1e-6 * max(1.0, abs(alpha)):
            break                                   # Krylov space exhausted
        v = w / beta
        if tol > 0.0 and j >= k and (j % 5 == 0 or j == m):
            tmat = (np.diag(alphas) + np.diag(betas[:-1], 1)
                    + np.diag(betas[:-1], -1))
            evals_j, evecs_j = np.linalg.eigh(tmat)
            top = evals_j[::-1][:k]
            bottom_row = np.abs(evecs_j[-1, ::-1][:k])
            bounds = betas[-1] * bottom_row / np.maximum(top, 1e-12)
            if float(np.max(bounds)) <= tol:
                break
    tmat = np.diag(alphas)
    if j > 1:
        tmat += np.diag(betas[:j - 1], 1) + np.diag(betas[:j - 1], -1)
    evals_h, evecs_h = np.linalg.eigh(tmat)
    kk = min(k, j)
    evals = np.pad(evals_h[::-1][:kk], (0, k - kk))
    evecs = np.zeros((j, k))
    evecs[:, :kk] = evecs_h[:, ::-1][:, :kk]
    theta = torch.as_tensor(evals, dtype=torch.float32, device=dev)
    vectors = (basis[:j].T @ torch.as_tensor(evecs, device=dev)) \
        .to(torch.float32).contiguous()
    av = matvec(vectors)
    res = torch.linalg.vector_norm(av - vectors * theta[None, :], dim=0) \
        / torch.clamp_min(theta, 1e-12)
    return EigResult(theta, vectors, res, j)


def randomized(matvec: Matvec, x0: torch.Tensor, *,
               depth: int = 2) -> EigResult:
    """One-pass randomized block-Krylov eigensolver (Musco–Musco style).

    Builds S = [X, ÂX, …, Â^depth X] with per-block column rescaling (the
    span is unchanged; the whitened Rayleigh–Ritz absorbs the rest of the
    ill-conditioning) and solves once on the (depth+1)·b subspace:
    ``depth + 1`` block mat-vecs, no iteration."""
    b = x0.shape[1]
    x = _orthonormalize(x0.to(torch.float32))
    s_blocks = [x]
    a_of_s = []                       # a_of_s[i] = Â·s_blocks[i], exact
    cur = x
    for i in range(depth + 1):
        a_cur = matvec(cur)
        a_of_s.append(a_cur)
        if i < depth:
            nrm = torch.linalg.vector_norm(a_cur, dim=0)
            cur = a_cur / torch.clamp_min(nrm, 1e-30)[None, :]
            s_blocks.append(cur)
    s = torch.cat(s_blocks, dim=1)
    a_s = torch.cat(a_of_s, dim=1)
    theta, c = _whitened_rayleigh_ritz(s, a_s, b)   # top-b, descending
    vectors = s @ c
    av = a_s @ c
    res = torch.linalg.vector_norm(av - vectors * theta[None, :], dim=0) \
        / torch.clamp_min(theta, 1e-12)
    return EigResult(theta, vectors, res, depth + 1)


def subspace_iteration(matvec: Matvec, x0: torch.Tensor, *,
                       max_iters: int = 50, tol: float = 1e-5) -> EigResult:
    """Block power iteration with Rayleigh–Ritz — the simple baseline. Two
    block mat-vecs an iteration; ``iterations`` counts them."""
    k = x0.shape[1]
    x = _orthonormalize(x0.to(torch.float32))
    res = torch.full((k,), float("inf"), dtype=torch.float32,
                     device=x.device)
    it = 0
    while it < max_iters and float(torch.max(res)) > tol:
        q = _orthonormalize(matvec(x))
        aq = matvec(q)
        theta, c = _whitened_rayleigh_ritz(q, aq, k)
        x = q @ c
        r = aq @ c - x * theta[None, :]
        res = torch.linalg.vector_norm(r, dim=0) \
            / torch.clamp_min(theta, 1e-12)
        it += 1
    ax = matvec(x)
    theta = torch.sum(x * ax, dim=0)
    order = torch.argsort(-theta)
    return EigResult(theta[order], x[:, order], res[order], it * 2)


def _chunked_randomized_impl(matvec, x0c, *, depth: int = 2) -> EigResult:
    """:func:`randomized` over host chunks: the Krylov blocks live as numpy
    row chunks, the ((depth+1)b)² Grams are added up chunk by chunk, and
    the one Rayleigh–Ritz runs in host float64."""
    from repro_torch.core.streaming import ChunkedDense

    b = x0c.k
    wrap = lambda chunks: ChunkedDense(tuple(
        torch.from_numpy(np.ascontiguousarray(c)) for c in chunks))
    mv = lambda chunks: [c.numpy() for c in matvec(wrap(chunks)).chunks]
    x, _ = _chunks_cholqr([c.numpy().astype(np.float32) for c in x0c.chunks])
    s_blocks = [x]
    a_of_s = []                       # Â applied to each stored block
    cur = x
    for i in range(depth + 1):
        a_cur = mv(cur)               # Â·s_blocks[i], exact
        a_of_s.append(a_cur)
        if i < depth:
            nrm = np.sqrt(np.maximum(_chunks_col_dots(a_cur, a_cur), 1e-60))
            scale = (1.0 / nrm).astype(np.float32)
            cur = [c * scale[None, :] for c in a_cur]
            s_blocks.append(cur)
    p = depth + 1
    m = p * b
    gram_m = np.zeros((m, m))
    gram_a = np.zeros((m, m))
    for i in range(p):
        for j in range(p):
            bi, bj = slice(i * b, (i + 1) * b), slice(j * b, (j + 1) * b)
            if i <= j:
                gram_m[bi, bj] = _chunks_inner(s_blocks[i], s_blocks[j])
                gram_m[bj, bi] = gram_m[bi, bj].T
            gram_a[bi, bj] = _chunks_inner(s_blocks[i], a_of_s[j])
    theta, c = _whitened_rayleigh_ritz_grams_np(gram_m, gram_a, b)
    cf = c.astype(np.float32)
    x_out = [sum(parts[i] @ cf[i * b:(i + 1) * b] for i in range(p))
             for parts in zip(*s_blocks)]
    ax_out = [sum(parts[i] @ cf[i * b:(i + 1) * b] for i in range(p))
              for parts in zip(*a_of_s)]
    order = np.argsort(-theta)
    res = _chunks_resnorms(x_out, ax_out, theta)
    return EigResult(torch.as_tensor(theta[order], dtype=torch.float32),
                     wrap([c[:, order] for c in x_out]),
                     torch.as_tensor(res[order], dtype=torch.float32),
                     depth + 1)


SOLVERS = {
    "lobpcg": lobpcg,
    "lobpcg_host": lobpcg_host,
    "lanczos": lanczos,
    "subspace": subspace_iteration,
    "randomized": randomized,
}

# ``solver="auto"`` is a policy, not a driver: the randomized sketch first,
# then (only if its residuals miss tol) a warm-started, preconditioned
# LOBPCG continuation with the adaptive stability stop.
AUTO_SOLVER = "auto"

#: Solvers of host-chunked operands (the host-driven ones).
CHUNKED_SOLVERS = ("lobpcg", "lobpcg_host", "randomized", AUTO_SOLVER)


def top_k_eigenpairs(
    matvec: Matvec,
    n: int,
    k: int,
    generator: torch.Generator,
    *,
    device="cpu",
    solver: str = "lobpcg",
    max_iters: int = 200,
    tol: float = 1e-5,
    buffer: int = 4,
    x0=None,
    precond=None,
    stable_tol: Optional[float] = None,
    chunk_sizes: Optional[Sequence[int]] = None,
) -> EigResult:
    """Top-k eigenpairs (observability wrapper).

    Runs :func:`_top_k_eigenpairs_impl` under an ``eigensolve`` span and
    records the solve with :func:`record_solve`."""
    with obs_trace.span("eigensolve", solver=solver, n=n, k=k,
                        streaming=chunk_sizes is not None) as sp:
        out = _top_k_eigenpairs_impl(
            matvec, n, k, generator, device=device, solver=solver,
            max_iters=max_iters, tol=tol, buffer=buffer, x0=x0,
            precond=precond, stable_tol=stable_tol, chunk_sizes=chunk_sizes)
        iters = int(out.iterations)
        res = out.resnorms
        resnorm_max = float(res.max()) if res.numel() else 0.0
        sp.set(iterations=iters, resnorm_max=resnorm_max)
    record_solve(solver, iters, resnorm_max)
    return out


def record_solve(solver: str, iterations: int, resnorm_max: float) -> None:
    """One finished solve on the metrics registry:
    ``repro_eigensolves_total{solver}``, ``repro_solver_iterations{solver}``
    and ``repro_solver_resnorm_max{solver}`` (the compressive cell reports
    here too, so a solver comparison reads one series)."""
    _SOLVES_TOTAL.inc(solver=solver)
    _SOLVER_ITERS.observe(iterations, solver=solver)
    _SOLVER_RESNORM.set(resnorm_max, solver=solver)


def _top_k_eigenpairs_impl(
    matvec: Matvec,
    n: int,
    k: int,
    generator: torch.Generator,
    *,
    device="cpu",
    solver: str = "lobpcg",
    max_iters: int = 200,
    tol: float = 1e-5,
    buffer: int = 4,
    x0=None,
    precond=None,
    stable_tol: Optional[float] = None,
    chunk_sizes: Optional[Sequence[int]] = None,
) -> EigResult:
    """Top-k eigenpairs with a small convergence buffer block.

    The start block is ``x0`` (see :func:`prepare_start_block`) or
    Gaussian columns from ``generator``. When n < 3k the blocked iteration
    cannot fit; the solve falls back to a dense exact eigendecomposition.
    ``x0``, ``precond`` and ``stable_tol`` apply to the LOBPCG family and
    ``"auto"``.

    ``solver="auto"``: one randomized block-Krylov pass (3 block
    mat-vecs); if its top-k residuals meet ``tol`` that is the answer,
    otherwise LOBPCG continues warm-started from the sketch with the
    preconditioner and the adaptive stop (``stable_tol``, default 1e-3);
    ``iterations`` is the sum over both. ``solver="lanczos"`` honours
    ``tol`` and reports its Krylov basis size; ``buffer`` does not apply to
    it.

    With ``chunk_sizes``, ``matvec`` maps a ``ChunkedDense`` to a
    ``ChunkedDense`` over that chunking, the start block is drawn chunk by
    chunk from ``generator`` (a CPU generator; never an (N, b) array) or
    made from ``x0``, and ``vectors`` are a ``ChunkedDense``:
    :func:`lobpcg_host_chunked` for ``"lobpcg"`` or ``"lobpcg_host"``,
    :func:`_chunked_randomized_impl` for ``"randomized"``, both for
    ``"auto"``."""
    if solver == "compressive":
        raise ValueError(
            "solver='compressive' is not an iterative eigensolver — the "
            "executor routes it to repro_torch.core.compressive before the "
            "eigensolve stage (Chebyshev-filtered random signals instead "
            "of eigenpairs); run it via executor.execute / SCRBModel.fit "
            "with SCRBConfig(solver='compressive')")
    valid = set(SOLVERS) | {AUTO_SOLVER}
    if solver not in valid:
        raise ValueError(f"unknown solver {solver!r}; options {sorted(valid)}")
    if chunk_sizes is not None and solver not in CHUNKED_SOLVERS:
        raise ValueError(
            f"streaming mat-vecs require a host-driven solver "
            f"({CHUNKED_SOLVERS}), got {solver!r}")
    if 3 * k > n:
        return _dense_exact(matvec, n, k, device, chunk_sizes)
    b = lobpcg_block_width(n, k, buffer)
    auto_stable = stable_tol if stable_tol is not None else 1e-3

    def trunc(out: EigResult, iterations: Optional[int] = None) -> EigResult:
        vecs = out.vectors.take_cols(k) if chunk_sizes is not None \
            else out.vectors[:, :k].contiguous()
        return EigResult(out.theta[:k], vecs, out.resnorms[:k],
                         out.iterations if iterations is None
                         else iterations)

    if chunk_sizes is not None:
        from repro_torch.core.streaming import ChunkedDense
        if x0 is not None:
            x0c = ChunkedDense.from_array(
                prepare_start_block(x0, n, b, generator, "cpu"), chunk_sizes)
        else:
            x0c = ChunkedDense.random_normal(generator, chunk_sizes, b)
        first = x0c
        rnd_iters = 0
        if solver in ("randomized", AUTO_SOLVER):
            rnd = _chunked_randomized_impl(matvec, x0c, depth=2)
            if solver == "randomized" \
                    or float(torch.max(rnd.resnorms[:k])) <= tol:
                return trunc(rnd)
            first, rnd_iters = rnd.vectors, rnd.iterations
        out = lobpcg_host_chunked(
            matvec, first, max_iters=max_iters, tol=tol, precond=precond,
            stable_tol=auto_stable if solver == AUTO_SOLVER else stable_tol,
            stable_k=k, conv_k=k)
        return trunc(out, out.iterations + rnd_iters)

    if x0 is not None:
        x0a = prepare_start_block(x0, n, b, generator, device)
    else:
        x0a = torch.randn((n, b), generator=generator, dtype=torch.float32,
                          device=generator.device).to(device)
    if solver == AUTO_SOLVER:
        rnd = randomized(matvec, x0a, depth=2)
        if float(torch.max(rnd.resnorms[:k])) <= tol:
            return trunc(rnd)
        out = lobpcg(matvec, rnd.vectors, max_iters=max_iters, tol=tol,
                     precond=precond, stable_tol=auto_stable, stable_k=k,
                     conv_k=k)
        return trunc(out, out.iterations + rnd.iterations)
    if solver == "randomized":
        return trunc(randomized(matvec, x0a, depth=2))
    if solver == "lanczos":
        return lanczos(matvec, x0a, k, max_iters=max_iters, tol=tol)
    if solver == "subspace":
        return trunc(subspace_iteration(matvec, x0a, max_iters=max_iters,
                                        tol=tol))
    driver = lobpcg_host if solver == "lobpcg_host" else lobpcg
    return trunc(driver(matvec, x0a, max_iters=max_iters, tol=tol,
                        precond=precond, stable_tol=stable_tol, stable_k=k,
                        conv_k=k))
