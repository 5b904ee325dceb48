"""Blocked LOBPCG for the implicit operator Â = Ẑ Ẑᵀ.

The solver of the main path: a fixed-shape [X|W|P] subspace, whitened
Rayleigh–Ritz (rank-deficiency safe), soft locking by residual masking, one
block mat-vec per iteration, and diagonal (degree) preconditioning. The
block mat-vec is the Gram operator (hand-written kernels on the card); the
dense algebra around it (QR, eigh, GEMM) runs on ``torch.linalg`` and
``torch.matmul``, in full float32 — the fit turns TF32 off.

Other solvers of the JAX package (``lobpcg_host``, ``randomized``,
``auto``, ``lanczos``, ``subspace``, ``compressive``) are not yet ported
and raise.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

Matvec = Callable[[torch.Tensor], torch.Tensor]

SOLVERS = ("lobpcg",)


class EigResult(NamedTuple):
    theta: torch.Tensor      # (k,) eigenvalues, descending
    vectors: torch.Tensor    # (n, k) eigenvectors
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
) -> EigResult:
    """Top-k eigenpairs of a symmetric PSD operator. x0: (n, k) start block.

    The JAX package's ``lax.while_loop`` as a Python loop with the same
    semantics: convergence is tested every iteration on the leading
    ``conv_k`` columns (one scalar read per iteration), AX is recomputed
    exactly every 16 iterations, and a converged ``x0`` exits with
    ``iterations == 0``. ``stable_tol`` adds the adaptive stop: every
    ``check_every`` iterations the leading ``stable_k`` Ritz columns are
    compared with the last checkpoint, and the solve stops when
    1 − cos(largest principal angle) < ``stable_tol``."""
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
    while it < max_iters and float(torch.max(res[:ck])) > tol:
        _, res, w = _lobpcg_residual_block(x, ax, tol, tvec)
        aw = matvec(w)
        x, ax, p, ap = _lobpcg_rr_update(x, ax, p, ap, w, aw, k)
        if (it + 1) % 16 == 0:       # exact refresh kills recombination drift
            ax = matvec(x)
        it += 1
        if stable_tol is not None and it % check_every == 0:
            align = float(_subspace_alignment(x_chk, x, sk))
            x_chk = x
            if 1.0 - align < stable_tol:
                break
    return _lobpcg_finalize(x, ax, it)


def lobpcg_block_width(n: int, k: int, buffer: int) -> int:
    """Width of the LOBPCG iterate block X: k + buffer, capped so [X|W|P]
    fits (3·b ≤ n)."""
    return max(1, min(k + buffer, n // 3))


def _dense_exact(matvec, n, k, device) -> EigResult:
    """Exact dense eigensolve for n < 3k (no [X|W|P] subspace fits): one
    mat-vec against the identity materializes the tiny operator."""
    a = matvec(torch.eye(n, dtype=torch.float32, device=device))
    a = a.detach().cpu().numpy().astype(np.float64)
    a = 0.5 * (a + a.T)
    evals, evecs = np.linalg.eigh(a)
    kk = min(k, n)
    theta = np.pad(evals[::-1][:kk], (0, k - kk)).astype(np.float32)
    vecs = np.zeros((n, k), np.float32)
    vecs[:, :kk] = evecs[:, ::-1][:, :kk]
    as_t = lambda a: torch.as_tensor(a, device=device)
    return EigResult(as_t(theta), as_t(vecs),
                     torch.zeros((k,), dtype=torch.float32, device=device), 1)


def prepare_start_block(x0, n: int, b: int,
                        generator: torch.Generator,
                        device) -> torch.Tensor:
    """Normalize a warm start to an (n, b) block on ``device``.

    ``x0`` may be an ``EigResult`` or an (n, kx) array/tensor; extra columns
    are truncated, missing columns are padded with Gaussian columns drawn
    from ``generator`` (the QR keeps the warm columns first)."""
    if hasattr(x0, "vectors"):                       # EigResult
        x0 = x0.vectors
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
) -> EigResult:
    """Top-k eigenpairs with a small convergence buffer block.

    The start block is ``x0`` (see :func:`prepare_start_block`) or
    Gaussian columns from ``generator``. When n < 3k the blocked iteration
    cannot fit; the solve falls back to a dense exact eigendecomposition.
    Only ``solver="lobpcg"`` is ported."""
    if solver not in SOLVERS:
        raise NotImplementedError(
            f"solver={solver!r} is not yet ported to repro_torch (ported: "
            f"{SOLVERS})")
    if 3 * k > n:
        return _dense_exact(matvec, n, k, device)
    b = lobpcg_block_width(n, k, buffer)
    if x0 is not None:
        x0a = prepare_start_block(x0, n, b, generator, device)
    else:
        x0a = torch.randn((n, b), generator=generator, dtype=torch.float32,
                          device=generator.device).to(device)
    out = lobpcg(matvec, x0a, max_iters=max_iters, tol=tol, precond=precond,
                 stable_tol=stable_tol, stable_k=k, conv_k=k)
    return EigResult(out.theta[:k], out.vectors[:, :k].contiguous(),
                     out.resnorms[:k], out.iterations)
