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

import math

import numpy as np
import torch
import torch.nn.functional as F

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


def rb_hard_cases(seed: int = 0, per_kind: int = 64):
    """Planted (x, b, w) float32 triples whose quotient ``(x − b)/w`` the
    RB kernel's fast step cannot decide: for each, one of

      - ``on``: the exact quotient is an integer n;
      - ``above`` / ``below``: its float32 rounding lies one ulp above or
        below n;
      - ``cross``: the exact quotient is below n but rounds up to n, so
        ``floor`` of the float32 quotient (what the plain version takes) is
        n while that of the exact one is n − 1.

    Returns ``(x (M,), b (M,), w (M,), kinds (M,) str)`` as numpy arrays,
    ``per_kind`` triples of each kind (fewer if the seeded search finds
    fewer), found from ``seed`` by stepping x by ulps around ``b + n·w``.
    """
    rng = np.random.default_rng(seed)
    m = 1 << 16
    w = rng.uniform(0.01, 8.0, size=m).astype(np.float32)
    n = rng.integers(-5000, 5000, size=m)
    b = (rng.uniform(size=m) * w).astype(np.float32)
    base = (b.astype(np.float64) + n * w.astype(np.float64)).astype(np.float32)
    n32 = n.astype(np.float32)
    picked = {"on": [], "above": [], "below": [], "cross": []}
    for step in range(-4, 5):
        x = base.copy()
        for _ in range(abs(step)):
            x = np.nextafter(x, np.float32(np.sign(step) * np.inf))
        t = x - b                                   # float32, as the kernel
        q = t / w                                   # IEEE float32 quotient
        exact = t.astype(np.float64) - n * w.astype(np.float64)  # exact sign
        kinds = {"on": (exact == 0) & (q == n32),
                 "above": q == np.nextafter(n32, np.float32(np.inf)),
                 "below": q == np.nextafter(n32, np.float32(-np.inf)),
                 "cross": (exact < 0) & (q == n32)}
        for kind, hit in kinds.items():
            for i in np.nonzero(hit)[0]:
                picked[kind].append((x[i], b[i], w[i]))
    out = []
    for kind, rows in picked.items():
        for xi, bi, wi in rows[:per_kind]:
            out.append((xi, bi, wi, kind))
    x, b, w, kinds = zip(*out)
    return (np.array(x, np.float32), np.array(b, np.float32),
            np.array(w, np.float32), np.array(kinds))


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


def bin_counts_ref(idx: torch.Tensor, d: int) -> torch.Tensor:
    """Column occupancy of the ELL pattern: int32 (D,), out[c] = the number
    of (row, grid) entries equal to c. Entries outside [0, d) are dropped,
    as the JAX package's scatter drops them."""
    flat = idx.reshape(-1).long()
    flat = flat[(flat >= 0) & (flat < d)]
    return torch.bincount(flat, minlength=d).to(torch.int32)


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


def kmeans_assign_stats_ref(
    x: torch.Tensor,          # (N, d) float32
    centroids: torch.Tensor,  # (K, d) float32
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The assignment and the Lloyd step's statistics: (labels int32 (N,),
    counts float32 (K,), sums float32 (K, d), inertia float32 ()).

    Counts by ``bincount``, sums by a one-hot (N, K)ᵀ·x product, never by
    float atomics: the arithmetic of the port's Lloyd step before the
    kernel had a statistics form."""
    labels, dists = kmeans_assign_ref(x, centroids)
    k = centroids.shape[0]
    counts = torch.bincount(labels, minlength=k).to(torch.float32)
    onehot = F.one_hot(labels.long(), k).to(torch.float32)     # (N, K)
    return labels, counts, onehot.T @ x, torch.sum(dists)


#: Elements of float32 scores one step of the plain attention holds (1 GiB).
_SCORE_ELEMS = 1 << 28


def flash_attention_ref(
    q: torch.Tensor,          # (BH, S, hd)
    k: torch.Tensor,          # (BH, T, hd)
    v: torch.Tensor,          # (BH, T, hd)
    *,
    causal: bool = True,
    window=None,
) -> torch.Tensor:
    """Dense softmax attention, the flash kernel's plain version.

    Scores in float32 (bf16 inputs are exact in float32), masked to -1e30
    (causal: ``kpos <= qpos``; window: ``kpos > qpos - window``, positions
    from 0 for both), softmax in float32, probabilities cast to ``v``'s
    dtype and multiplied in float32, output in ``q``'s dtype. Runs over
    (batch·head) in steps of at most 2^28 score elements."""
    bh, s_len, hd = q.shape
    t_len = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qpos = torch.arange(s_len, device=q.device)[:, None]
    kpos = torch.arange(t_len, device=q.device)[None, :]
    allow = torch.ones((s_len, t_len), dtype=torch.bool, device=q.device)
    if causal:
        allow &= kpos <= qpos
    if window is not None:
        allow &= kpos > qpos - window
    out = torch.empty_like(q)
    step = max(1, _SCORE_ELEMS // max(s_len * t_len, 1))
    for i in range(0, bh, step):
        scores = torch.matmul(q[i:i + step].float(),
                              k[i:i + step].float().transpose(1, 2)) * scale
        scores = scores.masked_fill_(~allow, -1e30)
        probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
        del scores
        out[i:i + step] = torch.matmul(probs, v[i:i + step].float()).to(q.dtype)
    return out


def flash_attention_bshd_ref(
    q: torch.Tensor,          # (B, S, H, hd)
    k: torch.Tensor,          # (B, T, Hkv, hd), Hkv divides H
    v: torch.Tensor,          # (B, T, Hkv, hd)
    *,
    causal: bool = True,
    window=None,
) -> torch.Tensor:
    """``flash_attention_ref`` in ``ops.flash_attention``'s layout: head
    ``h`` reads kv head ``h // (H // Hkv)``. Returns (B, S, H, hd)."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    fold = lambda x: x.transpose(1, 2).reshape(b * h, x.shape[1], hd)
    k, v = (x.repeat_interleave(rep, dim=2) for x in (k, v))
    out = flash_attention_ref(fold(q), fold(k), fold(v), causal=causal,
                              window=window)
    return out.reshape(b, h, s, hd).transpose(1, 2).contiguous()


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (batched) accumulated and returned in float32: float32
    operands as they are; bf16 ones on the card through cuBLAS's
    float32-output product (``aten::bmm.dtype``: the tensor cores' rate, no
    rounding of the result), on the CPU upcast first (that op has no CPU
    kernel; the same products, exact in float32)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _split(x: torch.Tensor, dtype: torch.dtype):
    """float32 ``x`` as operands of ``dtype``: itself in float32; else a
    head hi = x rounded and a tail lo = (x − hi) rounded, whose products
    sum to x's within ~2^-16 relative (a bf16 operand alone keeps 2^-8,
    and dS sums to 0 along a row, so its rounding does not cancel in dQ).
    ``x`` is overwritten."""
    if dtype == torch.float32:
        return (x,)
    hi = x.to(dtype)
    return hi, x.sub_(hi).to(dtype)        # hi read as float32 in place


def flash_attention_bwd_ref(
    q: torch.Tensor,          # (B, S, H, hd)
    k: torch.Tensor,          # (B, T, Hkv, hd), Hkv divides H
    v: torch.Tensor,          # (B, T, Hkv, hd)
    dout: torch.Tensor,       # (B, S, H, hd): the output's gradient
    *,
    causal: bool = True,
    window=None,
    chunk: int = 512,
):
    """Gradients (dq, dk, dv) of ``flash_attention_bshd_ref``, in the
    inputs' dtypes, recomputed ``chunk`` query rows at a time (the JAX
    package's ``jax.checkpoint``-ed attention recomputes its probabilities
    in the backward the same way; it has no backward kernel).

    Per chunk, for each kv head with its group of query heads side by side
    (so the products against K and V sum dk and dv over the group): scores
    in float32, masked to -1e30, softmax P in float32; dV += P (in V's
    dtype)ᵀ dO; dP = dO Vᵀ; dS = P ∘ (dP − rowsum(dP ∘ P)) in float32;
    dQ = dS K · scale and dK += dSᵀ Q · scale. Every product takes the
    inputs' dtype as operands and accumulates in float32 (bf16 on the
    tensor cores); dS goes in as two such operands, its rounding and the
    rest (``_split``: the reference's dS products take float32 dS), so dQ
    and dK cost two products each; dK and dV sum over the chunks in
    float32.
    Only the keys a chunk can see ([lo, hi): causal and window) are read,
    and without a window only the chunk's last keys need the mask."""
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep, g = h // hkv, b * hkv
    scale = 1.0 / math.sqrt(hd)
    kg = k.permute(0, 2, 1, 3).reshape(g, t, hd)
    vg = v.permute(0, 2, 1, 3).reshape(g, t, hd)

    def grouped(x, c0, c):
        # (B, c, H, hd) → (B·Hkv, rep·c, hd): row r·c + i is head
        # kv·rep + r at query c0 + i
        return x[:, c0:c0 + c].reshape(b, c, hkv, rep, hd).permute(
            0, 2, 3, 1, 4).reshape(g, rep * c, hd)

    dq = torch.empty_like(q)
    dk = torch.zeros((g, t, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    kpos = torch.arange(t, device=q.device)
    # rows that see no key get the plain version's uniform softmax over all
    # T keys: read them all
    keyless = window is not None and s >= t + window
    for c0 in range(0, s, chunk):
        c = min(chunk, s - c0)
        lo = max(0, c0 - window + 1) if window is not None else 0
        hi = min(t, c0 + c) if causal else t
        if keyless or lo >= hi:
            lo, hi = 0, t
        qc, doc = grouped(q, c0, c), grouped(dout, c0, c)
        kc, vc = kg[:, lo:hi], vg[:, lo:hi]
        sc = bmm_f32(qc, kc.transpose(1, 2)).mul_(scale)
        qpos = c0 + torch.arange(c, device=q.device)[:, None]
        # without a window the keys before c0 are seen by every row
        m0 = c0 - lo if causal and window is None and not keyless \
            and c0 >= lo else 0
        kp = kpos[lo + m0:hi]
        allow = torch.ones((c, hi - lo - m0), dtype=torch.bool,
                           device=q.device)
        if causal:
            allow &= kp <= qpos
        if window is not None:
            allow &= kp > qpos - window
        sc.view(g, rep, c, hi - lo)[..., m0:].masked_fill_(~allow, -1e30)
        p = torch.softmax(sc, dim=-1)
        del sc
        dv[:, lo:hi] += bmm_f32(p.to(v.dtype).transpose(1, 2), doc)
        ds = bmm_f32(doc, vc.transpose(1, 2))                  # dP
        ds.sub_((ds * p).sum(-1, keepdim=True)).mul_(p)
        del p
        dqc = torch.zeros((g, rep * c, hd), dtype=torch.float32,
                          device=q.device)
        for part in _split(ds, q.dtype):
            dk[:, lo:hi] += bmm_f32(part.transpose(1, 2), qc)
            dqc += bmm_f32(part, kc)
        del ds
        dqc.mul_(scale)
        dq[:, c0:c0 + c] = dqc.view(b, hkv, rep, c, hd).permute(
            0, 3, 1, 2, 4).reshape(b, c, h, hd)
    dk.mul_(scale)
    back = lambda x: x.view(b, hkv, t, hd).permute(0, 2, 1, 3)
    return dq, back(dk).to(k.dtype).contiguous(), \
        back(dv).to(v.dtype).contiguous()
