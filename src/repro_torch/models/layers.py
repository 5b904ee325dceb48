"""Layer pieces of the LM stack: RMSNorm, SwiGLU, RoPE (with partial
rotary and M-RoPE), causal attention, the GQA and MLA attention blocks, the
MLP block, the MoE FFN, the Mamba2 SSD mixer and the Hymba hybrid mixer.

Conventions (the JAX package's, ``repro.models.layers``):
  - projections are stored flat (D, H·hd) and applied as ``x @ w``;
  - weights are held in the config's compute dtype for serving; training
    holds float32 masters and casts them to that dtype under autograd
    (``transformer.forward_hidden(training=True)``), so every piece here
    is differentiable;
  - KV caches are flat (B, T, Hkv·hd), MLA's compressed ones (B, T,
    kv_lora_rank) and (B, T, qk_rope_dim), an SSM's ``state`` (B, H, N, P)
    float32 and ``conv`` (B, K−1, C). This port writes them in place (JAX
    returns updated copies), which saves a cache-sized copy per layer.

Attention: the uncached case (no cache, T == S, no offset) — the attention
of a prompt, and of a training batch — goes to
``kernels.ops.flash_attention``, the hand-written kernel on a CUDA tensor
(with a plain PyTorch backward when a gradient is needed) and its plain
version on a CPU tensor. The cached
case (decode: queries against the cache, masked to its valid prefix) is
plain PyTorch, the grouped einsum of the JAX package, which computes it
outside any Pallas kernel too. MLA (DeepSeek-V2), the MoE FFN
(DeepSeekMoE) and the Mamba2 SSD scan reach no Pallas kernel in the JAX
package either (einsums, a sort and scatters, a chunked scan), and are
plain PyTorch here too.

On a mesh (``models.sharding.Layout``) the blocks read their head counts
and widths from their weights' shapes, which are this rank's share when a
block runs split over the model axis (a GQA's query and KV heads may be
dealt unevenly, ``sharding.head_ranges``); such a block's ``tp`` (a
``sharding.ModelSplit``) marks its entry and its partial output, which is
all-reduced (or, on a training step whose residual is split over the
sequence, the split passed as ``tp=``: the entry all-gathers the sequence
and the partial output is reduce-scattered over it). An MLA split over
the model axis runs its own heads on the latent that every model rank
computes alike. An MoE split over the model axis holds this rank's share
of the routed experts (expert parallelism): it routes every token over all
experts, alike on every model rank, runs its own experts' slots, and sums
its partial output over the axis through the same exit. An SSM split over
the model axis scans its own SSD heads (dealt evenly or not,
``sharding.ssm_heads``) with the B and C that every rank computes alike,
and sums its gated norm's squares over the axis (``ModelSplit.total``). A
hybrid whose two branches both run split enters once and sums the two
partial outputs in one collective (``row_parallel_apart``) before each
branch's norm. The reference's ``shard_hint`` has no other counterpart.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30
Cache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def row_parallel(x: torch.Tensor, w: torch.Tensor, tp,
                 plus: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w for a block split over the model axis (``tp``, a
    ``sharding.ModelSplit``): each rank's partial product over its share
    of the inner dim, summed by ``tp.exit`` (an all-reduce, or a
    reduce-scatter over the sequence). ``plus``: another partial output of
    this rank (an MoE's routed experts'), added to the product over the
    axis in the same collective. Serving forms the partials in float32
    (``ref.bmm_f32``; ``plus`` float32 too) and rounds each sum once, as
    one card's product rounds once, then adds the two rounded sums, as one
    card adds its routed and shared experts' outputs; training keeps the
    compute dtype (that float32-output product has no derivative)."""
    y = _partial(x, w)
    if torch.is_grad_enabled():
        return tp.exit(y if plus is None else y + plus)
    if plus is None:
        return tp.exit(y).to(x.dtype)
    both = tp.exit(torch.cat([y, plus.float()], -1)).to(x.dtype)
    return both[..., w.shape[1]:] + both[..., :w.shape[1]]


def row_parallel_apart(pairs, tp) -> Tuple[torch.Tensor, ...]:
    """``row_parallel`` of several (x, w) of one block (a hybrid's two
    branches) through one collective: the partial products side by side
    along the last dim, summed by one ``tp.exit``, then split apart; each
    sum rounded once in serving, as ``row_parallel`` rounds its own."""
    both = tp.exit(torch.cat([_partial(x, w) for x, w in pairs], -1))
    if not torch.is_grad_enabled():
        both = both.to(pairs[0][0].dtype)
    return both.split([w.shape[1] for _, w in pairs], -1)


def _partial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row-parallel partial product x @ w: in the compute dtype while
    training, float32 in serving (``ref.bmm_f32``)."""
    if torch.is_grad_enabled():
        return x @ w
    return ref.bmm_f32(x.reshape(1, -1, x.shape[-1]), w[None]).reshape(
        *x.shape[:-1], w.shape[1])


def normal_(w: torch.Tensor, generator: torch.Generator,
            scale: float = 0.02) -> torch.Tensor:
    """Fill ``w`` with N(0, scale²) drawn in float32 from ``generator`` (the
    JAX package's ``_init``), rounded to ``w``'s dtype."""
    draw = torch.randn(w.shape, generator=generator, device=w.device,
                       dtype=torch.float32)
    with torch.no_grad():
        return w.copy_(draw.mul_(scale))


def param(*shape: int, device, dtype, fill: Optional[float] = None
            ) -> nn.Parameter:
    w = torch.empty(shape, device=device, dtype=dtype)
    if fill is not None:
        w.fill_(fill)
    return nn.Parameter(w, requires_grad=False)


# ---------------------------------------------------------------------------
# RoPE (+ partial rotary)
# ---------------------------------------------------------------------------

def rope_tables(
    positions: torch.Tensor,         # (B, S), or (3, B, S) for M-RoPE
    rotary_dim: int,
    theta: float,
    mrope_sections: Optional[Tuple[int, int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (B, S, rotary_dim/2), float32.

    M-RoPE (Qwen2-VL): positions (3, B, S) hold the temporal, height and
    width streams, and stream i owns the i-th run of ``mrope_sections``
    frequencies. (B, S) positions take the plain path whatever
    ``mrope_sections`` is, as in the JAX package."""
    half = rotary_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * freqs          # (..., B, S, half)
    if positions.dim() == 3:
        if mrope_sections is None or sum(mrope_sections) != half \
                or positions.shape[0] != len(mrope_sections):
            raise ValueError(f"positions {tuple(positions.shape)} need M-RoPE "
                             f"sections summing to {half}, got "
                             f"{mrope_sections}")
        ang = torch.cat([a[..., i0:i0 + n] for a, i0, n in zip(
            ang, (0, mrope_sections[0], sum(mrope_sections[:2])),
            mrope_sections)], dim=-1)
    elif positions.dim() != 2:
        raise ValueError(f"positions must be (B, S) or (3, B, S), got "
                         f"{tuple(positions.shape)}")
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate the first 2·half dims of x (B, S, H, hd); rest pass through."""
    half = cos.shape[-1]
    x1 = x[..., :half].float()
    x2 = x[..., half:2 * half].float()
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    rot = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return torch.cat([rot.to(x.dtype), x[..., 2 * half:]], dim=-1)


# ---------------------------------------------------------------------------
# core attention
# ---------------------------------------------------------------------------

def causal_attention(
    q: torch.Tensor,                 # (B, S, H, hd)
    k: torch.Tensor,                 # (B, T, Hkv, hd)
    v: torch.Tensor,                 # (B, T, Hkv, hd)
    *,
    q_offset: int = 0,               # position of q[0] in the kv timeline
    window: Optional[int] = None,
    chunk: int = 512,
    kv_len: Optional[int] = None,    # valid kv prefix (decode with cache)
) -> torch.Tensor:
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if kv_len is None and t == s and q_offset == 0:
        return ops.flash_attention(q, k, v, causal=True, window=window)
    if kv_len is not None:
        # keys at or past kv_len get probability exactly 0: leave them out
        k, v, t = k[:, :kv_len], v[:, :kv_len], kv_len
    rep = h // hkv
    scale = 1.0 / math.sqrt(hd)
    kpos = torch.arange(t, device=q.device)
    # float32 scores and products, as preferred_element_type=float32
    kf, vf = k.float(), v.float()
    outs = []
    for c0 in range(0, s, chunk):
        qc = q[:, c0:c0 + chunk]
        c = qc.shape[1]
        qpos = q_offset + c0 + torch.arange(c, device=q.device)
        qg = qc.reshape(b, c, hkv, rep, hd).float()
        scores = torch.einsum("bcgrd,btgd->bgrct", qg, kf) * scale
        allow = kpos[None, :] <= qpos[:, None]
        if window is not None:
            allow &= kpos[None, :] > qpos[:, None] - window
        scores = scores.masked_fill(~allow, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
        out = torch.einsum("bgrct,btgd->bcgrd", probs, vf)
        outs.append(out.reshape(b, c, h, hd).to(q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """Grouped-query attention with optional QKV bias and QK norm."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.cfg = cfg
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.wq = param(d, h * hd, **kw)
        self.wk = param(d, hkv * hd, **kw)
        self.wv = param(d, hkv * hd, **kw)
        self.wo = param(h * hd, d, **kw)
        if cfg.qkv_bias:
            self.bq = param(h * hd, fill=0.0, **kw)
            self.bk = param(hkv * hd, fill=0.0, **kw)
            self.bv = param(hkv * hd, fill=0.0, **kw)
        if cfg.qk_norm:
            self.q_norm = param(hd, fill=1.0, **kw)
            self.k_norm = param(hd, fill=1.0, **kw)
        self.tp = None       # a sharding.ModelSplit when split over heads

    def forward(
        self,
        x: torch.Tensor,                 # (B, S, D)
        cos: torch.Tensor, sin: torch.Tensor,
        *,
        window: Optional[int] = None,
        cache: Optional[Cache] = None,   # {"k","v"} flat (B, T, Hkv·hd)
        pos: Optional[int] = None,       # write offset into the cache
        tp=None,                         # the split to run through, if
                                         # not self.tp's (see MLP.forward)
    ) -> Tuple[torch.Tensor, Optional[Cache]]:
        tp = self.tp if tp is None else tp
        if tp is not None:
            x = tp.enter(x)
        out, cache = self.attend(x, cos, sin, window=window, cache=cache,
                                 pos=pos)
        if tp is not None:
            return row_parallel(out, self.wo, tp), cache
        return out @ self.wo, cache

    def attend(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               *, window: Optional[int] = None,
               cache: Optional[Cache] = None, pos: Optional[int] = None
               ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """The heads' output (B, S, h·hd) before ``wo``, from x as it
        entered the block (this rank's heads when it runs split)."""
        cfg = self.cfg
        hd = cfg.head_dim
        h, hkv = self.wq.shape[1] // hd, self.wk.shape[1] // hd
        b, s, _ = x.shape
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = q.reshape(b, s, h, hd)
        k = k.reshape(b, s, hkv, hd)
        v = v.reshape(b, s, hkv, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, self.q_norm, cfg.norm_eps)
            k = rmsnorm(k, self.k_norm, cfg.norm_eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        if cache is None:
            out = causal_attention(q, k, v, window=window,
                                   chunk=cfg.attn_chunk)
        else:
            t = cache["k"].shape[1]
            if pos < 0 or pos + s > t:
                raise ValueError(f"positions [{pos}, {pos + s}) do not fit a "
                                 f"cache of {t}")
            cache["k"][:, pos:pos + s] = k.reshape(b, s, hkv * hd)
            cache["v"][:, pos:pos + s] = v.reshape(b, s, hkv * hd)
            if pos == 0:
                # the prompt: the cache's valid prefix holds exactly these
                # k and v, so this is the cached attention with kv_len = s
                out = causal_attention(q, k, v, window=window,
                                       chunk=cfg.attn_chunk)
            else:
                out = causal_attention(
                    q, cache["k"].view(b, t, hkv, hd),
                    cache["v"].view(b, t, hkv, hd), q_offset=pos,
                    window=window, chunk=cfg.attn_chunk, kv_len=pos + s)
        return out.reshape(b, s, h * hd), cache


def init_gqa(cfg: ModelConfig, generator: torch.Generator, *,
             dtype: torch.dtype = torch.float32) -> GQA:
    p = GQA(cfg, device=generator.device, dtype=dtype)
    normal_(p.wq, generator)
    normal_(p.wk, generator)
    normal_(p.wv, generator)
    normal_(p.wo, generator, 0.02 / math.sqrt(2 * cfg.n_layers))
    return p


def apply_gqa(cfg: ModelConfig, p: GQA, x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, *, window: Optional[int] = None,
              cache: Optional[Cache] = None, pos: Optional[int] = None
              ) -> Tuple[torch.Tensor, Optional[Cache]]:
    return p(x, cos, sin, window=window, cache=cache, pos=pos)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU feed-forward block."""

    def __init__(self, cfg: ModelConfig, d_ff: Optional[int] = None, *,
                 device=None, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        kw = dict(device=device, dtype=dtype)
        self.wg = param(d, f, **kw)
        self.wu = param(d, f, **kw)
        self.wd = param(f, d, **kw)
        self.tp = None       # a sharding.ModelSplit when split over its width

    def forward(self, x: torch.Tensor, tp=None) -> torch.Tensor:
        """``tp``: the split to enter and exit through instead of
        ``self.tp`` (a training step whose residual is split over the
        sequence passes the layout's sequence split)."""
        tp = self.tp if tp is None else tp
        if tp is None:
            return swiglu(x, self.wg, self.wu, self.wd)
        return self.split(tp.enter(x), tp)

    def split(self, x: torch.Tensor, tp,
              plus: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The block's output from ``x`` as it entered through split
        ``tp``: this rank's columns of wg and wu, its rows of wd, summed
        over the axis with ``plus`` (``row_parallel``)."""
        return row_parallel(F.silu(x @ self.wg) * (x @ self.wu), self.wd,
                            tp, plus)


def init_mlp(cfg: ModelConfig, generator: torch.Generator,
             d_ff: Optional[int] = None, *,
             dtype: torch.dtype = torch.float32) -> MLP:
    p = MLP(cfg, d_ff, device=generator.device, dtype=dtype)
    normal_(p.wg, generator)
    normal_(p.wu, generator)
    normal_(p.wd, generator, 0.02 / math.sqrt(2 * cfg.n_layers))
    return p


def apply_mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    return p(x)


def add_to(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b, written into a unless autograd records: under ``remat="dots"``
    a matrix product's output is kept for the backward and must not
    change, so a sum onto one goes out of place while training."""
    return a + b if torch.is_grad_enabled() else a.add_(b)


# ---------------------------------------------------------------------------
# float32 products of low-precision operands
# ---------------------------------------------------------------------------

def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, m, k) @ (N, k, n) as float32: the JAX package's
    ``preferred_element_type=float32`` (``ref.bmm_f32``: bf16 operands on
    the card through cuBLAS's float32-output product). Where a gradient is
    needed the operands are upcast first, since that product has no
    derivative: the same products, exact in float32."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return torch.bmm(a.float(), b.float())
    return ref.bmm_f32(a, b)


# ---------------------------------------------------------------------------
# MLA attention block (DeepSeek-V2): low-rank compressed KV cache
# ---------------------------------------------------------------------------

def mla_scores(q_lat: torch.Tensor, q_rope: torch.Tensor, ckv: torch.Tensor,
               kr: torch.Tensor) -> torch.Tensor:
    """Unscaled float32 scores (B, H, C, T) of the absorbed queries
    q_lat (B, H, C, lo) and rotary queries q_rope (B, H, C, dr) against the
    latent keys ckv (B, T, lo) and rotary keys kr (B, T, dr)."""
    b, h, c, lo = q_lat.shape
    dr, t = q_rope.shape[-1], ckv.shape[1]
    sc = bmm_f32(q_lat.reshape(b, h * c, lo), ckv.transpose(1, 2))
    sc = add_to(sc, bmm_f32(q_rope.reshape(b, h * c, dr),
                            kr.transpose(1, 2)))
    return sc.view(b, h, c, t)


class MLA(nn.Module):
    """Multi-head latent attention: keys and values live in one compressed
    latent (``kv_lora_rank``) plus a shared rotary key, and the cache holds
    only those.

    Split over the model axis (``tp``, a ``sharding.ModelSplit``), wq
    holds this rank's heads' columns, w_uk and w_uv their columns, wo
    their rows; the latent and the rotary key, which every head reads,
    are computed alike on every model rank, and the heads' partial output
    is summed over the axis by ``row_parallel``."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.cfg = cfg
        d, h, m = cfg.d_model, cfg.n_heads, cfg.mla
        kw = dict(device=device, dtype=dtype)
        self.wq = param(d, h * (m.qk_nope_dim + m.qk_rope_dim), **kw)
        self.w_dkv = param(d, m.kv_lora_rank + m.qk_rope_dim, **kw)
        self.kv_ln = param(m.kv_lora_rank, fill=1.0, **kw)
        self.w_uk = param(m.kv_lora_rank, h * m.qk_nope_dim, **kw)
        self.w_uv = param(m.kv_lora_rank, h * m.v_dim, **kw)
        self.wo = param(h * m.v_dim, d, **kw)
        self.tp = None       # a sharding.ModelSplit when split over heads

    def forward(
        self,
        x: torch.Tensor,                 # (B, S, D)
        cos: torch.Tensor, sin: torch.Tensor,
        *,
        window: Optional[int] = None,
        cache: Optional[Cache] = None,   # {"ckv": (B,T,lo), "kr": (B,T,dr)}
        pos: Optional[int] = None,       # write offset into the cache
        tp=None,                         # the split to run through, if
                                         # not self.tp's (see MLP.forward)
    ) -> Tuple[torch.Tensor, Optional[Cache]]:
        cfg, m = self.cfg, self.cfg.mla
        tp = self.tp if tp is None else tp
        dn, dr, dv, lo = m.qk_nope_dim, m.qk_rope_dim, m.v_dim, m.kv_lora_rank
        # this rank's heads when the block runs split over the model axis
        h = self.wq.shape[1] // (dn + dr)
        if tp is not None:
            x = tp.enter(x)
        b, s, _ = x.shape
        scale = 1.0 / math.sqrt(dn + dr)

        q = (x @ self.wq).reshape(b, s, h, dn + dr)
        q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], cos, sin)
        dkv = x @ self.w_dkv                                 # (B, S, lo+dr)
        ckv = rmsnorm(dkv[..., :lo], self.kv_ln, cfg.norm_eps)
        kr = apply_rope(dkv[..., lo:][:, :, None, :], cos, sin)[:, :, 0]
        # absorbed scoring: q_nope projected into the latent space once, so
        # the keys stay compressed
        q_lat = torch.einsum("bshn,lhn->bhsl", q_nope,
                             self.w_uk.reshape(lo, h, dn))
        q_rope = q_rope.transpose(1, 2)                      # (B, H, S, dr)

        q_off = 0
        if cache is not None:
            t = cache["ckv"].shape[1]
            if pos < 0 or pos + s > t:
                raise ValueError(f"positions [{pos}, {pos + s}) do not fit a "
                                 f"cache of {t}")
            cache["ckv"][:, pos:pos + s] = ckv
            cache["kr"][:, pos:pos + s] = kr
            if pos > 0:
                # keys at or past pos + s get probability exactly 0: leave
                # them out
                ckv, kr = cache["ckv"][:, :pos + s], cache["kr"][:, :pos + s]
                q_off = pos
        t = ckv.shape[1]
        kpos = torch.arange(t, device=x.device)
        outs = []
        for c0 in range(0, s, cfg.attn_chunk):
            c = min(cfg.attn_chunk, s - c0)
            # causal: keys past the chunk's last query get probability 0
            hi = min(t, q_off + c0 + c)
            qpos = q_off + c0 + torch.arange(c, device=x.device)
            sc = mla_scores(q_lat[:, :, c0:c0 + c], q_rope[:, :, c0:c0 + c],
                            ckv[:, :hi], kr[:, :hi]) * scale
            allow = kpos[None, :hi] <= qpos[:, None]
            if window is not None:
                allow &= kpos[None, :hi] > qpos[:, None] - window
            sc = sc.masked_fill(~allow, NEG_INF)
            pr = torch.softmax(sc, dim=-1).to(x.dtype)
            outs.append(torch.bmm(pr.view(b, h * c, hi),
                                  ckv[:, :hi]).view(b, h, c, lo))
        o_lat = torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]
        out = torch.einsum("bhsl,lhv->bshv", o_lat,
                           self.w_uv.reshape(lo, h, dv)).reshape(b, s, h * dv)
        if tp is not None:
            return row_parallel(out, self.wo, tp), cache
        return out @ self.wo, cache


def init_mla(cfg: ModelConfig, generator: torch.Generator, *,
             dtype: torch.dtype = torch.float32) -> MLA:
    p = MLA(cfg, device=generator.device, dtype=dtype)
    normal_(p.wq, generator)
    normal_(p.w_dkv, generator)
    normal_(p.w_uk, generator)
    normal_(p.w_uv, generator)
    normal_(p.wo, generator, 0.02 / math.sqrt(2 * cfg.n_layers))
    return p


def apply_mla(cfg: ModelConfig, p: MLA, x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, *, window: Optional[int] = None,
              cache: Optional[Cache] = None, pos: Optional[int] = None
              ) -> Tuple[torch.Tensor, Optional[Cache]]:
    return p(x, cos, sin, window=window, cache=cache, pos=pos)


# ---------------------------------------------------------------------------
# MoE FFN (DeepSeekMoE): top-k routed experts + shared experts
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """Routed experts ``experts.{wg, wu, wd}`` (E, D, Fe) / (E, Fe, D), a
    router (D, E) and the shared experts as one SwiGLU of width
    n_shared·Fe.

    Split over the model axis (``tp``, a ``sharding.ModelSplit``), the
    expert stacks hold this rank's E/m experts and the shared SwiGLU its
    columns of wg, wu and rows of wd. The router sees the same input on
    every model rank (after ``tp.enter``) and picks the same experts and
    capacity drops there, as one card does; each rank runs the slots of its
    own experts (``first_expert`` onward), the others add exact zeros, and the
    routed partial output crosses the axis in the shared experts' exit
    (``MLP.split``): one collective."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.cfg = cfg
        mo = cfg.moe
        d, e, fe = cfg.d_model, mo.n_routed, mo.d_expert
        kw = dict(device=device, dtype=dtype)
        self.router = param(d, e, **kw)
        self.experts = nn.Module()
        self.experts.wg = param(e, d, fe, **kw)
        self.experts.wu = param(e, d, fe, **kw)
        self.experts.wd = param(e, fe, d, **kw)
        self.shared = MLP(cfg, mo.n_shared * fe, **kw)
        # a sharding.BatchStats on a mesh: the aux loss's global statistics
        self.batch_stats = None
        self.tp = None       # a sharding.ModelSplit when split over experts

    def forward(self, x: torch.Tensor, tp=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``tp``: the split to enter and exit through instead of
        ``self.tp`` (a training step whose residual is split over the
        sequence passes the layout's sequence split)."""
        tp = self.tp if tp is None else tp
        if tp is None:
            probs, gates, eidx = moe_route(self.cfg, self, x)
            out = moe_experts(self.cfg, self, x, gates, eidx)
            return out + self.shared(x), moe_aux(self.cfg, probs, eidx,
                                                 self.batch_stats)
        x = tp.enter(x)
        probs, gates, eidx = moe_route(self.cfg, self, x)
        # serving sums the routed slots in float32, a partial that
        # row_parallel rounds once over the axis, as one card rounds them
        routed = moe_experts(self.cfg, self, x, gates, eidx,
                             first=first_expert(self, tp),
                             acc=None if torch.is_grad_enabled()
                             else torch.float32)
        # every model rank computes the same aux loss from the same routing:
        # its gradient is shared out, so the entry's sum counts it once
        aux = tp.once(moe_aux(self.cfg, probs, eidx, self.batch_stats))
        # the routed partial joins the shared experts' exit
        return self.shared.split(x, tp, plus=routed), aux


def moe_capacity(cfg: ModelConfig, s: int) -> int:
    """Slots per expert and group: ceil(S·k·capacity_factor / E), at least
    1 (480 at S = 4,096 and DeepSeek's 64 experts, top 6; 1 at decode)."""
    mo = cfg.moe
    return max(int(math.ceil(s * mo.top_k * mo.capacity_factor
                             / mo.n_routed)), 1)


def moe_route(cfg: ModelConfig, p: MoE, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router probabilities (B, S, E) float32, the top-k gates (B, S, k)
    renormalised by their sum, and the experts they pick (B, S, k)."""
    logits = (x @ p.router).float()
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, eidx


def moe_slots(cfg: ModelConfig, eidx: torch.Tensor, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per group (a batch row), the S·k slots sorted stably by expert and
    ranked within it: (rank (B, S, k), keep = rank < cap). Token order
    breaks ties, so the capacity drops the latest tokens of an overfull
    expert."""
    g, s, k = eidx.shape
    e_flat = eidx.reshape(g, s * k)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    counts = torch.zeros((g, cfg.moe.n_routed), dtype=torch.int64,
                         device=eidx.device)
    counts.scatter_add_(1, e_sorted, torch.ones_like(e_sorted))
    offsets = counts.cumsum(-1) - counts
    rank_sorted = torch.arange(s * k, device=eidx.device)[None] \
        - torch.gather(offsets, 1, e_sorted)
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    rank = rank.view(g, s, k)
    return rank, rank < cap


def first_expert(p: MoE, tp) -> int:
    """The first of the experts whose stacks ``p`` holds on the model rank
    of split ``tp``: the rule splits the expert dim over ``model`` in rank
    order, so rank r holds experts [r·E/m, (r+1)·E/m)."""
    return tp.index * p.experts.wg.shape[0]


def moe_experts(cfg: ModelConfig, p: MoE, x: torch.Tensor,
                gates: torch.Tensor, eidx: torch.Tensor, *, first: int = 0,
                acc: Optional[torch.dtype] = None) -> torch.Tensor:
    """The routed experts' gated output (B, S, D) for the given routing.

    Dispatch: every kept slot's token row is copied to its own row of an
    (E, B·cap, D) buffer (unused rows stay 0), so the three expert products
    are batched matrix products over E. Combine: each token gathers its k
    rows and adds them in a fixed order (in ``acc``, float32 for a partial
    summed over ranks later; by default x's dtype). Neither step adds with
    atomics, so the output is the same bits on every run; a dropped slot's
    weight is 0, so it adds exact zeros, as in the JAX package's
    scatter-add.

    ``p``'s stacks may hold experts ``first`` onward alone (a model rank's
    share, ``first_expert``): the buffer then has their rows alone, and a
    slot of another expert is treated as dropped, its token copied nowhere
    and its weight 0. The capacity ranks come from the routing over all
    experts, so a kept slot is the one card's."""
    mo = cfg.moe
    g, s, d = x.shape
    e, k = p.experts.wg.shape[0], mo.top_k
    cap = moe_capacity(cfg, s)
    rank, keep = moe_slots(cfg, eidx, cap)
    local = eidx - first
    keep = keep & (local >= 0) & (local < e)
    local = local.clamp(0, e - 1)
    rows = e * g * cap
    grp = torch.arange(g, device=x.device)[:, None, None]
    dest = local * (g * cap) + grp * cap + rank.clamp(0, cap - 1)
    # buffer row -> the token filling it; empty rows (and, through the
    # spare last entry, every dropped slot) point at a zero row
    tok = torch.arange(g * s, device=x.device).view(g, s, 1).expand(g, s, k)
    fill = torch.full((rows + 1,), g * s, dtype=torch.int64, device=x.device)
    fill[torch.where(keep, dest, rows).reshape(-1)] = tok.reshape(-1)
    xz = torch.cat([x.reshape(g * s, d), x.new_zeros((1, d))])
    eb = xz[fill[:rows]].view(e, g * cap, d)
    we = p.experts
    h = F.silu(torch.bmm(eb, we.wg)) * torch.bmm(eb, we.wu)
    y = torch.bmm(h, we.wd).view(rows, d)
    w = (gates * keep).to(x.dtype)
    return (y[dest] * w[..., None]).sum(dim=2, dtype=acc)


def moe_aux(cfg: ModelConfig, probs: torch.Tensor, eidx: torch.Tensor,
            stats=None) -> torch.Tensor:
    """Switch-style load-balance loss E · Σ_e f_e p̄_e · router_aux_weight,
    f_e the share of all B·S·k slots routed to e (dropped ones too).

    With the batch split over ranks (``stats``, a ``sharding.BatchStats``)
    and a gradient to take, f_e counts the global batch's slots and this
    rank returns its share E · Σ_e f_e · (Σ of its probabilities)/N · w:
    the shares sum to the global loss and their gradients to its gradient
    (the mean of products is not the product of means). Serving, which
    discards the aux loss, takes the local batch's."""
    mo = cfg.moe
    b, s, k = eidx.shape
    flat = eidx.reshape(-1)
    counts = torch.zeros((mo.n_routed,), dtype=torch.int64,
                         device=eidx.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    if stats is not None and torch.is_grad_enabled():
        n = b * s * stats.shards
        frac = stats.sum(counts).float() / max(n * k, 1)
        share = probs.sum(dim=(0, 1)) / n
        return mo.n_routed * torch.sum(frac * share) * mo.router_aux_weight
    frac = counts.float() / max(b * s * k, 1)
    pbar = probs.mean(dim=(0, 1))
    return mo.n_routed * torch.sum(frac * pbar) * mo.router_aux_weight


def init_moe(cfg: ModelConfig, generator: torch.Generator, *,
             dtype: torch.dtype = torch.float32) -> MoE:
    p = MoE(cfg, device=generator.device, dtype=dtype)
    normal_(p.router, generator, 0.006)
    normal_(p.experts.wg, generator)
    normal_(p.experts.wu, generator)
    normal_(p.experts.wd, generator, 0.02 / math.sqrt(2 * cfg.n_layers))
    shared = p.shared
    normal_(shared.wg, generator)
    normal_(shared.wu, generator)
    normal_(shared.wd, generator, 0.02 / math.sqrt(2 * cfg.n_layers))
    return p


def apply_moe(cfg: ModelConfig, p: MoE, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output (B, S, D), aux load-balance loss scalar), as the JAX
    package's ``apply_moe``."""
    return p(x)


# ---------------------------------------------------------------------------
# Mamba2 SSD mixer
# ---------------------------------------------------------------------------

def _causal_conv(xc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv1d by shifted adds: xc (B, S, C), w (K, C),
    out[t] = b + Σ_i w[i]·x[t − K + 1 + i], the K − 1 inputs before the
    sequence read from ``state`` (B, K−1, C), zeros without one. Returns
    the output in float32 (the scan's precision; the JAX package rounds it
    to xc's dtype) and, with a state, the new state (the last K − 1 inputs,
    in xc's dtype)."""
    kk, s = w.shape[0], xc.shape[1]
    if state is None:
        pad = xc.new_zeros((xc.shape[0], kk - 1, xc.shape[2]))
    else:
        pad = state.to(xc.dtype)
    full = torch.cat([pad, xc], dim=1)
    out = full[:, :s].float() * w[0].float()
    for i in range(1, kk):
        out += full[:, i:i + s].float() * w[i].float()
    out += b.float()
    new_state = None if state is None else full[:, full.shape[1] - kk + 1:]
    return out, new_state


def ssd_chunk(state: torch.Tensor, da: torch.Tensor, xdt: torch.Tensor,
              bm: torch.Tensor, cm: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the SSD scan, float32: the state (B, H, N, P) before the
    chunk, da (B, Q, H) = dt·A ≤ 0, xdt (B, Q, H, P) = dt·x, bm, cm (B, Q,
    N). Returns the state after the chunk and y (B, Q, H, P): the
    intra-chunk term (C·B weighted by the decay from j to i, i ≥ j) plus
    the inter-chunk term (C times the carried state, decayed to i)."""
    q = da.shape[1]
    cum = torch.cumsum(da, dim=1).transpose(1, 2)            # (B, H, Q)
    seg = cum[..., :, None] - cum[..., None, :]              # (B, H, Qi, Qj)
    tri = torch.ones((q, q), dtype=torch.bool, device=da.device).tril()
    # above the diagonal seg ≥ 0 and exp(seg) may be inf: masked to -inf
    # before the exp, which gives exact zeros there and a zero gradient (a
    # where() after the exp, as the JAX package writes it, has the same
    # values but a gradient of 0·inf = nan where exp overflows)
    lmat = torch.exp(seg.masked_fill(~tri, float("-inf")))
    cb = cm @ bm.transpose(1, 2)                             # (B, Qi, Qj)
    xh = xdt.transpose(1, 2)                                 # (B, H, Q, P)
    y = (cb[:, None] * lmat) @ xh
    y = add_to(y, (cm[:, None] @ state) * torch.exp(cum)[..., None])
    decay_in = torch.exp(cum[..., -1:] - cum)                # (B, H, Q)
    contrib = bm.transpose(1, 2)[:, None] @ (xh * decay_in[..., None])
    state = torch.exp(cum[..., -1])[..., None, None] * state + contrib
    return state, y.transpose(1, 2)


def ssd_scan(da: torch.Tensor, xdt: torch.Tensor, bm: torch.Tensor,
             cm: torch.Tensor, state: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2's chunked state-space-duality scan over S positions, chunk
    by chunk (``ssd_chunk``), float32. S must be a multiple of min(chunk,
    S). Returns y (B, S, H, P), without the skip term, and the final
    state."""
    s = da.shape[1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the SSD "
                         f"chunk {q}")
    bm, cm = bm.float(), cm.float()
    ys = []
    for c0 in range(0, s, q):
        sl = slice(c0, c0 + q)
        state, y = ssd_chunk(state, da[:, sl], xdt[:, sl], bm[:, sl],
                             cm[:, sl])
        ys.append(y)
    return torch.cat(ys, dim=1), state


def ssd_step(state: torch.Tensor, da: torch.Tensor, xdt: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor) -> torch.Tensor:
    """One decode step, the scan at Q = 1, on a float32 ``state`` (B, H, N,
    P) in place: state ← exp(da)·state + B ⊗ xdt; returns y = C·state (B,
    H, P). da (B, H), xdt (B, H, P), bm, cm (B, N)."""
    state.mul_(torch.exp(da)[..., None, None])
    state.add_(bm.float()[:, None, :, None] * xdt[:, :, None, :])
    return (cm.float()[:, None, None, :] @ state)[:, :, 0]


class SSM(nn.Module):
    """Mamba2's SSD mixer: ``w_in`` (D, 2·di + 2·G·N + H) projects to the
    gate z, the conv input (x, B, C) and dt; a depthwise causal conv
    ``conv_w`` (K, C) plus ``conv_b``; the scan's ``a_log``, ``dt_bias``
    and skip ``d_skip`` (H,); the gated output's norm ``out_ln`` (di,) and
    ``w_out`` (di, D). Groups broadcast over heads: group 0's B and C serve
    every head (G = 1 in every config), as in the JAX package. From the
    conv to the output norm the activations stay float32 and are rounded
    to the weights' dtype once, before ``w_out`` (the JAX package rounds
    the conv output, its silu, y and the gated product to the compute
    dtype; in float32 the two agree).

    Split over the model axis (``tp``, a ``sharding.ModelSplit``), the
    weights hold this rank's SSD heads (``sharding.ssm_heads``): w_in its
    heads' z, x and dt columns beside the whole B and C, the conv its
    heads' x channels beside B and C, out_ln, a_log, d_skip and dt_bias
    its heads' entries, w_out their rows. Every rank computes B and C
    alike and scans its own heads; the gated norm's squares are summed
    over the axis (``ModelSplit.total``) and divided by the whole di, and
    the heads' partial output is summed by ``row_parallel``. Its cache
    holds the rank's own heads' state and conv inputs."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.cfg = cfg
        d, sc = cfg.d_model, cfg.ssm
        di, nh, cc = sc.d_inner(d), sc.n_heads(d), sc.conv_channels(d)
        kw = dict(device=device, dtype=dtype)
        self.w_in = param(d, 2 * di + 2 * sc.n_groups * sc.d_state + nh, **kw)
        self.conv_w = param(sc.conv_kernel, cc, **kw)
        self.conv_b = param(cc, fill=0.0, **kw)
        self.a_log = param(nh, **kw)
        self.d_skip = param(nh, fill=1.0, **kw)
        self.dt_bias = param(nh, **kw)
        self.out_ln = param(di, fill=1.0, **kw)
        self.w_out = param(di, d, **kw)
        self.tp = None       # a sharding.ModelSplit when split over heads

    def forward(
        self,
        x: torch.Tensor,                 # (B, S, D)
        cos: Optional[torch.Tensor] = None,
        sin: Optional[torch.Tensor] = None,
        *,
        window: Optional[int] = None,
        cache: Optional[Cache] = None,   # {"state", "conv"}
        pos: Optional[int] = None,
        tp=None,                         # the split to run through, if
                                         # not self.tp's (see MLP.forward)
    ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """RoPE, ``window`` and ``pos`` do not apply (the arguments are the
        attention mixers'). With a cache, its state and conv inputs start
        the sequence and are overwritten with the ones after it; one
        position (decode) takes the one-step recurrence."""
        tp = self.tp if tp is None else tp
        if tp is not None:
            x = tp.enter(x)
        y, cache = self.mix(x, cache=cache, tp=tp)
        if tp is not None:
            return row_parallel(y, self.w_out, tp), cache
        return y @ self.w_out, cache

    def mix(self, x: torch.Tensor, *, cache: Optional[Cache] = None,
            tp=None) -> Tuple[torch.Tensor, Optional[Cache]]:
        """The gated, normed output (B, S, di) before ``w_out``, in x's
        dtype, from x as it entered the block (this rank's heads and
        channels when it runs split through ``tp``)."""
        cfg, sc = self.cfg, self.cfg.ssm
        b, s, _ = x.shape
        # this rank's channels and heads when the block runs split
        di, nh, n = self.w_out.shape[0], self.a_log.shape[0], sc.d_state
        gn = sc.n_groups * n
        z, xbc, dt = (x @ self.w_in).split([di, di + 2 * gn, nh], dim=-1)
        conv_out, new_conv = _causal_conv(
            xbc, self.conv_w, self.conv_b,
            cache["conv"] if cache is not None else None)
        conv_out = F.silu(conv_out)
        xc = conv_out[..., :di].reshape(b, s, nh, sc.head_dim)
        bm = conv_out[..., di:di + n]
        cm = conv_out[..., di + gn:di + gn + n]

        dt = F.softplus(dt.float() + self.dt_bias.float())     # (B, S, H)
        da = dt * -torch.exp(self.a_log.float())               # ≤ 0
        xdt = xc * dt[..., None]                               # (B, S, H, P)
        if cache is not None and s == 1:
            state = cache["state"].float()       # the cache itself if float32
            y = ssd_step(state, da[:, 0], xdt[:, 0], bm[:, 0],
                         cm[:, 0])[:, None]
        else:
            state = cache["state"].float() if cache is not None else \
                x.new_zeros((b, nh, n, sc.head_dim), dtype=torch.float32)
            y, state = ssd_scan(da, xdt, bm, cm, state, sc.chunk)
        y = (y + xc * self.d_skip.float()[:, None]).reshape(b, s, di)
        y = y * F.silu(z.float())
        if tp is None:
            y = rmsnorm(y, self.out_ln, cfg.norm_eps)
        else:
            # the norm is over all di channels: the ranks' squares summed
            squares = tp.total(torch.sum(y * y, dim=-1, keepdim=True))
            y = y * torch.rsqrt(squares / sc.d_inner(cfg.d_model)
                                + cfg.norm_eps) * self.out_ln.float()
        if cache is not None:
            if state is not cache["state"]:
                cache["state"].copy_(state)
            cache["conv"].copy_(new_conv)
        return y.to(x.dtype), cache


def init_ssm(cfg: ModelConfig, generator: torch.Generator, *,
             dtype: torch.dtype = torch.float32) -> SSM:
    """The JAX package's ``init_ssm``: ``w_in`` N(0, 0.02²), ``conv_w`` N(0,
    0.2²), ``a_log`` = log(linspace(1, 16, H)), ``dt_bias`` the inverse
    softplus of dt log-uniform in [1e-3, 1e-1], ``w_out`` N(0, 0.02²)
    scaled by 1/√(2·n_layers), conv bias 0, skip and norm 1."""
    dev = generator.device
    p = SSM(cfg, device=dev, dtype=dtype)
    nh = p.a_log.shape[0]
    normal_(p.w_in, generator)
    normal_(p.conv_w, generator, 0.2)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((nh,), generator=generator, device=dev,
                   dtype=torch.float32)
    dt = torch.exp(lo + (hi - lo) * u)
    with torch.no_grad():
        p.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh, device=dev,
                                               dtype=torch.float32)))
        p.dt_bias.copy_(torch.log(torch.expm1(dt)))
    normal_(p.w_out, generator, 0.02 / math.sqrt(2 * cfg.n_layers))
    return p


def apply_ssm(cfg: ModelConfig, p: SSM, x: torch.Tensor, *,
              cache: Optional[Cache] = None
              ) -> Tuple[torch.Tensor, Optional[Cache]]:
    return p(x, cache=cache)


# ---------------------------------------------------------------------------
# Hymba hybrid mixer: attention ∥ SSM on the same normed input
# ---------------------------------------------------------------------------

class Hybrid(nn.Module):
    """Hymba's mixer: attention ``attn`` (a GQA) and an SSM ``ssm`` read the
    same input; each output is normed (``attn_out_ln``, ``ssm_out_ln``)
    and the two are fused by their mean, in float32 and rounded once (the
    JAX package rounds each norm and the sum). Its cache is {"k", "v",
    "state", "conv"}.

    On a mesh each branch runs split over the model axis where the layout
    splits it (``attn.tp``: this rank's query and KV heads,
    ``sharding.head_ranges``; ``ssm.tp``: its SSD heads,
    ``sharding.ssm_heads``). With both split the hybrid has a ``tp`` of
    its own: it enters once (on a training step or prefill whose residual
    is split over the sequence, the entry gathers the sequence, which the
    scan needs whole), runs the two branches' heads, and sums their
    partial outputs over the model axis in one collective
    (``row_parallel_apart``), each before its own norm, which is not
    linear. With one branch split the block runs whole on every model
    rank (on the gathered sequence) and that branch enters and exits by
    itself. The fused output and its gradient are whole on every model
    rank, or this rank's part of the sequence."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.attn = GQA(cfg, **kw)
        self.ssm = SSM(cfg, **kw)
        self.attn_out_ln = param(cfg.d_model, fill=1.0, **kw)
        self.ssm_out_ln = param(cfg.d_model, fill=1.0, **kw)
        self.tp = None       # a sharding.ModelSplit when both run split

    def forward(
        self,
        x: torch.Tensor,
        cos: torch.Tensor, sin: torch.Tensor,
        *,
        window: Optional[int] = None,
        cache: Optional[Cache] = None,
        pos: Optional[int] = None,
        tp=None,                         # the split to run through, if
                                         # not self.tp's (see MLP.forward)
    ) -> Tuple[torch.Tensor, Optional[Cache]]:
        tp = self.tp if tp is None else tp
        attn_cache = ssm_cache = None
        if cache is not None:
            attn_cache = {"k": cache["k"], "v": cache["v"]}
            ssm_cache = {"state": cache["state"], "conv": cache["conv"]}
        if tp is None:
            a, _ = self.attn(x, cos, sin, window=window, cache=attn_cache,
                             pos=pos)
            s, _ = self.ssm(x, cache=ssm_cache)
        else:
            h = tp.enter(x)
            a, _ = self.attn.attend(h, cos, sin, window=window,
                                    cache=attn_cache, pos=pos)
            s, _ = self.ssm.mix(h, cache=ssm_cache, tp=tp)
            a, s = row_parallel_apart(((a, self.attn.wo),
                                       (s, self.ssm.w_out)), tp)
        eps = self.cfg.norm_eps
        out = 0.5 * (rmsnorm(a.float(), self.attn_out_ln, eps)
                     + rmsnorm(s.float(), self.ssm_out_ln, eps))
        return out.to(x.dtype), cache


def init_hybrid(cfg: ModelConfig, generator: torch.Generator, *,
                dtype: torch.dtype = torch.float32) -> Hybrid:
    """The attention's weights drawn first, then the SSM's (the JAX
    package's key split)."""
    p = Hybrid(cfg, device=generator.device, dtype=dtype)
    p.attn = init_gqa(cfg, generator, dtype=dtype)
    p.ssm = init_ssm(cfg, generator, dtype=dtype)
    return p


def apply_hybrid(cfg: ModelConfig, p: Hybrid, x: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor, *,
                 window: Optional[int] = None, cache: Optional[Cache] = None,
                 pos: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Optional[Cache]]:
    return p(x, cos, sin, window=window, cache=cache, pos=pos)
