"""Layer pieces of the LM stack: RMSNorm, SwiGLU, RoPE (with partial
rotary), causal attention, the GQA and MLA attention blocks, the MLP block
and the MoE FFN.

Conventions (the JAX package's, ``repro.models.layers``):
  - projections are stored flat (D, H·hd) and applied as ``x @ w``;
  - weights are held in the config's compute dtype (this is a serving port:
    the trainer's float32 masters come with the training slice);
  - KV caches are flat (B, T, Hkv·hd), MLA's compressed ones (B, T,
    kv_lora_rank) and (B, T, qk_rope_dim). This port writes them in place
    (JAX returns updated copies), which saves a cache-sized copy per layer.

Attention: the uncached case (no cache, T == S, no offset) — the attention
of a prompt — goes to ``kernels.ops.flash_attention``, the hand-written
kernel on a CUDA tensor and its plain version on a CPU tensor. The cached
case (decode: queries against the cache, masked to its valid prefix) is
plain PyTorch, the grouped einsum of the JAX package, which computes it
outside any Pallas kernel too. MLA (DeepSeek-V2) and the MoE FFN
(DeepSeekMoE) reach no Pallas kernel in the JAX package either (einsums, a
sort and scatters), and are plain PyTorch here too.

Not ported yet (ROADMAP.md A10): the SSM and hybrid mixers, M-RoPE, and
the sharding hints.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
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
    positions: torch.Tensor,         # (B, S) integer
    rotary_dim: int,
    theta: float,
    mrope_sections: Optional[Tuple[int, int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (B, S, rotary_dim/2), float32."""
    if mrope_sections is not None or positions.dim() != 2:
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP.md A10.4)")
    half = rotary_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * freqs
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

    def forward(
        self,
        x: torch.Tensor,                 # (B, S, D)
        cos: torch.Tensor, sin: torch.Tensor,
        *,
        window: Optional[int] = None,
        cache: Optional[Cache] = None,   # {"k","v"} flat (B, T, Hkv·hd)
        pos: Optional[int] = None,       # write offset into the cache
    ) -> Tuple[torch.Tensor, Optional[Cache]]:
        cfg = self.cfg
        b, s, _ = x.shape
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
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
        return out.reshape(b, s, h * hd) @ self.wo, cache


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x, self.wg, self.wu, self.wd)


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


# ---------------------------------------------------------------------------
# float32 products of low-precision operands
# ---------------------------------------------------------------------------

def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, m, k) @ (N, k, n) as float32: the JAX package's
    ``preferred_element_type=float32``. Float32 operands multiply as they
    are; lower-precision ones on the card through cuBLAS with a float32
    output (``aten::bmm.dtype``: float32 accumulation, no rounding of the
    result), elsewhere upcast first (that op has no CPU kernel)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


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
    sc += bmm_f32(q_rope.reshape(b, h * c, dr), kr.transpose(1, 2))
    return sc.view(b, h, c, t)


class MLA(nn.Module):
    """Multi-head latent attention: keys and values live in one compressed
    latent (``kv_lora_rank``) plus a shared rotary key, and the cache holds
    only those."""

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

    def forward(
        self,
        x: torch.Tensor,                 # (B, S, D)
        cos: torch.Tensor, sin: torch.Tensor,
        *,
        window: Optional[int] = None,
        cache: Optional[Cache] = None,   # {"ckv": (B,T,lo), "kr": (B,T,dr)}
        pos: Optional[int] = None,       # write offset into the cache
    ) -> Tuple[torch.Tensor, Optional[Cache]]:
        cfg, m = self.cfg, self.cfg.mla
        b, s, _ = x.shape
        h = cfg.n_heads
        dn, dr, dv, lo = m.qk_nope_dim, m.qk_rope_dim, m.v_dim, m.kv_lora_rank
        scale = 1.0 / math.sqrt(dn + dr)

        q = (x @ self.wq).reshape(b, s, h, dn + dr)
        q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], cos, sin)
        dkv = x @ self.w_dkv                                 # (B, S, lo+dr)
        ckv = rmsnorm(dkv[..., :lo], self.kv_ln, cfg.norm_eps)
        kr = apply_rope(dkv[..., lo:][:, :, None, :], cos, sin)[:, :, 0]
        # absorbed scoring: q_nope projected into the latent space once, so
        # the keys stay compressed
        q_lat = torch.einsum("bshn,lhn->bhsl", q_nope,
                             self.w_uk.view(lo, h, dn))
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
                           self.w_uv.view(lo, h, dv))
        return out.reshape(b, s, h * dv) @ self.wo, cache


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
    n_shared·Fe."""

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

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        probs, gates, eidx = moe_route(self.cfg, self, x)
        out = moe_experts(self.cfg, self, x, gates, eidx)
        return out + self.shared(x), moe_aux(self.cfg, probs, eidx)


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


def moe_experts(cfg: ModelConfig, p: MoE, x: torch.Tensor,
                gates: torch.Tensor, eidx: torch.Tensor) -> torch.Tensor:
    """The routed experts' gated output (B, S, D) for the given routing.

    Dispatch: every kept slot's token row is copied to its own row of an
    (E, B·cap, D) buffer (unused rows stay 0), so the three expert products
    are batched matrix products over E. Combine: each token gathers its k
    rows and adds them in a fixed order. Neither step adds with atomics, so
    the output is the same bits on every run; a dropped slot's weight is 0,
    so it adds exact zeros, as in the JAX package's scatter-add."""
    mo = cfg.moe
    g, s, d = x.shape
    e, k = mo.n_routed, mo.top_k
    cap = moe_capacity(cfg, s)
    rank, keep = moe_slots(cfg, eidx, cap)
    rows = e * g * cap
    grp = torch.arange(g, device=x.device)[:, None, None]
    dest = eidx * (g * cap) + grp * cap + rank.clamp(0, cap - 1)
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
    return (y[dest] * w[..., None]).sum(dim=2)


def moe_aux(cfg: ModelConfig, probs: torch.Tensor,
            eidx: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance loss E · Σ_e f_e p̄_e · router_aux_weight,
    f_e the share of all B·S·k slots routed to e (dropped ones too)."""
    mo = cfg.moe
    b, s, k = eidx.shape
    flat = eidx.reshape(-1)
    counts = torch.zeros((mo.n_routed,), dtype=torch.int64,
                         device=eidx.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
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
