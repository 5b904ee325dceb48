"""Dense GQA layer pieces of the LM stack: RMSNorm, SwiGLU, RoPE (with
partial rotary), causal attention, the GQA block and the MLP block.

Conventions (the JAX package's, ``repro.models.layers``):
  - projections are stored flat (D, H·hd) and applied as ``x @ w``;
  - weights are held in the config's compute dtype (this is a serving port:
    the trainer's float32 masters come with the training slice);
  - KV caches are flat (B, T, Hkv·hd). This port writes them in place
    (JAX returns updated copies), which saves a cache-sized copy per layer.

Attention: the uncached case (no cache, T == S, no offset) — the attention
of a prompt — goes to ``kernels.ops.flash_attention``, the hand-written
kernel on a CUDA tensor and its plain version on a CPU tensor. The cached
case (decode: queries against the cache, masked to its valid prefix) is
plain PyTorch, the grouped einsum of the JAX package, which computes it
outside any Pallas kernel too.

Not ported yet (ROADMAP.md A10): MLA, MoE, the SSM and hybrid mixers,
M-RoPE, and the sharding hints.
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
