"""Model configuration for the unified LM stack (a copy of the JAX
package's ``models/config.py``: plain dataclasses, no framework code).

A model is a sequence of *segments*: (layer_kind × count). Each segment is a
homogeneous stack (a ``ModuleList`` run in a Python loop in this port);
heterogeneous depth patterns (DeepSeek's dense layer 0, Hymba's interleaved
global/SWA) become short segment lists. Layer kinds compose a token mixer
with an FFN:

  mixer: gqa | mla | ssm | hybrid (attn ∥ mamba heads)
  ffn:   mlp | moe | none (mamba-style blocks carry no separate FFN)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int = 64
    n_shared: int = 2
    top_k: int = 6
    d_expert: int = 1408
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # leading dense-MLP layers use the segment mechanism, not this config


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    conv_kernel: int = 4
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim

    def conv_channels(self, d_model: int) -> int:
        return self.d_inner(d_model) + 2 * self.n_groups * self.d_state


@dataclasses.dataclass(frozen=True)
class Segment:
    """``count`` stacked layers of the same kind, scanned together."""
    mixer: str          # gqa | mla | ssm | hybrid
    ffn: str            # mlp | moe | none
    count: int
    window: Optional[int] = None   # sliding-window size for this segment's attn
    d_ff: Optional[int] = None     # per-segment FFN width override

    @property
    def kind(self) -> str:
        return f"{self.mixer}_{self.ffn}"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | vlm | audio | hybrid
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    segments: Tuple[Segment, ...]
    # attention flavor flags
    qk_norm: bool = False
    qkv_bias: bool = False
    partial_rotary: float = 1.0     # fraction of head_dim carrying RoPE
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    # sub-configs
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # io
    input_mode: str = "tokens"      # tokens | embeds (vlm/audio stub frontends)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # numerics
    dtype: str = "bfloat16"         # activation/weight compute dtype
    remat: str = "full"             # full | dots | none
    attn_chunk: int = 512           # q-chunk for memory-bounded attention
    loss_chunk: int = 4096          # token-chunk for on-the-fly CE
    sub_quadratic: bool = False     # eligible for long_500k decode
    scan_layers: bool = True        # False → python-unrolled layers (the
                                    # trip-count-exact cost-model probes)
    dp_over_tp: bool = False        # small-model policy: the 'model' mesh
                                    # axis joins the DP/FSDP group instead of
                                    # tensor-parallelism (≪ collective bytes
                                    # when params are tiny vs the mesh)

    @property
    def n_layers(self) -> int:
        return sum(s.count for s in self.segments)

    @property
    def rotary_dim(self) -> int:
        if self.mla is not None:
            return self.mla.qk_rope_dim
        return int(self.head_dim * self.partial_rotary) // 2 * 2

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d = self.d_model
        total = self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            total += d * self.vocab_size                 # head
        total += d                                       # final norm
        for seg in self.segments:
            per = d                                      # ln1
            if seg.ffn != "none":
                per += d                                 # ln2
            if seg.mixer == "gqa" or seg.mixer == "hybrid":
                qkv = d * self.n_heads * self.head_dim \
                    + 2 * d * self.n_kv_heads * self.head_dim \
                    + self.n_heads * self.head_dim * d
                if self.qkv_bias:
                    qkv += (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                if self.qk_norm:
                    qkv += 2 * self.head_dim
                per += qkv
            if seg.mixer == "mla":
                m = self.mla
                per += d * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                per += d * (m.kv_lora_rank + m.qk_rope_dim) + m.kv_lora_rank
                per += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_dim)
                per += self.n_heads * m.v_dim * d
            if seg.mixer in ("ssm", "hybrid"):
                s = self.ssm
                di, nh = s.d_inner(d), s.n_heads(d)
                cc = s.conv_channels(d)
                per += d * (2 * di + 2 * s.n_groups * s.d_state + nh)
                per += s.conv_kernel * cc + cc
                per += 3 * nh + di + di * d
            if seg.mixer == "hybrid":
                per += 2 * d                 # per-branch fusion norms
            if seg.ffn == "mlp":
                f = seg.d_ff or self.d_ff
                per += 3 * d * f
            if seg.ffn == "moe":
                mo = self.moe
                per += d * mo.n_routed
                per += mo.n_routed * 3 * d * mo.d_expert
                per += mo.n_shared * 3 * d * mo.d_expert
            total += per * seg.count
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        inactive = (mo.n_routed - mo.top_k) * 3 * self.d_model * mo.d_expert
        n_moe_layers = sum(s.count for s in self.segments if s.ffn == "moe")
        return self.param_count() - inactive * n_moe_layers


def dense_segments(n_layers: int, window: Optional[int] = None) -> Tuple[Segment, ...]:
    return (Segment("gqa", "mlp", n_layers, window=window),)
