"""Architecture registry: the JAX package's ten backbones and its input-shape
grid, with six ported: the four dense GQA configurations and the two
DeepSeek ones (the MLA mixer, the MoE FFN).

Each ported ``<arch>.py`` exposes ``config()`` (the exact published
configuration, copied from the JAX package); the registry adds reduced
smoke variants and the shape table. The other four architectures need a
mixer or an input path that this port does not have yet, and
``get_config`` raises ``NotImplementedError`` for them, naming the
``ROADMAP.md`` item that ports them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.config import MLAConfig, ModelConfig

ARCH_IDS = (
    "qwen3-32b",
    "internlm2-1.8b",
    "qwen2.5-32b",
    "stablelm-12b",
    "mamba2-370m",
    "qwen2-vl-7b",
    "musicgen-large",
    "deepseek-v2-lite-16b",
    "deepseek-moe-16b",
    "hymba-1.5b",
)

_MODULES = {a: a.replace("-", "_").replace(".", "p") for a in ARCH_IDS}

#: Architectures whose layers the port cannot run yet → what they need.
UNPORTED: Dict[str, str] = {
    "mamba2-370m": "the Mamba2 SSD mixer (ssm)",
    "qwen2-vl-7b": "M-RoPE and the embeds input path",
    "musicgen-large": "the embeds input path",
    "hymba-1.5b": "the hybrid attention ∥ SSM mixer",
}

PORTED_ARCHS = tuple(a for a in ARCH_IDS if a not in UNPORTED)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; options: {list(_MODULES)}")
    if arch in UNPORTED:
        raise NotImplementedError(
            f"{arch} needs {UNPORTED[arch]}, which repro_torch does not have "
            "yet (ROADMAP.md A10); ported: " + ", ".join(PORTED_ARCHS))
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.config()


def smoke_config(arch: str) -> ModelConfig:
    """Family-faithful reduced configuration for CPU smoke tests: the JAX
    package's reduction, field for field, for the ported architectures
    (which carry no SSM or M-RoPE sub-config)."""
    cfg = get_config(arch)
    # shrink segment stack: keep the structural pattern, 1-2 layers each
    segs = tuple(
        dataclasses.replace(s, count=min(s.count, 2),
                            d_ff=(64 if s.d_ff else None),
                            window=(32 if s.window else None))
        for s in cfg.segments)
    kv = max(1, min(cfg.n_kv_heads, 2))
    # keep heads a multiple of kv heads
    heads = kv * max(1, 4 // kv)
    kw = dict(
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        segments=segs,
        dtype="float32",
        remat="none",
        attn_chunk=64,
        loss_chunk=256,
    )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                              v_dim=16)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, n_routed=8, n_shared=1,
                                        top_k=2, d_expert=32)
    return dataclasses.replace(cfg, **kw)
