"""Architecture registry: the JAX package's ten backbones and its input-shape
grid.

Each ``<arch>.py`` exposes ``config()`` (the exact published configuration,
copied from the JAX package); the registry adds reduced smoke variants and
the shape table.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.config import MLAConfig, ModelConfig, SSMConfig

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
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.config()


def smoke_config(arch: str) -> ModelConfig:
    """Family-faithful reduced configuration for CPU smoke tests: the JAX
    package's reduction, field for field."""
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
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, expand=2, head_dim=16, chunk=32,
                              conv_kernel=4, n_groups=1)
    if cfg.mrope_sections is not None:
        kw["mrope_sections"] = (2, 3, 3)
    return dataclasses.replace(cfg, **kw)
