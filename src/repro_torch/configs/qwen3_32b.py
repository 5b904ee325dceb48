"""Qwen3-32B [dense]: 64L, d=5120, 64H (GQA kv=8, head_dim=128), d_ff=25600,
vocab=151936 — qk_norm, no QKV bias. [hf:Qwen/Qwen3-32B family; hf]"""
from repro_torch.models.config import ModelConfig, dense_segments


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        family="dense",
        d_model=5_120,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,            # explicit: != d_model / n_heads in Qwen3
        d_ff=25_600,
        vocab_size=151_936,
        segments=dense_segments(64),
        qk_norm=True,
        rope_theta=1_000_000.0,
    )
