"""Qwen2.5-32B [dense]: 64L, d=5120, 40H (GQA kv=8), d_ff=27648,
vocab=152064 — QKV bias. [hf:Qwen/Qwen2.5-32B family; hf]"""
from repro_torch.models.config import ModelConfig, dense_segments


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        d_model=5_120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=27_648,
        vocab_size=152_064,
        segments=dense_segments(64),
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
