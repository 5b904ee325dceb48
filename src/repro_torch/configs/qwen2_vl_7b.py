"""Qwen2-VL-7B [vlm backbone]: 28L, d=3584, 28H (GQA kv=4), d_ff=18944,
vocab=152064 — M-RoPE (t/h/w sections), QKV bias. The ViT frontend is a
stub per assignment: inputs are precomputed patch embeddings.
[arXiv:2409.12191; hf]"""
from repro_torch.models.config import ModelConfig, dense_segments


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        d_model=3_584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18_944,
        vocab_size=152_064,
        segments=dense_segments(28),
        qkv_bias=True,
        mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
        input_mode="embeds",
    )
