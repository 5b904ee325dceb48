"""InternLM2-1.8B [dense]: 24L, d=2048, 16H (GQA kv=8), d_ff=8192,
vocab=92544. [arXiv:2403.17297; hf]"""
from repro_torch.models.config import ModelConfig, dense_segments


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        d_model=2_048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8_192,
        vocab_size=92_544,
        segments=dense_segments(24),
        rope_theta=1_000_000.0,
    )
