"""StableLM-2-12B [dense]: 40L, d=5120, 32H (GQA kv=8, head_dim=160),
d_ff=13824, vocab=100352 — partial rotary 25%.
[hf:stabilityai/stablelm-2-12b family; hf]"""
from repro_torch.models.config import ModelConfig, dense_segments


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        family="dense",
        d_model=5_120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=160,
        d_ff=13_824,
        vocab_size=100_352,
        segments=dense_segments(40),
        partial_rotary=0.25,
    )
