"""Hymba-1.5B [hybrid]: 32L, d=1600, 25H (GQA kv=5, head_dim=64), d_ff=5504,
vocab=32001, ssm_state=16 — every layer fuses attention and Mamba heads in
parallel; layers 0/15/31 use full (global) attention, the rest SWA-1024.
Meta-tokens are omitted (DESIGN.md §7). [arXiv:2411.13676; hf]"""
from repro_torch.models.config import ModelConfig, Segment, SSMConfig

_WINDOW = 1_024


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        d_model=1_600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5_504,
        vocab_size=32_001,
        segments=(
            Segment("hybrid", "mlp", 1, window=None),        # layer 0 global
            Segment("hybrid", "mlp", 14, window=_WINDOW),
            Segment("hybrid", "mlp", 1, window=None),        # middle global
            Segment("hybrid", "mlp", 15, window=_WINDOW),
            Segment("hybrid", "mlp", 1, window=None),        # last global
        ),
        ssm=SSMConfig(d_state=16, expand=2, head_dim=64, chunk=256),
        sub_quadratic=True,
    )
