"""Mamba2-370M [ssm]: 48L, d=1024, attention-free SSD blocks,
vocab=50280, ssm_state=128. [arXiv:2405.21060]"""
from repro_torch.models.config import ModelConfig, Segment, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        d_model=1_024,
        n_heads=1,               # no attention heads; SSD heads from SSMConfig
        n_kv_heads=1,
        head_dim=64,
        d_ff=0,
        vocab_size=50_280,
        segments=(Segment("ssm", "none", 48),),
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk=256),
        tie_embeddings=True,
        sub_quadratic=True,
        # 370M params on a 256-chip mesh: TP would be pure overhead —
        # the model axis joins DP/FSDP (§Perf iteration 7: −97% collective)
        dp_over_tp=True,
    )
