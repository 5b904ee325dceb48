"""DeepSeekMoE-16B [moe]: 28L, d=2048, 16H (GQA kv=16), layer 0 dense
(d_ff=10944), 27 MoE layers: 2 shared + 64 routed fine-grained experts
(d_expert=1408), top-6. vocab=102400. [arXiv:2401.06066; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig, Segment


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        d_model=2_048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1_408,
        vocab_size=102_400,
        segments=(
            Segment("gqa", "mlp", 1, d_ff=10_944),
            Segment("gqa", "moe", 27),
        ),
        moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_expert=1_408),
    )
