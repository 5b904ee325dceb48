"""DeepSeek-V2-Lite (16B) [moe]: 27L, d=2048, 16H MLA (kv_lora=512,
qk_nope=128, qk_rope=64, v=128), layer 0 dense (d_ff=10944), 26 MoE layers:
2 shared + 64 routed experts (d_expert=1408), top-6. vocab=102400.
[arXiv:2405.04434; hf]

Assignment-line note: the spec string says both "MoE 64e top-6" and
"2 shared+160 routed"; the published V2-Lite config is 64 routed + 2 shared,
which we implement (DESIGN.md §4)."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig, Segment


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        d_model=2_048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=192,            # qk_nope + qk_rope (bookkeeping only)
        d_ff=1_408,
        vocab_size=102_400,
        segments=(
            Segment("mla", "mlp", 1, d_ff=10_944),
            Segment("mla", "moe", 26),
        ),
        mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                      v_dim=128),
        moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_expert=1_408),
    )
