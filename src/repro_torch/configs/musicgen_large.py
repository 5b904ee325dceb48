"""MusicGen-large [audio backbone]: 48L, d=2048, 32H (MHA kv=32), d_ff=8192,
vocab=2048 — decoder-only over EnCodec tokens. The EnCodec frontend and
codebook-interleaving are stubs per assignment: inputs are precomputed frame
embeddings; the head predicts one codebook stream. [arXiv:2306.05284; hf]"""
from repro_torch.models.config import ModelConfig, dense_segments


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        d_model=2_048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8_192,
        vocab_size=2_048,
        segments=dense_segments(48),
        input_mode="embeds",
    )
