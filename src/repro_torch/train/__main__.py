"""End-to-end training run: ~100M-parameter LM for a few hundred steps.

The JAX package's ``examples/train_lm.py`` on the port: model init →
AdamW on float32 masters → resumable synthetic data → checkpointing and
restart → straggler watchdog, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.train --steps 300
    PYTHONPATH=src python -m repro_torch.train --device cpu --steps 2 \\
        --batch 2 --seq 16

(~110M params: 12L, d=768, 12H, d_ff=3072, vocab=32768 — GPT-small class.)
"""
import argparse
import os
import tempfile

from repro_torch.data.tokens import SyntheticTokens
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, dense_segments
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import TrainConfig, Trainer


def config_100m() -> ModelConfig:
    return ModelConfig(
        name="repro-100m",
        family="dense",
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3_072,
        vocab_size=32_768,
        segments=dense_segments(12),
        dtype="float32",          # the reference example's; bf16 also runs
        remat="none",
        attn_chunk=128,
        loss_chunk=1_024,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = config_100m()
    print(f"model: {cfg.name}  params={cfg.param_count()/1e6:.1f}M")
    params = T.init_params(cfg, 0, device=args.device, masters=True)
    data = SyntheticTokens(vocab_size=cfg.vocab_size, batch=args.batch,
                           seq_len=args.seq, seed=0)
    tcfg = TrainConfig(
        opt=OptConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps),
        checkpoint_every=50, checkpoint_dir=args.ckpt_dir, log_every=10)
    trainer = Trainer(cfg, tcfg, params, iter(data), device=args.device)
    if trainer.restore():
        data.step = trainer.step          # resume the data stream too
    final = trainer.run(args.steps - trainer.step)
    print(f"final: step={trainer.step} loss={final.get('loss', -1):.4f} "
          f"stragglers={len(trainer.stragglers)}")


if __name__ == "__main__":
    main()
