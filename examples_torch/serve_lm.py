"""Batched serving example: prefill + decode loop with KV caches.

The JAX package's ``examples/serve_lm.py`` on the PyTorch/CUDA port, on
the card unless ``--device cpu``.

    PYTHONPATH=src python examples_torch/serve_lm.py --arch internlm2-1.8b
    PYTHONPATH=src python examples_torch/serve_lm.py          # tiny default model
"""
import argparse
import time

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, dense_segments
from repro_torch.serve.engine import Engine, ServeConfig


def tiny_lm() -> ModelConfig:
    return ModelConfig(
        name="serve-demo-8m", family="dense", d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=512, vocab_size=1_024,
        segments=dense_segments(4), dtype="float32", remat="none",
        attn_chunk=64, loss_chunk=512)


def run(arch=None, batch: int = 4, prompt_len: int = 16, max_new: int = 32,
        *, device: str = "cuda", params=None, log=print) -> dict:
    """The example on ``device``; returns what it printed. ``params`` (the
    model's weights, e.g. ``transformer.params_from_reference``) injects
    weights drawn elsewhere."""
    cfg = smoke_config(arch) if arch else tiny_lm()
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{cfg.name} takes embeds input; use a token arch")
    if params is None:
        params = T.init_params(cfg, 0, device=device)
    engine = Engine(cfg, params, ServeConfig(
        cache_len=prompt_len + max_new,
        batch_size=batch, temperature=0.8), device=device)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(batch, prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new, seed=1)
    dt = time.perf_counter() - t0
    toks = batch * max_new
    log(f"model={cfg.name} generated {toks} tokens in {dt:.2f}s "
        f"({toks / dt:.1f} tok/s)")
    log(f"sample: {out[0][:16].tolist()}")
    return {"model": cfg.name, "vocab_size": cfg.vocab_size,
            "prompts": prompts, "tokens": out,
            "tokens_per_s": toks / dt, "seconds": dt,
            "stats": dict(engine.last_stats)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="assigned arch id (runs its reduced smoke config)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.arch, args.batch, args.prompt_len, args.max_new,
               device=args.device)


if __name__ == "__main__":
    main()
