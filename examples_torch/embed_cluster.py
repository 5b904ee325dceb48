"""The paper's technique as a framework feature: cluster LM representations.

The JAX package's ``examples/embed_cluster.py`` on the PyTorch/CUDA port,
on the card unless ``--device cpu``. Builds a topic-structured synthetic
corpus (K latent topics, each with its own token distribution), embeds
every document with a small in-framework LM (mean-pooled final hidden
states), then **fits SC_RB once** on a slice of the corpus and serves the
rest through the fitted model — the fit-once/predict-stream shape of the
fitted-model API:

  model = SCRBModel.fit(x_fit, cfg)       # Alg. 2 + out-of-sample state
  model.predict(batch)                    # new docs: no refit, O(batch) work
  model.save(path) / SCRBModel.load(path) # deployable artifact

    PYTHONPATH=src python examples_torch/embed_cluster.py [--docs 2000]
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import SCRBConfig, SCRBModel, metrics
from repro_torch.core.rb import suggest_sigma
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, dense_segments
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import TrainConfig, Trainer

VOCAB = 4_096
STEPS = 200


def topic_corpus(n_docs: int, seq: int, vocab: int, k: int, seed: int = 0):
    """Each topic owns a sparse token bucket; docs sample from their topic."""
    rng = np.random.default_rng(seed)
    topics = rng.integers(0, k, size=n_docs)
    buckets = np.array_split(rng.permutation(vocab), k)
    docs = np.zeros((n_docs, seq), np.int32)
    for i, t in enumerate(topics):
        docs[i] = rng.choice(buckets[t], size=seq)
    return docs, topics.astype(np.int32)


def tiny_lm(vocab: int) -> ModelConfig:
    return ModelConfig(
        name="embedder-8m", family="dense", d_model=128, n_heads=4,
        n_kv_heads=4, head_dim=32, d_ff=512, vocab_size=vocab,
        segments=dense_segments(4), dtype="float32", remat="none",
        attn_chunk=64, loss_chunk=512)


def lm_batches(docs: np.ndarray):
    """Next-token batches of 16 documents, drawn from seed 1."""
    rng = np.random.default_rng(1)
    while True:
        toks = docs[rng.integers(0, docs.shape[0], size=16)]
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def pool(cfg: ModelConfig, params, docs: np.ndarray, device) -> np.ndarray:
    """Each document's final hidden states mean-pooled, (n_docs, d_model),
    in batches of 200 on ``device``."""
    embs = []
    with torch.no_grad():
        for i in range(0, docs.shape[0], 200):
            tokens = torch.as_tensor(docs[i:i + 200], device=device)
            h, _ = T.forward_hidden(cfg, params, {"tokens": tokens})
            embs.append(h.mean(dim=1).cpu().numpy())      # (B, D) mean-pool
    return np.concatenate(embs)


def run(docs: int = 2_000, seq: int = 32, topics: int = 6, *,
        device: str = "cuda", steps: int = STEPS, params=None, plan=None,
        log=print) -> dict:
    """The example on ``device``; returns what it printed. ``params`` (the
    LM's float32 masters, e.g. ``transformer.params_from_reference``) and
    ``plan`` (the fit's ``ExecutionPlan``) inject draws made elsewhere;
    ``steps`` is the pretraining's length (200 in the JAX package)."""
    t0 = time.perf_counter()
    n_docs = docs
    docs, labels = topic_corpus(n_docs, seq, VOCAB, topics)
    cfg = tiny_lm(VOCAB)
    if params is None:
        params = T.init_params(cfg, 0, device=device, masters=True)

    # Brief LM pretraining on the corpus: random-init deep representations
    # are topic-blind (rank collapse); a few hundred steps of next-token
    # prediction make the pooled hidden states separate the latent topics —
    # the realistic "embed with a trained model" setting.
    trainer = Trainer(cfg, TrainConfig(
        opt=OptConfig(lr=3e-3, warmup_steps=10, total_steps=steps),
        log_every=50), params, lm_batches(docs), device=device)
    losses = [trainer.run(1)["loss"] for _ in range(steps)]
    params = trainer.params
    log(f"pretrained embedder: {losses[-1]:.3f} final LM loss")

    x = pool(cfg, params, docs, trainer.device)
    x = (x - x.mean(0)) / (x.std(0) + 1e-6)
    log(f"embedded {x.shape[0]} docs into {x.shape[1]}-d space")

    sigma = suggest_sigma(x)
    log(f"median-heuristic sigma = {sigma:.1f}")

    # fit ONCE on the first half of the corpus...
    n_fit = x.shape[0] // 2
    model = SCRBModel.fit(x[:n_fit], SCRBConfig(
        n_clusters=topics, n_grids=256, sigma=sigma,
        kmeans_replicates=4), plan=plan, device=device)
    m_fit = metrics.all_metrics(model.fit_result.labels, labels[:n_fit])
    log(f"SC_RB fit on {n_fit} docs: "
        + "  ".join(f"{k}={v:.3f}" for k, v in m_fit.items()))
    log(model.fit_result.timer)

    # ...then stream the remaining docs through the fitted model — the
    # serving loop: out-of-sample embed + nearest-centroid, no refitting
    preds = []
    t1 = time.perf_counter()
    for start in range(n_fit, x.shape[0], 256):
        preds.append(model.predict(x[start:start + 256]))
    served = np.concatenate(preds) if preds else np.empty((0,), np.int32)
    dt = time.perf_counter() - t1
    m_oos = metrics.all_metrics(served, labels[n_fit:])
    log(f"served {served.shape[0]} unseen docs in {dt:.2f}s "
        f"({served.shape[0] / max(dt, 1e-9):.0f} docs/s): "
        + "  ".join(f"{k}={v:.3f}" for k, v in m_oos.items()))

    # the fitted model is a deployable artifact
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scrb_model.npz")
        model.save(path)
        size = os.path.getsize(path)
        reloaded = SCRBModel.load(path, device=device)
    same = np.array_equal(reloaded.predict(x[n_fit:n_fit + 256]),
                          served[:min(256, served.shape[0])])
    log(f"saved {size / 2**20:.1f}MiB artifact to {path}; "
        f"reloaded predict bit-identical: {same}")
    return {"losses": losses, "lm": params, "lm_config": cfg,
            "embeddings": x, "sigma": sigma,
            "fit_labels": model.fit_result.labels, "fit_metrics": m_fit,
            "served": served, "served_metrics": m_oos,
            "docs_per_s": served.shape[0] / max(dt, 1e-9),
            "reloaded_identical": same, "artifact_bytes": size,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=2_000)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--topics", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.docs, args.seq, args.topics, device=args.device)


if __name__ == "__main__":
    main()
