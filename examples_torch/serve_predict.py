"""Fit → save → serve → query: the predict-serving walkthrough.

The JAX package's ``examples/serve_predict.py`` on the PyTorch/CUDA port,
on the card unless ``--device cpu``. Fits two models (the classic rings
geometry and a 6-d blobs mixture), saves both as O(D·K) npz artifacts,
loads them by name into a ``ClusterEngine``, and serves an interleaved mix
of ragged requests — showing the bucketed cell cache (each (model, bucket,
mode) is captured once, as a CUDA graph on the card), per-request latency
from ticketed submits, LRU accounting, and the stdlib-HTTP front end
answering the same queries over JSON on 127.0.0.1.

Run:  PYTHONPATH=src python examples_torch/serve_predict.py
"""
import argparse
import json
import os
import tempfile
import time
import urllib.request

import numpy as np

from repro_torch.core import SCRBConfig, SCRBModel
from repro_torch.data.synthetic import make_blobs, make_rings
from repro_torch.serve.cluster_engine import ClusterEngine, EngineConfig
from repro_torch.serve.server import ClusterServer


def run(*, device: str = "cuda", log=print) -> dict:
    """The example on ``device``; returns what it printed."""
    t0 = time.perf_counter()
    # 1. fit two models and save the deployable artifacts
    xr, _ = make_rings(2_000, 2, seed=0)
    xb, _ = make_blobs(2_000, 6, 4, seed=1)
    rings = SCRBModel.fit(xr, SCRBConfig(n_clusters=2, n_grids=64,
                                         sigma=0.15, seed=0), device=device)
    blobs = SCRBModel.fit(xb, SCRBConfig(n_clusters=4, n_grids=64,
                                         sigma=1.5, seed=1), device=device)
    with tempfile.TemporaryDirectory(prefix="scrb_serve_") as workdir:
        rings_npz = os.path.join(workdir, "rings.npz")
        blobs_npz = os.path.join(workdir, "blobs.npz")
        rings.save(rings_npz)
        blobs.save(blobs_npz)
        log(f"[serve] artifacts: rings {rings.nbytes/2**10:.0f}KiB, "
            f"blobs {blobs.nbytes/2**10:.0f}KiB → {workdir}")

        # 2. long-lived engine: load by name, build the bucket grid's cells
        engine = ClusterEngine(EngineConfig(max_resident_models=2),
                               device=device)
        engine.load_model("rings", rings_npz)       # from artifact path
        engine.load_model("blobs", blobs)           # or a fitted model
    warm = {}
    for name in engine.models:
        warm[name] = engine.warmup(name, modes=("predict", "transform"))
        log(f"[serve] warmup {name}: {warm[name]} cells compiled")

    # 3. sync API — and proof the engine matches the raw model bit-for-bit
    labels = engine.predict("rings", xr[:500])
    same = np.array_equal(labels, rings.predict(xr[:500]))
    assert same
    log(f"[serve] rings predict: {np.bincount(labels).tolist()} per cluster")

    # 4. ticketed batch loop: ragged requests coalesce into padded buckets
    rng = np.random.default_rng(0)
    tickets = []
    for _ in range(12):
        name = ("rings", "blobs")[rng.integers(2)]
        pool = xr if name == "rings" else xb
        rows = pool[rng.integers(0, len(pool) - 333):][:rng.integers(5, 333)]
        tickets.append((name, engine.submit(name, rows)))
    engine.drain()
    lats = [engine.take(t).latency * 1e3 for _, t in tickets]
    log(f"[serve] 12 ragged requests: latency p50 "
        f"{np.percentile(lats, 50):.1f}ms max {max(lats):.1f}ms")
    s = engine.stats()
    log(f"[serve] stats: {s['total_compiles']} compiles for {s['cells']} "
        f"cells, {s['rows_served']} rows in {s['batches']} batches "
        f"({s['padded_rows']} pad), resident={s['resident']}")

    # 5. the same engine over HTTP (ephemeral port)
    with ClusterServer(engine) as srv:
        body = json.dumps({"model": "blobs",
                           "rows": xb[:5].tolist()}).encode()
        req = urllib.request.Request(srv.url + "/v1/predict", body,
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            http = json.loads(r.read())
        log(f"[serve] HTTP {srv.url}/v1/predict → {http}")
    return {"rings_labels": labels, "engine_equals_model": same,
            "warmup_cells": warm, "latencies_ms": lats, "stats": s,
            "http": http,
            "engine_predict_http_rows": engine.predict("blobs", xb[:5]),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
