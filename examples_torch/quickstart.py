"""Quickstart: scalable spectral clustering with Random Binning features.

Runs SC_RB (the paper's Algorithm 2) on a non-convex two-ring dataset where
plain k-means fails, and prints the 4 paper metrics + per-stage timings —
the JAX package's ``examples/quickstart.py`` on the PyTorch/CUDA port, on
the card unless ``--device cpu``.

    PYTHONPATH=src python examples_torch/quickstart.py [--n 4000]
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu --n 800 --grids 96

For N beyond a single device's memory, pass ``--chunk-size`` to stream the
(N, R) ELL feature matrix through the pipeline in row chunks: peak device
residency of Z drops from O(N·R) to O(chunk_size·R) while computing the
paper's exact algorithm (identical labels up to permutation; see
``repro_torch.core.streaming``). A chunk of ~10⁵–10⁶ rows keeps per-chunk
kernel launches efficient; smaller chunks trade throughput for memory.

    PYTHONPATH=src python examples_torch/quickstart.py --n 100000 --chunk-size 16384
"""
import argparse
import time

from repro_torch.core import SCRBConfig, metrics, sc_rb
from repro_torch.core.baselines import METHODS, BaselineConfig
from repro_torch.data.synthetic import make_rings


def run(n: int = 4_000, grids: int = 256, chunk_size=None, *,
        device: str = "cuda", plan=None, log=print) -> dict:
    """The example on ``device``; returns what it printed. ``plan`` (an
    ``ExecutionPlan``) injects the fit's draws made elsewhere."""
    t0 = time.perf_counter()
    x, y = make_rings(n, 2, seed=0)

    res = sc_rb(x, SCRBConfig(
        n_clusters=2, n_grids=grids, sigma=0.15, kmeans_replicates=4,
        chunk_size=chunk_size), plan=plan, device=device)
    diag = res.diagnostics
    if chunk_size:
        log(f"  streaming: {diag['n_chunks']} chunks, ELL peak "
            f"{diag['ell_device_bytes_peak']/2**20:.1f} MiB on "
            f"device (single-shot would need {n*grids*4/2**20:.1f})")
    m = metrics.all_metrics(res.labels, y)
    log("SC_RB   : " + "  ".join(f"{k}={v:.3f}" for k, v in m.items()))
    log(f"  stages: {res.timer}")
    log(f"  diagnostics: D={diag['n_features_D']}, nnz={diag['nnz']}, "
        f"eigensolver iters={diag['solver_iterations']}")

    km = METHODS["kmeans"](x, BaselineConfig(n_clusters=2,
                                             kmeans_replicates=4),
                           device=device)
    mk = metrics.all_metrics(km.labels, y)
    log("k-means : " + "  ".join(f"{k}={v:.3f}" for k, v in mk.items())
        + "   <- fails on non-convex clusters, as in the paper's motivation")
    return {"labels": res.labels, "metrics": m, "diagnostics": diag,
            "stages": dict(res.timer.times), "kmeans_labels": km.labels,
            "kmeans_metrics": mk, "seconds": time.perf_counter() - t0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4_000)
    ap.add_argument("--grids", type=int, default=256, help="R, number of RB grids")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="stream Z in row chunks of this size (out-of-core N)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.n, args.grids, args.chunk_size, device=args.device)


if __name__ == "__main__":
    main()
