#!/usr/bin/env python3
"""Measurements of the port's device-resident covtype-shaped fit on one GPU.

    python3 tools/fit_study.py ab --trees TREE [TREE ...] [--rounds 4] [--fits 6]
    python3 tools/fit_study.py residuals
    python3 tools/fit_study.py obs [--pairs 6]
    python3 tools/fit_study.py lanczos-step

``chip_smoke.py`` gates the port; this script only measures, on the fit of
its phase 3 (``SCRBModel.fit`` of the covtype-shaped synthetic data, N =
581,012, d = 54, K = 7, R = 256, seed 0):

  ab            the fit from each TREE's own ``src/`` (a checkout of this
                repo, for example a parent commit unpacked with ``git
                archive``), one process per (round, tree), the trees in
                the order A B, B A, A B, ...; each process makes one
                warm-up fit and then ``--fits`` timed fits (host seconds
                after a device synchronise, and StageTimer's stages). A
                first untimed process per tree builds its kernels. Prints
                the medians per tree and stage, and each process's median.
  residuals     the same fit with solver="lobpcg" and "lobpcg_host": the
                largest leading-K relative residual of every iterate, and
                the iterates at which it is within tol.
  obs           the fit with the observability calls that run while tracing
                is off (the memory watermark, the eigensolve wrapper, the
                stage histogram and fit counters) against the same fit with
                them all, or one group, stubbed out, in rotation in one
                process; then each call's host time alone.

Every fit also records the cyclic garbage collector's pauses inside it.
  lanczos-step  one fully reorthogonalised Lanczos step against a (300, N)
                float64 basis (two projections, four passes over the
                basis): host numpy, where the JAX package keeps the basis,
                and the card.

Every mode prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COVTYPE = ("covtype-mult", 7, 54, 581_012, "aniso")   # paper Table 1
N_GRIDS = 256
LANCZOS_BASIS = 300        # SolverOptions.iters: lanczos' basis rows


def covtype_fit_inputs():
    """The covtype-shaped rows and the fit's config, as chip_smoke.py
    makes them."""
    from repro_torch.core import SCRBConfig
    from repro_torch.core.rb import suggest_sigma
    from repro_torch.data.synthetic import SuiteSpec, generate

    x, _ = generate(SuiteSpec(*COVTYPE), scale=1.0, seed=0)
    cfg = SCRBConfig(n_clusters=COVTYPE[1], n_grids=N_GRIDS,
                     sigma=suggest_sigma(x))
    return x, cfg


class GcPauses:
    """Milliseconds the cyclic garbage collector held the process, and its
    collections by generation, since the last ``take()``."""

    def __init__(self):
        self.ms, self.runs, self._t0 = 0.0, [0, 0, 0], 0.0
        gc.callbacks.append(self._on)

    def _on(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self.runs[info["generation"]] += 1

    def take(self) -> dict:
        out = {"gc_ms": self.ms, "gc_runs": list(self.runs)}
        self.ms, self.runs = 0.0, [0, 0, 0]
        return out


GC = GcPauses()


def timed_fit(x, cfg):
    import torch

    from repro_torch.core import SCRBModel
    torch.cuda.synchronize()
    GC.take()
    t0 = time.perf_counter()
    model = SCRBModel.fit(x, cfg)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, model.fit_result


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def child(src: str, fits: int) -> None:
    """One process of ``ab``: the fits of the tree whose ``src/`` is
    ``src``, as one JSON line."""
    sys.path.insert(0, src)
    from repro_torch.kernels import _build
    _build.build_all()
    x, cfg = covtype_fit_inputs()
    timed_fit(x, cfg)                                   # warm-up
    walls, stages, iters, gcs = [], [], [], []
    for _ in range(fits):
        wall, res = timed_fit(x, cfg)
        walls.append(wall)
        gcs.append(GC.take())
        stages.append(dict(res.timer.times))
        iters.append(int(res.diagnostics["solver_iterations"]))
    print(json.dumps({"src": src, "walls": walls, "stages": stages,
                      "iterations": iters, "gc": gcs}), flush=True)


def run_child(tree: Path, fits: int) -> dict:
    out = subprocess.run(
        [sys.executable, __file__, "child", "--src", str(tree / "src"),
         "--fits", str(fits)], capture_output=True, text=True, timeout=900)
    if out.returncode:
        sys.exit(f"the fits of {tree} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def ab(trees, rounds: int, fits: int) -> None:
    for tree in trees:                  # builds the kernels, untimed
        run_child(tree, 1)
    runs = {str(t): [] for t in trees}
    for r in range(rounds):
        for tree in (trees if r % 2 == 0 else trees[::-1]):
            runs[str(tree)].append(run_child(tree, fits))
            last = runs[str(tree)][-1]
            print(f"round {r} {tree}: fit median "
                  f"{statistics.median(last['walls']):.4f}s "
                  f"{[round(w, 4) for w in last['walls']]} iterations "
                  f"{sorted(set(last['iterations']))}; gc ms "
                  f"{[round(g['gc_ms'], 1) for g in last['gc']]}",
                  flush=True)
    for tree, procs in runs.items():
        walls = [w for p in procs for w in p["walls"]]
        stages = {}
        for p in procs:
            for st in p["stages"]:
                for k, v in st.items():
                    stages.setdefault(k, []).append(v)
        print(f"{tree}: {len(walls)} fits in {len(procs)} processes; fit "
              f"median {statistics.median(walls):.4f}s; per process "
              f"{[round(statistics.median(p['walls']), 4) for p in procs]};"
              " stage medians " + ", ".join(
                  f"{k} {statistics.median(v):.4f}"
                  for k, v in stages.items()), flush=True)


def residuals() -> None:
    import torch

    from repro_torch.core import eigensolver
    x, cfg = covtype_fit_inputs()
    k, tol = cfg.n_clusters, cfg.solver_options.tol
    block = eigensolver._lobpcg_residual_block
    for solver in ("lobpcg", "lobpcg_host"):
        seen = []

        def record(xb, ax, tol_, tvec):
            out = block(xb, ax, tol_, tvec)
            seen.append(float(torch.max(out[1][:k])))
            return out

        eigensolver._lobpcg_residual_block = record
        try:
            c = cfg.from_dict({**cfg.to_dict(), "solver": solver})
            wall, res = timed_fit(x, c)
        finally:
            eigensolver._lobpcg_residual_block = block
        # the first call is the start block's; then one an iteration, from
        # the start block's again (lobpcg_host: at its top, lobpcg: before
        # its update)
        per_iterate = seen[1:]
        within = [i for i, r in enumerate(per_iterate) if r <= tol]
        print(f"{solver}: {res.diagnostics['solver_iterations']} iterations"
              f" (fit {wall:.3f}s); tol {tol:g}; iterates within tol "
              f"{within}; largest leading-{k} residual of iterate i: "
              f"{[float(f'{r:.3g}') for r in per_iterate]}", flush=True)


def obs(pairs: int) -> None:
    import contextlib
    from unittest import mock

    from repro_torch import utils
    from repro_torch.core import eigensolver, executor
    from repro_torch.obs import memory

    class NoWatermark:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def as_dict(self):
            return {}

    noop = lambda *a, **k: None
    stubs = {
        "watermark": [(executor.obs_memory, "Watermark", NoWatermark)],
        "wrapper": [(eigensolver, "top_k_eigenpairs",
                     eigensolver._top_k_eigenpairs_impl)],
        "metrics": [(utils._STAGE_SECONDS, "observe", noop),
                    (executor._FITS_TOTAL, "inc", noop),
                    (executor._FIT_ROWS, "inc", noop)],
    }
    variants = {"as_is": [], "stubbed": sum(stubs.values(), []),
                **{f"no_{k}": v for k, v in stubs.items()}}

    def patched(name):
        stack = contextlib.ExitStack()
        for target, attr, value in variants[name]:
            stack.enter_context(mock.patch.object(target, attr, value))
        return stack

    x, cfg = covtype_fit_inputs()
    timed_fit(x, cfg)                                   # warm-up
    names = list(variants)
    rows = {n: [] for n in names}
    for r in range(pairs):
        for name in (names if r % 2 == 0 else names[::-1]):
            with patched(name):
                wall, res = timed_fit(x, cfg)
            rows[name].append({"wall": wall, **GC.take(),
                               "stages": dict(res.timer.times)})
    print("tracing off, the fit as is and with observability calls stubbed "
          f"out (all, or one group), in rotation ({pairs} each):")
    for name, rs in rows.items():
        stages = {k: statistics.median(r["stages"][k] for r in rs)
                  for k in rs[0]["stages"]}
        print(f"  {name}: median {statistics.median(r['wall'] for r in rs):.4f}"
              f"s {[round(r['wall'], 4) for r in rs]}; gc ms "
              f"{[round(r['gc_ms'], 1) for r in rs]}; stage medians "
              + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()),
              flush=True)
    for label, fn, reps in (
            ("memory.sample()", memory.sample, 100),
            ("Watermark enter+exit",
             lambda: memory.Watermark().__enter__().__exit__(), 100),
            ("record_solve", lambda: eigensolver.record_solve(
                "lobpcg", 31, 1e-5), 1000),
            ("stage histogram observe", lambda: utils._STAGE_SECONDS.observe(
                0.1, stage="svd"), 1000)):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        print(f"  {label}: {(time.perf_counter() - t0) / reps * 1e3:.4f} ms "
              "a call", flush=True)


def lanczos_step() -> None:
    import numpy as np
    import torch
    n, m = COVTYPE[3], LANCZOS_BASIS
    basis = np.full((m, n), 1e-3)
    av = np.ones(n)
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        w = av - basis.T @ (basis @ av)
        w = w - basis.T @ (basis @ w)
        host.append((time.perf_counter() - t0) * 1e3)
    del basis, w
    basis_d = torch.full((m, n), 1e-3, dtype=torch.float64, device="cuda")
    av_d = torch.ones(n, dtype=torch.float64, device="cuda")

    def step():
        w = av_d - basis_d.T @ (basis_d @ av_d)
        return w - basis_d.T @ (basis_d @ w)

    step()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        step()
    end.record()
    torch.cuda.synchronize()
    print(f"one reorthogonalised lanczos step against a ({m}, {n}) float64 "
          f"basis ({m * n * 8 / 1e9:.2f} GB): host numpy "
          f"{[round(t, 1) for t in host]} ms, the card "
          f"{start.elapsed_time(end) / 5:.3f} ms", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="mode", required=True)
    p = sub.add_parser("ab")
    p.add_argument("--trees", type=Path, nargs="+", required=True)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--fits", type=int, default=6)
    p = sub.add_parser("child")
    p.add_argument("--src", required=True)
    p.add_argument("--fits", type=int, required=True)
    sub.add_parser("residuals")
    p = sub.add_parser("obs")
    p.add_argument("--pairs", type=int, default=6)
    sub.add_parser("lanczos-step")
    args = parser.parse_args()
    if args.mode == "child":
        child(args.src, args.fits)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(card(), flush=True)
    if args.mode == "ab":
        ab([t.resolve() for t in args.trees], args.rounds, args.fits)
        return
    sys.path.insert(0, str(ROOT / "src"))
    {"residuals": residuals, "obs": lambda: obs(args.pairs),
     "lanczos-step": lanczos_step}[args.mode]()


if __name__ == "__main__":
    main()
