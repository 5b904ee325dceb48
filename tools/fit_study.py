#!/usr/bin/env python3
"""Measurements of the port's device-resident covtype-shaped fit, and of
two of its kernels, on one GPU.

    python3 tools/fit_study.py ab --trees TREE [TREE ...] [--rounds 4] [--fits 6]
    python3 tools/fit_study.py kernels --trees TREE [TREE ...] [--rounds 2]
    python3 tools/fit_study.py gather-forms [--rounds 2]
    python3 tools/fit_study.py residuals
    python3 tools/fit_study.py obs [--pairs 6]
    python3 tools/fit_study.py lanczos-step
    python3 tools/fit_study.py kmeans-seeds [--device cpu] [--rows N] [--seeds 4]

``chip_smoke.py`` gates the port; this script only measures, on the fit of
its phase 3 (``SCRBModel.fit`` of the covtype-shaped synthetic data, N =
581,012, d = 54, K = 7, R = 256, seed 0) and on the RB patterns of its
phases 2 and 10 (that data, d_g 2,048; the poker-shaped data, N =
1,025,010, d_g 512):

  ab            the fit from each TREE's own ``src/`` (a checkout of this
                repo, for example a parent commit unpacked with ``git
                archive``), one process per (round, tree), the trees in
                the order A B, B A, A B, ...; each process makes one
                warm-up fit and then ``--fits`` timed fits (host seconds
                after a device synchronise, and StageTimer's stages). A
                first untimed process per tree builds its kernels. Prints
                the medians per tree and stage, and each process's median.
  kernels       device ms (``chip_smoke.time_device``: launches queued
                behind a spin kernel) of each TREE's ``ops.z_matmul_gather``
                and ``ops.bin_counts``, one process per (round, tree) as in
                ``ab``: the gather at the serving engine's buckets (64 to
                4,096 rows of the covtype pattern) for K = 1 (the degrees)
                and K = 7 (the projection), at one row and one grid (a
                launch's floor) and on the host-chunked fits' ragged last
                chunks (covtype 56,724 rows at K = 1 and 11, poker 107,506
                at K = 14 and 32); ``bin_counts`` on the whole pattern, one
                131,072-row chunk and poker's ragged chunk. Prints each
                shape's bound (``chip_smoke.bound``) and medians per tree.
  gather-forms  this tree's gather route in each of its forms (staged
                through shared memory, or the register form:
                ``ops.Z_GATHER_ROWS_MIN_OUTPUTS`` forced), in turns, at each
                bucket for K = 1 and 7, between them (2,048 to 3,072 rows
                at K = 7) and on the covtype ragged chunk; the forms'
                outputs must be equal.
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

  kmeans-seeds  how far the fit's k-means moves with its seeds: the fit
                (``--rows`` first rows, on ``--device``: ``cuda`` or
                ``cpu``), then its embedding through the single
                placement's ``kmeans`` (k-means++ on all rows) from
                ``--seeds`` other seeds and through the mesh's
                ``distributed_kmeans`` (k-means++ on a 64-row pool) in a
                gloo world of 1 from ``--seeds`` seeds; the ARI of each
                against the fit's labels, and each inertia.

Every mode on the card prints the card's name and power limit first.
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


def run_child(tree: Path, *args: str) -> dict:
    """One process of this script (mode ``args``) on ``tree``'s own
    ``src/``: the JSON line it prints last."""
    out = subprocess.run(
        [sys.executable, __file__, *args, "--src", str(tree / "src")],
        capture_output=True, text=True, timeout=900)
    if out.returncode:
        sys.exit(f"the study of {tree} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def alternate(trees, rounds: int, args, show) -> dict:
    """One process (``run_child(tree, *args)``) per (round, tree), the trees
    in the order A B, B A, A B, ...; ``show(round, tree, result)`` as each
    ends. Returns each tree's results."""
    runs = {str(t): [] for t in trees}
    for r in range(rounds):
        for tree in (trees if r % 2 == 0 else trees[::-1]):
            runs[str(tree)].append(run_child(tree, *args))
            show(r, tree, runs[str(tree)][-1])
    return runs


def ab(trees, rounds: int, fits: int) -> None:
    for tree in trees:                  # builds the kernels, untimed
        run_child(tree, "child", "--fits", "1")

    def show(r, tree, last):
        print(f"round {r} {tree}: fit median "
              f"{statistics.median(last['walls']):.4f}s "
              f"{[round(w, 4) for w in last['walls']]} iterations "
              f"{sorted(set(last['iterations']))}; gc ms "
              f"{[round(g['gc_ms'], 1) for g in last['gc']]}", flush=True)

    runs = alternate(trees, rounds, ("child", "--fits", str(fits)), show)
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


BUCKETS = (64, 256, 1_024, 4_096)        # the serving engine's
CHUNK = 131_072                          # the host-chunked fits' chunk


def rb_pattern(spec):
    """The RB idx (N, R) int32 on the card, d_g and D of the synthetic rows
    of ``spec`` (a ``SuiteSpec``'s fields), as chip_smoke.py's phases 2 and
    10 make them."""
    import torch

    from repro_torch.core import RBMap, SCRBConfig
    from repro_torch.core.rb import suggest_sigma
    from repro_torch.data.synthetic import SuiteSpec, generate
    from repro_torch.kernels import ops

    x, _ = generate(SuiteSpec(*spec), scale=1.0, seed=0)
    cfg = SCRBConfig(n_clusters=spec[1], n_grids=N_GRIDS,
                     sigma=suggest_sigma(x))
    xd = torch.as_tensor(x, device="cuda")
    p = RBMap(n_grids=N_GRIDS, sigma=cfg.sigma).fit(cfg.seed, xd).params
    idx = ops.rb_binning(xd, p.widths, p.biases, p.hash_a, p.hash_c,
                         d_g=p.d_g)
    return idx, p.d_g, p.n_features


def kernel_child(src: str) -> None:
    """One process of ``kernels``: the device ms of the tree whose ``src/``
    is ``src``, and each shape's bound, as one JSON line."""
    sys.path[:0] = [src, str(ROOT)]
    import torch

    from chip_smoke import POKER, bound, gather_bound, time_device
    from repro_torch.kernels import _build, ops
    _build.build_all()
    g = torch.Generator(device="cuda").manual_seed(0)
    ms, bounds = {}, {}

    def gather(name, ie, d_g, k):
        ve = torch.randn((ie.shape[1] * d_g, k), generator=g, device="cuda")
        se = torch.rand((ie.shape[0],), generator=g, device="cuda") + 0.5
        ms[name] = time_device(
            lambda: ops.z_matmul_gather(ie, ve, se, d_g=d_g), iters=100)[0]
        bounds[name] = gather_bound(ie, k)[0]

    def counts(name, ie, d_g, big_d):
        ms[name] = time_device(
            lambda: ops.bin_counts(ie, d=big_d, d_g=d_g))[0]
        bounds[name] = bound(ie.numel() * 4 + big_d * 4, ie.numel())[0]

    for spec in (COVTYPE, POKER):
        idx, d_g, big_d = rb_pattern(spec)
        n = idx.shape[0]
        tag = f"{spec[0]} d_g {d_g}"
        ragged = idx[n // CHUNK * CHUNK:]
        if spec is COVTYPE:
            for rows in BUCKETS:
                for k in (1, 7):
                    gather(f"{tag} gather {rows} x K {k}", idx[:rows], d_g, k)
            gather(f"{tag} gather floor (1 row, 1 grid)",
                   idx[:1, :1].contiguous(), d_g, 1)
        for k in ((1, 11) if spec is COVTYPE else (14, 32)):
            gather(f"{tag} gather ragged chunk {ragged.shape[0]} x K {k}",
                   ragged, d_g, k)
        counts(f"{tag} bin_counts whole", idx, d_g, big_d)
        counts(f"{tag} bin_counts chunk", idx[:CHUNK], d_g, big_d)
        counts(f"{tag} bin_counts ragged chunk {ragged.shape[0]}", ragged,
               d_g, big_d)
        del idx, ragged
        torch.cuda.empty_cache()
    print(json.dumps({"src": src, "ms": ms, "bound_ms": bounds}), flush=True)


def kernels(trees, rounds: int) -> None:
    def show(r, tree, last):
        print(f"round {r} {tree}: " + json.dumps(
            {k: round(x, 5) for k, x in last["ms"].items()}), flush=True)

    runs = alternate(trees, rounds, ("kernel-child",), show)
    first = next(iter(runs.values()))[0]
    for name, b_ms in first["bound_ms"].items():
        times = {tree: [p["ms"][name] for p in procs]
                 for tree, procs in runs.items()}
        print(f"{name} (bound {b_ms:.5f} ms): " + "; ".join(
            f"{tree} median {statistics.median(t):.5f} ms "
            f"{[round(x, 5) for x in t]}" for tree, t in times.items()),
            flush=True)


GATHER_FORMS = {"staged form": 1 << 62,   # ops.Z_GATHER_ROWS_MIN_OUTPUTS
                "register form": 0}


def gather_forms(rounds: int) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import time_device
    from repro_torch.kernels import ops
    idx, d_g, big_d = rb_pattern(COVTYPE)
    ragged = idx[idx.shape[0] // CHUNK * CHUNK:]
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = ([(idx[:n], k) for n in BUCKETS for k in (1, 7)]
              + [(idx[:n], 7) for n in (2_048, 2_560, 3_072)]
              + [(ragged, 1), (ragged, 11)])
    times = {}
    for _ in range(rounds):
        for ie, k in shapes:
            n = ie.shape[0]
            ve = torch.randn((big_d, k), generator=g, device="cuda")
            se = torch.rand((n,), generator=g, device="cuda") + 0.5
            outs = []
            for form, rows_min in GATHER_FORMS.items():
                ops.Z_GATHER_ROWS_MIN_OUTPUTS = rows_min
                outs.append(ops.z_matmul_gather(ie, ve, se, d_g=d_g))
                times.setdefault((n, k, form), []).append(time_device(
                    lambda: ops.z_matmul_gather(ie, ve, se, d_g=d_g),
                    iters=100)[0])
            if not all(torch.equal(o, outs[0]) for o in outs):
                sys.exit(f"the gather forms differ at {n} x K {k}")
    for (n, k, form), ms in times.items():
        print(f"gather {n} x K {k} ({n * k} outputs), {form}: median "
              f"{statistics.median(ms):.5f} ms {[round(t, 5) for t in ms]}",
              flush=True)


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


def kmeans_seeds(device: str, rows, seeds: int) -> None:
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.core import executor, metrics
    from repro_torch.core.distributed import distributed_kmeans
    from repro_torch.core.kmeans import kmeans
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.world import init_world
    from repro_torch.utils import make_generator

    x, cfg = covtype_fit_inputs()
    x = x[:rows] if rows else x
    res = executor.execute(x, cfg, device=device)
    u = torch.as_tensor(res.embedding, device=device)
    k, it, reps = cfg.n_clusters, cfg.kmeans_iters, cfg.kmeans_replicates
    print(f"fit of {x.shape[0]} rows on {device}: inertia "
          f"{res.diagnostics['kmeans_inertia']:.2f}", flush=True)
    for s in range(seeds):
        km = kmeans(make_generator(100 + s, device), u, k, n_iters=it,
                    n_replicates=reps)
        print(f"kmeans, k-means++ on all rows, seed {100 + s}: ARI "
              f"{metrics.adjusted_rand_index(km.labels.cpu().numpy(), res.labels):.4f}"
              f", inertia {float(km.inertia):.2f}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        init_world(0, 1, str(Path(tmp) / "store"), backend="gloo")
        try:
            mesh = make_host_mesh(device_type=torch.device(device).type)
            for s in range(seeds):
                km, _ = distributed_kmeans(200 + s, u, k, mesh,
                                           n=u.shape[0], n_iters=it,
                                           n_replicates=reps)
                print(f"distributed_kmeans, k-means++ on a 64-row pool, "
                      f"seed {200 + s}: ARI "
                      f"{metrics.adjusted_rand_index(km.labels.numpy(), res.labels):.4f}"
                      f", inertia {float(km.inertia):.2f}", flush=True)
        finally:
            dist.destroy_process_group()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="mode", required=True)
    p = sub.add_parser("ab")
    p.add_argument("--trees", type=Path, nargs="+", required=True)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--fits", type=int, default=6)
    p = sub.add_parser("kernels")
    p.add_argument("--trees", type=Path, nargs="+", required=True)
    p.add_argument("--rounds", type=int, default=2)
    p = sub.add_parser("gather-forms")
    p.add_argument("--rounds", type=int, default=2)
    p = sub.add_parser("child")
    p.add_argument("--src", required=True)
    p.add_argument("--fits", type=int, required=True)
    p = sub.add_parser("kernel-child")
    p.add_argument("--src", required=True)
    sub.add_parser("residuals")
    p = sub.add_parser("obs")
    p.add_argument("--pairs", type=int, default=6)
    sub.add_parser("lanczos-step")
    p = sub.add_parser("kmeans-seeds")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--rows", type=int, default=None)
    p.add_argument("--seeds", type=int, default=4)
    args = parser.parse_args()
    if args.mode == "kmeans-seeds":
        sys.path.insert(0, str(ROOT / "src"))
        if args.device == "cuda":
            print(card(), flush=True)
        kmeans_seeds(args.device, args.rows, args.seeds)
        return
    if args.mode == "child":
        child(args.src, args.fits)
        return
    if args.mode == "kernel-child":
        kernel_child(args.src)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(card(), flush=True)
    if args.mode == "ab":
        ab([t.resolve() for t in args.trees], args.rounds, args.fits)
        return
    if args.mode == "kernels":
        kernels([t.resolve() for t in args.trees], args.rounds)
        return
    sys.path.insert(0, str(ROOT / "src"))
    {"residuals": residuals, "obs": lambda: obs(args.pairs),
     "lanczos-step": lanczos_step,
     "gather-forms": lambda: gather_forms(args.rounds)}[args.mode]()


if __name__ == "__main__":
    main()
