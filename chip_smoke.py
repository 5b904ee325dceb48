#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(with ``nvcc``, into the package's ignored ``build/`` directory), holds each
kernel against its plain PyTorch version at the main path's shapes, then
drives the main path through the entry points a user calls, at the size of
the paper's covtype dataset (N = 581,012, d = 54, K = 7; synthetic content
from a seed):

  phase 0  card and library versions
  phase 1  kernel build
  phase 2  every kernel against its plain version, with times and bounds
  phase 3  SCRBModel.fit on the card; every kernel's launch count > 0
  phase 4  save → load → predict (requests of 64, 1,000, 4,096 rows and a
           100,000-row batch); predict agrees with the fit labels ≥ 0.99
  phase 5  two fits of a 65,536-row slice give identical labels

Any failed check raises, and the script exits non-zero. It exits non-zero
before printing any result when no CUDA device is available or when the
package is not beside it. The last line is
``{"ok": true, "device": {...}}``; the line before it holds the card's name
and power limit, and the one before that the kernels' JSON record.

Bounds: ``bound_ms`` is the larger of (bytes each input read once and each
output written once) / 3.35 TB/s and (float32 operations) / 67 TFLOP/s,
the published H100 SXM peaks (dense, without sparsity, at 700 W).
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

COVTYPE = ("covtype-mult", 7, 54, 581_012, "aniso")   # paper Table 1
N_GRIDS = 256
EIG_BLOCK = 11            # LOBPCG block width at K = 7 (K + buffer 4)
SERVE_REQUESTS = (64, 1_000, 4_096)
SERVE_BATCH_ROWS = 100_000
DETERMINISM_ROWS = 65_536


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# --------------------------------------------------------------------------
# measurement helpers
# --------------------------------------------------------------------------

def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, f32_ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = f32_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within_sum_tolerance(got, want, abs_terms, rtol=1e-5, atol=1e-6):
    """Sums taken in another order agree to ``atol + rtol · Σ|terms|``:
    the float32 rounding of a sum is bounded by its absolute terms, not by
    its value (which may cancel to near 0)."""
    import torch
    err = (got.float() - want.float()).abs()
    ok = bool(torch.all(err <= atol + rtol * abs_terms))
    return ok, float(err.max()) if err.numel() else 0.0


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase0_card() -> dict:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    log(f"[phase 0] card: {smi}")
    log(f"[phase 0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, devices {device['count']}")
    return {"smi": smi, "device": device}


def phase1_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build_all()
    for name, info in report.items():
        log(f"[phase 1] built {name} in {info['seconds']:.1f}s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[phase 1]   {line.strip()}")
    for name in _build.LIBRARIES:
        _build.library(name)
    log(f"[phase 1] build + load {time.perf_counter() - t0:.1f}s")


def phase2_kernels(x, fm, seed: int = 0) -> list:
    """Every kernel against its plain version at the main path's shapes."""
    import torch

    from repro_torch.core import eigensolver, graph
    from repro_torch.core.kmeans import row_normalize
    from repro_torch.kernels import ops, ref

    dev = x.device
    n, d = x.shape
    p = fm.params
    r, d_g, big_d = p.n_grids, p.d_g, p.n_features
    kb = EIG_BLOCK
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = []

    # -- rb_binning: bit for bit -------------------------------------------
    args = (x, p.widths, p.biases, p.hash_a, p.hash_c)
    idx = ops.rb_binning(*args, d_g=d_g)
    want = ref.rb_binning_ref(*args, d_g)
    mism = int((idx != want).sum())
    if mism:
        fail(f"rb_binning differs from its plain version in {mism} entries")
    ms = time_ms(lambda: ops.rb_binning(*args, d_g=d_g))
    plain_ms = time_ms(lambda: ref.rb_binning_ref(*args, d_g), iters=2,
                       warmup=1)
    b_ms, b_by = bound(n * d * 4 + 3 * r * d * 4 + r * 4 + n * r * 4,
                       3.0 * n * r * d)
    rows.append(dict(name="rb_binning", route="cuda",
                     source="src/repro_torch/kernels/csrc/rb_binning.cu",
                     replaces="src/repro/kernels/rb_binning.py:74",
                     max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None,
                     check="bit-exact on all rows"))
    del want

    # -- the ELL products, on the fit's own pattern and row scales ----------
    adj = graph.build_normalized_adjacency(idx, d=big_d, d_g=d_g)
    s, csc = adj.rowscale, adj.csc
    u = torch.randn((n, kb), generator=g, device=dev)
    v = torch.randn((big_d, kb), generator=g, device=dev)
    idx_bytes = n * r * 4

    got = ops.z_matmul(idx, v, s, d_g=d_g)
    want = ref.z_matmul_ref(idx, v, s)
    ok, err = within_sum_tolerance(got, want,
                                   ref.z_matmul_ref(idx, v.abs(), s.abs()))
    if not ok:
        fail(f"z_matmul differs from its plain version (max abs {err:.3g})")
    w_bag = s[:, None].expand(n, r).contiguous()
    lib_ms = time_ms(lambda: torch.nn.functional.embedding_bag(
        idx, v, mode="sum", per_sample_weights=w_bag))
    del w_bag
    b_ms, b_by = bound(idx_bytes + big_d * kb * 4 + n * 4 + n * kb * 4,
                       n * r * kb + n * kb)
    rows.append(dict(name="z_matmul", route="cuda",
                     source="src/repro_torch/kernels/csrc/ell_spmm.cu",
                     replaces="src/repro/kernels/ell_spmm.py:85",
                     max_abs_err=err,
                     ms=time_ms(lambda: ops.z_matmul(idx, v, s, d_g=d_g)),
                     plain_ms=time_ms(lambda: ref.z_matmul_ref(idx, v, s),
                                      iters=3, warmup=1),
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     check="|err| <= 1e-6 + 1e-5 * sum|terms|"))

    got = ops.zt_matmul(idx, u, s, big_d, d_g=d_g, csc=csc)
    want = ref.zt_matmul_ref(idx, u, s, big_d)
    ok, err = within_sum_tolerance(
        got, want, ref.zt_matmul_ref(idx, u.abs(), s.abs(), big_d))
    if not ok:
        fail(f"zt_matmul differs from its plain version (max abs {err:.3g})")
    src_rows = (u * s[:, None]).repeat_interleave(r, dim=0)
    flat = idx.reshape(-1)
    lib_ms = time_ms(lambda: torch.zeros((big_d, kb), device=dev).index_add_(
        0, flat, src_rows), iters=3, warmup=1)
    del src_rows
    b_ms, b_by = bound(idx_bytes + (big_d + 1) * 8 + n * kb * 4 + n * 4
                       + big_d * kb * 4, 2.0 * n * r * kb)
    rows.append(dict(name="zt_matmul", route="cuda",
                     source="src/repro_torch/kernels/csrc/ell_spmm.cu",
                     replaces="src/repro/kernels/ell_spmm.py:222",
                     max_abs_err=err,
                     ms=time_ms(lambda: ops.zt_matmul(idx, u, s, big_d,
                                                      d_g=d_g, csc=csc)),
                     plain_ms=time_ms(lambda: ref.zt_matmul_ref(
                         idx, u, s, big_d), iters=3, warmup=1),
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     check="|err| <= 1e-6 + 1e-5 * sum|terms|"))

    # -- the Gram operator: zt kernel then z kernel (no kernel of its own) --
    got = ops.gram_matmul(idx, u, s, big_d, d_g=d_g, csc=csc)
    want = ref.z_matmul_ref(idx, ref.zt_matmul_ref(idx, u, s, big_d), s)
    terms = ref.z_matmul_ref(
        idx, ref.zt_matmul_ref(idx, u.abs(), s.abs(), big_d), s.abs())
    ok, err = within_sum_tolerance(got, want, terms)
    if not ok:
        fail(f"gram_matmul differs from its plain version (max abs {err:.3g})")
    gram_ms = time_ms(lambda: ops.gram_matmul(idx, u, s, big_d, d_g=d_g,
                                              csc=csc))
    gram_bound, gram_by = bound(idx_bytes + n * kb * 4 + n * 4 + n * kb * 4,
                                4.0 * n * r * kb)
    log(f"[phase 2] gram_matmul (zt kernel + z kernel): ms={gram_ms:.4f} "
        f"bound_ms={gram_bound:.4f} ({gram_by}) max_abs_err={err:.3g} ok")
    # the dense LOBPCG algebra around each Gram product, at the same shape
    x_blk = torch.linalg.qr(u)[0]
    w_blk = torch.randn((n, kb), generator=g, device=dev)
    res_ms = time_ms(lambda: eigensolver._lobpcg_residual_block(
        x_blk, u, 1e-4, s), iters=5)
    rr_ms = time_ms(lambda: eigensolver._lobpcg_rr_update(
        x_blk, u, w_blk, u, w_blk, u, kb), iters=5)
    log(f"[phase 2] lobpcg dense algebra per iteration (N={n}, b={kb}): "
        f"residual_block ms={res_ms:.4f} rr_update ms={rr_ms:.4f}")

    # -- kmeans_assign, on a row-normalized 7-wide embedding ---------------
    k_cl = COVTYPE[1]
    emb = row_normalize(torch.randn((n, k_cl), generator=g, device=dev))
    cents = emb[torch.randperm(n, generator=g, device=dev)[:k_cl]].contiguous()
    lab, dist = ops.kmeans_assign(emb, cents)
    lab_p, dist_p = ref.kmeans_assign_ref(emb, cents)
    d2 = (emb * emb).sum(-1, keepdim=True) - 2.0 * emb @ cents.T \
        + (cents * cents).sum(-1)[None]
    two = torch.topk(d2, 2, dim=1, largest=False).values
    clear = (two[:, 1] - two[:, 0]) > 1e-6
    bad = int(((lab != lab_p) & clear).sum())
    err = float((dist - dist_p).abs().max())
    if bad or err > 1e-5:
        fail(f"kmeans_assign differs from its plain version: {bad} labels "
             f"where the best two distances differ by > 1e-6, max distance "
             f"error {err:.3g}")
    b_ms, b_by = bound(n * k_cl * 4 + k_cl * k_cl * 4 + n * 8,
                       3.0 * n * k_cl * k_cl)
    rows.append(dict(name="kmeans_assign", route="cuda",
                     source="src/repro_torch/kernels/csrc/kmeans_assign.cu",
                     replaces="src/repro/kernels/kmeans_assign.py:41",
                     max_abs_err=err,
                     ms=time_ms(lambda: ops.kmeans_assign(emb, cents),
                                iters=50),
                     plain_ms=time_ms(lambda: ref.kmeans_assign_ref(
                         emb, cents), iters=50),
                     bound_ms=b_ms, bound_by=b_by,
                     library_ms=time_ms(lambda: torch.cdist(emb, cents)
                                        .argmin(1), iters=50),
                     check="labels equal where top-2 gap > 1e-6; "
                           "|dist err| <= 1e-5"))
    for row in rows:
        log(f"[phase 2] {row['name']}: ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']}) library_ms={row['library_ms']} "
            f"max_abs_err={row['max_abs_err']:.3g} ok ({row['check']})")
    return rows


def phase3_fit(x_np, y_np, cfg):
    import torch

    from repro_torch.core import SCRBModel, metrics
    from repro_torch.kernels import ops

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    model = SCRBModel.fit(x_np, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    res = model.fit_result
    diag = res.diagnostics
    log(f"[phase 3] fit N={x_np.shape[0]} d={x_np.shape[1]} "
        f"K={cfg.n_clusters} R={cfg.n_grids} sigma={cfg.sigma:.6g} "
        f"d_g={diag['d_g']} D={diag['n_features_D']} in {wall:.2f}s")
    log("[phase 3] stages (s): " + ", ".join(
        f"{k}={v:.3f}" for k, v in res.timer.times.items()))
    log(f"[phase 3] solver_iterations={diag['solver_iterations']} "
        f"resnorms={[float(f'{r:.3g}') for r in diag['solver_resnorms']]} "
        f"singular_values={[float(f'{s:.5f}') for s in res.singular_values]}")
    log(f"[phase 3] ACC={metrics.accuracy(res.labels, y_np):.4f} "
        f"NMI={metrics.nmi(res.labels, y_np):.4f} against the synthetic "
        "truth (for information)")
    log(f"[phase 3] max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[phase 3] kernel launches during the fit: {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        fail(f"the fit launched no {missing} kernel")
    if res.labels.shape != (x_np.shape[0],):
        fail(f"labels have shape {res.labels.shape}")
    return model, counts


def phase4_serve(model, x_np):
    from repro_torch.core import SCRBModel, metrics
    from repro_torch.kernels import ops

    fit_labels = model.fit_result.labels
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "model.npz")
        model.save(path)
        size = Path(path).stat().st_size
        ops.reset_launch_counts()
        served = SCRBModel.load(path, device="cuda")
        log(f"[phase 4] saved and loaded a {size / 2**20:.2f} MiB artifact "
            f"(state {served.nbytes} bytes)")
        for n_req in SERVE_REQUESTS:
            t0 = time.perf_counter()
            pred = served.predict(x_np[:n_req])
            dt = time.perf_counter() - t0
            acc = metrics.accuracy(pred, fit_labels[:n_req])
            log(f"[phase 4] predict {n_req} rows: {dt * 1e3:.2f} ms, "
                f"agreement with the fit labels {acc:.4f}")
            if acc < 0.99:
                fail(f"predict agrees with the fit labels at {acc:.4f} < 0.99")
        rows = x_np[:SERVE_BATCH_ROWS]
        served.predict(rows[:4096], batch_size=4096)        # warm the buckets
        t0 = time.perf_counter()
        pred = served.predict(rows, batch_size=4096)
        dt = time.perf_counter() - t0
        acc = metrics.accuracy(pred, fit_labels[:SERVE_BATCH_ROWS])
        log(f"[phase 4] predict {SERVE_BATCH_ROWS} rows (batch_size=4096): "
            f"{dt:.3f} s, {SERVE_BATCH_ROWS / dt:.0f} rows/s, agreement "
            f"{acc:.4f}")
        if acc < 0.99:
            fail(f"predict agrees with the fit labels at {acc:.4f} < 0.99")
        log(f"[phase 4] kernel launches while serving: {ops.launch_counts()}")


def phase5_determinism(x_np, cfg):
    import numpy as np

    from repro_torch.core import sc_rb

    xs = x_np[:DETERMINISM_ROWS]
    t0 = time.perf_counter()
    a = sc_rb(xs, cfg).labels
    b = sc_rb(xs, cfg).labels
    same = bool(np.array_equal(a, b))
    log(f"[phase 5] two fits of {DETERMINISM_ROWS} rows in "
        f"{time.perf_counter() - t0:.2f}s: labels identical = {same}")
    if not same:
        fail(f"two fits differ in {int((a != b).sum())} labels")


def main() -> None:
    t_start = time.perf_counter()
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the repro_torch package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(SRC))
    card = phase0_card()

    import torch

    from repro_torch.core import RBMap, SCRBConfig
    from repro_torch.core.rb import suggest_sigma
    from repro_torch.data.synthetic import SuiteSpec, generate

    t0 = time.perf_counter()
    phase1_build()
    log(f"[phase 1] {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    x_np, y_np = generate(SuiteSpec(*COVTYPE), scale=1.0, seed=0)
    sigma = suggest_sigma(x_np)
    cfg = SCRBConfig(n_clusters=COVTYPE[1], n_grids=N_GRIDS, sigma=sigma)
    log(f"[data] covtype-shaped synthetic N={x_np.shape[0]} d={x_np.shape[1]}"
        f" K={COVTYPE[1]}, sigma={sigma:.6g}, made in "
        f"{time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    x_dev = torch.as_tensor(x_np, device="cuda")
    fm = RBMap(n_grids=N_GRIDS, sigma=sigma).fit(cfg.seed, x_dev)
    kernels = phase2_kernels(x_dev, fm)
    del x_dev
    torch.cuda.empty_cache()
    log(f"[phase 2] {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    model, counts = phase3_fit(x_np, y_np, cfg)
    log(f"[phase 3] {time.perf_counter() - t0:.1f}s")
    for row in kernels:
        row["launches"] = counts[row["name"]]

    t0 = time.perf_counter()
    phase4_serve(model, x_np)
    log(f"[phase 4] {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    phase5_determinism(x_np, cfg)
    log(f"[phase 5] {time.perf_counter() - t0:.1f}s")

    log(f"[total] {time.perf_counter() - t_start:.1f}s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in kernels]}))
    print(card["smi"])
    print(json.dumps({"ok": True, "device": card["device"]}), flush=True)


if __name__ == "__main__":
    main()
