"""Divide-and-conquer partitioned SC_RB — ``placement="partitioned"``.

The JAX package's ``core/partitioned.py``: the global eigensolve is
replaced by an embarrassingly parallel map and a tiny reduce (the
divide-and-conquer SC line, Li et al., arXiv:2104.15042):

  1. **partition**  rows split into P near-equal partitions (a seeded
     shuffle first; a block list is split by whole blocks, each partition
     streaming its own chunks under ``host_chunked`` residency);
  2. **partition_fits**  each partition runs the executor recursively
     (``placement="single"``, the same residency knobs, every partition
     with ``cfg.seed``) with one shared fitted feature map, so all
     partitions live in one D-dimensional feature space. Partition i runs
     on device i mod the devices: the local CUDA devices (all of them for
     ``device="cuda"``), or the CPU. With ``workers > 1`` a thread pool
     runs them, each worker thread under a CUDA stream of its own, whose
     stage times wait for that stream alone. Under a mesh (SPMD),
     partition i runs on rank ``partition_devices(mesh)[i mod S]``, on
     that rank's device;
  3. **merge**  each partition is summarised by its ``local_clusters``
     k-means centroids in feature space (cluster-mass-weighted means of ẑ
     rows, one ``rmatvec`` against the one-hot labels), in host float64;
     the union of representatives is factored by one (m × m)
     eigendecomposition into a merged right subspace V, Σ, and a weighted
     k-means over the representatives gives the K global centroids. Under
     a mesh the summaries are gathered first, so the merge runs
     identically on every rank;
  4. **label**  every row goes through the out-of-sample path the fitted
     model serves with, so ``predict(x_train)`` reproduces the fit labels
     and the merged model saves, loads and serves unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import featuremap, rowmatrix, streaming
from repro_torch.core.kmeans import KMeansResult
from repro_torch.core.options import PartitionOptions
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace
from repro_torch.utils import StageTimer, full_float32


# --------------------------------------------------------------------------
# Partitioning
# --------------------------------------------------------------------------

def partition_rows(x, n_partitions: int, *, shuffle: bool,
                   seed: int) -> List[Any]:
    """Split the input into ≤ ``n_partitions`` row groups, as the JAX
    package does: arrays into near-equal slices (a seeded shuffle first
    when ``shuffle``, each slice's rows kept in input order), block lists
    by whole blocks, never concatenated."""
    if n_partitions < 1:
        raise ValueError(f"n_partitions must be >= 1, got {n_partitions}")
    if isinstance(x, (list, tuple)):
        blocks = [_host(b) for b in x]
        if not blocks:
            raise ValueError("empty block sequence")
        order = np.arange(len(blocks))
        if shuffle and len(blocks) > 1:
            order = np.random.default_rng(seed).permutation(len(blocks))
        groups = [g for g in np.array_split(order, n_partitions) if g.size]
        return [[blocks[i] for i in g] for g in groups]
    xs = _host(x)
    n = xs.shape[0]
    size = -(-n // n_partitions)
    if shuffle:
        perm = np.random.default_rng(seed).permutation(n)
        return [xs[np.sort(perm[i:i + size])] for i in range(0, n, size)]
    return [xs[i:i + size] for i in range(0, n, size)]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _part_rows(part) -> int:
    if isinstance(part, list):
        return sum(int(b.shape[0]) for b in part)
    return int(part.shape[0])


# --------------------------------------------------------------------------
# Merge: per-partition centroid representatives → merged subspace + centroids
# --------------------------------------------------------------------------

def _feature_space_representatives(res, local_k: int
                                   ) -> Tuple[np.ndarray, np.ndarray]:
    """One partition's summary: the (m_p, D) cluster means of its ẑ rows
    and their (m_p,) masses, from one ``rmatvec`` of the one-hot label
    matrix (host chunks of it on a host-chunked partition, so no O(N)
    device array)."""
    z = res.state["z"]
    labels = res.state["km"].labels.cpu().numpy()
    if isinstance(z, rowmatrix.HostChunkedRows):
        offsets = np.concatenate([[0], np.cumsum(z.store.chunk_sizes)])
        onehot = streaming.ChunkedDense(tuple(
            torch.from_numpy((labels[offsets[i]:offsets[i + 1], None]
                              == np.arange(local_k)[None, :])
                             .astype(np.float32))
            for i in range(len(offsets) - 1)))
    else:
        onehot = torch.as_tensor(
            labels[:, None] == np.arange(local_k)[None, :],
            dtype=torch.float32, device=z.device)
    sums = z.rmatvec(onehot).cpu().numpy().astype(np.float64)   # (D, k_l)
    mass = np.bincount(labels, minlength=local_k).astype(np.float64)
    keep = mass > 0
    means = (sums[:, keep] / mass[keep][None, :]).T          # (m_p, D)
    return means, mass[keep]


def merge_representatives(reps: np.ndarray, weights: np.ndarray, k: int
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Factor the weighted representative matrix M (m, D) into the merged
    top-K right subspace: with S = W^{1/2} M, eigh(S Sᵀ) (an (m, m)
    problem, m = P·K_l) gives S Sᵀ = U Λ Uᵀ, so V = Sᵀ U Λ^{-1/2} are the
    right singular vectors and Σ = Λ^{1/2} the spectrum estimate. Returns
    (V (D, k), Σ (k,), rep_embedding (m, k) — the representatives
    projected into the merged space and row-normalised). Host float64, the
    JAX package's arithmetic."""
    m = reps.shape[0]
    if m < k:
        raise ValueError(
            f"only {m} non-empty partition representatives for k={k} "
            f"global clusters; raise n_partitions or local_clusters")
    sw = reps * np.sqrt(weights)[:, None]                    # (m, D)
    gram = sw @ sw.T                                         # (m, m)
    evals, evecs = np.linalg.eigh(gram)                      # ascending
    order = np.argsort(evals)[::-1][:k]
    lam = np.maximum(evals[order], 0.0)
    sig = np.sqrt(lam)
    inv_sig = np.where(sig > 1e-6, 1.0 / np.maximum(sig, 1e-30), 0.0)
    v = (sw.T @ evecs[:, order]) * inv_sig[None, :]          # (D, k)
    # representatives in the merged embedding: row-normalize(M V Σ⁻¹)
    rep_emb = (reps @ v) * inv_sig[None, :]
    norms = np.linalg.norm(rep_emb, axis=1, keepdims=True)
    rep_emb = rep_emb / np.maximum(norms, 1e-12)
    return v.astype(np.float32), sig.astype(np.float32), \
        rep_emb.astype(np.float32)


def _weighted_kmeans(rng: np.random.Generator, pts: np.ndarray,
                     weights: np.ndarray, k: int, *, iters: int,
                     replicates: int
                     ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Mass-weighted Lloyd over the (m, k) representatives (m ≤ P·K_l is
    tiny, so numpy): weighted k-means++ seeding and best of ``replicates``
    by weighted inertia; the JAX package's draws from the same ``rng``."""
    m = pts.shape[0]
    best = None
    for _ in range(max(1, replicates)):
        # weighted k-means++ init
        cents = np.empty((k, pts.shape[1]), np.float64)
        probs = weights / weights.sum()
        cents[0] = pts[rng.choice(m, p=probs)]
        d2 = ((pts - cents[0]) ** 2).sum(-1)
        for c in range(1, k):
            p = weights * d2
            total = p.sum()
            idx = rng.choice(m, p=p / total) if total > 0 else rng.choice(m)
            cents[c] = pts[idx]
            d2 = np.minimum(d2, ((pts - cents[c]) ** 2).sum(-1))
        labels = np.zeros((m,), np.int32)
        for _ in range(max(1, iters)):
            dists = ((pts[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
            labels = dists.argmin(1)
            for c in range(k):
                sel = labels == c
                mass = weights[sel].sum()
                if mass > 0:
                    cents[c] = (pts[sel] * weights[sel, None]).sum(0) / mass
                else:       # empty cluster: reseed at the farthest point
                    cents[c] = pts[dists.min(1).argmax()]
        dists = ((pts[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
        labels = dists.argmin(1)
        inertia = float((weights * dists[np.arange(m), labels]).sum())
        if best is None or inertia < best[2]:
            best = (cents.astype(np.float32), labels.astype(np.int32),
                    inertia)
    return best


# --------------------------------------------------------------------------
# Devices, workers and streams
# --------------------------------------------------------------------------

def _resolve_devices(plan, dev: torch.device) -> Sequence[Any]:
    """Where partitions go: the data shards' ranks under a mesh, else the
    local CUDA devices (all of them for ``cuda`` without an index) or the
    CPU."""
    if plan.mesh is not None:
        from repro_torch.launch.mesh import partition_devices
        return partition_devices(plan.mesh)
    if dev.type == "cuda" and dev.index is None:
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)


def _record_on(obj, stream: "torch.cuda.Stream") -> None:
    """``record_stream(stream)`` on every CUDA tensor reachable from
    ``obj`` (tensors, tuples, lists, dicts, dataclasses): the caching
    allocator then keeps each block from the stream that made it until
    ``stream``'s work queued so far is done."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            obj.record_stream(stream)
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            _record_on(o, stream)
    elif isinstance(obj, dict):
        for o in obj.values():
            _record_on(o, stream)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _record_on(getattr(obj, f.name), stream)


def _on_device(dev: torch.device):
    """``dev`` as the current CUDA device for the block (nothing on the
    CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class _WorkerStreams:
    """One CUDA stream per (worker thread, device), made on first use."""

    def __init__(self):
        self._local = threading.local()

    def get(self, dev: torch.device) -> "torch.cuda.Stream":
        streams = getattr(self._local, "streams", None)
        if streams is None:
            streams = self._local.streams = {}
        if dev not in streams:
            streams[dev] = torch.cuda.Stream(dev)
        return streams[dev]


# --------------------------------------------------------------------------
# The partitioned execute — called by executor.execute for the placement
# --------------------------------------------------------------------------

def execute_partitioned(x, cfg, plan, dev: torch.device, *,
                        final_stage: str = "kmeans",
                        keep_embedding: bool = True,
                        keep_state: bool = False):
    """Run the divide-and-conquer fit on ``dev``; the contract of
    ``executor.execute`` (its ``placement="partitioned"`` branch). Timer
    stages: ``partition`` / ``rb_features`` (the shared map) /
    ``partition_fits`` / ``merge`` / ``kmeans`` (the global labelling
    pass)."""
    from repro_torch.core import executor as _executor
    from repro_torch.core.model import _oos_embed_impl

    devices = _resolve_devices(plan, dev)
    popts: Optional[PartitionOptions] = cfg.partition
    if popts is None:
        popts = PartitionOptions(n_partitions=max(2, len(devices)))
    k = cfg.n_clusters
    local_k = popts.local_clusters or k
    timer = StageTimer(dev)

    with timer.stage("partition"):
        parts = partition_rows(x, popts.n_partitions,
                               shuffle=popts.shuffle, seed=cfg.seed)
    n_parts = len(parts)
    rows = [_part_rows(p) for p in parts]
    if min(rows) < local_k:
        raise ValueError(
            f"smallest partition has {min(rows)} rows < local_clusters="
            f"{local_k}; lower n_partitions")

    # one shared fitted feature map ⇒ all partitions in one feature space
    fm = plan.feature_map
    if fm is None:
        fm = featuremap.from_config(cfg, impl=plan.impl)
    with timer.stage("rb_features"):
        if plan.chunk_size is not None or isinstance(x, (list, tuple)):
            fitted = fm.fit(cfg.seed,
                            streaming.as_row_chunks(x, plan.chunk_size),
                            device=dev)
        else:
            fitted = fm.fit(cfg.seed, _executor.as_device_rows(x, dev))

    sub_plan = _executor.ExecutionPlan(
        placement="single",
        residency="host_chunked" if plan.chunk_size is not None
        else "device",
        chunk_size=plan.chunk_size, prefetch=plan.prefetch, impl=plan.impl,
        block_rows=plan.block_rows, feature_map=fitted,
        laplacian_normalize=plan.laplacian_normalize)
    sub_cfg = dataclasses.replace(cfg, n_clusters=local_k, partition=None)

    if plan.mesh is not None:
        me = dist.get_rank()
        mine = [i for i in range(n_parts)
                if devices[i % len(devices)] == me]
        part_dev = lambda i: dev
        workers = popts.workers or 1
    else:
        mine = list(range(n_parts))
        part_dev = lambda i: devices[i % len(devices)]
        workers = popts.workers or max(1, min(n_parts, len(devices)))
    streams = _WorkerStreams() if workers > 1 else None
    # the shared map on each partition's device, copied here: a copy to
    # another card is queued on both cards' current streams of this thread
    part_devs = {part_dev(i) for i in mine}
    sub_plans = {d: dataclasses.replace(sub_plan, feature_map=fitted.to(d))
                 for d in part_devs}
    # this thread's streams: the shared map's tensors were made on them
    made_on = {d: torch.cuda.current_stream(d) for d in part_devs
               if d.type == "cuda"}

    def fit_one(i: int):
        pdev = part_dev(i)
        stream = None
        if streams is not None and pdev.type == "cuda":
            stream = streams.get(pdev)
            stream.wait_stream(made_on[pdev])
        # this span closes on the worker thread, so each partition lands on
        # its worker's track, nested in time under the root "fit" span
        with obs_trace.span("partition_fit", partition=i, device=str(pdev),
                            rows=rows[i]):
            if stream is None:
                # the partition's card current, so that its stage timer
                # waits on that card's work
                with _on_device(pdev):
                    return _fit_partition(parts[i], sub_cfg,
                                          sub_plans[pdev], pdev), None
            with torch.cuda.stream(stream), obs_trace.stream_scoped_sync():
                return _fit_partition(parts[i], sub_cfg, sub_plans[pdev],
                                      pdev), stream

    with timer.stage("partition_fits"):
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers,
                                    thread_name_prefix="partfit") as pool:
                done = list(pool.map(fit_one, mine))
        else:
            done = [fit_one(i) for i in mine]
        results = []
        for res, stream in done:
            if stream is not None:
                # the merge reads the partition's tensors on this thread's
                # stream: order it after the worker's, and keep the
                # allocator from handing their blocks back to the worker
                # stream while this one may still use them
                here = torch.cuda.current_stream(stream.device)
                here.wait_stream(stream)
                _record_on((res.state["z"], res.state["km"]), here)
            results.append(res)

    with timer.stage("merge"):
        local = [_summarize(res, local_k, cfg) for res in results]
        if plan.mesh is not None:
            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, list(zip(mine, local)))
            by_part = dict(p for rank in gathered for p in rank)
            summaries = [by_part[i] for i in range(n_parts)]
        else:
            summaries = local
        reps = np.concatenate([s["means"] for s in summaries], axis=0)
        weights = np.concatenate([s["mass"] for s in summaries])
        dual = np.sum([s["dual"] for s in summaries], axis=0)
        v, sig, rep_emb = merge_representatives(reps, weights, k)
        dual = dual.astype(np.float32)
        centroids, rep_inertia = None, 0.0
        if final_stage == "kmeans":
            rng = np.random.default_rng(cfg.seed + 0x5EED)
            centroids, _, rep_inertia = _weighted_kmeans(
                rng, rep_emb, weights, k,
                iters=cfg.kmeans_iters, replicates=cfg.kmeans_replicates)

    # global labelling: every row through the out-of-sample path the fitted
    # model serves with — predict(x_train) reproduces these labels
    inv_sig = np.where(sig > 1e-6, 1.0 / np.maximum(sig, 1e-30),
                       0.0).astype(np.float32)
    fitted_dev = fitted.to(dev)
    proj = torch.as_tensor(v * inv_sig[None, :], device=dev)
    dual_t = torch.as_tensor(dual, device=dev)
    cents_t = None if centroids is None else torch.as_tensor(centroids,
                                                             device=dev)
    emb_chunks, label_chunks = [], []
    inertia = 0.0
    with timer.stage("kmeans"), full_float32():
        for c in streaming.as_row_chunks(x, plan.chunk_size):
            xb = _executor.as_device_rows(c, dev)
            u = _oos_embed_impl(fitted_dev, dual_t, proj, xb,
                                laplacian=plan.laplacian_normalize)
            if cents_t is not None:
                lab, d2 = ops.kmeans_assign(u.contiguous(), cents_t,
                                            impl=cfg.impl)
                label_chunks.append(lab.cpu().numpy())
                inertia += float(torch.sum(d2))
            if keep_embedding:
                emb_chunks.append(u.cpu().numpy())

    labels = np.concatenate(label_chunks) if label_chunks else None
    embedding = (np.concatenate(emb_chunks, axis=0) if emb_chunks
                 else None)
    part_diag = {
        "n_partitions": n_parts,
        "workers": workers,
        "local_clusters": local_k,
        "shuffle": popts.shuffle,
        "partition_rows": rows,
        "partition_fit_s": [s["fit_s"] for s in summaries],
        "partition_stage_s": [s["stage_s"] for s in summaries],
        "representatives": int(reps.shape[0]),
        "rep_kmeans_inertia": float(rep_inertia),
        "merge_singular_values": [float(s) for s in sig],
        "devices": len(devices),
    }
    diagnostics = {
        "plan": {"placement": "partitioned", "residency": plan.residency,
                 "chunk_size": plan.chunk_size, "prefetch": plan.prefetch,
                 "impl": plan.impl},
        "device": str(dev),
        "feature_map": fitted.name,
        "solver": summaries[0]["solver"],
        "solver_requested": cfg.solver_options.solver,
        "solver_precond": cfg.solver_options.precond,
        "solver_iterations": max(s["iterations"] for s in summaries),
        "solver_resnorms": np.max(np.stack(
            [s["resnorms"] for s in summaries]), axis=0),
        "degrees_min": min(s["degrees"][0] for s in summaries),
        "degrees_max": max(s["degrees"][1] for s in summaries),
        "n_features_D": fitted.n_features,
        "nnz": sum(rows) * (fitted.n_grids if fitted.kind == "ell"
                            else fitted.n_features),
        "partitioned": part_diag,
    }
    if labels is not None:
        diagnostics["kmeans_inertia"] = inertia

    z_all = rowmatrix.PartitionedRows(
        parts=tuple(r.state["z"] for r in results), fmap=fitted_dev,
        dual=dual_t, part_rows=tuple(rows),
        degree_ranges=tuple(s["degrees"] for s in summaries),
        part_residency=tuple(s["residency"] for s in summaries))
    diagnostics.update(z_all.residency_diagnostics(cfg))
    km = None
    if labels is not None:
        km = KMeansResult(centroids=cents_t,
                          labels=torch.from_numpy(labels),
                          inertia=torch.tensor(inertia))
    state = None
    if keep_state:
        state = {
            "z": z_all,
            "features": rowmatrix.FittedFeatures(fitted_dev, None),
            "eig": None, "u_hat": None, "km": km, "plan": plan,
            "oos_proj": None,
            # the merged O(D·K) out-of-sample state, precomputed: no extra
            # rmatvec pass in SCRBModel.fit
            "partitioned": {"right_vectors": v, "singular_values": sig,
                            "degree_dual": dual},
        }
    for res in results:
        res.state = None              # drop per-partition O(N_p) internals
    return _executor.FitResult(
        labels=labels,
        embedding=embedding,
        singular_values=sig,
        timer=timer,
        diagnostics=diagnostics,
        state=state,
    )


def _fit_partition(xp, sub_cfg, sub_plan, dev: torch.device):
    """One partition: a complete single-placement fit ending in its local
    k-means (recursive executor reuse), its state kept for the merge."""
    from repro_torch.core import executor as _executor
    if isinstance(xp, list) and sub_plan.residency == "device":
        xp = np.concatenate(xp)          # a block-list partition, resident
    return _executor.execute(xp, sub_cfg, sub_plan, final_stage="kmeans",
                             keep_embedding=False, keep_state=True,
                             device=dev)


def _summarize(res, local_k: int, cfg) -> dict:
    """What the merge needs of one partition, on the host: its
    representatives and masses, its degree dual, and its diagnostics."""
    z = res.state["z"]
    means, mass = _feature_space_representatives(res, local_k)
    diag = res.diagnostics
    return {
        "means": means, "mass": mass,
        "dual": z.degree_dual().cpu().numpy().astype(np.float64),
        "fit_s": res.timer.total, "stage_s": dict(res.timer.times),
        "solver": diag["solver"],
        "iterations": int(diag["solver_iterations"]),
        "resnorms": np.asarray(diag["solver_resnorms"]),
        "degrees": (diag["degrees_min"], diag["degrees_max"]),
        "residency": z.residency_diagnostics(cfg),
    }
