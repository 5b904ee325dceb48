"""Plan-based stage-graph executor for SC_RB (the paper's Algorithm 2).

The five stages —

  1. Z  ← RB features of X          (Alg. 1, hashed ELL)          O(NRd)
  2. D̂ ← Z(Zᵀ1); Ẑ = D̂^{-1/2} Z    (Eq. 6)                       O(NR)
  3. U  ← top-K left singular vecs of Ẑ (blocked LOBPCG)          O(KNRm)
  4. Û ← row-normalize(U)
  5. labels ← k-means(Û, K)                                        O(NK²t)

— run once here, on one device (``device="cuda"`` unless the caller asks
for the CPU). ``SCRBConfig``, ``ExecutionPlan`` and ``FitResult`` keep the
JAX package's fields, so configs and artifacts round-trip between the two
packages. Every plan of the JAX package runs:

  placement  ``single``       one device;
             ``mesh``         SPMD row shards over ``torch.distributed``
                              (``SCRBModel.fit(..., mesh=...)``; every rank
                              calls with the same x; ELL maps);
             ``partitioned``  the divide-and-conquer fit
                              (``SCRBConfig(partition=PartitionOptions(
                              n_partitions>1))``, ``core.partitioned``),
                              with or without a mesh;
  residency  ``device``       whole arrays on the device (the default);
             ``host_chunked`` ``SCRBConfig(chunk_size=...)``: x and every
                              O(N) array on the host in row chunks, one
                              uploaded at a time; under a mesh, the
                              within-shard chunking of every sweep;

with every solver and every registered feature map
(``ExecutionPlan(feature_map=...)``: the Table-2 baselines).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import compressive, featuremap, rowmatrix, streaming
from repro_torch.core.kmeans import row_normalize
from repro_torch.core.options import (
    UNSET, CompressiveOptions, PartitionOptions, SolverOptions,
    normalize_config,
)
from repro_torch.obs import memory as obs_memory
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.utils import StageTimer, fold_seed, resolve_device

_FITS_TOTAL = obs_metrics.REGISTRY.counter(
    "repro_fits_total", "Completed executor fits.", ("placement", "solver"))
_FIT_ROWS = obs_metrics.REGISTRY.counter(
    "repro_fit_rows_total", "Rows processed by completed executor fits.",
    ("placement",))

# flat fields kept as deprecated shims; typed Any so the UNSET sentinel can
# flow through (see repro_torch.core.options.normalize_config)
_Flat = Any


@dataclasses.dataclass(frozen=True)
class SCRBConfig:
    """Run configuration, field for field the JAX package's: solver,
    compressive and partition knobs live in typed groups
    (``repro_torch.core.options``), the historical flat ``solver_*`` /
    ``compressive_*`` kwargs still work as deprecated shims. The device is
    not a field: it is a keyword of the entry points, so ``to_dict()`` and
    the saved artifact stay byte-compatible with the JAX package's.

    ``impl`` is kept only so artifacts round-trip: kernels dispatch by the
    device of their tensors, whatever its value."""

    n_clusters: int
    n_grids: int = 256            # R
    sigma: float = 1.0            # Laplacian kernel bandwidth
    d_g: Optional[int] = None     # hashed features per grid (power of 2);
                                  # None → auto-size from occupied-bin probe
    # -- deprecated flat shims (fold into solver_options) -------------------
    solver: _Flat = UNSET
    solver_iters: _Flat = UNSET
    solver_tol: _Flat = UNSET
    solver_buffer: _Flat = UNSET
    solver_precond: _Flat = UNSET
    solver_stable_tol: _Flat = UNSET
    # -- deprecated flat shims (fold into compressive_options) --------------
    compressive_signals: _Flat = UNSET
    compressive_degree: _Flat = UNSET
    compressive_probes: _Flat = UNSET
    compressive_subset: _Flat = UNSET
    compressive_lambdas: _Flat = UNSET
    compressive_auto_n: _Flat = UNSET
    # -----------------------------------------------------------------------
    kmeans_iters: int = 25
    kmeans_replicates: int = 10
    seed: int = 0
    impl: str = "auto"            # auto | pallas | xla: all dispatch by device
    chunk_size: Optional[int] = None      # rows per host chunk → streaming
    prefetch: bool = True                 # double-buffered H2D chunk uploads
    block_rows: Optional[Mapping[str, int]] = None   # TPU tiling; unused here
    trace: Optional[str] = None
    # ^ Chrome-trace output path: enables obs tracing for this fit and
    #   writes the trace on completion; run-local, never in the artifact
    # -- typed option groups (canonical; see repro_torch.core.options) ------
    solver_options: Optional[SolverOptions] = None
    compressive_options: Optional[CompressiveOptions] = None
    partition: Optional[PartitionOptions] = None

    def __post_init__(self):
        normalize_config(self)

    def to_dict(self) -> dict:
        """JSON-ready config dict in the flat spelling (plus a nested
        ``partition`` entry when set) — the JAX package's artifact layout."""
        d = {}
        for f in dataclasses.fields(self):
            if f.name in ("solver_options", "compressive_options",
                          "partition", "trace"):
                continue
            d[f.name] = getattr(self, f.name)
        if d.get("block_rows") is not None:
            d["block_rows"] = dict(d["block_rows"])
        if d.get("compressive_lambdas") is not None:
            d["compressive_lambdas"] = list(d["compressive_lambdas"])
        if self.partition is not None:
            d["partition"] = dataclasses.asdict(self.partition)
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "SCRBConfig":
        """Rebuild from ``to_dict`` output; flat keys here are round-trip
        data, so the deprecation warning is suppressed."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return cls(**dict(d))


@dataclasses.dataclass
class FitResult:
    """The typed result of one executor run. Unpacks as the historical
    ``(embedding, singular_values)`` pair."""

    labels: Optional[np.ndarray]  # (N,) int32; None when stages stop early
    embedding: Optional[np.ndarray]  # (N, K) row-normalized embedding
    singular_values: np.ndarray   # (K,) of Ẑ  (σ_i = sqrt(eigval of ẐẐᵀ))
    timer: StageTimer
    diagnostics: dict
    state: Optional[dict] = None  # fitted internals (``keep_state=True``)

    def __iter__(self):
        yield self.embedding
        yield self.singular_values

    @property
    def timings(self) -> dict:
        return self.timer.times


SCRBResult = FitResult


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Placement × residency (+ orthogonal knobs) for one SC_RB run; the
    JAX package's fields. ``eig_x0`` warm-starts (or injects) the
    eigensolve's start block; ``feature_map`` injects a (fitted) stage-1
    map."""

    placement: str = "single"            # single | mesh | partitioned
    residency: str = "device"            # device | host_chunked
    chunk_size: Optional[int] = None
    prefetch: bool = True
    impl: str = "auto"
    collective_compress: bool = False
    mesh: Optional[Any] = None
    block_rows: Optional[Mapping[str, int]] = None
    feature_map: Optional[Any] = None
    laplacian_normalize: bool = True
    eig_x0: Optional[Any] = None

    def __post_init__(self):
        if self.placement not in ("single", "mesh", "partitioned"):
            raise ValueError(f"unknown placement {self.placement!r}")
        if self.residency not in ("device", "host_chunked"):
            raise ValueError(f"unknown residency {self.residency!r}")
        if self.placement == "mesh" and self.mesh is None:
            raise ValueError("placement='mesh' requires a mesh")
        if self.placement == "single" and self.mesh is not None:
            raise ValueError("placement='single' must not carry a mesh")
        if (self.residency == "host_chunked" and self.placement != "mesh"
                and self.chunk_size is None):
            raise ValueError("residency='host_chunked' requires chunk_size")


_REPRESENTATIONS = {
    ("single", "device"): rowmatrix.DeviceRows,
    ("single", "host_chunked"): rowmatrix.HostChunkedRows,
    ("mesh", "device"): rowmatrix.MeshRows,
    ("mesh", "host_chunked"): rowmatrix.MeshRows,
    # the divide-and-conquer fit: per-partition single-placement sub-fits
    # aggregated by core.partitioned
    ("partitioned", "device"): rowmatrix.PartitionedRows,
    ("partitioned", "host_chunked"): rowmatrix.PartitionedRows,
}


def plan_from_config(config: SCRBConfig, mesh=None) -> ExecutionPlan:
    """The config → plan mapping behind the public entry points."""
    so = config.solver_options
    if config.chunk_size is not None and mesh is None \
            and so.solver not in ("lobpcg", "lobpcg_host", "randomized",
                                  "auto", "compressive"):
        raise ValueError(
            f"chunk_size streaming requires a host-driven solver "
            f"('lobpcg', 'lobpcg_host', 'randomized', 'auto' or "
            f"'compressive'), got {so.solver!r}")
    part = config.partition
    placement = "single"
    if part is not None and part.n_partitions > 1:
        placement = "partitioned"
    elif mesh is not None:
        placement = "mesh"
    return ExecutionPlan(
        placement=placement,
        residency="host_chunked" if config.chunk_size is not None
        else "device",
        chunk_size=config.chunk_size,
        prefetch=config.prefetch,
        impl=config.impl,
        mesh=mesh if placement != "single" else None,
        block_rows=config.block_rows,
    )


def effective_solver(config: SCRBConfig, n: int) -> str:
    """The solver a run executes: ``"auto"`` routes to the compressive cell
    at n ≥ ``compressive_auto_n``; everything else is taken literally."""
    so, co = config.solver_options, config.compressive_options
    if so.solver == "compressive":
        return "compressive"
    if so.solver == "auto" and co.auto_n is not None and n >= co.auto_n:
        return "compressive"
    return so.solver


def representation(plan: ExecutionPlan):
    """The RowMatrix class a plan selects."""
    return _REPRESENTATIONS[(plan.placement, plan.residency)]


def _check_feature_map(plan: ExecutionPlan) -> None:
    if plan.feature_map is not None and not isinstance(
            plan.feature_map, tuple(featuremap.FEATURE_MAPS.values())):
        raise ValueError(
            f"feature_map must be one of {sorted(featuremap.FEATURE_MAPS)}'s "
            f"maps, got {type(plan.feature_map).__name__}")


def as_device_rows(x, device: torch.device) -> torch.Tensor:
    """Input rows as a float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def configure_device(device: torch.device) -> None:
    """Turn TF32 off for the fit's dense algebra (float32 products run in
    full float32, as the reference's do)."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def execute(
    x,
    config: SCRBConfig,
    plan: Optional[ExecutionPlan] = None,
    *,
    final_stage: str = "kmeans",
    keep_embedding: bool = True,
    keep_state: bool = False,
    device="cuda",
) -> FitResult:
    """Run Algorithm 2 under a plan on ``device``.

    ``final_stage="normalize"`` stops after stage 4 (labels are None).
    ``keep_embedding=False`` leaves the (N, K) embedding out of the result.
    ``keep_state=True`` attaches the fitted internals (row matrix, fitted
    map, eigenpairs, k-means result) to ``result.state`` for
    ``SCRBModel.fit``. A device-residency plan moves ``x`` to ``device``
    first; a host-chunked plan leaves ``x`` (an array, a tensor or a list of
    row chunks) on the host.

    The run executes under a root ``fit`` span; ``cfg.trace`` scopes
    tracing to it and exports the Chrome trace on exit.
    """
    cfg = config
    dev = resolve_device(device)
    if plan is None:
        plan = plan_from_config(cfg)
    if final_stage not in ("normalize", "kmeans"):
        raise ValueError(f"unknown final_stage {final_stage!r}")
    _check_feature_map(plan)
    configure_device(dev)
    with obs_trace.tracing(cfg.trace):
        with obs_memory.Watermark() as wm:
            with obs_trace.span("fit", placement=plan.placement,
                                residency=plan.residency) as root:
                if plan.placement == "single" and plan.residency == "device":
                    x = as_device_rows(x, dev)
                res = _execute_impl(
                    x, cfg, plan, dev, final_stage=final_stage,
                    keep_embedding=keep_embedding, keep_state=keep_state)
                solver = res.diagnostics["solver"]
                root.set(solver=solver)
        res.diagnostics.setdefault("memory", wm.as_dict())
    n_rows = (res.labels.shape[0] if res.labels is not None
              else res.embedding.shape[0] if res.embedding is not None
              else 0)
    _FITS_TOTAL.inc(placement=plan.placement, solver=solver)
    if n_rows:
        _FIT_ROWS.inc(n_rows, placement=plan.placement)
    return res


def host_array(t, z=None) -> np.ndarray:
    """A tall result (a tensor or host chunks) as one host numpy array; a
    mesh representation ``z`` gathers its rows from every rank first."""
    if isinstance(t, streaming.ChunkedDense):
        return t.to_array()
    if isinstance(z, rowmatrix.MeshRows):
        t = z.gather_rows(t)
    return t.cpu().numpy()


def _execute_impl(
    x,
    cfg: SCRBConfig,
    plan: ExecutionPlan,
    dev: torch.device,
    *,
    final_stage: str,
    keep_embedding: bool,
    keep_state: bool,
) -> FitResult:
    if plan.placement == "partitioned":
        # lazy import: partitioned re-enters execute() per partition
        from repro_torch.core import partitioned
        return partitioned.execute_partitioned(
            x, cfg, plan, dev, final_stage=final_stage,
            keep_embedding=keep_embedding, keep_state=keep_state)
    rep_cls = representation(plan)
    fm = plan.feature_map
    if fm is None:
        fm = featuremap.from_config(cfg, impl=plan.impl)
    seed = cfg.seed
    timer = StageTimer(dev)
    k = cfg.n_clusters

    with timer.stage("rb_features"):
        feats = rep_cls.fit_transform(x, fm, cfg, plan, seed, dev)
    with timer.stage("degrees"):
        z = rep_cls.from_features(feats, cfg, plan, dev)
    solver = effective_solver(cfg, z.n)
    eig, comp = None, None
    with timer.stage("svd"):
        if solver == "compressive":
            # eigendecomposition-free: Chebyshev-filter d = O(log K) random
            # signals through the Gram product (no (N, K + buffer) iterate)
            comp = compressive.compressive_embed(
                z, k, fold_seed(seed, "eig"), cfg,
                laplacian_normalize=plan.laplacian_normalize)
        else:
            eig = z.eigenpairs(k, fold_seed(seed, "eig"), cfg,
                               x0=plan.eig_x0)
    with timer.stage("normalize"):
        u_hat = z.map_row_chunks(
            row_normalize, eig.vectors if comp is None else comp.embedding)
    km, cluster_diag = None, {}
    if final_stage == "kmeans":
        with timer.stage("kmeans"):
            if comp is None:
                km, cluster_diag = z.cluster(fold_seed(seed, "kmeans"),
                                             u_hat, cfg)
            else:           # k-means on a random row subset, then assign
                km, cluster_diag = compressive.subset_cluster(
                    z, u_hat, fold_seed(seed, "kmeans"), cfg)

    fitted = feats.fmap
    if comp is not None:
        # Ritz values of Â on the filtered span, padded/truncated to k; the
        # leading-k residuals only (the trailing d − rank directions of the
        # filtered span are null by design)
        sig_full = np.sqrt(np.maximum(comp.theta, 0.0))
        sigmas = np.zeros((k,), sig_full.dtype)
        sigmas[:min(k, sig_full.shape[0])] = sig_full[:k]
        resnorms = np.zeros((k,), np.float32)
        resnorms[:min(k, comp.resnorms.shape[0])] = comp.resnorms[:k]
        iterations = comp.iterations
    else:
        sigmas = torch.sqrt(torch.clamp_min(eig.theta, 0.0)).cpu().numpy()
        iterations, resnorms = eig.iterations, eig.resnorms.cpu().numpy()
    deg_min, deg_max = z.degree_range()
    diagnostics = {
        "plan": {"placement": plan.placement, "residency": plan.residency,
                 "chunk_size": plan.chunk_size, "prefetch": plan.prefetch,
                 "impl": plan.impl},
        "device": str(dev),
        "feature_map": fitted.name,
        "solver": solver,
        "solver_requested": cfg.solver_options.solver,
        "solver_precond": cfg.solver_options.precond,
        "solver_warm_start": plan.eig_x0 is not None,
        "solver_iterations": int(iterations),
        "solver_resnorms": np.asarray(resnorms),
        "degrees_min": deg_min,
        "degrees_max": deg_max,
        "n_features_D": fitted.n_features,
        "d_g": getattr(fitted, "d_g", None),
        "nnz": z.n * (fitted.n_grids if fitted.kind == "ell"
                      else fitted.n_features),
    }
    diagnostics.update(z.residency_diagnostics(cfg))
    if comp is not None:
        est = comp.estimate
        diagnostics["compressive"] = {
            "lambda_k": est.lambda_k, "lambda_k1": est.lambda_k1,
            "cutoff": est.cutoff, "filter_degree": comp.filter_degree,
            "signals": comp.signals, "probes": est.probes,
        }
        if plan.residency == "host_chunked":
            # the widest dense chunk on the device is the d-wide filter
            # block, not a LOBPCG (chunk, k+buffer) iterate
            diagnostics["embedding_device_bytes_peak"] = (
                z.store.max_chunk_rows * 4 * comp.signals)
    diagnostics.update(cluster_diag)
    if km is not None:
        diagnostics["kmeans_inertia"] = float(km.inertia)

    state = None
    if keep_state:
        state = {"z": z, "features": feats, "eig": eig, "u_hat": u_hat,
                 "km": km, "plan": plan,
                 "oos_proj": None if comp is None else comp.proj}
    return FitResult(
        labels=None if km is None else km.labels.cpu().numpy(),
        embedding=host_array(u_hat, z) if keep_embedding else None,
        singular_values=sigmas,
        timer=timer,
        diagnostics=diagnostics,
        state=state,
    )
