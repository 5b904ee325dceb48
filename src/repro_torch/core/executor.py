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
packages. Of the plans, placement ``single`` × residency ``device`` with
``solver="lobpcg"`` (the defaults) is ported; other placements,
residencies and solvers raise.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import featuremap, rowmatrix
from repro_torch.core.kmeans import row_normalize
from repro_torch.core.options import (
    UNSET, CompressiveOptions, PartitionOptions, SolverOptions,
    normalize_config,
)
from repro_torch.utils import StageTimer, fold_seed, resolve_device

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
    chunk_size: Optional[int] = None      # host-chunked residency (not ported)
    prefetch: bool = True
    block_rows: Optional[Mapping[str, int]] = None   # TPU tiling; unused here
    trace: Optional[str] = None           # run-local; never in the artifact
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


def plan_from_config(config: SCRBConfig, mesh=None) -> ExecutionPlan:
    """The config → plan mapping behind the public entry points."""
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


def _check_ported(cfg: SCRBConfig, plan: ExecutionPlan) -> None:
    if (plan.placement, plan.residency) != ("single", "device"):
        raise NotImplementedError(
            f"placement={plan.placement!r}, residency={plan.residency!r} is "
            "not yet ported to repro_torch (ported: single/device)")
    if plan.feature_map is not None and \
            not isinstance(plan.feature_map, featuremap.RBMap):
        raise NotImplementedError(
            "only the Random Binning feature map is ported to repro_torch")


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
    ``SCRBModel.fit``.
    """
    cfg = config
    dev = resolve_device(device)
    if plan is None:
        plan = plan_from_config(cfg)
    if final_stage not in ("normalize", "kmeans"):
        raise ValueError(f"unknown final_stage {final_stage!r}")
    _check_ported(cfg, plan)
    configure_device(dev)
    return _execute_impl(as_device_rows(x, dev), cfg, plan, dev,
                         final_stage=final_stage,
                         keep_embedding=keep_embedding, keep_state=keep_state)


def _execute_impl(
    x: torch.Tensor,
    cfg: SCRBConfig,
    plan: ExecutionPlan,
    dev: torch.device,
    *,
    final_stage: str,
    keep_embedding: bool,
    keep_state: bool,
) -> FitResult:
    rep_cls = rowmatrix.DeviceRows
    fm = plan.feature_map
    if fm is None:
        fm = featuremap.from_config(cfg, impl=plan.impl)
    seed = cfg.seed
    timer = StageTimer(dev)
    k = cfg.n_clusters

    with timer.stage("rb_features"):
        feats = rep_cls.fit_transform(x, fm, cfg, plan, seed)
    with timer.stage("degrees"):
        z = rep_cls.from_features(feats, cfg, plan)
    solver = effective_solver(cfg, z.n)
    if solver != "lobpcg":
        raise NotImplementedError(
            f"solver={solver!r} is not yet ported to repro_torch (ported: "
            "lobpcg)")
    with timer.stage("svd"):
        eig = z.eigenpairs(k, fold_seed(seed, "eig"), cfg, x0=plan.eig_x0)
    with timer.stage("normalize"):
        u_hat = z.map_row_chunks(row_normalize, eig.vectors)
    km, cluster_diag = None, {}
    if final_stage == "kmeans":
        with timer.stage("kmeans"):
            km, cluster_diag = z.cluster(fold_seed(seed, "kmeans"), u_hat,
                                         cfg)

    fitted = feats.fmap
    sigmas = torch.sqrt(torch.clamp_min(eig.theta, 0.0)).cpu().numpy()
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
        "solver_iterations": int(eig.iterations),
        "solver_resnorms": eig.resnorms.cpu().numpy(),
        "degrees_min": deg_min,
        "degrees_max": deg_max,
        "n_features_D": fitted.n_features,
        "d_g": fitted.d_g,
        "nnz": z.n * fitted.n_grids,
    }
    diagnostics.update(cluster_diag)
    if km is not None:
        diagnostics["kmeans_inertia"] = float(km.inertia)

    state = None
    if keep_state:
        state = {"z": z, "features": feats, "eig": eig, "u_hat": u_hat,
                 "km": km, "plan": plan}
    return FitResult(
        labels=None if km is None else km.labels.cpu().numpy(),
        embedding=u_hat.cpu().numpy() if keep_embedding else None,
        singular_values=sigmas,
        timer=timer,
        diagnostics=diagnostics,
        state=state,
    )
