"""The paper's comparison methods (Table 2/3) as plan configurations.

  K-means  Lloyd on raw X                                  [15]
  SC       exact spectral clustering (dense W, eigh)       [21]
  KK_RS    approximate kernel k-means by random sampling   [10]
  KK_RF    k-means on the RFF feature matrix               [11]
  SV_RF    k-means on the top singular vectors of RFF      [11]
  SC_LSC   landmark bipartite-graph SC                     [9]
  SC_Nys   Nyström-approximated SC                         [13]
  SC_RF    SC with the RFF-approximated Laplacian          (the paper's)
  SC_RB    this paper
  CSC_RB   SC_RB with solver="compressive" requested; as in the JAX
           package the flat solver mirror wins and it runs LOBPCG (C6)

The spectral methods are one code path, as in the JAX package: an
``ExecutionPlan`` whose stage-1 slot holds a registered
``featuremap`` map, run through the five-stage executor. The feature-space
kernel k-means methods (KK_RF, KK_RS) fit the same maps and skip the
spectral stages. ``METHOD_FEATURE_MAPS`` records the registry entry behind
each method (None for the two that use none).

Every method runs on ``device`` ("cuda" unless the caller asks for the
CPU) and shares the seed and k-means protocol. ``feature_map=`` (a fitted
map) and ``x0=`` (the eigensolver's start block) inject the draws, so a
parity test compares like with like.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import executor, featuremap
from repro_torch.core.kmeans import kmeans as _kmeans, row_normalize
from repro_torch.core.nystrom import pairwise_kernel
from repro_torch.utils import (
    StageTimer, fold_seed, make_generator, resolve_device,
)


@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    n_clusters: int
    rank: int = 256               # R: features / landmarks / samples budget
    sigma: float = 1.0
    kernel: str = "laplacian"     # kernel family of every kernel method
    kmeans_iters: int = 25
    kmeans_replicates: int = 10
    seed: int = 0


@dataclasses.dataclass
class BaselineResult:
    labels: np.ndarray
    timer: StageTimer


def _scrb_config(cfg: BaselineConfig, **fields) -> executor.SCRBConfig:
    return executor.SCRBConfig(
        n_clusters=cfg.n_clusters, n_grids=cfg.rank, sigma=cfg.sigma,
        kmeans_iters=cfg.kmeans_iters,
        kmeans_replicates=cfg.kmeans_replicates, seed=cfg.seed, **fields)


def _setup(device) -> tuple[torch.device, StageTimer]:
    dev = resolve_device(device)
    executor.configure_device(dev)
    return dev, StageTimer(dev)


def _finish_kmeans(seed: int, emb: torch.Tensor, cfg: BaselineConfig,
                   timer: StageTimer) -> np.ndarray:
    with timer.stage("kmeans"):
        res = _kmeans(make_generator(seed, emb.device), emb, cfg.n_clusters,
                      n_iters=cfg.kmeans_iters,
                      n_replicates=cfg.kmeans_replicates)
        return res.labels.cpu().numpy()


def _execute(x, scfg, plan, device) -> BaselineResult:
    res = executor.execute(x, scfg, plan, device=device)
    return BaselineResult(res.labels, res.timer)


def _spectral_via_registry(fm_name: str, *, laplacian: bool) -> Callable:
    """A Table-2 spectral method as an executor plan over the registry."""

    def run(x, cfg: BaselineConfig, *, device="cuda", feature_map=None,
            x0=None) -> BaselineResult:
        fm = feature_map or featuremap.make_feature_map(
            fm_name, rank=cfg.rank, sigma=cfg.sigma, kernel=cfg.kernel)
        plan = executor.ExecutionPlan(feature_map=fm, eig_x0=x0,
                                      laplacian_normalize=laplacian)
        return _execute(x, _scrb_config(cfg), plan, device)

    run.__name__ = f"spectral_{fm_name}"
    return run


def _feature_kmeans_via_registry(fm_name: str) -> Callable:
    """Kernel k-means in a registered map's feature space (KK_RF, KK_RS):
    centroids restricted to span(Φ), so plain k-means on Φ."""

    def run(x, cfg: BaselineConfig, *, device="cuda",
            feature_map=None) -> BaselineResult:
        dev, timer = _setup(device)
        with timer.stage("features"):
            fm = feature_map or featuremap.make_feature_map(
                fm_name, rank=cfg.rank, sigma=cfg.sigma, kernel=cfg.kernel)
            xs = executor.as_device_rows(x, dev)
            phi = fm.fit(cfg.seed, xs).transform(xs)
        labels = _finish_kmeans(fold_seed(cfg.seed, "kmeans"), phi, cfg,
                                timer)
        return BaselineResult(labels, timer)

    run.__name__ = f"feature_kmeans_{fm_name}"
    return run


# ---------------------------------------------------------------------------
# the two methods without a feature map
# ---------------------------------------------------------------------------

def kmeans_raw(x, cfg: BaselineConfig, *, device="cuda") -> BaselineResult:
    dev, timer = _setup(device)
    labels = _finish_kmeans(fold_seed(cfg.seed, "kmeans"),
                            executor.as_device_rows(x, dev), cfg, timer)
    return BaselineResult(labels, timer)


def sc_exact(x, cfg: BaselineConfig, *, device="cuda") -> BaselineResult:
    """Dense W and a full ``eigh``: O(N²) memory, O(N³) time, small N only
    (the paper's '—'). W is built in row blocks (``pairwise_kernel``) and
    normalized in place."""
    dev, timer = _setup(device)
    with timer.stage("graph"):
        xs = executor.as_device_rows(x, dev)
        w = pairwise_kernel(xs, xs, cfg.sigma, cfg.kernel)
        scale = 1.0 / torch.sqrt(torch.clamp_min(w.sum(1), 1e-12))
        a_norm = w.mul_(scale[:, None]).mul_(scale[None, :])
    with timer.stage("eig"):
        _, vecs = torch.linalg.eigh(a_norm)                  # ascending
        del a_norm, w
        u = row_normalize(vecs[:, -cfg.n_clusters:].contiguous())
    labels = _finish_kmeans(fold_seed(cfg.seed, "kmeans"), u, cfg, timer)
    return BaselineResult(labels, timer)


def _csc_rb_config(cfg: BaselineConfig) -> executor.SCRBConfig:
    """``csc_rb``'s config, built as the JAX package's runner builds it:
    ``solver_options`` replaced with ``solver="compressive"`` over a
    normalized config whose flat ``solver`` mirror ("lobpcg") then wins
    again, so the method runs LOBPCG, not the compressive cell
    (ROADMAP.md C6). The port keeps that behaviour so both packages'
    Table-2 columns are one method; ``solver="compressive"`` in an
    ``SCRBConfig`` runs the cell."""
    base = _scrb_config(cfg)
    return dataclasses.replace(
        base, solver_options=dataclasses.replace(base.solver_options,
                                                 solver="compressive"))


def csc_rb_baseline(x, cfg: BaselineConfig, *, device="cuda",
                    feature_map=None, x0=None) -> BaselineResult:
    """Compressive SC_RB as the JAX package's runner has it: the executor
    on :func:`_csc_rb_config`, which resolves to LOBPCG (ROADMAP.md C6)."""
    scfg = _csc_rb_config(cfg)
    plan = dataclasses.replace(executor.plan_from_config(scfg),
                               feature_map=feature_map, eig_x0=x0)
    return _execute(x, scfg, plan, device)


def sc_rb_baseline(x, cfg: BaselineConfig, *, device="cuda",
                   feature_map=None, x0=None) -> BaselineResult:
    """This paper under the shared baseline protocol (the default RB plan),
    through the executor and not ``SCRBModel``, so no row pays the fitted
    model's ``oos_state`` pass; the labels are ``pipeline.sc_rb``'s."""
    scfg = _scrb_config(cfg)
    plan = dataclasses.replace(executor.plan_from_config(scfg),
                               feature_map=feature_map, eig_x0=x0)
    return _execute(x, scfg, plan, device)


METHODS: Dict[str, Callable[..., BaselineResult]] = {
    "kmeans": kmeans_raw,
    "sc": sc_exact,
    "kk_rs": _feature_kmeans_via_registry("nystrom"),
    "kk_rf": _feature_kmeans_via_registry("rff"),
    "sv_rf": _spectral_via_registry("rff", laplacian=False),
    "sc_lsc": _spectral_via_registry("lsc", laplacian=True),
    "sc_nys": _spectral_via_registry("nystrom", laplacian=True),
    "sc_rf": _spectral_via_registry("rff", laplacian=True),
    "sc_rb": sc_rb_baseline,
    "csc_rb": csc_rb_baseline,
}

#: The registry entry behind each method (None: not a feature-map method).
METHOD_FEATURE_MAPS: Dict[str, Optional[str]] = {
    "kmeans": None,
    "sc": None,
    "kk_rs": "nystrom",
    "kk_rf": "rff",
    "sv_rf": "rff",
    "sc_lsc": "lsc",
    "sc_nys": "nystrom",
    "sc_rf": "rff",
    "sc_rb": "rb",
    "csc_rb": "rb",
}
