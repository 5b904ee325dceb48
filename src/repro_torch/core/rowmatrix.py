"""RowMatrix — the data-representation layer of the plan-based executor.

Algorithm 2's five stages are written once in ``repro_torch.core.executor``
against a small surface (``matvec``/``rmatvec``/``gram``, ``eigenpairs``,
``cluster``, ``map_row_chunks``, ``degree_dual``). A representation says
where Ẑ = D̂^{-1/2}Z lives. Only ``DeviceRows`` — the whole (N, R) ELL
matrix on one device — is ported; the host-chunked, mesh and partitioned
representations of the JAX package are not yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import eigensolver, graph
from repro_torch.core.kmeans import kmeans as _kmeans
from repro_torch.utils import make_generator


def _solver_precond(cfg, deg) -> Optional[torch.Tensor]:
    """The (N,) diagonal preconditioner a config selects: the degree-based
    Jacobi diagonal for ``SolverOptions.precond="degree"``, else None."""
    precond = cfg.solver_options.precond
    if precond == "degree":
        return eigensolver.degree_precond(deg)
    if precond in ("none", None):
        return None
    raise ValueError(
        f"unknown solver precond {precond!r}; options ('degree', 'none')")


@dataclasses.dataclass(frozen=True)
class FittedFeatures:
    """Stage-1 output: a fitted feature map + its feature payload."""

    fmap: Any
    payload: Any


@dataclasses.dataclass
class DeviceRows:
    """Whole-array residency on one device: ``adj`` is a
    ``graph.NormalizedAdjacency`` whose tensors lie on the fit's device."""

    kind = "device"
    adj: graph.NormalizedAdjacency

    @classmethod
    def fit_transform(cls, x: torch.Tensor, fm, cfg, plan,
                      seed: int) -> FittedFeatures:
        fitted = fm.fit(seed, x)
        return FittedFeatures(fitted, fitted.transform(x))

    @classmethod
    def from_features(cls, feats: FittedFeatures, cfg, plan) -> "DeviceRows":
        fm = feats.fmap
        if fm.kind != "ell":
            raise NotImplementedError(
                "dense feature maps are not yet ported to repro_torch")
        return cls(graph.build_normalized_adjacency(
            feats.payload, d=fm.n_features, d_g=fm.d_g, impl=plan.impl,
            normalize=plan.laplacian_normalize))

    @property
    def n(self) -> int:
        return self.adj.n

    @property
    def device(self) -> torch.device:
        return self.adj.idx.device

    def degree_range(self) -> Tuple[float, float]:
        return float(torch.min(self.adj.deg)), float(torch.max(self.adj.deg))

    def matvec(self, v):
        return self.adj.matmat(v)

    def rmatvec(self, u):
        return self.adj.rmatmat(u)

    def gram(self, u):
        return self.adj.gram_matvec(u)

    def map_row_chunks(self, fn, *tall):
        return fn(*tall)

    def degree_dual(self) -> torch.Tensor:
        """The (D,) bin occupancies Zᵀ1, retained from the degree pass: the
        vector a new point's degree is read from."""
        return self.adj.counts.to(torch.float32)

    def eigenpairs(self, k: int, seed: int, cfg,
                   x0=None) -> eigensolver.EigResult:
        """Top-k eigenpairs of ẐẐᵀ; the start block is drawn on the CPU
        from ``seed`` (so CPU and CUDA fits start alike) unless ``x0``
        injects one."""
        so = cfg.solver_options
        return eigensolver.top_k_eigenpairs(
            self.adj.gram_matvec, self.n, k, make_generator(seed),
            device=self.device, solver=so.solver, max_iters=so.iters,
            tol=so.tol, buffer=so.buffer, x0=x0,
            precond=_solver_precond(cfg, self.adj.deg),
            stable_tol=so.stable_tol)

    def cluster(self, seed: int, u_hat: torch.Tensor, cfg) -> Tuple[Any, dict]:
        res = _kmeans(make_generator(seed, self.device), u_hat,
                      cfg.n_clusters, n_iters=cfg.kmeans_iters,
                      n_replicates=cfg.kmeans_replicates, impl=cfg.impl)
        return res, {}

