"""RowMatrix — the data-representation layer of the plan-based executor.

Algorithm 2's five stages are written once in ``repro_torch.core.executor``
against a small surface (``matvec``/``matvec_tall``/``rmatvec``/``gram``,
``random_tall``, ``eigenpairs``, ``cluster``, ``map_row_chunks``,
``reduce``, ``degree_dual``, ``residency_diagnostics``). A representation
says where Ẑ = D̂^{-1/2}Z lives:

  - ``DeviceRows``      the whole (N, R) ELL matrix (or a dense map's
    (N, m) features) on one device; tall dense operands are device tensors.
  - ``HostChunkedRows`` host row chunks (``streaming.ChunkedELL``, or
    ``featuremap.ChunkedDenseFeatures`` for a dense map); tall dense
    operands are ``streaming.ChunkedDense`` and every sweep uploads one
    prefetched chunk at a time.

The mesh and partitioned representations of the JAX package are not yet
ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import eigensolver, featuremap, graph, streaming
from repro_torch.core.kmeans import kmeans as _kmeans, streaming_kmeans
from repro_torch.utils import make_generator, prefetch_to_device, to_host


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


def _draw(generator: torch.Generator, shape, dist: str) -> torch.Tensor:
    """Gaussian or ±1 (``dist="rademacher"``) float32 entries from
    ``generator``, on its device."""
    if dist == "rademacher":
        return streaming.rademacher(shape, generator)
    if dist != "normal":
        raise ValueError(f"unknown dist {dist!r}")
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)


@dataclasses.dataclass(frozen=True)
class FittedFeatures:
    """Stage-1 output: a fitted feature map + its feature payload."""

    fmap: Any
    payload: Any


@dataclasses.dataclass
class DeviceRows:
    """Whole-array residency on one device: ``adj`` is a
    ``graph.NormalizedAdjacency`` (ELL maps) or a
    ``featuremap.NormalizedDenseFeatures`` (dense maps), with the same
    product surface, its tensors on the fit's device."""

    kind = "device"
    adj: Any

    @classmethod
    def fit_transform(cls, x: torch.Tensor, fm, cfg, plan, seed: int,
                      dev: torch.device) -> FittedFeatures:
        fitted = fm.fit(seed, x)
        return FittedFeatures(fitted, fitted.transform(x))

    @classmethod
    def from_features(cls, feats: FittedFeatures, cfg, plan,
                      dev: torch.device) -> "DeviceRows":
        fm = feats.fmap
        if fm.kind != "ell":
            return cls(featuremap.build_normalized_dense(
                feats.payload, laplacian=plan.laplacian_normalize))
        return cls(graph.build_normalized_adjacency(
            feats.payload, d=fm.n_features, d_g=fm.d_g, impl=plan.impl,
            normalize=plan.laplacian_normalize))

    @property
    def n(self) -> int:
        return self.adj.n

    @property
    def device(self) -> torch.device:
        return self.adj.device

    def degree_range(self) -> Tuple[float, float]:
        return float(torch.min(self.adj.deg)), float(torch.max(self.adj.deg))

    def matvec(self, v):
        return self.adj.matmat(v)

    def matvec_tall(self, v):
        return self.adj.matmat(v.to(device=self.device, dtype=torch.float32))

    def rmatvec(self, u):
        return self.adj.rmatmat(u)

    def gram(self, u):
        return self.adj.gram_matvec(u)

    def random_tall(self, generator: torch.Generator, width: int,
                    dist: str = "normal") -> torch.Tensor:
        """An (N, width) random block on the device, drawn from
        ``generator`` on its own device (a CPU generator gives the same
        block to a CPU and a CUDA fit): Gaussian, or ±1 for
        ``dist="rademacher"``."""
        return _draw(generator, (self.n, width), dist).to(self.device)

    def map_row_chunks(self, fn, *tall):
        return fn(*tall)

    def reduce(self, fn, init, *tall):
        return fn(init, *tall)

    def degree_dual(self) -> torch.Tensor:
        """The (D,) vector a new point's degree is read from, retained from
        the degree pass: the bin occupancies Zᵀ1 (ELL maps) or Φᵀ1 (dense
        maps)."""
        if isinstance(self.adj, featuremap.NormalizedDenseFeatures):
            return self.adj.colsum
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

    def residency_diagnostics(self, cfg) -> dict:
        return {}


@dataclasses.dataclass
class HostChunkedRows:
    """Host row chunks; no stage allocates an O(N) device array.

    ``store`` is a ``streaming.ChunkedELL`` (the RB map's ELL pattern) or
    a ``featuremap.ChunkedDenseFeatures`` (dense maps), with the same sweep
    surface. ``x`` stays on the host: stage 1 uploads it one chunk at a
    time and brings each chunk's features back."""

    kind = "host_chunked"
    store: Any

    @classmethod
    def fit_transform(cls, x, fm, cfg, plan, seed: int,
                      dev: torch.device) -> FittedFeatures:
        x_chunks = streaming.as_row_chunks(x, plan.chunk_size)
        fitted = fm.fit(seed, x_chunks, device=dev)
        # row-local ⇒ the single-shot transform's features for any chunking
        payload = streaming.chunked_transform(
            fitted.transform, x_chunks, device=dev, prefetch=plan.prefetch)
        return FittedFeatures(fitted, payload)

    @classmethod
    def from_features(cls, feats: FittedFeatures, cfg, plan,
                      dev: torch.device) -> "HostChunkedRows":
        fm = feats.fmap
        if fm.kind != "ell":
            return cls(featuremap.build_chunked_dense(
                feats.payload, laplacian=plan.laplacian_normalize,
                prefetch=plan.prefetch, device=dev))
        return cls(streaming.build_chunked_adjacency(
            feats.payload, d=fm.n_features, d_g=fm.d_g, impl=plan.impl,
            prefetch=plan.prefetch, normalize=plan.laplacian_normalize,
            device=dev))

    @property
    def n(self) -> int:
        return self.store.n

    @property
    def device(self) -> torch.device:
        return self.store.device

    def degree_range(self) -> Tuple[float, float]:
        return float(torch.min(self.store.deg)), float(torch.max(self.store.deg))

    def degree_dual(self) -> torch.Tensor:
        """The (D,) degree dual kept by the degree pass, on the fit's
        device: the bin occupancies Zᵀ1, or Φᵀ1 for a dense map."""
        if isinstance(self.store, featuremap.ChunkedDenseFeatures):
            return self.store.colsum
        return self.store.counts.to(device=self.device, dtype=torch.float32)

    def rmatvec(self, u: streaming.ChunkedDense) -> torch.Tensor:
        """Ẑᵀ u : host chunks (N, K) of any width K → (D, K) on the
        device."""
        return self.store.rmatmat_chunked(u)

    def matvec_tall(self, v) -> streaming.ChunkedDense:
        """Ẑ v : (D, K) → host row chunks (N, K). Never an (N, K) device
        array: each chunk's rows go back to the host as they are made."""
        return self.store.matmat_chunked(
            v.to(device=self.device, dtype=torch.float32))

    def gram(self, u: streaming.ChunkedDense) -> streaming.ChunkedDense:
        """(Ẑ Ẑᵀ) u over host chunks of any width (a zt sweep, then a z
        sweep)."""
        return self.store.gram_matvec_chunked(u)

    def random_tall(self, generator: torch.Generator, width: int,
                    dist: str = "normal") -> streaming.ChunkedDense:
        """A random block as host chunks aligned with the ELL chunking,
        drawn chunk after chunk from ``generator`` (a CPU generator): no
        (N, width) array is built, and the draw does not depend on the
        prefetch setting."""
        if dist == "rademacher":
            return streaming.ChunkedDense.random_rademacher(
                generator, self.store.chunk_sizes, width)
        if dist != "normal":
            raise ValueError(f"unknown dist {dist!r}")
        return streaming.ChunkedDense.random_normal(
            generator, self.store.chunk_sizes, width)

    def _uploads(self, *tall):
        return prefetch_to_device(
            zip(*[t.chunks for t in tall]), device=self.device,
            enabled=self.store.prefetch, measure=self.store.h2d_stats)

    def map_row_chunks(self, fn, *tall) -> streaming.ChunkedDense:
        """``fn`` over aligned row chunks of the tall operands
        (``ChunkedDense``), one uploaded chunk at a time; the result stays
        on the host."""
        return streaming.ChunkedDense(tuple(
            to_host(fn(*cs)) for cs in self._uploads(*tall)))

    def reduce(self, fn, init, *tall):
        """Fold ``acc = fn(acc, *chunks)`` over aligned uploaded row chunks
        of the tall operands, in chunk order."""
        acc = init
        for cs in self._uploads(*tall):
            acc = fn(acc, *cs)
        return acc

    def eigenpairs(self, k: int, seed: int, cfg,
                   x0=None) -> eigensolver.EigResult:
        """Top-k eigenpairs by ``eigensolver.lobpcg_host_chunked``: the
        start block drawn chunk by chunk on the CPU from ``seed`` unless
        ``x0`` injects one; the vectors come back as host chunks."""
        so = cfg.solver_options
        return eigensolver.top_k_eigenpairs(
            self.store.gram_matvec_chunked, self.n, k, make_generator(seed),
            device=self.device, solver=so.solver, max_iters=so.iters,
            tol=so.tol, buffer=so.buffer, x0=x0,
            precond=_solver_precond(cfg, self.store.deg),
            stable_tol=so.stable_tol, chunk_sizes=self.store.chunk_sizes)

    def cluster(self, seed: int, u_hat, cfg) -> Tuple[Any, dict]:
        """``kmeans.streaming_kmeans`` over the host chunks of the
        embedding, with the reference's step count: at least one Sculley
        step per chunk."""
        kmeans_steps = max(cfg.kmeans_iters, u_hat.n_chunks)
        res = streaming_kmeans(
            make_generator(seed, self.device), u_hat, cfg.n_clusters,
            n_steps=kmeans_steps, n_replicates=cfg.kmeans_replicates,
            impl=cfg.impl, prefetch=self.store.prefetch,
            measure=self.store.h2d_stats, device=self.device)
        return res, {"kmeans_steps": kmeans_steps}

    def residency_diagnostics(self, cfg) -> dict:
        """The reference's keys: chunking, the closed-form device peaks of
        the ELL chunk and of the widest dense chunk (the (chunk, k+buffer)
        LOBPCG block), and the largest upload any sweep measured."""
        ell = self.store
        return {
            "n_chunks": ell.n_chunks,
            "chunk_rows_max": ell.max_chunk_rows,
            "ell_device_bytes_peak": ell.ell_device_bytes_peak,
            "embedding_device_bytes_peak": ell.max_chunk_rows * 4
            * eigensolver.lobpcg_block_width(
                ell.n, cfg.n_clusters, cfg.solver_options.buffer),
            "h2d_max_chunk_bytes": ell.h2d_stats.get("max_item_bytes", 0),
            "prefetch": ell.prefetch,
        }

