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

  - ``MeshRows``        this rank's contiguous row shard of the (N, R)
    ELL matrix on its device, in an SPMD world over ``torch.distributed``
    (``placement="mesh"``): products are local, and the collectives of
    ``core.distributed`` join the shards.
  - ``PartitionedRows`` the aggregate handle of a divide-and-conquer fit
    (``placement="partitioned"``): the summed degree dual and the
    partitions' degree ranges and residency diagnostics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import eigensolver, featuremap, graph, streaming
from repro_torch.core.kmeans import kmeans as _kmeans, streaming_kmeans
from repro_torch.kernels import ops
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



# --------------------------------------------------------------------------
# Mesh placement — rows sharded over the data axes of a DeviceMesh; with
# chunk_size every within-shard sweep runs over row chunks.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class MeshRows:
    """This rank's row shard of Ẑ, in an SPMD world (``placement="mesh"``).

    Every rank runs the fit with the same global x; rank r keeps rows
    ``[r·N/S, (r+1)·N/S)`` of the S data shards (N must divide by S). The
    products are local and the collectives of ``core.distributed`` join
    the shards: one ``all_reduce`` of q per Gram product, of the (D,)
    counts in the degree pass. ``chunk_size`` bounds every within-shard
    sweep (Gram products, k-means) to O(chunk) temporaries. Tall operands
    are this rank's rows on its device; (D, K) results are replicated.
    Supports ELL maps only, as the JAX package's."""

    kind = "mesh"
    mesh: Any                      # torch.distributed DeviceMesh
    idx: torch.Tensor              # (n_local, R) int32, this rank's rows
    rowscale: torch.Tensor         # (n_local,) float32
    degrees: torch.Tensor          # (n_local,) float32
    n_total: int                   # N, all shards
    row0: int                      # this shard's first global row
    d: int
    d_g: int
    impl: str = "auto"
    chunk_size: Optional[int] = None
    compress: bool = False
    counts: Optional[torch.Tensor] = None   # (D,) int32 replicated Zᵀ1
    cscs: Optional[Sequence[ops.EllCSC]] = None   # card: each chunk's CSC
    _gram_cache: Any = dataclasses.field(default=None, repr=False,
                                         compare=False)

    @staticmethod
    def shard_bounds(mesh, n: int) -> Tuple[int, int]:
        """(first row, row count) of this rank's shard of ``n`` rows;
        raises the JAX package's error when ``n`` does not divide."""
        from repro_torch.launch.mesh import data_rank, data_shards
        shards = data_shards(mesh)
        if n % shards:
            raise ValueError(
                f"distributed k-means needs N divisible by the data shards: "
                f"N={n}, shards={shards}")
        rows = n // shards
        return data_rank(mesh) * rows, rows

    @classmethod
    def fit_transform(cls, x, fm, cfg, plan, seed: int,
                      dev: torch.device) -> FittedFeatures:
        """Fit the map on the global x (the same grids on every rank: they
        come from the seed) and transform this rank's rows on ``dev``."""
        if fm.kind != "ell":
            raise ValueError(
                f"placement='mesh' currently supports ELL feature maps only "
                f"(got {fm.name!r} of kind {fm.kind!r}); run dense maps "
                f"under placement='single'")
        if isinstance(x, (list, tuple)):
            x = np.concatenate([np.asarray(c) for c in x])
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x, np.float32)
        lo, rows = cls.shard_bounds(plan.mesh, x.shape[0])
        fitted = fm.fit(seed, x).to(dev)
        x_local = torch.as_tensor(x[lo:lo + rows], device=dev)
        return FittedFeatures(fitted, fitted.transform(x_local))

    @classmethod
    def from_features(cls, feats: FittedFeatures, cfg, plan,
                      dev: torch.device) -> "MeshRows":
        from repro_torch.core.distributed import make_degree_pass
        from repro_torch.launch.mesh import data_shards
        fm = feats.fmap
        idx = feats.payload
        d, r = fm.n_features, idx.shape[1]
        n_total = idx.shape[0] * data_shards(plan.mesh)
        lo, _ = cls.shard_bounds(plan.mesh, n_total)
        # one pass yields the degrees and the replicated (D,) occupancies:
        # the fitted model's degree dual, kept for free
        deg, counts = make_degree_pass(plan.mesh, idx, d, fm.d_g, plan.impl,
                                       chunk_size=plan.chunk_size)()
        if plan.laplacian_normalize:
            rowscale = 1.0 / torch.sqrt(float(r) * torch.clamp_min(deg, 1e-8))
        else:
            rowscale = torch.full_like(deg, graph._sqrt_r(r)[1])
        cscs = None
        if idx.is_cuda:
            cscs = tuple(ops.ell_csc(idx[s:e], d) for s, e in
                         streaming.row_chunk_bounds(idx.shape[0],
                                                    plan.chunk_size))
        return cls(plan.mesh, idx, rowscale.contiguous(), deg,
                   n_total=n_total, row0=lo, d=d, d_g=fm.d_g,
                   impl=plan.impl, chunk_size=plan.chunk_size,
                   compress=plan.collective_compress, counts=counts,
                   cscs=cscs)

    @property
    def n(self) -> int:
        return self.n_total

    @property
    def n_local(self) -> int:
        return self.idx.shape[0]

    @property
    def rows(self) -> slice:
        """This shard's global rows."""
        return slice(self.row0, self.row0 + self.n_local)

    @property
    def device(self) -> torch.device:
        return self.idx.device

    @property
    def group(self):
        from repro_torch.launch.mesh import data_group
        return data_group(self.mesh)

    @property
    def n_shards(self) -> int:
        from repro_torch.launch.mesh import data_shards
        return data_shards(self.mesh)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global (N, …) tensor from every rank's rows of it
        (``all_gather``): the labels, or an embedding the caller keeps."""
        from repro_torch.core.distributed import all_gather_rows
        return all_gather_rows(t, self.group)

    @property
    def deg(self) -> torch.Tensor:
        """The global (N,) degrees (gathered)."""
        return self.gather_rows(self.degrees)

    def degree_range(self) -> Tuple[float, float]:
        """Min/max reduced over the ranks (two scalars; no O(N) gather)."""
        lo = torch.min(self.degrees).reshape(1).clone()
        hi = torch.max(self.degrees).reshape(1).clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=self.group)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=self.group)
        return float(lo), float(hi)

    def _gram_fn(self):
        if self._gram_cache is None:
            from repro_torch.core.distributed import make_gram_matvec
            self._gram_cache = make_gram_matvec(
                self.mesh, self.idx, self.rowscale, self.d, self.d_g,
                self.impl, compress=self.compress,
                chunk_size=self.chunk_size, cscs=self.cscs)
        return self._gram_cache

    def matvec(self, v):
        """Ẑ v: (D, K) replicated → this rank's rows (n_local, K)."""
        return streaming.chunked_z_matmul(
            self.idx, v.to(device=self.device, dtype=torch.float32),
            self.rowscale, d_g=self.d_g, chunk_size=self.chunk_size,
            impl=self.impl)

    def matvec_tall(self, v):
        return self.matvec(v)

    def rmatvec(self, u):
        """Ẑᵀ u: this rank's rows of u → (D, K) replicated."""
        from repro_torch.core.distributed import make_zt_matvec
        return make_zt_matvec(self.mesh, self.idx, self.rowscale, self.d,
                              self.d_g, self.impl,
                              chunk_size=self.chunk_size,
                              cscs=self.cscs)(u.contiguous())

    def gram(self, u):
        return self._gram_fn()(u)

    def global_gram(self, v: torch.Tensor) -> torch.Tensor:
        """Âv for the global (N, b) block ``v``, which every rank holds:
        this rank's rows through the sharded Gram product, then one
        ``all_gather`` of them and of the rank's float32 column sums of
        ``v``. The sums must agree bit for bit: a rank whose replicated
        algebra drifted would take another branch and leave the others
        waiting in a collective, so every rank raises at once instead."""
        from repro_torch.core.distributed import all_gather_rows
        y = self.gram(v[self.rows].contiguous())
        mine = torch.cat([y, v.sum(dim=0, keepdim=True).to(y.dtype)])
        parts = all_gather_rows(mine, self.group).reshape(
            self.n_shards, self.n_local + 1, -1)
        sums = parts[:, -1]
        if not bool(torch.equal(sums, sums[:1].expand_as(sums))):
            raise RuntimeError(
                "the ranks' replicated mat-vec inputs differ (column sums "
                f"{sums.tolist()}): the replicated algebra diverged")
        return parts[:, :-1].reshape(self.n, -1)

    def random_tall(self, generator: torch.Generator, width: int,
                    dist: str = "normal") -> torch.Tensor:
        """This rank's rows of the global (N, width) draw from
        ``generator`` (on the CPU): the single placement's block, cut."""
        return _draw(generator, (self.n, width), dist)[self.rows] \
            .to(self.device)

    def map_row_chunks(self, fn, *tall):
        return fn(*tall)

    def reduce(self, fn, init, *tall):
        """``fn`` folded over this rank's row chunks, then summed over the
        ranks (``init`` must be the identity, e.g. zeros)."""
        from repro_torch.core.distributed import make_sharded_reduce
        return make_sharded_reduce(self.mesh, fn,
                                   chunk_size=self.chunk_size)(init, *tall)

    def degree_dual(self) -> torch.Tensor:
        """The bin occupancies Zᵀ1, kept from the degree pass."""
        return self.counts.to(torch.float32)

    def eigenpairs(self, k: int, seed: int, cfg,
                   x0=None) -> eigensolver.EigResult:
        """Top-k eigenpairs of this rank's rows
        (``eigensolver.top_k_eigenpairs_sharded``): the sharded LOBPCG for
        ``lobpcg`` and ``lobpcg_host``, every other solver and the n < 3k
        dense fallback against :meth:`global_gram`. The start block is the
        single placement's global draw from ``seed``. The degree
        preconditioner needs the global degrees (its clip is at their
        median): one gather of the (N,) vector."""
        so = cfg.solver_options
        precond = _solver_precond(
            cfg, self.deg if so.precond == "degree" else None)
        group = self.group

        def reduce(t: torch.Tensor) -> torch.Tensor:
            dist.all_reduce(t, group=group)
            return t

        return eigensolver.top_k_eigenpairs_sharded(
            self._gram_fn(), self.n, k, make_generator(seed),
            rows=self.rows, device=self.device, reduce=reduce,
            global_matvec=self.global_gram, solver=so.solver, max_iters=so.iters, tol=so.tol,
            buffer=so.buffer, x0=x0, precond=precond,
            stable_tol=so.stable_tol)

    def cluster(self, seed: int, u_hat: torch.Tensor, cfg
                ) -> Tuple[Any, dict]:
        from repro_torch.core.distributed import distributed_kmeans
        return distributed_kmeans(
            seed, u_hat, cfg.n_clusters, self.mesh, n=self.n,
            n_iters=cfg.kmeans_iters, n_replicates=cfg.kmeans_replicates,
            impl=cfg.impl, chunk_size=self.chunk_size)

    def residency_diagnostics(self, cfg) -> dict:
        chunk = min(self.chunk_size or self.n_local, self.n_local)
        return {
            "n_shards": self.n_shards,
            "shard_rows": self.n_local,
            # per-device temporary working set of a within-shard ELL sweep
            "ell_device_bytes_peak": chunk * self.idx.shape[1] * 4,
        }


# --------------------------------------------------------------------------
# Partitioned placement — the divide-and-conquer fit's aggregate handle.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PartitionedRows:
    """Union of per-partition representations (``placement="partitioned"``).

    Each partition's sub-fit built its own ``DeviceRows`` /
    ``HostChunkedRows`` under one shared fitted feature map, so all
    partitions live in one feature space; this is what the merge in
    ``core.partitioned`` hands to ``SCRBModel.fit`` as the run's
    ``state["z"]``: the summed degree dual, the degree range and the
    residency diagnostics — not the solver surface (no global solve
    happens). Under a mesh a rank holds only its own partitions in
    ``parts``; the per-partition summaries (``part_rows``,
    ``degree_ranges``, ``part_residency``) cover all of them."""

    kind = "partitioned"
    parts: Tuple[Any, ...]         # this process's partitions' RowMatrix
    fmap: Any                      # the shared fitted feature map
    dual: torch.Tensor             # (D,) summed Zᵀ1 across partitions
    part_rows: Tuple[int, ...] = ()
    degree_ranges: Tuple[Tuple[float, float], ...] = ()
    part_residency: Tuple[dict, ...] = ()

    @property
    def n(self) -> int:
        return sum(self.part_rows)

    @property
    def n_partitions(self) -> int:
        return len(self.part_rows)

    @property
    def device(self) -> torch.device:
        return self.dual.device

    def degree_range(self) -> Tuple[float, float]:
        """Within-partition degree range (each partition normalises against
        its own degrees — the divide-and-conquer approximation)."""
        return (min(r[0] for r in self.degree_ranges),
                max(r[1] for r in self.degree_ranges))

    def degree_dual(self) -> torch.Tensor:
        return self.dual

    def residency_diagnostics(self, cfg) -> dict:
        """The partitions' residency diagnostics aggregated: peak byte
        counts max'd (partitions share a device in turn or run on distinct
        ones), chunk counts summed."""
        out = {"n_partitions": self.n_partitions}
        for diag in self.part_residency:
            for key, val in diag.items():
                if key == "n_chunks":
                    out[key] = out.get(key, 0) + val
                elif isinstance(val, (int, float)) and \
                        not isinstance(val, bool):
                    out[key] = max(out.get(key, 0), val)
                else:
                    out[key] = val
        return out
