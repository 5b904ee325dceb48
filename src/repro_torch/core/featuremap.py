"""FeatureMap — stage 1 of the executor and of fitted models.

A feature map produces a row-local representation Φ with Φ Φᵀ ≈ W; the
degrees, the eigensolve and the out-of-sample extension are written
against the map. Its protocol:

  ``fit(seed, x) -> fitted map``  draw the map's parameters
  ``transform(x) -> features``    row-local; ``kind == "ell"`` maps emit
                                  int32 ELL column indices (N, R)
  ``n_features``                  total feature columns D

plus the out-of-sample trio used by ``SCRBModel``: ``oos_degrees`` (degree
of a new point against the fitted graph, from the O(D) degree dual),
``oos_rowscale`` and ``project`` (Ẑ_new · M).

Registered maps (``FEATURE_MAPS``), those of the JAX package:

  rb       Random Binning (Alg. 1, hashed ELL)        this paper
  rff      Random Fourier Features                    SC_RF / SV_RF / KK_RF
  nystrom  landmark Nyström features                  SC_Nys / KK_RS
  lsc      s nearest anchors' affinities              SC_LSC

``kind == "dense"`` maps emit float32 (N, m) features. Their row-local
work runs in fixed row tiles (``utils.map_row_tiles``), so a row's
features do not depend on the batch it came in. ``meta_dict`` and
``state_dict`` keep the JAX package's layouts: artifacts cross-load.

The dense operands at the bottom (``NormalizedDenseFeatures``,
``ChunkedDenseFeatures``) are the dense counterparts of
``graph.NormalizedAdjacency`` and ``streaming.ChunkedELL``, with the same
product surface, so ``rowmatrix.DeviceRows`` and ``HostChunkedRows`` carry
either.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import graph, rb, rff, streaming
from repro_torch.core.nystrom import kernel_tile_rows, pairwise_kernel
from repro_torch.kernels import ops
from repro_torch.utils import (
    ROW_TILE, DeviceLike, fold_seed, map_row_tiles, prefetch_to_device,
    resolve_device, to_host,
)


def _chunk_list(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _data_dim(x) -> int:
    return int(_chunk_list(x)[0].shape[1])


def _n_rows(x) -> int:
    return sum(int(c.shape[0]) for c in _chunk_list(x))


def _fit_device(x, device) -> torch.device:
    """A fit's device: ``device`` if given, else ``x``'s (the CPU for an
    array or a list of host chunks)."""
    if device is not None:
        return torch.device(device)
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _as_t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device)


@dataclasses.dataclass(frozen=True)
class RBMap:
    """Random Binning features (Alg. 1): hashed ELL indices, D = R·d_g."""

    name = "rb"
    kind = "ell"
    n_grids: int
    sigma: float
    d_g: Optional[int] = None     # None → auto-size at fit from the data
    impl: str = "auto"
    params: Optional[rb.RBParams] = None

    def fit(self, seed: int, x, device=None) -> "RBMap":
        """Draw the grids from ``fold_seed(seed, "rb")`` (and size d_g from
        ``fold_seed(seed, "probe")``), on ``device``: by default ``x``'s
        (the CPU for an array or a list of host chunks; a host-chunked fit
        passes its own). An already fitted map (``params`` given, e.g.
        injected) keeps its grids."""
        device = _fit_device(x, device)
        if self.params is not None:
            return self.to(device)
        d_g = self.d_g or rb.suggest_d_g(x, self.sigma,
                                         seed=fold_seed(seed, "probe"))
        params = rb.make_rb_params(fold_seed(seed, "rb"), self.n_grids,
                                   _data_dim(x), self.sigma, d_g)
        return dataclasses.replace(self, d_g=d_g, params=params.to(device))

    def to(self, device) -> "RBMap":
        return dataclasses.replace(self, params=self.params.to(device))

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        return rb.rb_transform(x, self.params, impl=self.impl)

    @property
    def n_features(self) -> int:
        return self.params.n_features

    @property
    def dim(self) -> int:
        """Input dimensionality d."""
        return self.params.dim

    def oos_degrees(self, feats: torch.Tensor,
                    dual: torch.Tensor) -> torch.Tensor:
        """deg(x) = (1/R) Σ_g counts[idx_g] — the fitted bin occupancies
        evaluated at the new point's bins (Eq. 6, one-sided)."""
        return graph.degrees_from_counts(feats, dual)

    def oos_rowscale(self, deg: torch.Tensor, *,
                     laplacian: bool) -> torch.Tensor:
        if not laplacian:
            return torch.full_like(deg, graph._sqrt_r(self.n_grids)[1])
        return 1.0 / torch.sqrt(float(self.n_grids)
                                * torch.clamp_min(deg, 1e-8))

    def project(self, feats: torch.Tensor, rowscale: torch.Tensor,
                m: torch.Tensor) -> torch.Tensor:
        return ops.z_matmul(feats, m.contiguous(), rowscale.contiguous(),
                            d_g=self.d_g, impl=self.impl)

    # -- (de)serialization ---------------------------------------------------
    def meta_dict(self) -> dict:
        return {"name": self.name, "n_grids": self.n_grids,
                "sigma": self.sigma, "d_g": self.d_g, "impl": self.impl}

    def state_dict(self) -> dict:
        """numpy arrays in the JAX package's layout (uint32 hash params)."""
        p = self.params
        return {"widths": p.widths.detach().cpu().numpy(),
                "biases": p.biases.detach().cpu().numpy(),
                "hash_a": rb.i32_to_u32_numpy(p.hash_a),
                "hash_c": rb.i32_to_u32_numpy(p.hash_c)}

    @classmethod
    def from_state(cls, meta: dict, arrays: dict,
                   device: DeviceLike = "cuda") -> "RBMap":
        """A fitted map from the artifact's numpy arrays (or the JAX
        package's ``state_dict``), with its tensors on ``device``."""
        device = resolve_device(device)
        as_bits = lambda a: torch.from_numpy(
            np.array(a, np.uint32).view(np.int32))
        params = rb.RBParams(
            torch.from_numpy(np.array(arrays["widths"], np.float32)),
            torch.from_numpy(np.array(arrays["biases"], np.float32)),
            as_bits(arrays["hash_a"]), as_bits(arrays["hash_c"]),
            d_g=int(meta["d_g"]))
        return cls(n_grids=int(meta["n_grids"]), sigma=float(meta["sigma"]),
                   d_g=int(meta["d_g"]), impl=meta["impl"],
                   params=params.to(device))


# --------------------------------------------------------------------------
# Dense maps share the (N, m) float32 out-of-sample algebra.
# --------------------------------------------------------------------------

class _DenseOOS:
    kind = "dense"

    def oos_degrees(self, feats: torch.Tensor,
                    dual: torch.Tensor) -> torch.Tensor:
        """deg(x) = φ(x) · (Φᵀ1): a new point's kernel degree against the
        fitted graph (the fit's own degrees are the same function)."""
        return map_row_tiles(lambda f: f @ dual, feats)

    def oos_rowscale(self, deg: torch.Tensor, *,
                     laplacian: bool) -> torch.Tensor:
        if not laplacian:
            return torch.ones_like(deg)
        return 1.0 / torch.sqrt(torch.clamp_min(deg, 1e-8))

    def project(self, feats: torch.Tensor, rowscale: torch.Tensor,
                m: torch.Tensor) -> torch.Tensor:
        return map_row_tiles(lambda f, s: (f * s[:, None]) @ m, feats,
                             rowscale)


@dataclasses.dataclass(frozen=True)
class RFFMap(_DenseOOS):
    """Random Fourier Features: the RF baselines' map."""

    name = "rff"
    rank: int
    sigma: float
    kernel: str = "laplacian"
    params: Optional[rff.RFFParams] = None

    def fit(self, seed: int, x, device=None) -> "RFFMap":
        """Draw w and b from ``fold_seed(seed, "rff")``; an already fitted
        map keeps its draws. On ``device`` (by default ``x``'s)."""
        device = _fit_device(x, device)
        if self.params is not None:
            return self.to(device)
        params = rff.make_rff_params(fold_seed(seed, "rff"), self.rank,
                                     _data_dim(x), self.sigma,
                                     kernel=self.kernel)
        return dataclasses.replace(self, params=params.to(device))

    def to(self, device) -> "RFFMap":
        return dataclasses.replace(self, params=self.params.to(device))

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        return rff.rff_transform(x, self.params)

    @property
    def n_features(self) -> int:
        return self.params.n_features

    @property
    def dim(self) -> int:
        return self.params.dim

    def meta_dict(self) -> dict:
        return {"name": self.name, "rank": self.rank, "sigma": self.sigma,
                "kernel": self.kernel}

    def state_dict(self) -> dict:
        return {"w": self.params.w.detach().cpu().numpy(),
                "b": self.params.b.detach().cpu().numpy()}

    @classmethod
    def from_state(cls, meta: dict, arrays: dict,
                   device: DeviceLike = "cuda") -> "RFFMap":
        device = resolve_device(device)
        params = rff.RFFParams(_as_t(arrays["w"], device),
                               _as_t(arrays["b"], device))
        return cls(rank=int(meta["rank"]), sigma=float(meta["sigma"]),
                   kernel=meta["kernel"], params=params)


@dataclasses.dataclass(frozen=True)
class NystromMap(_DenseOOS):
    """Nyström landmark features Φ = K_nm · K_mm^{-1/2} (SC_Nys, KK_RS).

    ``fit`` samples m = min(rank, N/2) landmarks uniformly (by global row
    index, never concatenating a chunked input; the JAX package's numpy
    selection) and whitens K_mm: W = V Λ^{-1/2} Vᵀ over the eigenvalues
    above ``eps`` (``eigh`` in float32, on the fit's device). ``transform``
    is row-local: the kernel block against the landmarks times W, the
    Nyström out-of-sample extension."""

    name = "nystrom"
    rank: int
    sigma: float
    kernel: str = "laplacian"
    landmarks: Optional[torch.Tensor] = None    # (m, d)
    whiten: Optional[torch.Tensor] = None       # (m, m) = V Λ^{-1/2} Vᵀ

    def fit(self, seed: int, x, device=None, eps: float = 1e-6
            ) -> "NystromMap":
        """Landmarks drawn from ``fold_seed(seed, "nystrom")``; an already
        fitted map keeps its arrays. On ``device`` (by default ``x``'s)."""
        device = _fit_device(x, device)
        if self.landmarks is not None:
            return self.to(device)
        m = max(1, min(self.rank, _n_rows(x) // 2))
        lm = rb._gather_sample(x, m, seed=fold_seed(seed, "nystrom"))
        return self.with_landmarks(_as_t(lm, device), eps=eps)

    def with_landmarks(self, landmarks: torch.Tensor,
                       eps: float = 1e-6) -> "NystromMap":
        """The map fitted on given landmarks (m, d): K_mm's whitener."""
        lm = landmarks.to(torch.float32).contiguous()
        k_mm = pairwise_kernel(lm, lm, self.sigma, self.kernel)
        lam, v = torch.linalg.eigh(k_mm)
        inv_sqrt = torch.where(
            lam > eps, 1.0 / torch.sqrt(torch.clamp_min(lam, eps)),
            torch.zeros_like(lam))
        whiten = (v * inv_sqrt[None, :]) @ v.T
        return dataclasses.replace(self, landmarks=lm,
                                   whiten=whiten.contiguous())

    def to(self, device) -> "NystromMap":
        return dataclasses.replace(self, landmarks=self.landmarks.to(device),
                                   whiten=self.whiten.to(device))

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        lm, w = self.landmarks, self.whiten
        x = x.to(torch.float32).contiguous()
        return map_row_tiles(
            lambda xt: pairwise_kernel(xt, lm, self.sigma, self.kernel) @ w,
            x, rows=kernel_tile_rows(lm.shape[0], lm.shape[1], self.kernel))

    @property
    def n_features(self) -> int:
        return self.landmarks.shape[0]

    @property
    def dim(self) -> int:
        return self.landmarks.shape[1]

    def meta_dict(self) -> dict:
        return {"name": self.name, "rank": self.rank, "sigma": self.sigma,
                "kernel": self.kernel}

    def state_dict(self) -> dict:
        return {"landmarks": self.landmarks.detach().cpu().numpy(),
                "whiten": self.whiten.detach().cpu().numpy()}

    @classmethod
    def from_state(cls, meta: dict, arrays: dict,
                   device: DeviceLike = "cuda") -> "NystromMap":
        device = resolve_device(device)
        return cls(rank=int(meta["rank"]), sigma=float(meta["sigma"]),
                   kernel=meta["kernel"],
                   landmarks=_as_t(arrays["landmarks"], device),
                   whiten=_as_t(arrays["whiten"], device))


def lloyd_anchors(x, p: int, seed: int, *, n_refine: int = 3,
                  max_sample: int = 8192) -> np.ndarray:
    """LSC's p anchors, float64 (p, d): a uniform sample of min(N,
    max(max_sample, 4p)) rows (``rb._gather_sample``), p of them drawn as
    seeds, then ``n_refine`` Lloyd steps, in numpy on the host with the JAX
    package's draws and arithmetic (the distances in blocks of 512 sample
    rows, the same per-row sums as its one broadcast)."""
    n = _n_rows(x)
    sample = np.asarray(
        rb._gather_sample(x, min(n, max(max_sample, 4 * p)), seed=seed),
        np.float64)
    rng = np.random.default_rng(seed)
    anchors = sample[rng.choice(sample.shape[0], p, replace=False)]
    for _ in range(n_refine):
        lab = np.concatenate([
            np.argmin(((sample[i:i + 512, None, :] - anchors[None, :, :])
                       ** 2).sum(-1), -1)
            for i in range(0, sample.shape[0], 512)])
        for c in range(p):
            sel = lab == c
            if np.any(sel):
                anchors[c] = sample[sel].mean(0)
    return anchors


@dataclasses.dataclass(frozen=True)
class LSCMap(_DenseOOS):
    """LSC anchor affinities: the s nearest anchors, row-stochastic
    (SC_LSC).

    ``fit`` picks p = min(rank, N/2) anchors (``lloyd_anchors``, seeded
    by ``fold_seed(seed, "lsc")``); ``transform`` keeps each row's
    affinities at or above its s-th largest and divides by their sum:
    row-local, so it is also the out-of-sample extension."""

    name = "lsc"
    rank: int
    sigma: float
    kernel: str = "laplacian"
    n_nearest: int = 5
    anchors: Optional[torch.Tensor] = None      # (p, d)

    def fit(self, seed: int, x, device=None, n_refine: int = 3,
            max_sample: int = 8192) -> "LSCMap":
        device = _fit_device(x, device)
        if self.anchors is not None:
            return self.to(device)
        p = max(1, min(self.rank, _n_rows(x) // 2))
        anchors = lloyd_anchors(x, p, fold_seed(seed, "lsc"),
                                n_refine=n_refine, max_sample=max_sample)
        return dataclasses.replace(self, anchors=_as_t(anchors, device))

    def to(self, device) -> "LSCMap":
        return dataclasses.replace(self, anchors=self.anchors.to(device))

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        anchors = self.anchors
        s = min(self.n_nearest, anchors.shape[0])

        def block(xt):
            aff = pairwise_kernel(xt, anchors, self.sigma, self.kernel)
            thresh = torch.topk(aff, s, dim=-1).values[:, -1]
            kept = torch.where(aff >= thresh[:, None], aff,
                               torch.zeros_like(aff))
            return kept / torch.clamp_min(kept.sum(-1, keepdim=True), 1e-12)

        return map_row_tiles(
            block, x.to(torch.float32).contiguous(),
            rows=kernel_tile_rows(anchors.shape[0], anchors.shape[1],
                                  self.kernel))

    @property
    def n_features(self) -> int:
        return self.anchors.shape[0]

    @property
    def dim(self) -> int:
        return self.anchors.shape[1]

    def meta_dict(self) -> dict:
        return {"name": self.name, "rank": self.rank, "sigma": self.sigma,
                "kernel": self.kernel, "n_nearest": self.n_nearest}

    def state_dict(self) -> dict:
        return {"anchors": self.anchors.detach().cpu().numpy()}

    @classmethod
    def from_state(cls, meta: dict, arrays: dict,
                   device: DeviceLike = "cuda") -> "LSCMap":
        device = resolve_device(device)
        return cls(rank=int(meta["rank"]), sigma=float(meta["sigma"]),
                   kernel=meta["kernel"], n_nearest=int(meta["n_nearest"]),
                   anchors=_as_t(arrays["anchors"], device))


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

FEATURE_MAPS = {
    "rb": RBMap,
    "rff": RFFMap,
    "nystrom": NystromMap,
    "lsc": LSCMap,
}


def make_feature_map(name: str, *, rank: int, sigma: float,
                     kernel: str = "laplacian", **kwargs):
    """An unfitted feature map from the registry, by name."""
    if name not in FEATURE_MAPS:
        raise ValueError(
            f"unknown feature map {name!r}; options {sorted(FEATURE_MAPS)}")
    if name == "rb":
        return RBMap(n_grids=rank, sigma=sigma, **kwargs)
    return FEATURE_MAPS[name](rank=rank, sigma=sigma, kernel=kernel, **kwargs)


def from_config(cfg, impl: str = "auto") -> RBMap:
    """The default stage-1 map of an ``SCRBConfig``: Random Binning."""
    return RBMap(n_grids=cfg.n_grids, sigma=cfg.sigma, d_g=cfg.d_g, impl=impl)


def load_fitted(meta: dict, arrays: dict, device: DeviceLike = "cuda"):
    """A fitted map from an artifact's metadata and arrays (written by
    either package), with its tensors on ``device``."""
    name = meta["name"]
    if name not in FEATURE_MAPS:
        raise ValueError(
            f"unknown feature map {name!r}; options {sorted(FEATURE_MAPS)}")
    return FEATURE_MAPS[name].from_state(meta, arrays, device=device)


# --------------------------------------------------------------------------
# Dense operands: the (N, m) counterparts of NormalizedAdjacency and
# ChunkedELL, so the row representations carry dense maps through the same
# stages.
# --------------------------------------------------------------------------

def _row_tiles(parts_stream, rows: int):
    """Regroup a stream of row-aligned tensor tuples (row chunks) into
    tuples of exactly ``rows`` rows, cut at multiples of ``rows`` counted
    from the first row of the stream, whatever the chunk boundaries; the
    last one zero-padded."""
    carry = None
    for parts in parts_stream:
        n, start = parts[0].shape[0], 0
        if carry is not None:
            start = min(rows - carry[0].shape[0], n)
            carry = tuple(torch.cat([c, p[:start]])
                          for c, p in zip(carry, parts))
            if carry[0].shape[0] < rows:
                continue
            yield carry
            carry = None
        while start + rows <= n:
            yield tuple(p[start:start + rows] for p in parts)
            start += rows
        if start < n:
            carry = tuple(p[start:] for p in parts)
    if carry is not None:
        m = carry[0].shape[0]
        yield tuple(torch.cat([c, c.new_zeros((rows - m,) + c.shape[1:])])
                    for c in carry)


def _tile_sum(tiles, fn, init: torch.Tensor) -> torch.Tensor:
    """``init + Σ fn(*tile)`` over the tiles, added in order."""
    acc = init
    for tile in tiles:
        acc = acc + fn(*tile)
    return acc


def _degrees(phi: torch.Tensor, colsum: torch.Tensor, laplacian: bool,
             eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(deg, rowscale) of dense rows: deg = Φ (Φᵀ1), row-local."""
    deg = map_row_tiles(lambda p: p @ colsum, phi)
    if laplacian:
        return deg, 1.0 / torch.sqrt(torch.clamp_min(deg, eps))
    return deg, torch.ones_like(deg)


@dataclasses.dataclass(frozen=True)
class NormalizedDenseFeatures:
    """Ẑ = D̂^{-1/2} Φ for a dense feature matrix on the device, applied
    implicitly."""

    phi: torch.Tensor        # (N, m) float32
    rowscale: torch.Tensor   # (N,)
    deg: torch.Tensor        # (N,) kernel degrees
    colsum: torch.Tensor     # (m,) = Φᵀ1, the degree dual

    @property
    def n(self) -> int:
        return self.phi.shape[0]

    @property
    def width(self) -> int:
        return self.phi.shape[1]

    @property
    def device(self) -> torch.device:
        return self.phi.device

    def rmatmat(self, u: torch.Tensor) -> torch.Tensor:
        """Ẑᵀ u : (N, K) → (m, K)."""
        return self.phi.T @ (u * self.rowscale[:, None])

    def matmat(self, v: torch.Tensor) -> torch.Tensor:
        """Ẑ v : (m, K) → (N, K)."""
        return (self.phi @ v) * self.rowscale[:, None]

    def gram_matvec(self, u: torch.Tensor) -> torch.Tensor:
        return self.matmat(self.rmatmat(u))


def build_normalized_dense(phi: torch.Tensor, *, laplacian: bool = True,
                           eps: float = 1e-8) -> NormalizedDenseFeatures:
    """The degree pass of a dense map: Φᵀ1 added up tile by tile (tiles of
    ``ROW_TILE`` rows; the host-chunked store adds the same tiles in the
    same order, so both give the same bits), then deg = Φ (Φᵀ1) and the
    row scales, row-locally."""
    phi = phi.to(torch.float32).contiguous()
    colsum = _tile_sum(_row_tiles([(phi,)], ROW_TILE),
                       lambda p: p.sum(0),
                       torch.zeros((phi.shape[1],), dtype=torch.float32,
                                   device=phi.device))
    deg, rowscale = _degrees(phi, colsum, laplacian, eps)
    return NormalizedDenseFeatures(phi, rowscale, deg, colsum)


@dataclasses.dataclass(frozen=True)
class ChunkedDenseFeatures:
    """Host-chunked Ẑ = D̂^{-1/2} Φ: the dense counterpart of
    ``streaming.ChunkedELL``, with its chunk-sweep surface (prefetched
    uploads, ``rmatmat_chunked``, ``gram_matvec_chunked``, ``h2d_stats``),
    so ``rowmatrix.HostChunkedRows`` carries either.

    Sums over rows (Φᵀ1 and Ẑᵀu) go over tiles of ``ROW_TILE`` rows cut
    from the start of the data, whatever the chunking, added in order; the
    row-local products run in fixed row tiles. So the degree dual, the
    degrees, the row scales and every product have the same bits for any
    chunking, and Φᵀ1 and the degrees those of the device store."""

    phi_chunks: Tuple[torch.Tensor, ...]       # each (rows_c, m) float32
    rowscale_chunks: Tuple[torch.Tensor, ...]  # each (rows_c,) float32
    colsum: torch.Tensor                       # (m,) Φᵀ1, on ``device``
    deg: torch.Tensor                          # (N,) float32, host
    prefetch: bool = True
    h2d_stats: dict = dataclasses.field(default_factory=dict, compare=False)
    device: torch.device = torch.device("cpu")

    @property
    def n(self) -> int:
        return sum(c.shape[0] for c in self.phi_chunks)

    @property
    def width(self) -> int:
        return self.phi_chunks[0].shape[1]

    @property
    def n_chunks(self) -> int:
        return len(self.phi_chunks)

    @property
    def chunk_sizes(self) -> Tuple[int, ...]:
        return tuple(c.shape[0] for c in self.phi_chunks)

    @property
    def max_chunk_rows(self) -> int:
        return max(c.shape[0] for c in self.phi_chunks)

    @property
    def ell_device_bytes_peak(self) -> int:
        """Device residency of the feature matrix: one chunk (the same
        accounting as ``ChunkedELL``)."""
        return self.max_chunk_rows * self.width * 4

    def _stream(self, *extra_chunk_seqs):
        return prefetch_to_device(
            zip(self.phi_chunks, self.rowscale_chunks, *extra_chunk_seqs),
            device=self.device, enabled=self.prefetch,
            measure=self.h2d_stats)

    def _check_aligned(self, u: streaming.ChunkedDense) -> None:
        if u.chunk_sizes != self.chunk_sizes:
            raise ValueError(f"chunking mismatch: u has {u.chunk_sizes}, "
                             f"features have {self.chunk_sizes}")

    def rmatmat_chunked(self, u: streaming.ChunkedDense) -> torch.Tensor:
        """Ẑᵀ u : host chunks (N, K) → (m, K) on the device."""
        self._check_aligned(u)
        return _tile_sum(
            _row_tiles(self._stream(u.chunks), ROW_TILE),
            lambda p, s, uc: p.T @ (uc * s[:, None]),
            torch.zeros((self.width, u.k), dtype=torch.float32,
                        device=self.device))

    def matmat_chunked(self, v: torch.Tensor) -> streaming.ChunkedDense:
        """Ẑ v : (m, K) → host row chunks (N, K)."""
        v = v.to(device=self.device, dtype=torch.float32)
        return streaming.ChunkedDense(tuple(
            to_host(map_row_tiles(lambda p, s: (p @ v) * s[:, None], pc, sc))
            for pc, sc in self._stream()))

    def gram_matvec_chunked(self, u: streaming.ChunkedDense
                            ) -> streaming.ChunkedDense:
        return self.matmat_chunked(self.rmatmat_chunked(u))


def build_chunked_dense(phi_chunks: Sequence, *, laplacian: bool = True,
                        prefetch: bool = True, eps: float = 1e-8,
                        device: DeviceLike = "cuda"
                        ) -> ChunkedDenseFeatures:
    """The streaming degree pass of a dense map (two sweeps): Φᵀ1 over
    row tiles, then the degrees and row scales chunk by chunk, row-locally.
    The chunks stay on the host (pinned on the card)."""
    dev = resolve_device(device)
    pin = dev.type == "cuda"
    phi_chunks = tuple(
        streaming._pinned(streaming._as_host(c).to(torch.float32)
                          .contiguous(), pin) for c in phi_chunks)
    h2d_stats: dict = {}

    def sweep():
        return prefetch_to_device(((c,) for c in phi_chunks), device=dev,
                                  enabled=prefetch, measure=h2d_stats)

    colsum = _tile_sum(_row_tiles(sweep(), ROW_TILE), lambda p: p.sum(0),
                       torch.zeros((phi_chunks[0].shape[1],),
                                   dtype=torch.float32, device=dev))
    deg_chunks, scale_chunks = [], []
    for (pc,) in sweep():
        deg_c, scale_c = _degrees(pc, colsum, laplacian, eps)
        deg_chunks.append(to_host(deg_c))
        scale_chunks.append(to_host(scale_c))
    return ChunkedDenseFeatures(
        phi_chunks, tuple(scale_chunks), colsum=colsum,
        deg=torch.cat(deg_chunks), prefetch=prefetch, h2d_stats=h2d_stats,
        device=dev)
