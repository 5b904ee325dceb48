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

Only Random Binning (``rb``, the paper's map) is ported; the dense maps of
the JAX package (rff, nystrom, lsc) are not yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import graph, rb
from repro_torch.kernels import ops
from repro_torch.utils import fold_seed


def _data_dim(x) -> int:
    return int((list(x) if isinstance(x, (list, tuple)) else [x])[0].shape[1])


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

    def fit(self, seed: int, x) -> "RBMap":
        """Draw the grids from ``fold_seed(seed, "rb")`` (and size d_g from
        ``fold_seed(seed, "probe")``), on ``x``'s device. An already fitted
        map (``params`` given, e.g. injected) keeps its grids."""
        device = x.device if isinstance(x, torch.Tensor) else "cpu"
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
                   device="cpu") -> "RBMap":
        """A fitted map from the artifact's numpy arrays (or the JAX
        package's ``state_dict``), with its tensors on ``device``."""
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


FEATURE_MAPS = {"rb": RBMap}


def from_config(cfg, impl: str = "auto") -> RBMap:
    """The default stage-1 map of an ``SCRBConfig``: Random Binning."""
    return RBMap(n_grids=cfg.n_grids, sigma=cfg.sigma, d_g=cfg.d_g, impl=impl)


def load_fitted(meta: dict, arrays: dict, device="cpu") -> RBMap:
    name = meta["name"]
    if name not in FEATURE_MAPS:
        raise NotImplementedError(
            f"feature map {name!r} is not yet ported to repro_torch "
            f"(ported: {sorted(FEATURE_MAPS)})")
    return FEATURE_MAPS[name].from_state(meta, arrays, device=device)
