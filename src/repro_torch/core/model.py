"""SCRBModel — the fitted-model API over the executor.

The RB feature matrix Z implicitly carries the similarity graph, so what is
needed to embed and label a new point is computed at fit time: the feature
map's grids, the degree dual Zᵀ1, the right singular subspace and the
k-means centroids. ``fit`` runs Algorithm 2 once through
``executor.execute`` and adds

  V = Ẑᵀ U Σ⁻¹                  (D, K) right singular subspace — one more
                                 pass of the ``zt`` kernel,
  dual = Zᵀ 1                    (D,) out-of-sample degree oracle,

after which ``transform``/``predict`` are the Nyström-style out-of-sample
extension with O(D·K) state:

  φ = map.transform(x_new)             row-local features (rb_binning)
  deg = φ · dual                       degree vs the fitted graph
  ẑ = D̂^{-1/2} φ                      fitted-degree normalization
  u = ẑ · V Σ⁻¹                        projection (z_matmul)
  û = u / ‖u‖                          row-normalize (Alg. 2 step 4)
  label = argmin_k ‖û − c_k‖           nearest centroid (kmeans_assign)

``save``/``load`` use the JAX package's one-``.npz`` artifact (format
"1.1"), key for key: artifacts move between the two packages both ways.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import executor as _executor, featuremap
from repro_torch.core.kmeans import row_normalize
from repro_torch.kernels import ops
from repro_torch.utils import fold_seed, resolve_device

#: Serialization format. Major bumps break ``load``; minor bumps are
#: additive and readable by any same-major build.
FORMAT_VERSION = "1.1"

#: Geometric batch-bucket grid of ``transform``/``predict``: every batch is
#: zero-padded up to a bucket, so a server sees a handful of shapes. All
#: out-of-sample ops are row-local, so padded rows never touch real rows.
BUCKET_GRID = (64, 256, 1024, 4096)


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def round_to_bucket(n: int, grid=BUCKET_GRID, *, multiple_of: int = 1) -> int:
    """Smallest bucket in ``grid`` that fits ``n`` rows; above the top
    bucket, the next multiple of the top bucket."""
    if n < 1:
        raise ValueError(f"need at least one row, got {n}")
    top = grid[-1]
    size = next((b for b in grid if n <= b), _ceil_to(n, top))
    return _ceil_to(size, multiple_of) if multiple_of > 1 else size


def _oos_embed_impl(fm, dual, proj, x, *, laplacian: bool) -> torch.Tensor:
    """Out-of-sample embedding: transform → fitted-degree normalize →
    project onto V Σ⁻¹ → row-normalize."""
    feats = fm.transform(x)
    deg = fm.oos_degrees(feats, dual)
    scale = fm.oos_rowscale(deg, laplacian=laplacian)
    return row_normalize(fm.project(feats, scale, proj))


def _oos_predict_impl(fm, dual, proj, cents, x, *, laplacian: bool,
                      impl: str) -> torch.Tensor:
    u = _oos_embed_impl(fm, dual, proj, x, laplacian=laplacian)
    labels, _ = ops.kmeans_assign(u.contiguous(), cents, impl=impl)
    return labels


def _row_chunks(x, chunk_size: Optional[int]) -> list:
    if isinstance(x, (list, tuple)):
        if not x:
            raise ValueError("empty chunk sequence")
        return list(x)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    if chunk_size is None or chunk_size >= x.shape[0]:
        return [x]
    return [x[i:i + chunk_size] for i in range(0, x.shape[0], chunk_size)]


@dataclasses.dataclass
class SCRBModel:
    """A fitted SC_RB model with out-of-sample ``transform``/``predict``;
    its state (tensors on the model's device) is O(D·K), independent of
    N_train."""

    config: _executor.SCRBConfig
    feature_map: Any                       # fitted featuremap.RBMap
    degree_dual: torch.Tensor              # (D,) Zᵀ1
    right_vectors: torch.Tensor            # (D, K) V = Ẑᵀ U Σ⁻¹
    singular_values: torch.Tensor          # (K,)
    centroids: Optional[torch.Tensor]      # (n_clusters, K)
    laplacian_normalize: bool = True
    fit_result: Optional[_executor.FitResult] = None   # not serialized

    @property
    def device(self) -> torch.device:
        return self.right_vectors.device

    # -- fitting -----------------------------------------------------------
    @classmethod
    def fit(
        cls,
        x,
        config: _executor.SCRBConfig,
        *,
        k: "Optional[int | str]" = None,
        mesh=None,
        plan: Optional[_executor.ExecutionPlan] = None,
        final_stage: str = "kmeans",
        keep_embedding: bool = True,
        x0=None,
        device="cuda",
    ) -> "SCRBModel":
        """Run Algorithm 2 on ``device`` and keep the out-of-sample state.

        ``k`` overrides ``config.n_clusters``; ``k="auto"`` picks K by the
        eigengap over the rank-``n_clusters`` spectrum (``n_clusters`` acts
        as K_max). ``x0`` warm-starts (or injects) the eigensolve's start
        block through ``ExecutionPlan.eig_x0``. The train-run ``FitResult``
        rides along as ``model.fit_result``.
        """
        auto_k = False
        if isinstance(k, str):
            if k != "auto":
                raise ValueError(f"k must be an int or 'auto', got {k!r}")
            auto_k = True
        elif k is not None:
            config = dataclasses.replace(config, n_clusters=int(k))
        if plan is None:
            plan = _executor.plan_from_config(config, mesh=mesh)
        if x0 is not None:
            plan = dataclasses.replace(plan, eig_x0=x0)
        if auto_k:
            res, config = cls._execute_auto_k(
                x, config, plan, final_stage=final_stage,
                keep_embedding=keep_embedding, device=device)
        else:
            res = _executor.execute(x, config, plan, final_stage=final_stage,
                                    keep_embedding=keep_embedding,
                                    keep_state=True, device=device)
        st = res.state
        z, eig, km = st["z"], st["eig"], st["km"]
        with res.timer.stage("oos_state"):
            sig = torch.as_tensor(np.asarray(res.singular_values, np.float32),
                                  device=z.device)
            inv_sig = torch.where(sig > 1e-6,
                                  1.0 / torch.clamp_min(sig, 1e-30),
                                  torch.zeros_like(sig))
            # V = Ẑᵀ U Σ⁻¹ — one more pass of the zt kernel
            v = z.rmatvec(eig.vectors) * inv_sig[None, :]
            dual = z.degree_dual()
        res.state = None          # drop the O(N) internals; model is O(D·K)
        return cls(
            config=config,
            feature_map=st["features"].fmap,
            degree_dual=dual,
            right_vectors=v,
            singular_values=sig,
            centroids=None if km is None else km.centroids,
            laplacian_normalize=plan.laplacian_normalize,
            fit_result=res,
        )

    @staticmethod
    def _execute_auto_k(x, config, plan, *, final_stage, keep_embedding,
                        device):
        """``k="auto"``: one run stopped after the normalize stage with
        K_max eigenpairs, the eigengap pick, then prefix truncation of the
        eigenvectors and k-means at the chosen K — no second eigensolve."""
        k_max = config.n_clusters
        if k_max < 3:
            raise ValueError(
                f"k='auto' needs n_clusters (K_max) >= 3, got {k_max}")
        res = _executor.execute(x, config, plan, final_stage="normalize",
                                keep_embedding=False, keep_state=True,
                                device=device)
        st = res.state
        z, eig = st["z"], st["eig"]
        theta = np.asarray(res.singular_values, np.float64) ** 2
        # eigengap: choose the k ∈ [2, K_max-1] maximizing λ_k − λ_{k+1}
        gaps = theta[:-1] - theta[1:]
        chosen = int(np.argmax(gaps[1:k_max - 1])) + 2
        vecs_k = eig.vectors[:, :chosen].contiguous()
        eig_k = eig._replace(theta=eig.theta[:chosen], vectors=vecs_k,
                             resnorms=eig.resnorms[:chosen])
        cfg_k = dataclasses.replace(config, n_clusters=chosen)
        with res.timer.stage("normalize"):
            u_hat = z.map_row_chunks(row_normalize, vecs_k)
        km, cluster_diag = None, {}
        if final_stage == "kmeans":
            with res.timer.stage("kmeans"):
                km, cluster_diag = z.cluster(
                    fold_seed(config.seed, "kmeans"), u_hat, cfg_k)
        res.labels = None if km is None else km.labels.cpu().numpy()
        if keep_embedding:
            res.embedding = u_hat.cpu().numpy()
        res.singular_values = np.asarray(res.singular_values)[:chosen]
        st["eig"], st["km"], st["u_hat"] = eig_k, km, u_hat
        res.diagnostics.update(cluster_diag)
        if km is not None:
            res.diagnostics["kmeans_inertia"] = float(km.inertia)
        res.diagnostics["k_auto"] = {
            "k": chosen, "k_max": k_max,
            "spectrum": [float(t) for t in theta],
            "gaps": [float(g) for g in gaps],
        }
        return res, cfg_k

    # -- inference ---------------------------------------------------------
    @property
    def _projection(self) -> torch.Tensor:
        """V Σ⁻¹ (D, K): Ẑ_new · (V Σ⁻¹) ≈ U_new (Eq. 7 out-of-sample)."""
        sig = self.singular_values
        inv_sig = torch.where(sig > 1e-6, 1.0 / torch.clamp_min(sig, 1e-30),
                              torch.zeros_like(sig))
        return (self.right_vectors * inv_sig[None, :]).contiguous()

    def _serve_batches(self, x, batch_size: Optional[int]):
        """Yield (device_batch, n_real_rows) pairs, zero-padding each chunk
        up to the bucket grid when ``batch_size`` is set."""
        eff = None if batch_size is None else round_to_bucket(batch_size)
        for c in _row_chunks(x, eff):
            rows = c.shape[0]
            xb = _executor.as_device_rows(c, self.device)
            if batch_size is not None and rows > 0:
                target = round_to_bucket(rows)
                if target != rows:
                    pad = torch.zeros((target - rows, xb.shape[1]),
                                      dtype=xb.dtype, device=xb.device)
                    xb = torch.cat([xb, pad])
            yield xb, rows

    def transform(self, x, *, batch_size: Optional[int] = None) -> np.ndarray:
        """Out-of-sample spectral embedding (n_new, K), in batches of
        ``batch_size`` rows rounded up to ``BUCKET_GRID``."""
        proj = self._projection
        outs = [
            _oos_embed_impl(self.feature_map, self.degree_dual, proj, xb,
                            laplacian=self.laplacian_normalize)[:rows]
            .cpu().numpy()
            for xb, rows in self._serve_batches(x, batch_size)
        ]
        return np.concatenate(outs, axis=0)

    def predict(self, x, *, batch_size: Optional[int] = None) -> np.ndarray:
        """Nearest-fitted-centroid labels for new points, (n_new,) int32."""
        if self.centroids is None:
            raise ValueError(
                "model has no centroids (fit stopped before the k-means "
                "stage); use transform() or refit with final_stage='kmeans'")
        proj = self._projection
        cents = self.centroids.contiguous()
        outs = [
            _oos_predict_impl(self.feature_map, self.degree_dual, proj, cents,
                              xb, laplacian=self.laplacian_normalize,
                              impl=self.config.impl)[:rows].cpu().numpy()
            for xb, rows in self._serve_batches(x, batch_size)
        ]
        return np.concatenate(outs, axis=0)

    @property
    def data_dim(self) -> int:
        """Input dimensionality d expected by ``transform``/``predict``."""
        return int(self.feature_map.params.dim)

    def _arrays(self) -> dict:
        as_np = lambda t: t.detach().cpu().numpy().astype(np.float32)
        arrays = {
            "degree_dual": as_np(self.degree_dual),
            "right_vectors": as_np(self.right_vectors),
            "singular_values": as_np(self.singular_values),
        }
        if self.centroids is not None:
            arrays["centroids"] = as_np(self.centroids)
        for k, v in self.feature_map.state_dict().items():
            arrays[f"fm_{k}"] = v
        return arrays

    @property
    def nbytes(self) -> int:
        """Serialized state size — independent of N_train by construction."""
        return int(sum(a.nbytes for a in self._arrays().values()))

    # -- serialization -----------------------------------------------------
    def save(self, path: str) -> None:
        """One-file artifact: npz arrays + JSON metadata header, in the JAX
        package's layout."""
        meta = {
            "format_version": FORMAT_VERSION,
            "config": self.config.to_dict(),
            "laplacian_normalize": bool(self.laplacian_normalize),
            "has_centroids": self.centroids is not None,
            "feature_map": self.feature_map.meta_dict(),
            "data_dim": self.data_dim,
        }
        meta_bytes = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                   dtype=np.uint8)
        with open(path, "wb") as f:
            np.savez(f, _meta=meta_bytes, **self._arrays())

    @classmethod
    def load(cls, path: str, *, device="cuda") -> "SCRBModel":
        """Read an artifact (written by either package) onto ``device``."""
        dev = resolve_device(device)
        with np.load(path, allow_pickle=False) as npz:
            meta = json.loads(bytes(npz["_meta"].tobytes()).decode("utf-8"))
            ver = meta.get("format_version")
            # v1.0 artifacts stamped the bare int 1; ≥1.1 stamps "major.minor"
            try:
                major = ver if isinstance(ver, int) \
                    else int(str(ver).split(".", 1)[0])
            except ValueError:
                major = None
            if major != int(FORMAT_VERSION.split(".", 1)[0]):
                raise ValueError(
                    f"unsupported model artifact format_version={ver!r}: "
                    f"this build reads major "
                    f"{FORMAT_VERSION.split('.', 1)[0]} "
                    f"(writes {FORMAT_VERSION})")
            fm_arrays = {k[3:]: npz[k] for k in npz.files
                         if k.startswith("fm_")}
            as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                             device=dev)
            return cls(
                config=_executor.SCRBConfig.from_dict(meta["config"]),
                feature_map=featuremap.load_fitted(meta["feature_map"],
                                                   fm_arrays, device=dev),
                degree_dual=as_t(npz["degree_dual"]),
                right_vectors=as_t(npz["right_vectors"]),
                singular_values=as_t(npz["singular_values"]),
                centroids=as_t(npz["centroids"]) if meta["has_centroids"]
                else None,
                laplacian_normalize=meta["laplacian_normalize"],
            )
