"""Random Binning feature generation — Algorithm 1 of the paper.

Given a product-form kernel ``k(x,y) = Π_l k_l(|x_l − y_l|)``, draw R random
grids; each grid maps a point to the indicator of the bin it falls in, and
the collision probability of two points equals the kernel value, so
``E[Z Zᵀ] = W``. For the Laplacian kernel ``exp(−δ/σ)`` the grid widths are
``Gamma(shape=2, scale=σ)``.

The countably infinite bin space is hashed into ``d_g`` columns per grid
(multiply-shift hashing), giving an ELL matrix ``idx int32 (N, R)``: the
paper's O(NR) memory with static shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.utils import make_generator


def u32_to_i32(values: torch.Tensor) -> torch.Tensor:
    """int32 tensor with the bits of uint32 ``values`` (given as int64)."""
    v = values.to(torch.int64) & 0xFFFFFFFF
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def i32_to_u32_numpy(bits: torch.Tensor) -> np.ndarray:
    """uint32 numpy array of an int32 tensor of uint32 bits."""
    return bits.detach().cpu().numpy().astype(np.int32).view(np.uint32)


@dataclasses.dataclass(frozen=True)
class RBParams:
    """Parameters of R random grids (+ hashing) for d-dimensional data.

    ``hash_a`` and ``hash_c`` hold uint32 values as int32 bit patterns
    (PyTorch's uint32 arithmetic is incomplete); ``state_dict`` and
    ``from_state`` convert to and from the artifact's uint32 arrays."""

    widths: torch.Tensor   # (R, d) float32, ω ~ Gamma(2, σ) per (grid, dim)
    biases: torch.Tensor   # (R, d) float32, u ~ U[0, ω)
    hash_a: torch.Tensor   # (R, d) int32 bits of uint32 odd multipliers
    hash_c: torch.Tensor   # (R,) int32 bits of uint32 mixing constants
    d_g: int               # hashed features per grid (power of two)

    @property
    def n_grids(self) -> int:
        return self.widths.shape[0]

    @property
    def dim(self) -> int:
        return self.widths.shape[1]

    @property
    def n_features(self) -> int:
        """Total feature columns D = R · d_g."""
        return self.n_grids * self.d_g

    def to(self, device) -> "RBParams":
        return dataclasses.replace(
            self, widths=self.widths.to(device), biases=self.biases.to(device),
            hash_a=self.hash_a.to(device), hash_c=self.hash_c.to(device))


def make_rb_params(
    seed: int,
    n_grids: int,
    dim: int,
    sigma: float,
    d_g: int = 1024,
) -> RBParams:
    """Draw grid widths/biases per Alg. 1 (Laplacian kernel) + hash params.

    Drawn on the CPU from a generator seeded with ``seed``, so a CPU and a
    CUDA fit of the same seed use the same grids. Gamma(2, σ) is drawn as σ
    times the sum of two Exp(1) variables."""
    if d_g < 1 or d_g & (d_g - 1):
        raise ValueError(f"d_g must be a power of two, got {d_g}")
    g = make_generator(seed)
    shape = (n_grids, dim)
    expo = torch.empty((2,) + shape, dtype=torch.float32).exponential_(
        generator=g)
    widths = torch.clamp_min(float(sigma) * expo.sum(0), 1e-6)
    biases = torch.rand(shape, generator=g, dtype=torch.float32) * widths
    hash_a = torch.randint(0, 2**31 - 1, shape, generator=g,
                           dtype=torch.int64) * 2 + 1
    hash_c = torch.randint(0, 2**31 - 1, (n_grids,), generator=g,
                           dtype=torch.int64)
    return RBParams(widths, biases, u32_to_i32(hash_a), u32_to_i32(hash_c),
                    d_g)


def rb_transform(x: torch.Tensor, params: RBParams, *,
                 impl: str = "auto") -> torch.Tensor:
    """ELL column indices of the RB feature matrix: int32 (N, R).

    The implied Z has ``Z[i, idx[i,g]] = 1/sqrt(R)`` (values folded into
    row scales downstream)."""
    return ops.rb_binning(
        x.to(torch.float32).contiguous(), params.widths, params.biases,
        params.hash_a, params.hash_c, d_g=params.d_g, impl=impl)


def rb_bins_exact(x: np.ndarray, params: RBParams) -> np.ndarray:
    """Un-hashed integer bin coordinates (N, R, d) — numpy oracle.

    Two points share a bin in grid g iff their coordinate rows are equal."""
    w = params.widths.detach().cpu().numpy()[None]
    u = params.biases.detach().cpu().numpy()[None]
    return np.floor((x[:, None, :] - u) / w).astype(np.int64)


def laplacian_kernel(x: np.ndarray, y: Optional[np.ndarray] = None, *,
                     sigma: float) -> np.ndarray:
    """Exact product-Laplacian kernel matrix exp(−‖x−y‖₁/σ) (test oracle)."""
    y = x if y is None else y
    l1 = np.abs(x[:, None, :] - y[None, :, :]).sum(-1)
    return np.exp(-l1 / sigma)


def gaussian_kernel(x: np.ndarray, y: Optional[np.ndarray] = None, *,
                    sigma: float) -> np.ndarray:
    """Gaussian RBF kernel exp(−‖x−y‖²/2σ²) (baselines)."""
    y = x if y is None else y
    sq = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    return np.exp(-sq / (2.0 * sigma**2))


def expected_nonempty_bins(idx: torch.Tensor, d_g: int) -> float:
    """Empirical κ (Def. 1): the mean over grids of 1/max_b ν_b, ν_b the
    share of the rows in bin b (from ``ops.bin_counts``' exact occupancies).
    Larger κ ⇒ faster convergence in R."""
    n, r = idx.shape
    counts = ops.bin_counts(idx, d=r * d_g, d_g=d_g).reshape(r, d_g)
    top = counts.max(dim=1).values.to(torch.float64)
    return float(torch.mean(n / top))


def _to_numpy_rows(x, sel: Optional[np.ndarray]) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        rows = x if sel is None else x[torch.as_tensor(sel, device=x.device)]
        return rows.detach().cpu().numpy()
    xs = np.asarray(x)
    return xs if sel is None else xs[sel]


def _gather_sample(x, n_sample: int, seed: int) -> np.ndarray:
    """Uniform row subsample of an array, a tensor, or a sequence of row
    chunks. The selection is the JAX package's (same numpy generator, same
    call), so both packages suggest the same σ and d_g for the same data;
    a device tensor sends only the sampled rows to the host."""
    if isinstance(x, (list, tuple)):
        sizes = [int(c.shape[0]) for c in x]
        total = sum(sizes)
        if total <= n_sample:
            return np.concatenate([_to_numpy_rows(c, None) for c in x])
        bounds = np.cumsum([0] + sizes)
        sel = np.random.default_rng(seed).choice(total, n_sample,
                                                 replace=False)
        rows = []
        for i in sel:
            c = int(np.searchsorted(bounds, i, side="right")) - 1
            rows.append(_to_numpy_rows(x[c], np.array([i - bounds[c]]))[0])
        return np.stack(rows)
    n = int(x.shape[0])
    sel = None
    if n > n_sample:
        sel = np.random.default_rng(seed).choice(n, n_sample, replace=False)
    return _to_numpy_rows(x, sel)


def suggest_d_g(
    x: "torch.Tensor | np.ndarray | Sequence[np.ndarray]",
    sigma: float,
    *,
    seed: Optional[int] = None,
    n_probe_grids: int = 8,
    n_sample: int = 2048,
    headroom: float = 8.0,
    min_d_g: int = 256,
    max_d_g: int = 1 << 16,
) -> int:
    """Pick the per-grid hash width d_g from the data's occupied-bin count.

    Probes a few grids (drawn from ``seed``) on a subsample, counts exact
    occupied bins, and takes the next power of two ≥ headroom × P90(count):
    hash collisions inject spurious edges once occupied bins approach d_g.
    """
    seed = 0 if seed is None else seed
    xs = _gather_sample(x, n_sample, seed=0)
    probe = make_rb_params(seed, n_probe_grids, xs.shape[1], sigma,
                           d_g=min_d_g)
    bins = rb_bins_exact(xs, probe)                       # (n, G, d)
    counts = [len({tuple(row) for row in bins[:, g, :]})
              for g in range(n_probe_grids)]
    target = headroom * float(np.percentile(counts, 90))
    d_g = 1 << max(int(np.ceil(np.log2(max(target, 1.0)))), 0)
    return int(min(max(d_g, min_d_g), max_d_g))


def suggest_sigma(x: "torch.Tensor | np.ndarray | Sequence[np.ndarray]", *,
                  n_sample: int = 512, scale: float = 0.5,
                  seed: int = 0) -> float:
    """Median-heuristic bandwidth for the Laplacian kernel:
    σ = scale · median‖x_i − x_j‖₁ over a subsample."""
    xs = _gather_sample(x, n_sample, seed)
    d1 = np.abs(xs[:, None, :] - xs[None, :, :]).sum(-1)
    iu = np.triu_indices(xs.shape[0], k=1)
    return float(np.median(d1[iu]) * scale)
