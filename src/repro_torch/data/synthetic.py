"""Seeded synthetic clustering benchmarks standing in for the paper's 8
LibSVM datasets (offline container — DESIGN.md §7).

Each generator is deterministic in ``seed`` and returns ``(X float32 (N,d),
y int32 (N,))``. ``paper_suite`` mirrors the paper's Table 1 (name, K, d, N)
at a configurable scale factor so benchmark shapes track the paper's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

Array = np.ndarray
Dataset = Tuple[Array, Array]


def make_blobs(
    n: int, d: int, k: int, *, seed: int = 0, spread: float = 0.25,
    anisotropic: bool = False,
) -> Dataset:
    """Gaussian mixture with well-separated random centers on the sphere."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    centers *= 2.0
    y = rng.integers(0, k, size=n)
    x = centers[y] + spread * rng.normal(size=(n, d))
    if anisotropic:
        for c in range(k):
            m = rng.normal(size=(d, d)) * 0.3 + np.eye(d)
            sel = y == c
            x[sel] = (x[sel] - centers[c]) @ m + centers[c]
    return x.astype(np.float32), y.astype(np.int32)


def make_rings(n: int, k: int, *, d: int = 2, seed: int = 0, noise: float = 0.04) -> Dataset:
    """Concentric rings — the classic 'k-means fails, SC wins' geometry.

    For d > 2 the rings are embedded by a random orthogonal map + noise.
    """
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, size=n)
    radii = 1.0 + 1.2 * y
    theta = rng.uniform(0, 2 * np.pi, size=n)
    pts = np.stack([radii * np.cos(theta), radii * np.sin(theta)], axis=1)
    pts += noise * rng.normal(size=pts.shape)
    if d > 2:
        q, _ = np.linalg.qr(rng.normal(size=(d, d)))
        emb = np.zeros((n, d), np.float64)
        emb[:, :2] = pts
        pts = emb @ q + 0.02 * rng.normal(size=(n, d))
    return pts.astype(np.float32), y.astype(np.int32)


def make_moons(n: int, *, d: int = 2, seed: int = 0, noise: float = 0.06) -> Dataset:
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=n)
    t = rng.uniform(0, np.pi, size=n)
    x0 = np.where(y == 0, np.cos(t), 1.0 - np.cos(t))
    x1 = np.where(y == 0, np.sin(t), 0.5 - np.sin(t))
    pts = np.stack([x0, x1], axis=1) + noise * rng.normal(size=(n, 2))
    if d > 2:
        q, _ = np.linalg.qr(rng.normal(size=(d, d)))
        emb = np.zeros((n, d), np.float64)
        emb[:, :2] = pts
        pts = emb @ q + 0.02 * rng.normal(size=(n, d))
    return pts.astype(np.float32), y.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SuiteSpec:
    name: str
    k: int
    d: int
    n_paper: int
    generator: str = "blobs"      # blobs | aniso | rings


# Table 1 of the paper: (K, d, N). Same shapes, synthetic content.
PAPER_TABLE1 = [
    SuiteSpec("pendigits", 10, 16, 10_992, "blobs"),
    SuiteSpec("letter", 26, 16, 15_500, "aniso"),
    SuiteSpec("mnist", 10, 780, 70_000, "blobs"),
    SuiteSpec("acoustic", 3, 50, 98_528, "aniso"),
    SuiteSpec("ijcnn1", 2, 22, 126_701, "rings"),
    SuiteSpec("cod_rna", 2, 8, 321_054, "rings"),
    SuiteSpec("covtype-mult", 7, 54, 581_012, "aniso"),
    SuiteSpec("poker", 10, 10, 1_025_010, "blobs"),
]


def generate(spec: SuiteSpec, *, scale: float = 1.0, seed: int = 0) -> Dataset:
    n = max(64 * spec.k, int(spec.n_paper * scale))
    if spec.generator == "blobs":
        return make_blobs(n, spec.d, spec.k, seed=seed)
    if spec.generator == "aniso":
        return make_blobs(n, spec.d, spec.k, seed=seed, spread=0.35, anisotropic=True)
    if spec.generator == "rings":
        return make_rings(n, spec.k, d=spec.d, seed=seed)
    raise ValueError(spec.generator)


def paper_suite(scale: float = 0.05, seed: int = 0) -> Dict[str, Dataset]:
    """All 8 paper-shaped datasets at ``scale`` × the paper's N."""
    return {s.name: generate(s, scale=scale, seed=seed) for s in PAPER_TABLE1}
