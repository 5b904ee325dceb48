"""Typed option groups for ``SCRBConfig`` — the grouped-config API.

(A copy of the JAX package's module, kept field for field so configs and
artifacts round-trip; of the solvers and placements it names, the port
runs ``lobpcg`` on placement ``single`` so far.)

Four PRs of knob accretion left ``SCRBConfig`` with a flat ``solver_*`` /
``compressive_*`` sprawl; this module groups them into frozen sub-configs:

  ``SolverOptions``       eigensolver family, iteration/tolerance budget,
                          preconditioner, stability stop
  ``CompressiveOptions``  the eigendecomposition-free cell's signal/filter/
                          probe/subset knobs + the ``auto`` routing threshold
  ``PartitionOptions``    the divide-and-conquer ``placement="partitioned"``
                          fit (``repro.core.partitioned``)

``SCRBConfig`` keeps every historical flat kwarg as a deprecated shim:
passing one still works (it is folded into the matching group and a
``DeprecationWarning`` is emitted), and the flat attribute reads stay valid
because normalization mirrors the canonical group values back onto the flat
fields. ``normalize_config`` is the single normalization point — executor /
compressive / rowmatrix code reads grouped options only.

Precedence when both spellings are given: an explicitly-passed flat kwarg
wins over the group field (and warns). A flat value *equal* to the group's
is silent — that is the ``dataclasses.replace(cfg, ...)`` path, which
re-passes every current field value.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Mapping, Optional, Tuple


class _Unset:
    """Sentinel for 'flat kwarg not passed' (distinct from None, which is a
    meaningful value for several knobs)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "<unset>"


UNSET = _Unset()


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Eigensolver selection + budget (stage 3 of Algorithm 2)."""

    solver: str = "lobpcg"        # lobpcg | lobpcg_host | lanczos | subspace
                                  # | randomized | auto | compressive
    iters: int = 300              # max solver iterations
    tol: float = 1e-4             # residual-norm stop
    buffer: int = 4               # LOBPCG block-width buffer over K
    precond: str = "degree"       # "degree" (Jacobi-on-L̂ diagonal) | "none"
    stable_tol: Optional[float] = None
    # ^ adaptive stop: exit once the leading-k Ritz subspace moves less than
    #   this between checkpoints. None keeps the pure residual stop.


@dataclasses.dataclass(frozen=True)
class CompressiveOptions:
    """Knobs of the eigendecomposition-free ``solver="compressive"`` cell
    (``repro.core.compressive``) + the ``solver="auto"`` routing point."""

    signals: Optional[int] = None     # d filtered random signals; None → O(log K)
    degree: Optional[int] = None      # Chebyshev filter degree; None → from gap
    probes: int = 32                  # Rademacher probes for eigencount traces
    subset: Optional[int] = None      # rows sampled for k-means; None → O(K log K)
    lambdas: Optional[Tuple[float, float]] = None   # known (λ_K, λ_{K+1}) bracket
    auto_n: Optional[int] = 1_000_000
    # ^ solver="auto" prefers compressive at n ≥ this; None disables routing.

    def __post_init__(self):
        if self.lambdas is not None and not isinstance(self.lambdas, tuple):
            object.__setattr__(self, "lambdas",
                               tuple(float(v) for v in self.lambdas))


@dataclasses.dataclass(frozen=True)
class PartitionOptions:
    """Divide-and-conquer fit (``placement="partitioned"``): split rows into
    ``n_partitions``, fit each independently through the recursive executor
    (shared feature map ⇒ one feature space), merge the per-partition
    centroid representatives in feature space, label all N rows through the
    out-of-sample path. See ``repro.core.partitioned``."""

    n_partitions: int = 4
    workers: Optional[int] = None     # parallel fits; None → min(P, n_devices)
    shuffle: bool = True              # seeded row shuffle before splitting
    # (contiguous slices of sorted data would give single-cluster partitions)
    local_clusters: Optional[int] = None
    # ^ clusters per partition (the merge sees P·local_clusters
    #   representatives); None → the global n_clusters.

    def __post_init__(self):
        if self.n_partitions < 1:
            raise ValueError(
                f"n_partitions must be >= 1, got {self.n_partitions}")
        if self.workers is not None and self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")


#: flat SCRBConfig field → attribute of the matching group.
SOLVER_FLAT_FIELDS = {
    "solver": "solver",
    "solver_iters": "iters",
    "solver_tol": "tol",
    "solver_buffer": "buffer",
    "solver_precond": "precond",
    "solver_stable_tol": "stable_tol",
}
COMPRESSIVE_FLAT_FIELDS = {
    "compressive_signals": "signals",
    "compressive_degree": "degree",
    "compressive_probes": "probes",
    "compressive_subset": "subset",
    "compressive_lambdas": "lambdas",
    "compressive_auto_n": "auto_n",
}


def _coerce_group(group_cls, value, field_name):
    """Accept a group instance or a plain mapping (JSON artifact configs)."""
    if value is None or isinstance(value, group_cls):
        return value
    if isinstance(value, Mapping):
        return group_cls(**value)
    raise TypeError(
        f"{field_name} must be a {group_cls.__name__} or a mapping, "
        f"got {type(value).__name__}")


def _flat_value(flat_field, value):
    if flat_field == "compressive_lambdas" and value is not None \
            and not isinstance(value, _Unset):
        return tuple(float(v) for v in value)
    return value


def _normalize_group(cfg, group_field, group_cls, flat_spec):
    group = _coerce_group(group_cls, getattr(cfg, group_field), group_field)
    overrides, deprecated = {}, []
    for flat_field, attr in flat_spec.items():
        value = getattr(cfg, flat_field)
        if isinstance(value, _Unset):
            continue
        value = _flat_value(flat_field, value)
        if group is None or getattr(group, attr) != value:
            overrides[attr] = value
            deprecated.append(flat_field)
    if group is None:
        group = group_cls(**overrides)
    elif overrides:
        group = dataclasses.replace(group, **overrides)
    if deprecated:
        warnings.warn(
            f"flat SCRBConfig kwarg(s) {deprecated} are deprecated; pass "
            f"{group_field}={group_cls.__name__}(...) instead (the flat "
            f"value(s) were applied)",
            DeprecationWarning, stacklevel=5)
    object.__setattr__(cfg, group_field, group)
    # mirror the canonical group back onto the flat fields so legacy
    # attribute *reads* (cfg.solver, cfg.compressive_probes, ...) stay valid
    for flat_field, attr in flat_spec.items():
        object.__setattr__(cfg, flat_field, getattr(group, attr))


def normalize_config(cfg) -> None:
    """The single normalization point, called from
    ``SCRBConfig.__post_init__``: folds deprecated flat kwargs into their
    groups (warning on actual flat usage), materializes default groups, and
    mirrors group values onto the flat fields."""
    _normalize_group(cfg, "solver_options", SolverOptions,
                     SOLVER_FLAT_FIELDS)
    _normalize_group(cfg, "compressive_options", CompressiveOptions,
                     COMPRESSIVE_FLAT_FIELDS)
    # partition has no flat legacy; None means "not partitioned", so it is
    # only coerced (mapping → dataclass), never defaulted.
    object.__setattr__(cfg, "partition",
                       _coerce_group(PartitionOptions, cfg.partition,
                                     "partition"))
