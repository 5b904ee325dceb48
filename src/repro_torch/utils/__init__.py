"""Shared small utilities: the stage timer, seed derivation, device checks,
and the package logger."""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Iterator, Union

import torch

logger = logging.getLogger("repro_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "[%(asctime)s] %(name)s %(levelname)s %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``torch.device`` for an entry point's ``device=`` keyword.

    A CUDA device with no card present raises: an entry point never
    carries on on the CPU when it was asked for the GPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def _fnv1a(name: str) -> int:
    h = 2166136261
    for ch in name.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h


def fold_seed(seed: int, *names: str) -> int:
    """Deterministically derive a generator seed from string tags.

    The tags and their FNV-1a hash are those of the JAX package's
    ``fold_key`` (``"probe"``, ``"rb"``, ``"eig"``, ``"kmeans"``), so each
    random draw of a fit has the same name in both packages; the numbers
    drawn differ, since torch cannot replay JAX's PRNG.
    """
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    for name in names:
        # splitmix64 step over (state, tag hash): a well-mixed 63-bit seed
        s = (s ^ (_fnv1a(name) * 0x9E3779B97F4A7C15)) & 0xFFFFFFFFFFFFFFFF
        s = ((s ^ (s >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        s = ((s ^ (s >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        s ^= s >> 31
    return s & 0x7FFFFFFFFFFFFFFF


def make_generator(seed: int, device: DeviceLike = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


class StageTimer:
    """Wall-clock per-stage timer used by the SC_RB pipeline.

    Records ``{stage: seconds}``. On a CUDA run every clock read is
    preceded by ``torch.cuda.synchronize()``, so a stage's time includes
    the device work it queued rather than only the launches.
    """

    def __init__(self, device: DeviceLike = "cpu") -> None:
        self.times: Dict[str, float] = {}
        self._sync = torch.device(device).type == "cuda"

    def _clock(self) -> float:
        if self._sync:
            torch.cuda.synchronize()
        return time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = self._clock()
        yield
        dt = self._clock() - t0
        self.times[name] = self.times.get(name, 0.0) + dt

    @property
    def total(self) -> float:
        return sum(self.times.values())

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v:.3f}s" for k, v in self.times.items())
        return f"StageTimer({inner}, total={self.total:.3f}s)"
