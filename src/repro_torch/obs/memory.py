"""Host-RSS and device-memory watermark sampling.

The JAX package's ``obs.memory`` for PyTorch: one sampling surface for the
tracer (``Tracer(memory=True)``) and for the executor's
``FitResult.diagnostics["memory"]``:

- ``host_rss_bytes()``      — current resident set size (``/proc/self/statm``).
- ``host_peak_rss_bytes()`` — lifetime RSS high-water mark (``getrusage``).
- ``device_bytes_in_use()`` — live CUDA allocation of the caching allocator
  (``torch.cuda.memory_stats``); ``None`` when no CUDA device is in use.
- ``device_peak_bytes()``   — its high-water mark
  (``torch.cuda.max_memory_allocated``).
- ``sample()``              — one dict with all of the above.
- ``Watermark``             — scoped peak-delta helper for tests/benchmarks.
"""
from __future__ import annotations

import os
import resource
from typing import Dict, Optional

import torch

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def host_rss_bytes() -> int:
    """Current host resident set size in bytes (0 if unreadable)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, IndexError, ValueError):
        return 0


def host_peak_rss_bytes() -> int:
    """Lifetime peak RSS in bytes (``ru_maxrss`` is KiB on Linux)."""
    try:
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except (OSError, ValueError):
        return 0


def _cuda_in_use(device=None) -> bool:
    """Whether a CUDA device reports: CUDA initialised (a fit or an upload
    touched the card), and ``device``, when given, a CUDA device."""
    if device is not None and torch.device(device).type != "cuda":
        return False
    return torch.cuda.is_initialized()


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """``torch.cuda.memory_stats`` of ``device`` (default: the current CUDA
    device), or ``None`` on a CPU run."""
    if not _cuda_in_use(device):
        return None
    return torch.cuda.memory_stats(device) or None


def device_bytes_in_use(device=None) -> Optional[int]:
    """Bytes the caching allocator holds for live tensors on ``device``, or
    ``None`` on a CPU run."""
    stats = device_memory_stats(device)
    if not stats:
        return None
    return stats.get("allocated_bytes.all.current")


def device_peak_bytes(device=None) -> Optional[int]:
    """Peak bytes allocated on ``device`` since the last
    ``torch.cuda.reset_peak_memory_stats``, or ``None`` on a CPU run."""
    if not _cuda_in_use(device):
        return None
    return torch.cuda.max_memory_allocated(device)


def sample() -> Dict[str, Optional[int]]:
    """One watermark sample: host RSS + peak, device in-use + peak (both
    from one ``torch.cuda.memory_stats`` read, which builds a dict of some
    100 entries: ``memory_allocated`` and ``max_memory_allocated`` would
    build it twice)."""
    stats = device_memory_stats() or {}
    return {
        "rss_bytes": host_rss_bytes(),
        "peak_rss_bytes": host_peak_rss_bytes(),
        "device_bytes_in_use": stats.get("allocated_bytes.all.current"),
        "device_peak_bytes": stats.get("allocated_bytes.all.peak"),
    }


class Watermark:
    """Scoped memory watermark: RSS/device deltas across a ``with`` block.

    ``peak_rss_delta_bytes`` uses the process-lifetime high-water mark, so
    it is an upper bound credited to the block (exact when the block is
    where the peak actually occurred).
    """

    __slots__ = ("start", "end")

    def __init__(self):
        self.start: Dict[str, Optional[int]] = {}
        self.end: Dict[str, Optional[int]] = {}

    def __enter__(self) -> "Watermark":
        self.start = sample()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = sample()
        return False

    @property
    def rss_delta_bytes(self) -> int:
        return (self.end.get("rss_bytes") or 0) - (self.start.get("rss_bytes") or 0)

    @property
    def peak_rss_delta_bytes(self) -> int:
        return (self.end.get("peak_rss_bytes") or 0) - (self.start.get("peak_rss_bytes") or 0)

    @property
    def device_delta_bytes(self) -> Optional[int]:
        a, b = self.start.get("device_bytes_in_use"), self.end.get("device_bytes_in_use")
        if a is None or b is None:
            return None
        return b - a

    def as_dict(self) -> Dict[str, Optional[int]]:
        return {
            "rss_bytes": self.end.get("rss_bytes"),
            "peak_rss_bytes": self.end.get("peak_rss_bytes"),
            "rss_delta_bytes": self.rss_delta_bytes,
            "peak_rss_delta_bytes": self.peak_rss_delta_bytes,
            "device_bytes_in_use": self.end.get("device_bytes_in_use"),
            "device_peak_bytes": self.end.get("device_peak_bytes"),
            "device_delta_bytes": self.device_delta_bytes,
        }
