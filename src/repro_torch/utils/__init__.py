"""Shared small utilities: the stage timer, seed derivation, device checks,
double-buffered host→device uploads, and the package logger."""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Any, Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

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


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """Float32 products in full float32 (no TF32) inside the block, whatever
    the process has set; the previous settings come back on exit. Serving
    (``SCRBModel.predict``/``transform``, the cluster engine) runs under it,
    as a fit runs under ``executor.configure_device``."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


#: Rows of the fixed tiles that ``map_row_tiles`` runs a row-local function
#: on.
ROW_TILE = 4096


def map_row_tiles(fn, *xs: torch.Tensor, rows: int = ROW_TILE
                  ) -> torch.Tensor:
    """``fn`` over consecutive tiles of ``rows`` rows of the row-aligned
    tensors ``xs`` (the last tile zero-padded), the outputs concatenated
    with the padding cut.

    BLAS libraries pick their kernel by shape: MKL and cuBLAS may give a
    row other bits in a call of 1 row than in a call of 4,096 (a
    matrix-vector product sums in another order). A row-local ``fn`` run
    at one shape gives each row the same bits whatever batch it came in,
    so the fit's transform, ``predict`` and the serving engine's buckets
    agree bit for bit."""
    n = xs[0].shape[0]
    outs = []
    for start in range(0, max(n, 1), rows):
        parts = [x[start:start + rows] for x in xs]
        m = parts[0].shape[0]
        if m < rows:
            parts = [torch.cat([p, p.new_zeros((rows - m,) + p.shape[1:])])
                     for p in parts]
        outs.append(fn(*parts)[:m])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


_STAGE_SECONDS = _metrics.REGISTRY.histogram(
    "repro_stage_seconds", "Pipeline stage wall-clock seconds.", ("stage",))


class StageTimer:
    """Wall-clock per-stage timer used by the SC_RB pipeline.

    Records ``{stage: seconds}``. On a CUDA run every clock read is
    preceded by ``obs.trace._device_sync()`` (``torch.cuda.synchronize()``;
    the thread's current stream alone on a partitioned fit's worker), so a
    stage's time includes the device work it queued rather than only the
    launches. Each stage
    also opens a ``obs.trace`` span of its name (free when tracing is off)
    and feeds the ``repro_stage_seconds`` histogram, as in the JAX package;
    ``times`` comes from the timer's own clock either way.
    """

    def __init__(self, device: DeviceLike = "cpu") -> None:
        self.times: Dict[str, float] = {}
        self._sync = torch.device(device).type == "cuda"

    def _clock(self) -> float:
        if self._sync:
            _trace._device_sync()
        return time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        with _trace.span(name):
            t0 = self._clock()
            yield
            dt = self._clock() - t0
        self.times[name] = self.times.get(name, 0.0) + dt
        _STAGE_SECONDS.observe(dt, stage=name)

    @property
    def total(self) -> float:
        return sum(self.times.values())

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v:.3f}s" for k, v in self.times.items())
        return f"StageTimer({inner}, total={self.total:.3f}s)"


def tree_map(fn, obj):
    """``fn`` over the leaves of tuples, lists and dataclasses."""
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree_map(fn, o) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return fn(obj)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the CPU. A CUDA tensor is copied (synchronously) into pinned
    memory, so that a later upload of it can be asynchronous."""
    if t.device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t)


_PREFETCH_ITEMS = _metrics.REGISTRY.counter(
    "repro_prefetch_items_total", "Host pytrees uploaded by prefetch_to_device.")
_PREFETCH_BYTES = _metrics.REGISTRY.counter(
    "repro_prefetch_bytes_total", "Bytes uploaded by prefetch_to_device.")


def _tree_nbytes(item) -> int:
    """Bytes of the arrays among an item's leaves."""
    total = 0

    def add(t):
        nonlocal total
        if isinstance(t, (np.ndarray, torch.Tensor)):
            total += t.nbytes
        return t

    tree_map(add, item)
    return total


def prefetch_to_device(
    items: Iterable[Any], *, device: DeviceLike = "cpu", enabled: bool = True,
    measure: Optional[Dict[str, int]] = None,
) -> Iterator[Any]:
    """Double-buffered upload of an iterable of host items to ``device``.

    An item is a tensor, a numpy array, or a tuple, list or dataclass of
    them (other leaves pass through). Yields each item with its arrays on
    ``device``. On CUDA every copy is ``non_blocking`` from pinned host
    memory (a host tensor that is not pinned is copied into pinned memory
    first: an upload is never silently synchronous) on a side stream; an
    event orders it before the consumer's work on the current stream, and
    ``record_stream`` keeps the caching allocator from reusing its device
    buffer until that work is done. With ``enabled=True`` the upload of
    item i+1 is issued before item i is handed out, so it overlaps the
    compute on item i (up to two items in flight); ``enabled=False``
    uploads each item as it is consumed. The values, and the order in which
    a consumer adds them up, are the same either way. On the CPU the items
    are handed out as they are.

    ``measure`` (a dict) is updated in place with the measured uploads:
    ``max_item_bytes`` (the largest item), ``items`` and ``bytes`` (their
    total), the check behind the residency diagnostics. Every item also
    feeds the ``repro_prefetch_items_total`` / ``repro_prefetch_bytes_total``
    counters and, when tracing is on, an ``h2d`` span (``sync=False``: it
    times the issue; a synchronize there would undo the double buffering).
    """
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream(dev) if cuda and enabled else None

    def put(item):
        def leaf(t):
            if isinstance(t, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(t))
            if not isinstance(t, torch.Tensor):
                return t
            if not cuda or t.device.type != "cpu":
                return t.to(dev)
            if not t.is_pinned():
                t = t.pin_memory()
            if side is None:
                return t.to(dev, non_blocking=True)
            with torch.cuda.stream(side):
                out = t.to(dev, non_blocking=True)
            out.record_stream(torch.cuda.current_stream(dev))
            return out

        nbytes = _tree_nbytes(item)
        if measure is not None:
            measure["max_item_bytes"] = max(measure.get("max_item_bytes", 0),
                                            nbytes)
            measure["items"] = measure.get("items", 0) + 1
            measure["bytes"] = measure.get("bytes", 0) + nbytes
        _PREFETCH_ITEMS.inc()
        _PREFETCH_BYTES.inc(nbytes)
        with _trace.span("h2d", sync=False, bytes=nbytes):
            tree = tree_map(leaf, item)
        event = None
        if side is not None:
            event = torch.cuda.Event()
            event.record(side)
        return tree, event

    def ready(pair):
        tree, event = pair
        if event is not None:
            torch.cuda.current_stream(dev).wait_event(event)
        return tree

    it = iter(items)
    if not enabled:
        for item in it:
            yield ready(put(item))
        return
    try:
        cur = put(next(it))
    except StopIteration:
        return
    for item in it:
        nxt = put(item)     # issue the upload of i+1 before i is consumed
        yield ready(cur)
        cur = nxt
    yield ready(cur)
