"""Thread-safe hierarchical span tracer with Chrome-trace-event export.

The JAX package's ``obs.trace`` for PyTorch: the same span names, attributes
and Chrome-trace layout, so a trace of a port fit and one of a reference fit
read alike.

1. **Disabled is free.** Tracing is off by default and the fit path calls
   ``span(...)`` unconditionally, so the disabled path costs one attribute
   check and returns a shared no-op context manager: no allocation, no lock
   and no device synchronize.
2. **Spans measure device work, not the launches.** CUDA launches return
   before the device is done: a span closed right after a kernel call has
   timed the enqueue. With ``sync=True`` (the default for stage-level
   spans) the span exit calls ``torch.cuda.synchronize()`` first (when CUDA
   is initialised; on the CPU there is nothing to wait for; on a worker
   thread under ``stream_scoped_sync``, its current stream's
   ``synchronize()``), so the
   recorded duration covers the device work launched inside the span.
   Spans that time only the issue side (the prefetch ``h2d`` spans) pass
   ``sync=False`` and never synchronize.
3. **Threads are tracks.** Every span records the thread it closed on; the
   Chrome export emits per-thread track metadata.

The module-level tracer (``TRACER``) is what the pipeline instruments
against; tests construct private ``Tracer`` instances. ``REPRO_TRACE=<path>``
enables the module tracer at import and registers an atexit Chrome-JSON
export to that path.
"""
from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

_DISABLED = os.environ.get("REPRO_OBS_DISABLED", "") not in ("", "0")

_SYNC = threading.local()


@contextlib.contextmanager
def stream_scoped_sync():
    """Inside the block, on this thread, :func:`_device_sync` waits for the
    thread's current CUDA stream only (for the spans and ``StageTimer``).
    A worker thread of a partitioned fit runs its partitions on a stream of
    its own: a whole-device synchronize there would wait for every other
    worker's partitions too, and a stage timed on one worker would include
    the others' work."""
    prev = getattr(_SYNC, "stream", False)
    _SYNC.stream = True
    try:
        yield
    finally:
        _SYNC.stream = prev


def _device_sync() -> None:
    """Wait for the work queued on the current CUDA device (on this thread's
    current stream alone under :func:`stream_scoped_sync`), when CUDA is
    initialised; a no-op on the CPU (nothing is queued there)."""
    if torch.cuda.is_initialized():
        if getattr(_SYNC, "stream", False):
            torch.cuda.current_stream().synchronize()
        else:
            torch.cuda.synchronize()


class _NullSpan:
    """Shared no-op span for the disabled path (and a safe ``set`` sink)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()

_THREAD = threading.local()
_TRACKS = itertools.count(1)


def _track() -> int:
    """The calling thread's track number, never given to another thread.
    A thread's ``ident`` is not: a thread that starts after another ended
    may get its ident, and the two would share a track."""
    track = getattr(_THREAD, "track", None)
    if track is None:
        track = _THREAD.track = next(_TRACKS)
    return track


class Span:
    """One open span; context-manager. ``set(**attrs)`` adds attributes any
    time before exit (e.g. results only known mid-stage)."""

    __slots__ = ("name", "attrs", "sync", "t0_ns", "dur_ns", "tid",
                 "thread_name", "depth", "_tracer", "_mem0")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any],
                 sync: Optional[bool]):
        self.name = name
        self.attrs = attrs
        self.sync = tracer.sync if sync is None else sync
        self._tracer = tracer
        self.t0_ns = 0
        self.dur_ns = 0
        self.tid = 0
        self.thread_name = ""
        self.depth = 0
        self._mem0 = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        tr = self._tracer
        stack = tr._stack()
        self.depth = len(stack)
        stack.append(self)
        if tr.memory:
            from repro_torch.obs import memory as _memory
            self._mem0 = _memory.sample()
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.sync:
            _device_sync()
        self.dur_ns = time.perf_counter_ns() - self.t0_ns
        tr = self._tracer
        if self._mem0 is not None:
            from repro_torch.obs import memory as _memory
            m1 = _memory.sample()
            self.attrs["rss_bytes"] = m1["rss_bytes"]
            self.attrs["rss_delta_bytes"] = (m1["rss_bytes"]
                                             - self._mem0["rss_bytes"])
            if m1.get("device_bytes_in_use") is not None:
                self.attrs["device_bytes_in_use"] = m1["device_bytes_in_use"]
                self.attrs["device_delta_bytes"] = (
                    m1["device_bytes_in_use"]
                    - (self._mem0.get("device_bytes_in_use") or 0))
        th = threading.current_thread()
        self.tid = _track()
        self.thread_name = th.name
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        tr._record(self)
        return False


class Tracer:
    """Span collector. ``enabled=False`` (the default) short-circuits
    ``span`` to the shared null span."""

    def __init__(self, *, enabled: bool = False, sync: bool = True,
                 memory: bool = False):
        self.enabled = enabled and not _DISABLED
        self.sync = sync
        self.memory = memory
        self.path: Optional[str] = None
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._local = threading.local()
        self._epoch_ns = time.perf_counter_ns()

    # -- recording ---------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def span(self, name: str, *, sync: Optional[bool] = None, **attrs):
        """Open a span (context manager). Free when the tracer is off."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, attrs, sync)

    # -- lifecycle ---------------------------------------------------------
    def enable(self, path: Optional[str] = None, *,
               sync: Optional[bool] = None,
               memory: Optional[bool] = None) -> bool:
        """Turn the tracer on (no-op under ``REPRO_OBS_DISABLED``). ``path``
        sets where ``export_chrome()`` writes by default. Returns whether
        the tracer is enabled after the call."""
        if _DISABLED:
            return False
        self.enabled = True
        if path:
            self.path = path
        if sync is not None:
            self.sync = sync
        if memory is not None:
            self.memory = memory
        return True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._spans = []
        self._epoch_ns = time.perf_counter_ns()

    # -- introspection / export --------------------------------------------
    def finished(self, name: Optional[str] = None) -> List[Span]:
        """Snapshot of closed spans (optionally filtered by name)."""
        with self._lock:
            spans = list(self._spans)
        if name is not None:
            spans = [s for s in spans if s.name == name]
        return spans

    def export_chrome(self, path: Optional[str] = None) -> dict:
        """Chrome-trace-event JSON (Perfetto / ``chrome://tracing``).

        Complete ("X") events in microseconds relative to the tracer epoch;
        per-thread metadata events give the tracks stable human names.
        Writes to ``path`` (or the path given at ``enable``) when set;
        always returns the trace dict.
        """
        spans = self.finished()
        tids: Dict[int, str] = {}
        for s in spans:
            tids.setdefault(s.tid, s.thread_name)
        # stable small tids: main thread first, then by first appearance
        tid_map = {t: i + 1 for i, t in enumerate(tids)}
        pid = os.getpid()
        events: List[dict] = []
        for t, nm in tids.items():
            events.append({"ph": "M", "pid": pid, "tid": tid_map[t],
                           "name": "thread_name", "args": {"name": nm}})
            events.append({"ph": "M", "pid": pid, "tid": tid_map[t],
                           "name": "thread_sort_index",
                           "args": {"sort_index": tid_map[t]}})
        for s in spans:
            events.append({
                "ph": "X", "pid": pid, "tid": tid_map[s.tid],
                "name": s.name,
                "ts": (s.t0_ns - self._epoch_ns) / 1e3,
                "dur": s.dur_ns / 1e3,
                "args": _jsonable(s.attrs),
            })
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        path = path or self.path
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace


def _jsonable(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = repr(v)
    return out


#: The process tracer every pipeline layer instruments against.
TRACER = Tracer()


def span(name: str, *, sync: Optional[bool] = None, **attrs):
    """Open a span on the process tracer — the one-liner used across the
    codebase. Returns the shared null span when tracing is off."""
    if not TRACER.enabled:
        return NULL_SPAN
    return Span(TRACER, name, attrs, sync)


def enable(path: Optional[str] = None, *, sync: Optional[bool] = None,
           memory: Optional[bool] = None) -> bool:
    """Enable the process tracer (see ``Tracer.enable``); registers an
    atexit Chrome export when a path is given."""
    ok = TRACER.enable(path, sync=sync, memory=memory)
    if ok and path:
        _register_atexit_export()
    return ok


def disable() -> None:
    TRACER.disable()


def export(path: Optional[str] = None) -> dict:
    return TRACER.export_chrome(path)


_ATEXIT_REGISTERED = False


def _register_atexit_export() -> None:
    global _ATEXIT_REGISTERED
    if _ATEXIT_REGISTERED:
        return
    _ATEXIT_REGISTERED = True

    def _flush():
        if TRACER.path and TRACER.finished():
            try:
                TRACER.export_chrome()
            except Exception:
                pass

    atexit.register(_flush)


@contextlib.contextmanager
def tracing(path: Optional[str]):
    """Scoped tracing for one run (the ``SCRBConfig(trace=...)`` hook).

    ``path=None`` → passthrough. If the process tracer is *already* enabled
    (``REPRO_TRACE`` or an enclosing run), this is a
    reentrant no-op — spans land in the enclosing trace and whoever enabled
    it exports it. Otherwise the tracer is enabled for the scope and the
    collected trace is exported to ``path`` on exit, with the tracer
    returned to its prior (disabled) state.
    """
    if path is None or TRACER.enabled or _DISABLED:
        yield TRACER
        return
    TRACER.enable(path)
    try:
        yield TRACER
    finally:
        try:
            TRACER.export_chrome(path)
        finally:
            TRACER.disable()
            TRACER.reset()      # scoped run: don't leak spans past export


# REPRO_TRACE=<path>: enable process-wide tracing at import, export at exit.
_ENV_PATH = os.environ.get("REPRO_TRACE", "")
if _ENV_PATH and not _DISABLED:
    enable(_ENV_PATH)
