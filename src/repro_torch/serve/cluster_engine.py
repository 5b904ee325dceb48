"""Continuous-batching predict serving engine over fitted ``SCRBModel``s.

The JAX package's ``repro.serve.cluster_engine``, with its public surface
(``EngineConfig``, ``ClusterEngine``, ``Result``, ``MODES``,
``STAT_KEYS``). A model's state is small (O(D·K)) and fixed, the requests
are ragged, so the engine batches on rows:

- **Bucketed cells.** Requests for one (model, mode) are coalesced and
  zero-padded up to a bucket of ``EngineConfig.buckets``. On the card a
  cell is one ``torch.cuda.CUDAGraph`` per (state slot, bucket, mode),
  captured once over a static input of the bucket's shape: it replays
  ``model._oos_predict_impl`` / ``_oos_embed_impl`` (for an RB model
  ``rb_binning``, the degree gather and the projection through
  ``z_matmul``'s gather kernel, ``row_normalize`` and ``kmeans_assign``)
  with no host dispatch. The path runs once eagerly first, so the kernel
  build and every first-use query happen before capture. On the CPU a cell
  is the plain function, with the same counters. Every out-of-sample op is
  row-local, so pad rows never touch real rows and each request's output
  is bit-identical to ``model.predict``/``transform``.
- **Pinned staging ring.** Each (shape, dtype) owns a small ring of host
  buffers (pinned on the card): a batch is assembled in a ring buffer and
  copied into the graph's static input, and the output comes back into
  another. The ring is filled when a shape first appears, so steady-state
  serving allocates nothing, on the host or (graphs) on the device.
- **Multi-model LRU over state slots.** Models are registered by name
  (``load_model`` takes an npz path or a fitted model; re-loading a name is
  a hot-swap). A graph reads its state at fixed addresses, so device state
  lives in *slots* keyed by the state's signature (the map's metadata and
  every state tensor's shape and dtype), and cells are keyed by slot. The
  LRU (``max_resident_models`` / ``device_budget_bytes``, counted over the
  resident models' state as in the JAX package) evicts a model by handing
  its slot back. A re-faulted model copies its state into a free slot of
  its signature, one H2D copy and no capture; a slot, and its graphs, is
  made only when every slot of the signature holds a resident model. So
  eviction keeps the captured cells, as the JAX package's keeps its
  compiled ones. A slot is freed, with its static inputs and its cells,
  when no registered model has its signature any more (a hot-swap to a
  refitted model), and free slots are freed oldest first while all slots'
  state exceeds ``device_budget_bytes``: a model re-faulted after that
  captures its cells again. So the slots never outnumber the registered
  signatures, and under a budget their state stays within it (or within
  the resident models' state, when the newest model alone exceeds it).

The engine is synchronous and single-threaded: ``submit`` enqueues and
returns a ticket, ``step`` serves one coalesced batch, ``drain`` runs until
idle, ``take`` collects a finished ticket. ``serve/server.py`` puts a
stdlib HTTP front end over the same loop.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import model as _model
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.utils import (
    DeviceLike, full_float32, resolve_device, tree_map,
)

MODES = ("predict", "transform")

#: The per-model counters behind ``stats()``: one ``engine_<key>_total``
#: counter per key on the engine's private registry. ``compiles`` counts
#: captured cells (graphs on the card).
STAT_KEYS = ("compiles", "cache_hits", "resident_hits", "resident_misses",
             "evictions", "rows_served", "batches", "padded_rows")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs for ``ClusterEngine``: the JAX package's but ``donate``,
    which a graph's static input, taking every batch in place, makes
    moot."""

    buckets: Tuple[int, ...] = _model.BUCKET_GRID
    max_resident_models: int = 4          # LRU capacity (count)
    device_budget_bytes: Optional[int] = None   # LRU capacity (bytes)
    ring_slots: int = 2                   # staging buffers per shape
    max_batch_rows: Optional[int] = None  # coalescing cap; None → top bucket
    impl: Optional[str] = None            # kmeans_assign impl override
    trace: Optional[str] = None           # Chrome-trace output path: enables
    # process-wide repro_torch.obs tracing at engine construction (each
    # step emits a span) and exports the trace at process exit

    def __post_init__(self):
        if tuple(sorted(self.buckets)) != tuple(self.buckets) or \
                len(self.buckets) == 0 or self.buckets[0] < 1:
            raise ValueError(f"buckets must be ascending and ≥1: {self.buckets}")


class _StagingRing:
    """Per-(shape, dtype) ring of reusable host buffers, pinned for a card.

    The first request for a shape fills its whole ring (counted in
    ``allocations``); later ``get``s hand out the least recently used
    buffer, so steady state allocates nothing."""

    def __init__(self, slots: int, pin: bool):
        self.slots = max(1, int(slots))
        self.pin = pin
        self._rings: Dict[tuple, collections.deque] = {}
        self.allocations = 0

    def get(self, shape: Tuple[int, ...],
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
        key = (tuple(shape), dtype)
        ring = self._rings.get(key)
        if ring is None:
            ring = collections.deque(
                torch.empty(shape, dtype=dtype, pin_memory=self.pin)
                for _ in range(self.slots))
            self._rings[key] = ring
            self.allocations += self.slots
        buf = ring.popleft()
        ring.append(buf)
        return buf


def _tensors(tree) -> List[torch.Tensor]:
    """The tensor leaves of a state tree, in a fixed order."""
    out: List[torch.Tensor] = []

    def grab(t):
        if isinstance(t, torch.Tensor):
            out.append(t)
        return t

    tree_map(grab, tree)
    return out


@dataclasses.dataclass(eq=False)
class _Slot:
    """Device tensors that hold one model's serving state at a time:
    ``state`` is (fitted map, dual, projection, centroids)."""

    id: int
    sig: tuple
    state: tuple
    nbytes: int
    owner: Optional[str] = None
    inputs: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Resident:
    slot: Optional[_Slot]
    nbytes: int


@dataclasses.dataclass
class _Cell:
    """One (slot, bucket, mode): ``fn`` on the static input ``x``; on the
    card ``graph`` replays it into ``out``. ``launches`` holds the kernel
    launches its capture recorded."""

    fn: Callable[[torch.Tensor], torch.Tensor]
    x: torch.Tensor
    graph: Optional[Any] = None
    out: Optional[torch.Tensor] = None
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Request:
    ticket: int
    model: str
    mode: str
    x: np.ndarray
    out: np.ndarray
    submitted_at: float
    cursor: int = 0               # rows already served
    completed_at: Optional[float] = None


@dataclasses.dataclass
class Result:
    """A finished request: output rows and timing."""

    ticket: int
    model: str
    mode: str
    values: np.ndarray
    submitted_at: float
    completed_at: float

    @property
    def latency(self) -> float:
        return self.completed_at - self.submitted_at


class ClusterEngine:
    """Long-lived multi-model serving loop on ``device`` ("cuda" unless the
    caller asks for the CPU); see the module docstring.

    Counters live on a per-engine ``obs.metrics.MetricsRegistry``
    (``self.registry``), beside a per-(model, mode) latency histogram;
    ``stats()`` returns the JAX package's dict plus ``slots``,
    ``slots_freed`` and ``replayed_launches`` (kernel launches made by graph replays, by
    kernel: ``ops.LAUNCHES`` counts the wrappers' own launches only)."""

    def __init__(self, config: Optional[EngineConfig] = None, *,
                 device: DeviceLike = "cuda"):
        self.config = config or EngineConfig()
        self.device = resolve_device(device)
        self._graphs = self.device.type == "cuda"
        self._pool = torch.cuda.graph_pool_handle() if self._graphs else None
        self._models: Dict[str, _model.SCRBModel] = {}
        self._states: Dict[str, Tuple[tuple, tuple, int]] = {}
        self._resident: "collections.OrderedDict[str, _Resident]" = \
            collections.OrderedDict()
        self._slots: List[_Slot] = []     # free ones in order of release
        self._slot_ids = itertools.count()
        self.slots_freed = 0
        self._cells: Dict[Tuple[int, int, str], _Cell] = {}
        self._ring = _StagingRing(self.config.ring_slots, pin=self._graphs)
        self._pending: "collections.deque[_Request]" = collections.deque()
        self._results: Dict[int, _Request] = {}
        self._tickets = itertools.count()
        self.registry = obs_metrics.MetricsRegistry()
        self._counters: Dict[str, obs_metrics.Counter] = {
            key: self.registry.counter(
                f"engine_{key}_total", f"Engine per-model {key} events.",
                ("model",))
            for key in STAT_KEYS}
        self._requests_total = self.registry.counter(
            "engine_requests_total", "Requests completed by the engine.",
            ("model", "mode"))
        self._latency_hist = self.registry.histogram(
            "engine_request_latency_seconds",
            "Per-request submit→complete latency.", ("model", "mode"))
        self._batch_rows_hist = self.registry.histogram(
            "engine_batch_rows", "Real rows per coalesced device batch.",
            ("model",), buckets=obs_metrics.log_buckets(1.0, 2 ** 20, 2))
        self.total_compiles = 0
        self.replayed_launches: Dict[str, int] = collections.Counter()
        if self.config.trace:
            obs_trace.enable(self.config.trace)

    def _bump(self, name: str, key: str, amount: int = 1) -> None:
        self._counters[key].inc(amount, model=name)

    # -- model registry / LRU ---------------------------------------------
    def load_model(self, name: str, source) -> _model.SCRBModel:
        """Register (or hot-swap) a model under ``name``.

        ``source`` is an npz artifact path (loaded onto the host) or a
        fitted ``SCRBModel``. Re-using a name drops the old model's
        residency and hands its slot back: the slot and its cells stay if
        another registered model has its signature, else they are freed."""
        mdl = source if isinstance(source, _model.SCRBModel) \
            else _model.SCRBModel.load(source, device="cpu")
        if name in self._models:            # hot-swap
            res = self._resident.pop(name, None)
            if res is not None and res.slot is not None:
                self._hand_back(res.slot)
        proj = mdl._projection
        tree = (mdl.feature_map, mdl.degree_dual, proj, mdl.centroids)
        if self._graphs:    # pinned host copies: a re-fault is one async H2D
            tree = tree_map(lambda t: t.pin_memory() if isinstance(
                t, torch.Tensor) and t.device.type == "cpu" else t, tree)
        leaves = _tensors(tree)
        sig = (json.dumps(mdl.feature_map.meta_dict(), sort_keys=True),
               bool(mdl.laplacian_normalize),
               self.config.impl or mdl.config.impl,
               tuple((tuple(t.shape), t.dtype) for t in leaves))
        self._states[name] = (sig, tree, sum(t.nbytes for t in leaves))
        self._models[name] = mdl
        for key in STAT_KEYS:       # zeroed series: the model shows in
            self._counters[key].inc(0, model=name)   # /metrics at once
        self._free_slots()
        return mdl

    def _take_slot(self, name: str) -> _Slot:
        """A free slot of the model's signature (a new one if none is free),
        with the model's state copied in."""
        sig, tree, _ = self._states[name]
        slot = next((s for s in self._slots
                     if s.sig == sig and s.owner is None), None)
        if slot is None:
            state = tree_map(lambda t: torch.empty(
                t.shape, dtype=t.dtype, device=self.device)
                if isinstance(t, torch.Tensor) else t, tree)
            slot = _Slot(id=next(self._slot_ids), sig=sig, state=state,
                         nbytes=sum(t.nbytes for t in _tensors(state)))
            self._slots.append(slot)
        for dst, src in zip(_tensors(slot.state), _tensors(tree)):
            dst.copy_(src, non_blocking=True)
        slot.owner = name
        return slot

    def _ensure_resident(self, name: str) -> _Resident:
        res = self._resident.get(name)
        if res is not None:
            self._bump(name, "resident_hits")
            self._resident.move_to_end(name)
            return res
        self._bump(name, "resident_misses")
        res = _Resident(slot=None, nbytes=self._states[name][2])
        self._resident[name] = res
        self._evict()
        res.slot = self._take_slot(name)
        self._free_slots()
        return res

    def _evict(self) -> None:
        """Evict least-recently-used models until under the limits; the
        newest entry always stays. An evicted model's slot becomes free."""
        cfg = self.config

        def over() -> bool:
            if len(self._resident) > cfg.max_resident_models:
                return True
            if cfg.device_budget_bytes is None:
                return False
            return sum(r.nbytes for r in self._resident.values()) \
                > cfg.device_budget_bytes

        while len(self._resident) > 1 and over():
            victim, res = self._resident.popitem(last=False)
            if res.slot is not None:
                self._hand_back(res.slot)
            self._bump(victim, "evictions")

    def _hand_back(self, slot: _Slot) -> None:
        """Free ``slot`` for another model of its signature; it moves to
        the end of ``_slots``, so free slots stand in order of release."""
        slot.owner = None
        self._slots.remove(slot)
        self._slots.append(slot)

    def _free_slots(self) -> None:
        """Free every slot whose signature no registered model has, then
        free slots, oldest release first, while all slots' state exceeds
        ``device_budget_bytes``; each goes with its static inputs and its
        cells (graphs)."""
        live = {state[0] for state in self._states.values()}
        dead = [s for s in self._slots if s.owner is None and s.sig not in live]
        budget = self.config.device_budget_bytes
        if budget is not None:
            total = sum(s.nbytes for s in self._slots if s not in dead)
            for s in self._slots:
                if total <= budget:
                    break
                if s.owner is None and s not in dead:
                    dead.append(s)
                    total -= s.nbytes
        for slot in dead:
            self._slots.remove(slot)
            for key in [k for k in self._cells if k[0] == slot.id]:
                del self._cells[key]
            self.slots_freed += 1

    # -- cells -------------------------------------------------------------
    def _cell(self, name: str, bucket: int, mode: str, res: _Resident,
              dim: int) -> _Cell:
        slot = res.slot
        key = (slot.id, bucket, mode)
        cell = self._cells.get(key)
        if cell is not None:
            self._bump(name, "cache_hits")
            return cell
        mdl = self._models[name]
        fm, dual, proj, cents = slot.state
        lap = bool(mdl.laplacian_normalize)
        impl = self.config.impl or mdl.config.impl
        if mode == "predict":
            def fn(xb):
                return _model._oos_predict_impl(fm, dual, proj, cents, xb,
                                                laplacian=lap, impl=impl)
        else:
            def fn(xb):
                return _model._oos_embed_impl(fm, dual, proj, xb,
                                              laplacian=lap)
        x = slot.inputs.get(bucket)
        if x is None:
            x = slot.inputs[bucket] = torch.zeros(
                (bucket, dim), dtype=torch.float32, device=self.device)
        cell = _Cell(fn=fn, x=x)
        if self._graphs:
            self._capture(cell)
        self._cells[key] = cell
        self._bump(name, "compiles")
        self.total_compiles += 1
        return cell

    def _capture(self, cell: _Cell) -> None:
        """Run the cell once eagerly on a side stream (the kernels' build,
        the k-means grid's first-use query and every allocation happen
        there), then capture it into a CUDA graph on the engine's pool."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        with full_float32():
            side.wait_stream(main)
            with torch.cuda.stream(side):
                cell.fn(cell.x)
            main.wait_stream(side)
            before = ops.launch_counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool):
                cell.out = cell.fn(cell.x)
        after = ops.launch_counts()
        cell.graph = graph
        cell.launches = {k: after[k] - before[k] for k in after
                         if after[k] > before[k]}

    def _run(self, cell: _Cell, buf: torch.Tensor,
             out: torch.Tensor) -> None:
        """The cell on the staged batch ``buf``, its output into the host
        buffer ``out``."""
        if cell.graph is None:
            with full_float32():
                out.copy_(cell.fn(buf))
            return
        cell.x.copy_(buf, non_blocking=True)
        cell.graph.replay()
        out.copy_(cell.out)                 # waits for the replay
        for k, v in cell.launches.items():
            self.replayed_launches[k] += v

    def warmup(self, name: str, *, dim: Optional[int] = None,
               modes: Tuple[str, ...] = ("predict",)) -> int:
        """Build (capture) every bucket cell of ``name`` and fill the
        staging rings, so a first request pays execution only. Returns the
        number of cells built now."""
        mdl = self._models[name]
        dim = dim or mdl.data_dim
        res = self._ensure_resident(name)
        before = self.total_compiles
        k = mdl.right_vectors.shape[1]
        for mode in modes:
            if mode == "predict" and mdl.centroids is None:
                continue
            for bucket in self.config.buckets:
                self._cell(name, bucket, mode, res, dim)
                self._ring.get((bucket, dim))
                self._ring.get(*self._out_spec(mode, bucket, k))
        return self.total_compiles - before

    @staticmethod
    def _out_spec(mode: str, rows: int, k: int):
        if mode == "predict":
            return (rows,), torch.int32
        return (rows, k), torch.float32

    # -- request loop ------------------------------------------------------
    def submit(self, name: str, x, mode: str = "predict") -> int:
        """Enqueue rows for ``name``; returns a ticket for ``take``."""
        if name not in self._models:
            raise KeyError(f"unknown model {name!r}; load_model() first")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        mdl = self._models[name]
        if mode == "predict" and mdl.centroids is None:
            raise ValueError(f"model {name!r} has no centroids; "
                             "use mode='transform'")
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        if x.ndim != 2:
            raise ValueError(f"expected (n, d) rows, got shape {x.shape}")
        if x.shape[1] != mdl.data_dim:
            raise ValueError(f"model {name!r} expects {mdl.data_dim}-d rows, "
                             f"got {x.shape[1]}-d")
        k = mdl.right_vectors.shape[1]
        out = np.empty((x.shape[0],), np.int32) if mode == "predict" \
            else np.empty((x.shape[0], k), np.float32)
        req = _Request(ticket=next(self._tickets), model=name, mode=mode,
                       x=x, out=out, submitted_at=time.perf_counter())
        if x.shape[0] == 0:                 # nothing to do on the device
            req.completed_at = req.submitted_at
            self._results[req.ticket] = req
            self._requests_total.inc(model=name, mode=mode)
        else:
            self._pending.append(req)
        return req.ticket

    def step(self) -> int:
        """Serve one coalesced batch for the oldest pending (model, mode)
        group; returns rows served (0 when idle)."""
        if not self._pending:
            return 0
        head = self._pending[0]
        name, mode = head.model, head.mode
        cap = self.config.max_batch_rows or self.config.buckets[-1]
        take: List[Tuple[_Request, int]] = []
        total = 0
        for req in self._pending:
            if req.model != name or req.mode != mode:
                continue
            if total >= cap:
                break
            n = min(req.x.shape[0] - req.cursor, cap - total)
            take.append((req, n))
            total += n
        bucket = _model.round_to_bucket(total, self.config.buckets)
        dim = head.x.shape[1]
        k = self._models[name].right_vectors.shape[1]
        with obs_trace.span("engine.step", sync=False, model=name,
                            mode=mode, bucket=bucket, rows=total):
            res = self._ensure_resident(name)
            cell = self._cell(name, bucket, mode, res, dim)
            buf = self._ring.get((bucket, dim))
            rows = buf.numpy()
            off = 0
            for req, n in take:
                rows[off:off + n] = req.x[req.cursor:req.cursor + n]
                off += n
            rows[off:] = 0.0                # pad rows: zeros, sliced off
            out_buf = self._ring.get(*self._out_spec(mode, bucket, k))
            self._run(cell, buf, out_buf)   # returns once the output is in
            out = out_buf.numpy()
            done_at = time.perf_counter()
        off = 0
        for req, n in take:
            req.out[req.cursor:req.cursor + n] = out[off:off + n]
            req.cursor += n
            off += n
            if req.cursor == req.x.shape[0]:
                req.completed_at = done_at
                self._results[req.ticket] = req
                self._pending.remove(req)
                self._requests_total.inc(model=name, mode=mode)
                self._latency_hist.observe(done_at - req.submitted_at,
                                           model=name, mode=mode)
        self._bump(name, "rows_served", total)
        self._bump(name, "batches")
        self._bump(name, "padded_rows", bucket - total)
        self._batch_rows_hist.observe(total, model=name)
        return total

    def drain(self) -> int:
        """Run ``step`` until the queue is empty; returns rows served."""
        total = 0
        while self._pending:
            total += self.step()
        return total

    def take(self, ticket: int) -> Result:
        """Collect a finished ticket (once); KeyError if unknown/unfinished."""
        req = self._results.pop(ticket, None)
        if req is None:
            raise KeyError(f"ticket {ticket} is not finished (or was already "
                           "taken); call step()/drain() first")
        return Result(ticket=req.ticket, model=req.model, mode=req.mode,
                      values=req.out, submitted_at=req.submitted_at,
                      completed_at=req.completed_at)

    # -- sync convenience --------------------------------------------------
    def predict(self, name: str, x) -> np.ndarray:
        t = self.submit(name, x, "predict")
        self.drain()
        return self.take(t).values

    def transform(self, name: str, x) -> np.ndarray:
        t = self.submit(name, x, "transform")
        self.drain()
        return self.take(t).values

    # -- introspection -----------------------------------------------------
    @property
    def models(self) -> Tuple[str, ...]:
        return tuple(self._models)

    @property
    def resident_models(self) -> Tuple[str, ...]:
        return tuple(self._resident)

    def _model_stat_dict(self, name: str) -> Dict[str, int]:
        if name not in self._models:
            raise KeyError(name)
        return {key: int(self._counters[key].get(model=name))
                for key in STAT_KEYS}

    def latency_quantiles(self, name: str, mode: str = "predict",
                          *, qs: Tuple[float, ...] = (0.5, 0.99)
                          ) -> Dict[float, Optional[float]]:
        """Per-request latency quantiles (seconds) of one (model, mode),
        from the engine's histogram; ``None`` until it has traffic."""
        return {q: self._latency_hist.quantile(q, model=name, mode=mode)
                for q in qs}

    def stats(self, name: Optional[str] = None) -> Dict[str, Any]:
        if name is not None:
            return self._model_stat_dict(name)
        per = {}
        for m in self._models:
            d = self._model_stat_dict(m)
            for mode in MODES:
                p50 = self._latency_hist.quantile(0.5, model=m, mode=mode)
                p99 = self._latency_hist.quantile(0.99, model=m, mode=mode)
                if p50 is not None:
                    d[f"latency_{mode}_p50_ms"] = p50 * 1e3
                    d[f"latency_{mode}_p99_ms"] = p99 * 1e3
            per[m] = d
        return {
            "models": per,
            "total_compiles": self.total_compiles,
            "cells": len(self._cells),
            "slots": len(self._slots),
            "slots_freed": self.slots_freed,
            "resident": list(self._resident),
            "resident_bytes": sum(r.nbytes for r in self._resident.values()),
            "staging_allocations": self._ring.allocations,
            "pending": len(self._pending),
            "rows_served": sum(s["rows_served"] for s in per.values()),
            "batches": sum(s["batches"] for s in per.values()),
            "padded_rows": sum(s["padded_rows"] for s in per.values()),
            "evictions": sum(s["evictions"] for s in per.values()),
            "replayed_launches": dict(self.replayed_launches),
        }

    def metrics_text(self) -> str:
        """Prometheus text exposition: this engine's registry plus the
        process-global one, the body of ``GET /metrics``."""
        self.registry.gauge(
            "engine_resident_models",
            "Models with device-resident state.").set(len(self._resident))
        self.registry.gauge(
            "engine_resident_bytes",
            "Bytes of device-resident model state.").set(
            sum(r.nbytes for r in self._resident.values()))
        self.registry.gauge(
            "engine_pending_requests", "Queued unfinished requests.").set(
            len(self._pending))
        return obs_metrics.render_prometheus(
            [self.registry, obs_metrics.REGISTRY])
