"""Process-wide metrics registry: labeled counters, gauges, log histograms.

The JAX package's ``obs.metrics``, line for line (it is pure Python; the
port keeps its own copy), so metric names, labels and the Prometheus text
are the same in both packages:

- ``Counter``   — monotonically increasing float per label-set.
- ``Gauge``     — last-written float per label-set.
- ``Histogram`` — log-bucketed distribution per label-set. No samples are
  stored: observations land in geometric buckets and quantiles are
  estimated from cumulative bucket counts with log-linear interpolation,
  so p50/p90/p99 cost O(buckets) memory regardless of traffic. The
  default bucket ladder has 4 buckets per decade (growth 10^0.25 ≈ 1.78),
  which bounds the quantile estimate within one bucket factor of exact.

Instruments are registered on a ``MetricsRegistry``; the module-level
``REGISTRY`` is the process default (fit pipeline, eigensolves, prefetch).
``render_prometheus`` concatenates registries in Prometheus
text-exposition format 0.0.4.

``REPRO_OBS_DISABLED=1`` turns every instrument into a no-op at import —
the no-observability baseline.
"""
from __future__ import annotations

import math
import os
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_DISABLED = os.environ.get("REPRO_OBS_DISABLED", "") not in ("", "0")

LabelValues = Tuple[str, ...]


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> Tuple[float, ...]:
    """Geometric bucket upper bounds from ``lo`` to ≥ ``hi``,
    ``per_decade`` buckets per decade."""
    if lo <= 0 or hi <= lo:
        raise ValueError("need 0 < lo < hi")
    growth = 10.0 ** (1.0 / per_decade)
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * growth)
    return tuple(out)


#: Default latency ladder: 10 µs .. ~100 s, 4 buckets/decade.
DEFAULT_LATENCY_BUCKETS = log_buckets(1e-5, 100.0)
#: Default size ladder (bytes): 1 KiB .. ~16 GiB, one bucket per octave.
DEFAULT_BYTES_BUCKETS = tuple(float(2 ** e) for e in range(10, 35))


def _check_name(name: str) -> str:
    ok = name and (name[0].isalpha() or name[0] in "_:") and all(
        c.isalnum() or c in "_:" for c in name)
    if not ok:
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _fmt_labels(names: Sequence[str], values: LabelValues,
                extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [f'{n}="{_escape_label(str(v))}"' for n, v in zip(names, values)]
    if extra is not None:
        pairs.append(f'{extra[0]}="{extra[1]}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Instrument:
    """Shared label plumbing. Each instrument holds one dict keyed by the
    label-value tuple; all mutation is under the registry lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.Lock):
        self.name = _check_name(name)
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock

    def _key(self, labels: Dict[str, str]) -> LabelValues:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(labels)}")
        return tuple(str(labels[n]) for n in self.labelnames)


class Counter(_Instrument):
    kind = "counter"

    def __init__(self, name, help, labelnames, lock):
        super().__init__(name, help, labelnames, lock)
        self._values: Dict[LabelValues, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if _DISABLED:
            return
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def collect(self) -> Dict[LabelValues, float]:
        with self._lock:
            return dict(self._values)


class Gauge(_Instrument):
    kind = "gauge"

    def __init__(self, name, help, labelnames, lock):
        super().__init__(name, help, labelnames, lock)
        self._values: Dict[LabelValues, float] = {}

    def set(self, value: float, **labels) -> None:
        if _DISABLED:
            return
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        if _DISABLED:
            return
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def collect(self) -> Dict[LabelValues, float]:
        with self._lock:
            return dict(self._values)


class _HistogramSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1 = overflow (+Inf)
        self.sum = 0.0
        self.count = 0


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        b = tuple(sorted(float(x) for x in buckets))
        if not b or any(x <= 0 for x in b):
            raise ValueError("histogram buckets must be positive")
        self.buckets = b
        self._series: Dict[LabelValues, _HistogramSeries] = {}

    def observe(self, value: float, **labels) -> None:
        if _DISABLED:
            return
        v = float(value)
        key = self._key(labels)
        # bisect over the bucket bounds: first bound >= v
        lo, hi = 0, len(self.buckets)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.buckets[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistogramSeries(len(self.buckets))
            s.counts[lo] += 1
            s.sum += v
            s.count += 1

    # -- reading -----------------------------------------------------------
    def _get_series(self, labels: Dict[str, str]) -> Optional[_HistogramSeries]:
        key = self._key(labels)
        with self._lock:
            return self._series.get(key)

    def count(self, **labels) -> int:
        s = self._get_series(labels)
        return s.count if s else 0

    def sum(self, **labels) -> float:
        s = self._get_series(labels)
        return s.sum if s else 0.0

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Estimate the ``q``-quantile (0 ≤ q ≤ 1) from bucket counts with
        log-linear interpolation inside the landing bucket. ``None`` when
        the series is empty. Accurate within one bucket growth factor."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be in [0, 1]")
        s = self._get_series(labels)
        if s is None or s.count == 0:
            return None
        with self._lock:
            counts = list(s.counts)
            total = s.count
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c > 0:
                if i >= len(self.buckets):       # overflow bucket: no upper bound
                    return self.buckets[-1]
                hi = self.buckets[i]
                lo = self.buckets[i - 1] if i > 0 else hi / (
                    self.buckets[1] / self.buckets[0] if len(self.buckets) > 1 else 2.0)
                frac = (rank - prev_cum) / c
                frac = min(max(frac, 0.0), 1.0)
                return float(lo * (hi / lo) ** frac)
        return self.buckets[-1]

    def collect(self) -> Dict[LabelValues, Dict[str, object]]:
        with self._lock:
            return {
                k: {"counts": list(s.counts), "sum": s.sum, "count": s.count}
                for k, s in self._series.items()
            }


class MetricsRegistry:
    """A namespace of instruments. Registering the same name twice returns
    the existing instrument (so module-level ``counter(...)`` calls are
    idempotent across reimports) but raises on kind/label mismatch."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}

    def _register(self, cls, name: str, help: str,
                  labelnames: Sequence[str], **kw) -> _Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls) or inst.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{inst.kind}{inst.labelnames}")
                return inst
            inst = cls(name, help, labelnames, self._lock, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  ) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)

    # -- test / ops surface ------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[LabelValues, object]]:
        """Plain-dict copy of every series — stable for test assertions."""
        out: Dict[str, Dict[LabelValues, object]] = {}
        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            out[inst.name] = inst.collect()
        return out

    def reset(self) -> None:
        """Zero every series (instruments stay registered)."""
        with self._lock:
            for inst in self._instruments.values():
                if isinstance(inst, Histogram):
                    inst._series = {}
                else:
                    inst._values = {}  # type: ignore[attr-defined]

    def to_prometheus(self) -> str:
        """Prometheus text-exposition format 0.0.4."""
        lines: List[str] = []
        with self._lock:
            instruments = sorted(self._instruments.values(),
                                 key=lambda i: i.name)
        for inst in instruments:
            lines.append(f"# HELP {inst.name} {inst.help}")
            lines.append(f"# TYPE {inst.name} {inst.kind}")
            if isinstance(inst, Histogram):
                for key, data in sorted(inst.collect().items()):
                    cum = 0
                    counts = data["counts"]
                    for i, bound in enumerate(inst.buckets):
                        cum += counts[i]
                        lbl = _fmt_labels(inst.labelnames, key,
                                          ("le", _fmt_value(bound)))
                        lines.append(f"{inst.name}_bucket{lbl} {cum}")
                    cum += counts[len(inst.buckets)]
                    lbl = _fmt_labels(inst.labelnames, key, ("le", "+Inf"))
                    lines.append(f"{inst.name}_bucket{lbl} {cum}")
                    lbl = _fmt_labels(inst.labelnames, key)
                    lines.append(f"{inst.name}_sum{lbl} {_fmt_value(data['sum'])}")
                    lines.append(f"{inst.name}_count{lbl} {data['count']}")
            else:
                for key, value in sorted(inst.collect().items()):
                    lbl = _fmt_labels(inst.labelnames, key)
                    lines.append(f"{inst.name}{lbl} {_fmt_value(value)}")
        return "\n".join(lines) + "\n"


#: The process-default registry (fit pipeline, prefetch, solver metrics).
REGISTRY = MetricsRegistry()


def render_prometheus(registries: Iterable[MetricsRegistry]) -> str:
    """Concatenate several registries' expositions (deduplicating repeated
    registry objects) — used by ``GET /metrics`` to serve the engine's
    private registry alongside the process ``REGISTRY``."""
    seen: List[MetricsRegistry] = []
    for r in registries:
        if all(r is not s for s in seen):
            seen.append(r)
    return "".join(r.to_prometheus() for r in seen)
