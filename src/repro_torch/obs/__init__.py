"""Observability: structured tracing, metrics, memory watermarks.

The JAX package's ``obs`` for PyTorch, with the same names:

``repro_torch.obs.trace``
    Thread-safe hierarchical span tracer (a span's close waits for the CUDA
    device when ``sync`` is on, so spans measure device work, not the
    launches), span attributes, per-thread tracks, and Chrome-trace-event
    JSON export viewable in Perfetto / ``chrome://tracing``. Off by
    default; enabled for one fit by ``SCRBConfig(trace=...)`` or process
    wide by the ``REPRO_TRACE=<path>`` environment variable.

``repro_torch.obs.metrics``
    Process-wide registry (``REGISTRY``) of labeled counters, gauges and
    log-bucketed histograms, with ``snapshot``/``reset`` and a Prometheus
    text-exposition encoder. Always on: recording a metric is a dict update
    under a lock.

``repro_torch.obs.memory``
    Device-memory (``torch.cuda`` allocator) and host-RSS watermark
    sampling.

Kill switch: ``REPRO_OBS_DISABLED=1`` disables tracing and metrics at
import time.
"""
from repro_torch.obs import memory, metrics, trace

__all__ = ["memory", "metrics", "trace"]
