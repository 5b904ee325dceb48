"""The port's observability (``repro_torch.obs``) against the JAX package's.

Mirrors ``tests/test_obs.py``: span nesting, cross-thread tracks and the
Chrome-trace JSON, histogram quantiles, Prometheus text, registry
snapshot/reset, memory watermarks, ``StageTimer`` over spans, the prefetch
counters and ``h2d`` spans, and a traced fit. The reference's partitioned
case is ported in ``tests/test_torch_partitioned.py`` and its serving-engine
cases in ``tests/test_torch_serve.py``; here the two packages
are held against each other: the same Prometheus text for the same
operations, the same span names and ``timer.times`` keys from the same
traced fit (device rows and host chunks), the same metric names, and no
device synchronize while tracing is off.

Tests that enable a process-global ``TRACER`` restore it in ``finally``
blocks; tests against a process-global ``REGISTRY`` assert deltas.
"""
import contextlib
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

from repro.core import executor as jexec
from repro.data.synthetic import make_blobs
from repro.obs import metrics as jmetrics
from repro_torch.core import executor as texec
from repro_torch.core import streaming as tstreaming
from repro_torch.obs import memory as obs_memory
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.utils import StageTimer, prefetch_to_device

FAST = dict(n_clusters=4, n_grids=16, sigma=1.5, d_g=128, solver_tol=1e-2,
            kmeans_replicates=1, seed=0)


def _cfg(mod, **kw):
    with pytest.warns(DeprecationWarning):
        return mod.SCRBConfig(**FAST, **kw)


@contextlib.contextmanager
def _tracer(path=None, **kw):
    """Enable the port's global tracer for one test, always restoring it."""
    assert obs_trace.TRACER.enable(path, **kw)
    try:
        yield obs_trace.TRACER
    finally:
        obs_trace.TRACER.disable()
        obs_trace.TRACER.reset()


# -- trace -----------------------------------------------------------------

def test_span_disabled_is_null():
    assert not obs_trace.TRACER.enabled
    with obs_trace.span("nope", k=1) as sp:
        assert sp is obs_trace.NULL_SPAN
        sp.set(anything="goes")
    assert obs_trace.TRACER.finished() == []


def test_span_nesting_and_chrome_export(tmp_path):
    with _tracer(sync=False) as tr:
        with obs_trace.span("outer", stage="a"):
            with obs_trace.span("inner") as sp:
                sp.set(rows=7)
                time.sleep(0.002)
        outer, = tr.finished("outer")
        inner, = tr.finished("inner")
        assert outer.depth == 0 and inner.depth == 1
        assert inner.t0_ns >= outer.t0_ns
        assert inner.t0_ns + inner.dur_ns <= outer.t0_ns + outer.dur_ns
        assert inner.attrs["rows"] == 7
        path = str(tmp_path / "t.json")
        doc = tr.export_chrome(path)
    with open(path) as f:
        assert json.load(f) == doc
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"outer", "inner"}
    for e in xs:
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        assert e["ts"] >= 0 and e["dur"] >= 0
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert any(e["name"] == "thread_name" for e in metas)


def test_spans_closed_on_other_threads_get_own_tracks():
    def work(i):
        with obs_trace.span("job", i=i):
            time.sleep(0.005)

    with _tracer(sync=False) as tr:
        threads = [threading.Thread(target=work, args=(i,), name=f"wk{i}")
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        jobs = tr.finished("job")
        assert len(jobs) == 2
        assert len({s.tid for s in jobs}) == 2
        assert {s.thread_name for s in jobs} == {"wk0", "wk1"}
        assert all(s.depth == 0 for s in jobs)
        doc = tr.export_chrome()
    names = [e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"]
    assert {"wk0", "wk1"} <= set(names)


def test_threads_that_do_not_overlap_get_own_tracks():
    """A thread started after another has ended may get its ident; its
    spans still go on a track of its own."""
    def work(i):
        with obs_trace.span("job", i=i):
            pass

    with _tracer(sync=False) as tr:
        for i in range(2):
            t = threading.Thread(target=work, args=(i,), name=f"wk{i}")
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        jobs = tr.finished("job")
        assert len({s.tid for s in jobs}) == 2
        doc = tr.export_chrome()
    names = [e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"]
    assert {"wk0", "wk1"} <= set(names)


def test_tracing_contextmanager_scopes_and_is_reentrant(tmp_path):
    path = str(tmp_path / "scoped.json")
    with obs_trace.tracing(path):
        assert obs_trace.TRACER.enabled
        with obs_trace.tracing(str(tmp_path / "ignored.json")):
            with obs_trace.span("s"):
                pass
        assert obs_trace.TRACER.enabled
    assert not obs_trace.TRACER.enabled
    with open(path) as f:
        doc = json.load(f)
    assert [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"] == ["s"]
    assert not (tmp_path / "ignored.json").exists()
    with obs_trace.tracing(None):
        assert not obs_trace.TRACER.enabled


def test_tracing_off_never_synchronizes(monkeypatch):
    """A disabled span, and a span with sync=False, never wait for the
    device; an enabled stage span does, once."""
    calls = []
    monkeypatch.setattr(obs_trace, "_device_sync", lambda: calls.append(1))
    x, _ = make_blobs(200, 4, 3, seed=0)
    texec.execute(x, _cfg(texec), device="cpu")
    with obs_trace.span("off"):
        pass
    assert calls == []
    with _tracer(sync=True):
        with obs_trace.span("issue", sync=False):
            pass
        assert calls == []
        with obs_trace.span("stage"):
            pass
    assert calls == [1]


# -- metrics ---------------------------------------------------------------

def test_counter_and_gauge_basics():
    reg = obs_metrics.MetricsRegistry()
    c = reg.counter("c_total", "help", ("model",))
    c.inc(model="a")
    c.inc(2.5, model="a")
    c.inc(model="b")
    assert c.get(model="a") == 3.5 and c.get(model="b") == 1.0
    assert c.get(model="never") == 0.0
    with pytest.raises(ValueError, match="only go up"):
        c.inc(-1, model="a")
    with pytest.raises(ValueError, match="label"):
        c.inc(wrong="a")
    g = reg.gauge("g", "help")
    g.set(4.0)
    g.inc(-1.5)
    assert g.get() == 2.5
    assert reg.counter("c_total", "help", ("model",)) is c
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("c_total", "help", ("model",))


def test_histogram_quantiles_close_to_exact():
    reg = obs_metrics.MetricsRegistry()
    h = reg.histogram("lat_seconds", "help",
                      buckets=obs_metrics.log_buckets(1e-4, 10.0))
    rng = np.random.default_rng(0)
    xs = np.exp(rng.normal(-3.0, 1.0, size=5000))
    for v in xs:
        h.observe(float(v))
    assert h.count() == 5000
    assert h.sum() == pytest.approx(float(xs.sum()), rel=1e-6)
    factor = 10 ** 0.25
    for q in (0.5, 0.9, 0.99):
        exact = float(np.quantile(xs, q))
        assert exact / factor <= h.quantile(q) <= exact * factor
    assert reg.histogram("empty_seconds", "h").quantile(0.5) is None


def _exercise(mod):
    reg = mod.MetricsRegistry()
    reg.counter("req_total", "requests", ("model", "mode")).inc(
        3, model='a"b\\c', mode="p")
    reg.gauge("temp", "gauge").set(1.5)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    return reg


def test_prometheus_exposition_format():
    reg = _exercise(obs_metrics)
    text = reg.to_prometheus()
    assert "# TYPE req_total counter" in text
    assert r'req_total{model="a\"b\\c",mode="p"} 3' in text
    assert "# TYPE lat_seconds histogram" in text
    assert 'lat_seconds_bucket{le="0.1"} 1' in text
    assert 'lat_seconds_bucket{le="1"} 2' in text
    assert 'lat_seconds_bucket{le="+Inf"} 3' in text
    assert "lat_seconds_count 3" in text
    assert "lat_seconds_sum 5.55" in text
    assert "temp 1.5" in text
    with pytest.raises(ValueError, match="metric name"):
        reg.counter("bad-name", "h")
    # the reference's text for the same operations, byte for byte
    assert text == _exercise(jmetrics).to_prometheus()


def test_registry_snapshot_and_reset_isolation():
    reg = obs_metrics.MetricsRegistry()
    c = reg.counter("n_total", "h", ("k",))
    c.inc(4, k="x")
    snap = reg.snapshot()
    c.inc(k="x")
    assert snap["n_total"][("x",)] == 4.0
    assert reg.snapshot()["n_total"][("x",)] == 5.0
    reg.reset()
    assert c.get(k="x") == 0.0
    assert reg.counter("n_total", "h", ("k",)) is c
    assert obs_metrics.REGISTRY.get("n_total") is None


def test_render_prometheus_dedups_registries():
    reg = obs_metrics.MetricsRegistry()
    reg.counter("one_total", "h").inc()
    text = obs_metrics.render_prometheus([reg, reg, obs_metrics.REGISTRY])
    assert text.count("# TYPE one_total counter") == 1


# -- memory ----------------------------------------------------------------

def test_memory_sample_and_watermark():
    s = obs_memory.sample()
    assert s["rss_bytes"] > 0
    assert s["peak_rss_bytes"] >= s["rss_bytes"] // 2
    with obs_memory.Watermark() as wm:
        ballast = np.ones(2_000_000, np.float64)
        assert ballast.sum() > 0
    d = wm.as_dict()
    assert set(d) >= {"rss_delta_bytes", "peak_rss_delta_bytes"}
    assert wm.peak_rss_delta_bytes >= 0
    if not torch.cuda.is_initialized():
        # a CPU run reports no device numbers, as the reference does
        # without a device allocator
        assert obs_memory.device_bytes_in_use() is None
        assert obs_memory.device_peak_bytes() is None
        assert d["device_delta_bytes"] is None
    assert obs_memory.device_memory_stats("cpu") is None


# -- StageTimer and prefetch -----------------------------------------------

def test_stage_timer_times_semantics_unchanged():
    timer = StageTimer()
    with timer.stage("a"):
        time.sleep(0.01)
    with timer.stage("a"):
        time.sleep(0.01)
    with timer.stage("b"):
        pass
    assert set(timer.times) == {"a", "b"}
    assert timer.times["a"] >= 0.02
    h = obs_metrics.REGISTRY.get("repro_stage_seconds")
    assert h.count(stage="a") >= 2


def test_stage_timer_emits_spans_when_tracing():
    with _tracer(sync=False) as tr:
        timer = StageTimer()
        with timer.stage("mystage"):
            pass
        assert len(tr.finished("mystage")) == 1
    assert "mystage" in timer.times


def test_prefetch_measure_counters_and_h2d_spans():
    c_items = obs_metrics.REGISTRY.get("repro_prefetch_items_total")
    c_bytes = obs_metrics.REGISTRY.get("repro_prefetch_bytes_total")
    before, bytes0 = c_items.get(), c_bytes.get()
    measure = {}
    items = ((i, np.ones((4, 4), np.float32)) for i in range(3))
    with _tracer() as tr:
        out = list(prefetch_to_device(items, measure=measure))
        spans = tr.finished("h2d")
    assert len(out) == 3
    assert measure["items"] == 3 and measure["max_item_bytes"] == 64
    assert c_items.get() - before == 3 and c_bytes.get() - bytes0 == 192
    assert [s.attrs["bytes"] for s in spans] == [64, 64, 64]
    assert not any(s.sync for s in spans)


# -- fit wiring ------------------------------------------------------------

@pytest.fixture(scope="module")
def blobs():
    return make_blobs(300, 6, 4, seed=0)


def test_traced_fit_spans_memory_and_counters(blobs, tmp_path):
    x, _ = blobs
    path = str(tmp_path / "fit_trace.json")
    fits = obs_metrics.REGISTRY.get("repro_fits_total")
    solves = obs_metrics.REGISTRY.get("repro_eigensolves_total")
    f0 = sum(fits.collect().values())
    s0 = sum(solves.collect().values())

    res = texec.execute(x, _cfg(texec, trace=path), device="cpu")

    assert not obs_trace.TRACER.enabled
    with open(path) as f:
        doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"fit", "rb_features", "eigensolve", "kmeans"} <= names
    root, = (e for e in doc["traceEvents"]
             if e["ph"] == "X" and e["name"] == "fit")
    assert root["args"]["placement"] == "single"
    assert root["args"]["solver"] == "lobpcg"
    assert res.diagnostics["memory"]["rss_delta_bytes"] is not None
    assert sum(fits.collect().values()) == f0 + 1
    assert sum(solves.collect().values()) >= s0 + 1
    texec.execute(x, _cfg(texec), device="cpu")
    assert obs_trace.TRACER.finished() == []


def test_config_trace_excluded_from_artifact_dict(tmp_path):
    cfg = _cfg(texec, trace=str(tmp_path / "t.json"))
    d = cfg.to_dict()
    assert "trace" not in d
    rt = texec.SCRBConfig.from_dict(d)
    assert rt.trace is None and rt.n_grids == cfg.n_grids
    assert d == _cfg(jexec, trace=str(tmp_path / "t.json")).to_dict()


@pytest.mark.parametrize("chunk_size", [None, 120])
def test_trace_names_and_stage_keys_match_reference(blobs, tmp_path,
                                                    chunk_size):
    """The same fit traced in both packages: the same span names (the root
    ``fit``, the five stages, ``eigensolve``, and ``h2d`` on host chunks),
    the same root attributes and the same ``timer.times`` keys."""
    x, _ = blobs
    docs, times = [], []
    for mod, run in ((jexec, lambda c: jexec.execute(jnp.asarray(x), c)),
                     (texec, lambda c: texec.execute(x, c, device="cpu"))):
        path = str(tmp_path / f"{mod.__name__}.json")
        res = run(_cfg(mod, trace=path, chunk_size=chunk_size))
        with open(path) as f:
            docs.append([e for e in json.load(f)["traceEvents"]
                         if e["ph"] == "X"])
        times.append(set(res.timer.times))
    jnames, tnames = ({e["name"] for e in d} for d in docs)
    assert tnames == jnames
    assert {"fit", "rb_features", "degrees", "svd", "normalize", "kmeans",
            "eigensolve"} <= tnames
    assert ("h2d" in tnames) == (chunk_size is not None)
    jroot, troot = (next(e for e in d if e["name"] == "fit") for d in docs)
    assert {k: troot["args"][k] for k in ("placement", "residency", "solver")
            } == {k: jroot["args"][k]
                  for k in ("placement", "residency", "solver")}
    jeig, teig = (next(e for e in d if e["name"] == "eigensolve")
                  for d in docs)
    assert set(teig["args"]) == set(jeig["args"])
    assert times[0] == times[1]


def test_fit_metric_names_match_reference(blobs):
    """A fit feeds metrics of the same names and labels in both packages."""
    x, _ = blobs
    jexec.execute(jnp.asarray(x), _cfg(jexec, chunk_size=150))
    texec.execute(x, _cfg(texec, chunk_size=150), device="cpu")
    names = ("repro_fits_total", "repro_fit_rows_total",
             "repro_eigensolves_total", "repro_solver_iterations",
             "repro_solver_resnorm_max", "repro_stage_seconds",
             "repro_prefetch_items_total", "repro_prefetch_bytes_total")
    for name in names:
        mine = obs_metrics.REGISTRY.get(name)
        theirs = jmetrics.REGISTRY.get(name)
        assert mine is not None and theirs is not None, name
        assert type(mine).__name__ == type(theirs).__name__
        assert mine.labelnames == theirs.labelnames
    fits = obs_metrics.REGISTRY.get("repro_fits_total")
    assert fits.get(placement="single", solver="lobpcg") >= 1


def test_chunked_fit_trace_counts_one_h2d_span_per_upload(tmp_path):
    """On host chunks every upload of every sweep is one ``h2d`` span whose
    bytes add up to what the sweeps measured."""
    x, _ = make_blobs(300, 6, 4, seed=1)
    path = str(tmp_path / "chunked.json")
    res = texec.execute(x, _cfg(texec, trace=path, chunk_size=100),
                        keep_state=True, device="cpu")
    with open(path) as f:
        h2d = [e for e in json.load(f)["traceEvents"]
               if e["ph"] == "X" and e["name"] == "h2d"]
    store = res.state["z"].store
    assert isinstance(store, tstreaming.ChunkedELL)
    assert len(h2d) >= store.h2d_stats["items"] > 0
    assert max(e["args"]["bytes"] for e in h2d) >= \
        store.h2d_stats["max_item_bytes"]
