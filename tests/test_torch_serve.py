"""The port's predict serving engine and HTTP front end, on the CPU.

The JAX package's engine and server tests (tests/test_serve.py), name for
name, on the port's models: bucket-padding bit-identity with
``model.predict``/``transform``, cell accounting, LRU cell survival,
hot-swap, coalescing and splitting, edge requests, the byte-budget
eviction and the HTTP round trip. On the CPU a cell is the plain function
with the same counters; the card's CUDA graphs are held in
tests/test_torch_cuda.py.

The promise kept for eviction differs in kind from the JAX package's: a
graph reads its state at fixed addresses, so state lives in slots keyed by
its signature and cells by slot; an evicted model hands its slot back and a
re-fault copies its state into a free slot of its signature (one H2D copy,
no capture), so cells survive eviction. A slot no registered model's
signature matches (after a hot-swap), or a free one while the slots' state
is over the byte budget, is freed with its cells. Beyond the reference's
tests: slots bounded over repeated hot-swaps to refitted models, dense-map models through the engine
(bit-identical to their ``predict``/``transform``), models of one
signature sharing one slot's cells, and an artifact fitted and saved by
the JAX package served by the port's engine with the labels of the JAX
package's engine.
"""
import dataclasses
import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

from repro.core import SCRBConfig as JConfig, SCRBModel as JModel
from repro.core import executor as jexec
from repro.core import featuremap as jfm
from repro.serve.cluster_engine import (
    ClusterEngine as JEngine, EngineConfig as JEngineConfig,
)
from repro_torch.core import SCRBConfig, SCRBModel, SolverOptions
from repro_torch.core import executor as texec
from repro_torch.core import featuremap as tfm
from repro_torch.data.synthetic import make_blobs, make_rings
from repro_torch.serve.cluster_engine import ClusterEngine, EngineConfig
from repro_torch.serve.server import ClusterServer

BUCKETS = (32, 64, 128)


def _cfg(**kw):
    return SCRBConfig(solver_options=SolverOptions(tol=1e-2), **kw)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: torch's intra-op threads only contend, most of all with
    the other test processes of a parallel run."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def fitted():
    """Two small fitted models with different dims and K."""
    xb, _ = make_blobs(300, 6, 4, seed=0)
    xr, _ = make_rings(300, 2, seed=1)
    mb = SCRBModel.fit(xb, _cfg(n_clusters=4, n_grids=16, sigma=1.5,
                                d_g=128, kmeans_replicates=1, seed=0),
                       device="cpu")
    mr = SCRBModel.fit(xr, _cfg(n_clusters=2, n_grids=16, sigma=0.15,
                                d_g=128, kmeans_replicates=1, seed=1),
                       device="cpu")
    return {"blobs": (mb, xb), "rings": (mr, xr)}


def _engine(fitted, **kw):
    eng = ClusterEngine(EngineConfig(buckets=BUCKETS, **kw), device="cpu")
    for name, (mdl, _) in fitted.items():
        eng.load_model(name, mdl)
    return eng


def test_engine_bucket_padding_parity(fitted):
    """Engine outputs are bit-identical to direct model.predict/transform
    for ragged sizes that land in every bucket (pad rows never leak)."""
    eng = _engine(fitted)
    for name, (mdl, x) in fitted.items():
        for n in (1, 17, 32, 33, 64, 100, 128):
            np.testing.assert_array_equal(eng.predict(name, x[:n]),
                                          mdl.predict(x[:n]))
        np.testing.assert_array_equal(eng.transform(name, x[:50]),
                                      mdl.transform(x[:50]))


def test_engine_jit_cache_accounting(fitted):
    """Second request in the same bucket builds nothing; a new bucket
    builds exactly one cell; warmup precovers the whole grid."""
    eng = _engine(fitted)
    _, x = fitted["blobs"]
    eng.predict("blobs", x[:40])                  # bucket 64
    assert eng.total_compiles == 1
    eng.predict("blobs", x[:60])                  # same bucket → cache hit
    assert eng.total_compiles == 1
    assert eng.stats("blobs")["cache_hits"] == 1
    eng.predict("blobs", x[:100])                 # bucket 128 → one build
    assert eng.total_compiles == 2
    n_new = eng.warmup("blobs", modes=("predict", "transform"))
    assert n_new == 2 * len(BUCKETS) - 2          # grid minus the two above
    before = eng.total_compiles
    eng.predict("blobs", x[:10])
    eng.transform("blobs", x[:90])
    assert eng.total_compiles == before           # fully warm


def test_engine_lru_eviction_and_cell_survival(fitted):
    """One resident slot, two models interleaved: every switch evicts, the
    results stay bit-identical, and cells survive eviction: a re-fault
    copies the state into the model's free slot, no new cell."""
    eng = _engine(fitted, max_resident_models=1)
    for name in fitted:
        eng.warmup(name, modes=("predict", "transform"))
    compiles = eng.total_compiles
    for rep in range(3):
        for name, (mdl, x) in fitted.items():
            sl = slice(10 * rep, 10 * rep + 45)
            np.testing.assert_array_equal(eng.predict(name, x[sl]),
                                          mdl.predict(x[sl]))
    s = eng.stats()
    assert s["evictions"] >= 5                    # every switch evicts
    assert len(s["resident"]) == 1
    assert eng.total_compiles == compiles         # cells survived
    assert s["slots"] == 2                        # one per signature


def test_engine_hot_swap(fitted):
    """Re-loading a name swaps the artifact: the old state is dropped and
    traffic at once reflects the new model."""
    mb, xb = fitted["blobs"]
    mr, xr = fitted["rings"]
    eng = ClusterEngine(EngineConfig(buckets=BUCKETS), device="cpu")
    eng.load_model("m", mb)
    np.testing.assert_array_equal(eng.predict("m", xb[:20]),
                                  mb.predict(xb[:20]))
    eng.load_model("m", mr)                       # hot-swap, different dim
    with pytest.raises(ValueError, match="expects 2-d rows"):
        eng.predict("m", xb[:20])
    np.testing.assert_array_equal(eng.predict("m", xr[:20]),
                                  mr.predict(xr[:20]))
    s = eng.stats()
    assert s["slots"] == 1 and s["slots_freed"] == 1
    assert s["cells"] == 1                        # the old slot's cell went


def test_engine_refit_swaps_keep_slots_bounded(fitted):
    """A periodic refit with a data-derived sigma changes the signature at
    every swap: each swap frees the old slot and its cells, so the slots
    (and the captured cells) stay bounded, and traffic is served by the
    newest model."""
    mdl, x = fitted["blobs"]
    refits = [SCRBModel.fit(x, dataclasses.replace(mdl.config, sigma=sig),
                            device="cpu") for sig in (1.4, 1.6)]
    eng = ClusterEngine(EngineConfig(buckets=BUCKETS), device="cpu")
    eng.load_model("other", fitted["rings"][0])
    eng.warmup("other")
    for i in range(6):
        m = refits[i % 2]
        eng.load_model("m", m)
        np.testing.assert_array_equal(eng.predict("m", x[:40]),
                                      m.predict(x[:40]))
        s = eng.stats()
        assert s["slots"] == 2                    # "other"'s and "m"'s
        assert s["slots_freed"] == i
        assert s["cells"] == len(BUCKETS) + 1


def test_engine_coalesces_and_splits(fitted):
    """Many small requests coalesce into one batch; a request bigger than
    the coalescing cap is split across steps and put back together."""
    mdl, x = fitted["blobs"]
    eng = _engine(fitted)
    tickets = [eng.submit("blobs", x[i * 10:(i + 1) * 10]) for i in range(5)]
    assert eng.step() == 50                       # one batch, five requests
    assert eng.stats("blobs")["batches"] == 1
    for i, t in enumerate(tickets):
        np.testing.assert_array_equal(
            eng.take(t).values, mdl.predict(x[i * 10:(i + 1) * 10]))
    big = np.vstack([x, x])[:290]                 # > top bucket (128) → split
    t = eng.submit("blobs", big)
    served = eng.drain()
    assert served == 290
    assert eng.stats("blobs")["batches"] >= 1 + 3
    np.testing.assert_array_equal(eng.take(t).values, mdl.predict(big))


def test_engine_edge_requests(fitted):
    eng = _engine(fitted)
    # an empty request completes without device work
    t = eng.submit("blobs", np.empty((0, 6), np.float32))
    res = eng.take(t)
    assert res.values.shape == (0,) and res.latency == 0.0
    assert eng.total_compiles == 0
    with pytest.raises(KeyError, match="unknown model"):
        eng.submit("nope", np.zeros((1, 6), np.float32))
    with pytest.raises(ValueError, match="mode"):
        eng.submit("blobs", np.zeros((1, 6), np.float32), "embed")
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        eng.submit("blobs", np.zeros((6,), np.float32).reshape(1, 2, 3))
    with pytest.raises(ValueError, match="expects 6-d"):
        eng.submit("blobs", np.zeros((3, 5), np.float32))
    with pytest.raises(KeyError, match="not finished"):
        eng.take(12345)
    # a transform-only model rejects predict submissions
    _, x = fitted["blobs"]
    emb_only = SCRBModel.fit(x, _cfg(n_clusters=4, n_grids=16, sigma=1.5,
                                     d_g=128, seed=0),
                             final_stage="normalize", device="cpu")
    eng.load_model("emb", emb_only)
    with pytest.raises(ValueError, match="no centroids"):
        eng.submit("emb", x[:4])
    assert eng.transform("emb", x[:4]).shape == (4, 4)


def test_engine_device_budget_eviction(fitted):
    """device_budget_bytes evicts by size, but never the newest entry."""
    eng = _engine(fitted, device_budget_bytes=1)   # absurdly small budget
    for name, (mdl, x) in fitted.items():
        np.testing.assert_array_equal(eng.predict(name, x[:8]),
                                      mdl.predict(x[:8]))
    assert len(eng.resident_models) == 1           # newest always kept
    assert eng.stats()["evictions"] == 1
    assert eng.stats()["slots"] == 1               # the evicted slot freed
    assert eng.stats()["slots_freed"] == 1


def test_cluster_server_http_roundtrip(fitted, tmp_path):
    """The stdlib front end serves the same engine loop: load via POST,
    predict/transform parity, stats, and error codes."""
    mdl, x = fitted["blobs"]
    path = str(tmp_path / "m.npz")
    mdl.save(path)
    eng = ClusterEngine(EngineConfig(buckets=BUCKETS), device="cpu")
    with ClusterServer(eng) as srv:
        def post(route, body):
            req = urllib.request.Request(
                srv.url + route, json.dumps(body).encode(),
                {"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        code, out = post("/v1/models", {"name": "m", "path": path})
        assert code == 200 and out["data_dim"] == 6
        code, out = post("/v1/predict", {"model": "m",
                                         "rows": x[:9].tolist()})
        assert code == 200
        np.testing.assert_array_equal(out["labels"], mdl.predict(x[:9]))
        code, out = post("/v1/transform", {"model": "m",
                                           "rows": x[:3].tolist()})
        assert code == 200 and np.asarray(out["embedding"]).shape == (3, 4)
        code, out = post("/v1/predict", {"model": "ghost", "rows": [[0] * 6]})
        assert code == 400 and "ghost" in out["error"]
        with urllib.request.urlopen(srv.url + "/v1/stats") as r:
            stats = json.loads(r.read())
        assert stats["rows_served"] == 12
        with urllib.request.urlopen(srv.url + "/metrics") as r:
            text = r.read().decode()
        assert 'engine_rows_served_total{model="m"} 12' in text


# -- beyond the reference's tests -------------------------------------------

@pytest.fixture(scope="module")
def dense_fitted():
    """A model of each dense map (and SV_RF's unnormalized one)."""
    x, _ = make_blobs(300, 6, 4, seed=2)
    out = {}
    for name, fm_name, lap in (("sc_rf", "rff", True),
                               ("sv_rf", "rff", False),
                               ("sc_nys", "nystrom", True),
                               ("sc_lsc", "lsc", True)):
        fm = tfm.make_feature_map(fm_name, rank=64, sigma=1.5)
        plan = texec.ExecutionPlan(feature_map=fm, laplacian_normalize=lap)
        out[name] = SCRBModel.fit(
            x, _cfg(n_clusters=4, n_grids=64, sigma=1.5, kmeans_replicates=2,
                    seed=1), plan=plan, device="cpu")
    return out, x


def test_engine_dense_models_bit_identical(dense_fitted):
    """Dense-map models through the engine, coalesced and padded, give the
    bits of their own predict/transform (their row-local products run in
    fixed row tiles)."""
    models, x = dense_fitted
    eng = ClusterEngine(EngineConfig(buckets=BUCKETS), device="cpu")
    for name, mdl in models.items():
        eng.load_model(name, mdl)
    for name, mdl in models.items():
        tickets = [(eng.submit(name, x[a:b]), a, b)
                   for a, b in ((0, 1), (1, 40), (40, 200), (200, 300))]
        emb = eng.submit(name, x[5:77], "transform")
        eng.drain()
        for t, a, b in tickets:
            np.testing.assert_array_equal(eng.take(t).values,
                                          mdl.predict(x[a:b]))
        np.testing.assert_array_equal(eng.take(emb).values,
                                      mdl.transform(x[5:77]))


def test_engine_models_of_one_signature_share_cells(fitted):
    """Two models whose states have the same signature (the same map
    metadata and state shapes) share one slot's cells under
    max_resident_models=1: the second model builds no cell."""
    mdl, x = fitted["blobs"]
    twin = SCRBModel.fit(x[::-1].copy(), mdl.config, device="cpu")
    eng = ClusterEngine(EngineConfig(buckets=BUCKETS, max_resident_models=1),
                        device="cpu")
    eng.load_model("a", mdl)
    eng.load_model("b", twin)
    assert eng.warmup("a") == len(BUCKETS)
    assert eng.warmup("b") == 0
    for name, m in (("a", mdl), ("b", twin), ("a", mdl)):
        np.testing.assert_array_equal(eng.predict(name, x[:70]),
                                      m.predict(x[:70]))
    assert eng.stats()["slots"] == 1


@pytest.mark.parametrize("fm_name", ["rb", "nystrom"])
def test_engine_serves_a_reference_artifact_like_the_reference(tmp_path,
                                                               fm_name):
    """An artifact fitted and saved by the JAX package, served by the
    port's engine, gives the labels and (to float32 tolerance) the
    embedding of the JAX package's engine on the same rows."""
    x, _ = make_blobs(300, 6, 4, seed=3)
    cfg = JConfig(n_clusters=4, n_grids=64, sigma=1.5, d_g=256,
                  kmeans_replicates=2, seed=0)
    plan = None
    if fm_name != "rb":
        plan = jexec.ExecutionPlan(feature_map=jfm.make_feature_map(
            fm_name, rank=64, sigma=1.5))
    path = str(tmp_path / "ref.npz")
    JModel.fit(jnp.asarray(x), cfg, plan=plan).save(path)
    jeng = JEngine(JEngineConfig(buckets=BUCKETS))
    jeng.load_model("m", path)
    eng = ClusterEngine(EngineConfig(buckets=BUCKETS), device="cpu")
    eng.load_model("m", path)
    for a, b in ((0, 1), (1, 64), (64, 300)):
        np.testing.assert_array_equal(eng.predict("m", x[a:b]),
                                      jeng.predict("m", x[a:b]))
    np.testing.assert_allclose(eng.transform("m", x[:100]),
                               jeng.transform("m", x[:100]), atol=1e-5)
