"""The port's partitioned placement against the JAX package's.

``placement="partitioned"`` (``repro_torch.core.partitioned``) on the data
of ``tests/test_partitioned.py``: ``make_blobs(1200, 8, 4)``, ``BASE``.
Inputs are made with numpy from a seed and go through both packages; the
reference's draws are injected where the two are compared fit against fit
(RB params through ``RBMap.from_state``; each partition's LOBPCG start
block by patching the port's draw in ``DeviceRows.eigenpairs`` to the
reference's ``normal(fold_key(PRNGKey(seed), "eig"), (N_p, b))``).
Tolerances: partitions bit for bit; the merge's V, Σ and centroids from
the same inputs within 1e-6 and the same labels; the representatives
within 1e-5 (float32 products, another summation order); whole fits by
ARI ≥ 0.99 and merged singular values within 1e-3 relative; predict on
the training rows, save → load and the engine bit for bit.
"""
import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

from repro.core import executor as jexec
from repro.core import featuremap as jfm
from repro.core import model as jmodel
from repro.core import rb as jrb
from repro.core.eigensolver import lobpcg_block_width
from repro.core.options import PartitionOptions as JPartitionOptions
from repro.data.synthetic import make_blobs
from repro.utils import fold_key
from repro_torch.core import executor as texec
from repro_torch.core import featuremap as tfm
from repro_torch.core import metrics, rowmatrix
from repro_torch.core import model as tmodel
from repro_torch.core.kmeans import KMeansResult
from repro_torch.core.options import PartitionOptions as TPartitionOptions
from repro_torch.core.options import SolverOptions as TSolverOptions

jpart = importlib.import_module("repro.core.partitioned")
tpart = importlib.import_module("repro_torch.core.partitioned")

BASE = dict(n_clusters=4, n_grids=64, sigma=1.0, d_g=1024,
            kmeans_replicates=2, seed=0)
STAGES = {"partition", "rb_features", "partition_fits", "merge", "kmeans"}


@pytest.fixture(scope="module")
def data():
    return make_blobs(1200, 8, 4, seed=0)


def _cfgs(n_partitions=3, base=None, **popts):
    kw = dict(BASE, **(base or {}))
    return (jexec.SCRBConfig(**kw, partition=JPartitionOptions(
                n_partitions=n_partitions, **popts)),
            texec.SCRBConfig(**kw, partition=TPartitionOptions(
                n_partitions=n_partitions, **popts)))


@pytest.fixture(scope="module")
def maps(data):
    """The reference's fitted RB map and the port's copy of it."""
    x, _ = data
    key = jax.random.PRNGKey(BASE["seed"])
    params = jrb.make_rb_params(fold_key(key, "rb"), BASE["n_grids"],
                                x.shape[1], BASE["sigma"], BASE["d_g"])
    jmap = jfm.RBMap(n_grids=BASE["n_grids"], sigma=BASE["sigma"],
                     d_g=BASE["d_g"], params=params)
    return jmap, tfm.RBMap.from_state(jmap.meta_dict(), jmap.state_dict(),
                                      device="cpu")


def _reference_start_blocks(monkeypatch):
    """Every port sub-fit's LOBPCG starts from the reference's block."""
    orig = rowmatrix.DeviceRows.eigenpairs

    def eigenpairs(self, k, seed, cfg, x0=None):
        b = lobpcg_block_width(self.n, k, cfg.solver_options.buffer)
        block = jax.random.normal(
            fold_key(jax.random.PRNGKey(BASE["seed"]), "eig"), (self.n, b),
            jnp.float32)
        return orig(self, k, seed, cfg, x0=np.asarray(block))

    monkeypatch.setattr(rowmatrix.DeviceRows, "eigenpairs", eigenpairs)


@pytest.fixture(scope="module")
def fits(data, maps):
    """Both packages' partitioned fits, the reference's draws injected."""
    x, _ = data
    jmap, tmap = maps
    jcfg, tcfg = _cfgs()
    jres = jexec.execute(x, jcfg, dataclasses.replace(
        jexec.plan_from_config(jcfg), feature_map=jmap), keep_state=True)
    with pytest.MonkeyPatch.context() as mp:
        _reference_start_blocks(mp)
        tres = texec.execute(x, tcfg, dataclasses.replace(
            texec.plan_from_config(tcfg), feature_map=tmap),
            keep_state=True, device="cpu")
    return jres, tres


# -- partitioning and the merge, from the same inputs ----------------------

@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("n_partitions", [1, 3, 4, 7])
def test_partition_rows_bit_for_bit(shuffle, n_partitions):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(103, 3)).astype(np.float32)
    want = jpart.partition_rows(x, n_partitions, shuffle=shuffle, seed=5)
    got = tpart.partition_rows(x, n_partitions, shuffle=shuffle, seed=5)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    blocks = [x[i:i + 10] for i in range(0, 103, 10)]
    want = jpart.partition_rows(blocks, n_partitions, shuffle=shuffle,
                                seed=5)
    got = tpart.partition_rows(blocks, n_partitions, shuffle=shuffle,
                               seed=5)
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        for gb, wb in zip(g, w):
            np.testing.assert_array_equal(gb, wb)
    assert tpart.partition_rows(torch.from_numpy(x), n_partitions,
                                shuffle=shuffle, seed=5)[0].shape == \
        jpart.partition_rows(x, n_partitions, shuffle=shuffle,
                             seed=5)[0].shape


def test_merge_and_weighted_kmeans_match_the_reference():
    rng = np.random.default_rng(0)
    reps = rng.normal(size=(12, 40))
    weights = rng.uniform(1.0, 50.0, size=12)
    jv, js, je = jpart.merge_representatives(reps, weights, 4)
    tv, ts, te = tpart.merge_representatives(reps, weights, 4)
    np.testing.assert_allclose(tv, jv, atol=1e-6)
    np.testing.assert_allclose(ts, js, atol=1e-6)
    np.testing.assert_allclose(te, je, atol=1e-6)
    jc, jl, ji = jpart._weighted_kmeans(np.random.default_rng(7), je,
                                        weights, 4, iters=25, replicates=3)
    tc, tl, ti = tpart._weighted_kmeans(np.random.default_rng(7), te,
                                        weights, 4, iters=25, replicates=3)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tc, jc, atol=1e-6)
    assert abs(ti - ji) <= 1e-6 * max(1.0, abs(ji))
    with pytest.raises(ValueError, match="representatives"):
        tpart.merge_representatives(reps[:3], weights[:3], 4)


def test_feature_space_representatives_match(data, maps):
    """One partition's summary from the same ELL pattern and the same
    labels: the reference's sub-fit, and the port's with the reference's
    k-means labels put in its place."""
    x, _ = data
    jmap, tmap = maps
    xp = x[:400]
    jres = jexec.execute(xp, jexec.SCRBConfig(**BASE), jexec.ExecutionPlan(
        feature_map=jmap), keep_state=True)
    tres = texec.execute(xp, texec.SCRBConfig(**BASE), texec.ExecutionPlan(
        feature_map=tmap), keep_state=True, device="cpu")
    labels = torch.as_tensor(np.array(jres.state["km"].labels))
    tres.state["km"] = KMeansResult(None, labels, torch.tensor(0.0))
    jm, jw = jpart._feature_space_representatives(jres, 4)
    tm, tw = tpart._feature_space_representatives(tres, 4)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-5)


# -- whole fits ------------------------------------------------------------

def test_partitioned_fit_matches_the_reference(data, fits):
    x, y = data
    jres, tres = fits
    assert metrics.adjusted_rand_index(tres.labels, jres.labels) >= 0.99
    assert metrics.accuracy(tres.labels, y) >= 0.97
    np.testing.assert_allclose(tres.singular_values, jres.singular_values,
                               rtol=1e-3)
    assert set(tres.timer.times) == set(jres.timer.times) == STAGES
    assert set(tres.diagnostics) - {"device"} == set(jres.diagnostics)
    assert set(tres.diagnostics["partitioned"]) == \
        set(jres.diagnostics["partitioned"])
    d = tres.diagnostics["partitioned"]
    assert d["n_partitions"] == 3 and sum(d["partition_rows"]) == 1200
    assert d["partition_rows"] == jres.diagnostics["partitioned"][
        "partition_rows"]
    assert d["representatives"] == \
        jres.diagnostics["partitioned"]["representatives"]


def test_partitioned_state_and_rowmatrix(data, fits):
    x, _ = data
    _, tres = fits
    st = tres.state
    assert isinstance(st["z"], rowmatrix.PartitionedRows)
    assert st["z"].n == x.shape[0] and st["z"].n_partitions == 3
    ps = st["partitioned"]
    assert ps["right_vectors"].shape == (BASE["n_grids"] * BASE["d_g"],
                                         BASE["n_clusters"])
    assert st["z"].degree_dual().shape == (BASE["n_grids"] * BASE["d_g"],)
    lo, hi = st["z"].degree_range()
    assert lo == tres.diagnostics["degrees_min"] > 0
    assert hi == tres.diagnostics["degrees_max"] >= lo


def test_workers_give_the_same_bits(data):
    x, _ = data
    _, one = _cfgs()
    _, three = _cfgs(workers=3)
    a = texec.execute(x, one, device="cpu")
    b = texec.execute(x, three, device="cpu")
    assert a.diagnostics["partitioned"]["workers"] == 1
    assert b.diagnostics["partitioned"]["workers"] == 3
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.singular_values, b.singular_values)
    np.testing.assert_array_equal(a.embedding, b.embedding)


def test_partitioned_host_chunked_matches_the_reference(data, maps):
    x, y = data
    jmap, tmap = maps
    jcfg, tcfg = _cfgs(base=dict(chunk_size=128))
    plan = texec.plan_from_config(tcfg)
    assert (plan.placement, plan.residency) == ("partitioned",
                                                "host_chunked")
    jres = jexec.execute(x, jcfg, dataclasses.replace(
        jexec.plan_from_config(jcfg), feature_map=jmap))
    tres = texec.execute(x, tcfg, dataclasses.replace(plan, feature_map=tmap),
                         device="cpu")
    assert metrics.adjusted_rand_index(tres.labels, jres.labels) >= 0.99
    assert tres.diagnostics["n_chunks"] == jres.diagnostics["n_chunks"]
    assert metrics.accuracy(tres.labels, y) >= 0.97


def test_block_list_input(data):
    x, y = data
    blocks = [x[i:i + 200] for i in range(0, x.shape[0], 200)]
    _, cfg = _cfgs(base=dict(chunk_size=200), shuffle=False)
    res = texec.execute(blocks, cfg, device="cpu")
    assert metrics.accuracy(res.labels, y) >= 0.95


@pytest.fixture(scope="module")
def merged(data):
    x, _ = data
    _, cfg = _cfgs()
    return tmodel.SCRBModel.fit(x, cfg, device="cpu")


def test_merged_model_predicts_its_fit_labels(data, merged):
    x, _ = data
    np.testing.assert_array_equal(merged.predict(x), merged.fit_result.labels)
    np.testing.assert_array_equal(merged.predict(x, batch_size=256),
                                  merged.fit_result.labels)
    assert merged.right_vectors.shape[1] == BASE["n_clusters"]


def test_merged_model_save_load_both_packages(data, merged, tmp_path):
    x, _ = data
    path = str(tmp_path / "merged.npz")
    merged.save(path)
    loaded = tmodel.SCRBModel.load(path, device="cpu")
    assert loaded.config == merged.config
    assert loaded.config.partition.n_partitions == 3
    np.testing.assert_array_equal(loaded.predict(x),
                                  merged.fit_result.labels)
    ref = jmodel.SCRBModel.load(path)
    assert ref.config.partition.n_partitions == 3
    np.testing.assert_array_equal(ref.predict(x), merged.predict(x))
    # and the reference's merged model in the port
    jcfg, _ = _cfgs()
    jm = jmodel.SCRBModel.fit(x, jcfg)
    jpath = str(tmp_path / "ref_merged.npz")
    jm.save(jpath)
    tm = tmodel.SCRBModel.load(jpath, device="cpu")
    np.testing.assert_array_equal(tm.predict(x), jm.predict(x))


def test_merged_model_serves_through_engine(data, merged):
    from repro_torch.serve.cluster_engine import ClusterEngine, EngineConfig
    x, _ = data
    eng = ClusterEngine(EngineConfig(buckets=(64, 256)), device="cpu")
    eng.load_model("merged", merged)
    np.testing.assert_array_equal(eng.predict("merged", x[:300]),
                                  merged.predict(x[:300]))


def test_errors_tiny_partitions_and_k_auto(data):
    x, _ = data
    _, cfg = _cfgs(4, local_clusters=8)
    with pytest.raises(ValueError, match="local_clusters"):
        texec.execute(x[:9], cfg, device="cpu")
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="k='auto'"):
        tmodel.SCRBModel.fit(x, cfg, k="auto", device="cpu")


def test_partitioned_traced_fit_has_worker_tracks(data, tmp_path):
    x, _ = make_blobs(600, 6, 4, seed=0)
    path = str(tmp_path / "part_trace.json")
    cfg = texec.SCRBConfig(n_clusters=4, n_grids=32, sigma=1.5, d_g=256,
                           solver_options=TSolverOptions(tol=1e-2),
                           kmeans_replicates=1, seed=0,
                           partition=TPartitionOptions(n_partitions=3,
                                                       workers=2),
                           trace=path)
    res = texec.execute(x, cfg, device="cpu")
    assert res.labels.shape == (600,)
    with open(path) as f:
        doc = json.load(f)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    root, = (e for e in xs if e["name"] == "fit"
             and e["args"]["placement"] == "partitioned")
    parts = [e for e in xs if e["name"] == "partition_fit"]
    assert len(parts) == 3
    assert {e["args"]["partition"] for e in parts} == {0, 1, 2}
    assert len({e["tid"] for e in parts}) == 2        # one track a worker
    for e in parts:                                   # nested under the root
        assert e["ts"] >= root["ts"] - 1e3
        assert e["ts"] + e["dur"] <= root["ts"] + root["dur"] + 1e3


# -- what the worker threads share -----------------------------------------

def test_launch_counts_stay_exact_under_threads():
    """More threads than cores add to one count with a short switch
    interval: no increment is lost (``ops.LAUNCHES`` is guarded)."""
    import sys
    import threading

    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    per, threads = 5_000, 32
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            ops._count("bin_counts") for _ in range(per)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(prev)
    assert ops.launch_counts()["bin_counts"] == per * threads
    ops.reset_launch_counts()


def test_stream_scoped_sync_is_per_thread(monkeypatch):
    """Under ``stream_scoped_sync`` a thread's waits are its current
    stream's; another thread, and the same thread after the block, wait for
    the whole device."""
    import threading

    from repro_torch.obs import trace as obs_trace
    calls = []

    class _Stream:
        def synchronize(self):
            calls.append(("stream", threading.get_ident()))

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda: calls.append(("device",
                                              threading.get_ident())))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    other = threading.Thread(target=obs_trace._device_sync)
    with obs_trace.stream_scoped_sync():
        obs_trace._device_sync()
        other.start()
        other.join(timeout=10)
    obs_trace._device_sync()
    me = threading.get_ident()
    assert calls == [("stream", me), ("device", other.ident),
                     ("device", me)]
