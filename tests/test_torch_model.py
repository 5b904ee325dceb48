"""The port's fit, artifact and serving paths against the JAX package's.

Inputs are made with numpy from a seed and go through both packages; every
random draw of the reference is injected into the port (RB params through
``RBMap.from_state``, the LOBPCG start block through
``ExecutionPlan.eig_x0``, k-means seeds through ``kmeans(init=...)``), so
like is compared with like. Tolerances: ELL indices and labels under given
centroids exact; degrees and row scales within 1e-5 (float32, other
summation order); the leading K Ritz values within 1e-4 and principal-angle
cosines ≥ 1 − 1e-3 (both solves stop at tol 1e-3); whole-fit labels
ARI ≥ 0.99.
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import executor as jexec
from repro.core import featuremap as jfm
from repro.core import model as jmodel
from repro.core import rb as jrb
from repro.core.eigensolver import lobpcg_block_width
from repro.core.options import SolverOptions as JSolverOptions
from repro.data.synthetic import make_blobs, make_rings
from repro.utils import fold_key
from repro_torch.core import executor as texec
from repro_torch.core import featuremap as tfm
from repro_torch.core import metrics
from repro_torch.core import model as tmodel
from repro_torch.core.options import SolverOptions as TSolverOptions

# the package __init__ files re-export a ``kmeans`` function over the module
jkm = importlib.import_module("repro.core.kmeans")
tkm = importlib.import_module("repro_torch.core.kmeans")

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
SEED = 3
CASES = {
    "blobs3": dict(data=lambda: make_blobs(600, 6, 3, seed=0),
                   cfg=dict(n_clusters=3, n_grids=64, sigma=1.5, d_g=1024)),
    "rings2": dict(data=lambda: make_rings(600, 2, seed=0),
                   cfg=dict(n_clusters=2, n_grids=96, sigma=0.15, d_g=4096)),
}
COMMON = dict(kmeans_replicates=2, seed=SEED)


def _configs(case):
    kw = dict(CASES[case]["cfg"], **COMMON)
    return (jexec.SCRBConfig(**kw, solver_options=JSolverOptions(tol=1e-3)),
            texec.SCRBConfig(**kw, solver_options=TSolverOptions(tol=1e-3)))


@pytest.fixture(scope="module", params=sorted(CASES))
def parity(request):
    """One fit of each package on the same data, draws injected."""
    case = request.param
    x, y = CASES[case]["data"]()
    jcfg, tcfg = _configs(case)
    key = jax.random.PRNGKey(SEED)
    params = jrb.make_rb_params(fold_key(key, "rb"), jcfg.n_grids,
                                x.shape[1], jcfg.sigma, jcfg.d_g)
    jmap = jfm.RBMap(n_grids=jcfg.n_grids, sigma=jcfg.sigma, d_g=jcfg.d_g,
                     params=params)
    jres = jexec.execute(jnp.asarray(x), jcfg,
                         jexec.ExecutionPlan(feature_map=jmap),
                         keep_state=True)
    b = lobpcg_block_width(x.shape[0], jcfg.n_clusters,
                           jcfg.solver_options.buffer)
    x0 = np.asarray(jax.random.normal(fold_key(key, "eig"),
                                      (x.shape[0], b), jnp.float32))
    tmap = tfm.RBMap.from_state(jmap.meta_dict(), jmap.state_dict())
    tres = texec.execute(x, tcfg,
                         texec.ExecutionPlan(feature_map=tmap, eig_x0=x0),
                         keep_state=True, device="cpu")
    return dict(case=case, x=x, y=y, key=key, jcfg=jcfg, tcfg=tcfg,
                jres=jres, tres=tres)


def test_fit_parity_ell_indices_equal(parity):
    want = np.asarray(parity["jres"].state["features"].payload)
    got = parity["tres"].state["features"].payload
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fit_parity_degrees_and_rowscale(parity):
    jadj = parity["jres"].state["z"].adj
    tadj = parity["tres"].state["z"].adj
    np.testing.assert_allclose(tadj.deg.numpy(), np.asarray(jadj.deg),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tadj.rowscale.numpy(),
                               np.asarray(jadj.rowscale), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tadj.counts.numpy(), np.asarray(jadj.counts),
                               rtol=1e-5, atol=1e-5)


def test_fit_parity_ritz_values_and_subspace(parity):
    k = parity["jcfg"].n_clusters
    jeig, teig = parity["jres"].state["eig"], parity["tres"].state["eig"]
    np.testing.assert_allclose(teig.theta[:k].numpy(),
                               np.asarray(jeig.theta)[:k], atol=1e-4)
    qa, _ = np.linalg.qr(np.asarray(jeig.vectors, np.float64)[:, :k])
    qb, _ = np.linalg.qr(teig.vectors.numpy().astype(np.float64)[:, :k])
    cosines = np.linalg.svd(qa.T @ qb, compute_uv=False)
    assert cosines.min() >= 1 - 1e-3, cosines


def test_fit_parity_labels(parity):
    ari = metrics.adjusted_rand_index(parity["tres"].labels,
                                      parity["jres"].labels)
    assert ari >= 0.99, ari
    assert metrics.accuracy(parity["tres"].labels, parity["y"]) >= \
        metrics.accuracy(parity["jres"].labels, parity["y"]) - 0.01


def test_kmeans_injected_seeds_exact(parity):
    """The reference's own k-means++ seeds through the port's Lloyd loop
    reproduce the reference's labels exactly."""
    jcfg = parity["jcfg"]
    u_hat = np.array(parity["jres"].state["u_hat"], np.float32)
    keys = jax.random.split(fold_key(parity["key"], "kmeans"),
                            jcfg.kmeans_replicates)
    inits = np.stack([np.asarray(jkm._plusplus_init(kk, jnp.asarray(u_hat),
                                                    jcfg.n_clusters))
                      for kk in keys])
    got = tkm.kmeans(None, torch.from_numpy(u_hat), jcfg.n_clusters,
                     n_iters=jcfg.kmeans_iters, init=torch.from_numpy(inits))
    np.testing.assert_array_equal(got.labels.numpy(), parity["jres"].labels)
    one = jkm._lloyd(jnp.asarray(u_hat), jnp.asarray(inits[0]),
                     jcfg.kmeans_iters, "xla")
    mine = tkm._lloyd(torch.from_numpy(u_hat), torch.from_numpy(inits[0]),
                      jcfg.kmeans_iters)
    np.testing.assert_array_equal(mine.labels.numpy(), np.asarray(one.labels))
    np.testing.assert_allclose(mine.centroids.numpy(),
                               np.asarray(one.centroids), atol=1e-5)


def test_fit_is_deterministic():
    x, _ = make_blobs(400, 5, 3, seed=1)
    cfg = texec.SCRBConfig(n_clusters=3, n_grids=32, sigma=1.5, d_g=512,
                           kmeans_replicates=2,
                           solver_options=TSolverOptions(tol=1e-3))
    a = texec.execute(x, cfg, device="cpu").labels
    b = texec.execute(x, cfg, device="cpu").labels
    np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# Artifacts: the checked-in reference artifact, and both directions.
# --------------------------------------------------------------------------

def test_reference_artifact_labels_exact():
    model = tmodel.SCRBModel.load(os.path.join(DATA_DIR, "tiny_model_v1.npz"),
                                  device="cpu")
    xq = np.load(os.path.join(DATA_DIR, "tiny_model_v1_x.npy"))
    want = np.load(os.path.join(DATA_DIR, "tiny_model_v1_labels.npy"))
    np.testing.assert_array_equal(model.predict(xq), want)
    np.testing.assert_array_equal(model.predict(xq, batch_size=64), want)
    assert model.data_dim == xq.shape[1]


@pytest.fixture(scope="module")
def blobs():
    return make_blobs(500, 6, 4, seed=2)


BASE = dict(n_clusters=4, n_grids=32, sigma=1.5, d_g=512,
            kmeans_replicates=2, seed=0)


def test_reference_saved_model_loads_in_port(blobs, tmp_path):
    x, _ = blobs
    jm = jmodel.SCRBModel.fit(
        jnp.asarray(x), jexec.SCRBConfig(
            **BASE, solver_options=JSolverOptions(tol=1e-3)))
    path = str(tmp_path / "ref.npz")
    jm.save(path)
    tm = tmodel.SCRBModel.load(path, device="cpu")
    assert tm.config.to_dict() == jm.config.to_dict()
    np.testing.assert_array_equal(tm.predict(x), jm.predict(x))
    np.testing.assert_allclose(tm.transform(x[:64]), jm.transform(x[:64]),
                               atol=1e-5)


def test_port_saved_model_loads_in_reference(blobs, tmp_path):
    x, _ = blobs
    tm = tmodel.SCRBModel.fit(
        x, texec.SCRBConfig(**BASE, solver_options=TSolverOptions(tol=1e-3)),
        device="cpu")
    path = str(tmp_path / "port.npz")
    tm.save(path)
    jm = jmodel.SCRBModel.load(path)
    np.testing.assert_array_equal(jm.predict(x), tm.predict(x))
    with np.load(path) as npz:
        keys = sorted(npz.files)
    jm.save(str(tmp_path / "again.npz"))
    with np.load(str(tmp_path / "again.npz")) as npz:
        assert sorted(npz.files) == keys
    # predict on the training rows reproduces the fit labels
    assert metrics.accuracy(tm.predict(x, batch_size=100),
                            tm.fit_result.labels) >= 0.99


def test_k_auto_and_bucketed_predict(blobs):
    x, _ = blobs
    cfg = texec.SCRBConfig(**dict(BASE, n_clusters=6),
                           solver_options=TSolverOptions(tol=1e-3))
    m = tmodel.SCRBModel.fit(x, cfg, k="auto", device="cpu")
    chosen = m.fit_result.diagnostics["k_auto"]["k"]
    assert 2 <= chosen <= 5 and m.centroids.shape[0] == chosen
    want = m.predict(x)
    for bs in (64, 100, 300):
        np.testing.assert_array_equal(m.predict(x, batch_size=bs), want)
    assert tmodel.round_to_bucket(65) == 256
    assert tmodel.round_to_bucket(5000) == 8192
