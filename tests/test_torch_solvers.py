"""The port's eigensolvers against the JAX package's.

Mirrors the per-solver checks of ``tests/test_eigensolver.py`` (dense
oracles from ``numpy.linalg.eigh``) and runs each solver of both packages
from the same start block: the reference draws it from its key, and the
same numbers go into the port (``x0=``, or as the solver's own start block
argument). Tolerances: Ritz values within 1e-4 relative of each other where
both solves reach ``tol`` (1e-3 against the dense oracle where the
reference's test uses it), principal-angle cosines of the leading k
vectors ≥ 1 − 1e-3 where both reach ``tol``; fits by ARI ≥ 0.99.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

from repro.core import eigensolver as jeig
from repro.core import executor as jexec
from repro.core import featuremap as jfm
from repro.core import rb as jrb
from repro.core.options import SolverOptions as JSolverOptions
from repro.core.streaming import ChunkedDense as JChunkedDense
from repro.data.synthetic import make_blobs
from repro.utils import fold_key
from repro_torch.core import eigensolver as teig
from repro_torch.core import executor as texec
from repro_torch.core import featuremap as tfm
from repro_torch.core import metrics
from repro_torch.core.options import SolverOptions as TSolverOptions
from repro_torch.core.streaming import ChunkedDense as TChunkedDense
from repro_torch.obs import metrics as obs_metrics


def _psd(seed, n, decay=0.9):
    """The reference test's PSD matrix with a geometric spectrum
    (eigenvalues known exactly), as a float32 numpy array."""
    q, _ = jnp.linalg.qr(jax.random.normal(jax.random.PRNGKey(seed), (n, n)))
    lam = decay ** jnp.arange(n)
    a = (q * lam[None, :]) @ q.T
    return np.array(a, np.float32), np.asarray(lam), np.asarray(q)


def _mv(a):
    at, aj = torch.from_numpy(a), jnp.asarray(a)
    return (lambda u: aj @ u), (lambda u: at @ u)


def _block(seed, n, b):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (n, b)),
                    np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    if hasattr(t, "to_array"):
        return t.to_array()
    return np.asarray(t)


def _cosines(a, b, k):
    qa, _ = np.linalg.qr(_np(a).astype(np.float64)[:, :k])
    qb, _ = np.linalg.qr(_np(b).astype(np.float64)[:, :k])
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


def _same_pairs(j, t, k, *, rtol=1e-4, angles=True):
    jt, tt = _np(j.theta)[:k], _np(t.theta)[:k]
    np.testing.assert_allclose(tt, jt, rtol=rtol, atol=1e-6)
    if angles:
        assert _cosines(j.vectors, t.vectors, k).min() >= 1 - 1e-3


# -- LOBPCG family ---------------------------------------------------------

@pytest.mark.parametrize("n,k", [(60, 4), (120, 8)])
def test_lobpcg_matches_dense_and_reference(n, k):
    a, lam, _ = _psd(n, n)
    jmv, tmv = _mv(a)
    x0 = _block(1, n, k)
    ref = jeig.lobpcg(jmv, jnp.asarray(x0), max_iters=400, tol=1e-7)
    got = teig.lobpcg(tmv, torch.from_numpy(x0), max_iters=400, tol=1e-7)
    np.testing.assert_allclose(_np(got.theta), lam[:k], rtol=1e-4, atol=1e-5)
    assert float(got.resnorms.max()) < 1e-3
    _same_pairs(ref, got, k)


def test_lobpcg_clustered_spectrum():
    n = 100
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.concatenate([[1.0, 1.0 - 1e-4, 1.0 - 2e-4, 0.9],
                          0.5 * 0.9 ** np.arange(n - 4)])
    a = ((q * lam[None, :]) @ q.T).astype(np.float32)
    jmv, tmv = _mv(a)
    x0 = _block(1, n, 6)
    ref = jeig.lobpcg(jmv, jnp.asarray(x0), max_iters=600, tol=1e-6)
    got = teig.lobpcg(tmv, torch.from_numpy(x0), max_iters=600, tol=1e-6)
    np.testing.assert_allclose(_np(got.theta)[:4], lam[:4], atol=1e-4)
    np.testing.assert_allclose(_np(got.theta)[:4], _np(ref.theta)[:4],
                               atol=1e-4)


def test_lobpcg_host_matches_reference_and_device_driver():
    n, k = 90, 5
    a, lam, _ = _psd(3, n)
    jmv, tmv = _mv(a)
    x0 = _block(4, n, k)
    ref = jeig.lobpcg_host(jmv, jnp.asarray(x0), max_iters=400, tol=1e-7)
    got = teig.lobpcg_host(tmv, torch.from_numpy(x0), max_iters=400, tol=1e-7)
    dev = teig.lobpcg(tmv, torch.from_numpy(x0), max_iters=400, tol=1e-7)
    np.testing.assert_allclose(_np(got.theta), lam[:k], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(got.theta), _np(dev.theta), atol=1e-5)
    assert float(got.resnorms.max()) < 1e-3
    _same_pairs(ref, got, k)
    # checks every 4 iterations: the stop lands on a checkpoint
    assert got.iterations % 4 == 0 and ref.iterations == got.iterations


def test_lobpcg_stability_no_blowup():
    n = 200
    a, _, _ = _psd(5, n, decay=0.999)
    _, tmv = _mv(a)
    res = teig.lobpcg(tmv, torch.from_numpy(_block(2, n, 10)),
                      max_iters=500, tol=1e-8)
    assert float(res.theta.max()) < 1.5


@pytest.mark.parametrize("driver", ["lobpcg", "lobpcg_host"])
def test_converged_x0_exits_at_zero_iterations(driver):
    n, k = 60, 4
    a, _, _ = _psd(10, n, decay=0.8)
    _, tmv = _mv(a)
    _, evecs = np.linalg.eigh(a.astype(np.float64))
    x0 = torch.from_numpy(np.ascontiguousarray(evecs[:, ::-1][:, :k])
                          .astype(np.float32))
    res = getattr(teig, driver)(tmv, x0, max_iters=100, tol=1e-4)
    assert res.iterations == 0


@pytest.mark.parametrize("driver", ["lobpcg", "lobpcg_host"])
def test_precond_converges_to_same_pairs(driver):
    n, k = 100, 4
    a, lam, _ = _psd(15, n, decay=0.9)
    jmv, tmv = _mv(a)
    tvec = np.random.default_rng(1).uniform(0.5, 1.0, n).astype(np.float32)
    x0 = _block(2, n, k)
    ref = getattr(jeig, driver)(jmv, jnp.asarray(x0), max_iters=400,
                                tol=1e-6, precond=jnp.asarray(tvec))
    got = getattr(teig, driver)(tmv, torch.from_numpy(x0), max_iters=400,
                                tol=1e-6, precond=torch.from_numpy(tvec))
    np.testing.assert_allclose(_np(got.theta), lam[:k], rtol=1e-4, atol=1e-5)
    _same_pairs(ref, got, k)


@pytest.mark.parametrize("driver", ["lobpcg", "lobpcg_host"])
def test_adaptive_stability_stop(driver):
    n, k = 120, 4
    a, _, _ = _psd(16, n, decay=0.97)
    jmv, tmv = _mv(a)
    x0 = torch.from_numpy(_block(3, n, k + 2))
    full = getattr(teig, driver)(tmv, x0, max_iters=500, tol=1e-8)
    adap = getattr(teig, driver)(tmv, x0, max_iters=500, tol=1e-8,
                                 stable_tol=1e-4, stable_k=k)
    assert adap.iterations < full.iterations
    assert float(teig._subspace_alignment(full.vectors, adap.vectors,
                                          k)) > 0.999
    ref = getattr(jeig, driver)(jmv, jnp.asarray(x0.numpy()), max_iters=500,
                                tol=1e-8, stable_tol=1e-4, stable_k=k)
    assert _cosines(ref.vectors, adap.vectors, k).min() > 0.999


def test_rr_update_rank_deficient_keeps_orthonormality():
    n, k = 40, 4
    a, _, _ = _psd(13, n, decay=0.8)
    at = torch.from_numpy(a)
    x = torch.from_numpy(np.linalg.qr(
        np.random.default_rng(0).normal(size=(n, k)))[0].astype(np.float32))
    ax = at @ x
    x_new, ax_new, _, _ = teig._lobpcg_rr_update(
        x, ax, torch.zeros_like(x), torch.zeros_like(x), x, ax, k)
    np.testing.assert_allclose(_np(x_new.T @ x_new), np.eye(k), atol=5e-3)
    np.testing.assert_allclose(_np(at @ x_new), _np(ax_new), atol=5e-3)


def test_degree_precond_matches_reference():
    deg = np.array([1.0, 1.5, 4.0, 100.0, 2.0], np.float32)
    t = teig.degree_precond(torch.from_numpy(deg))
    assert t.dtype == torch.float32 and t.shape == deg.shape
    assert bool(torch.all(t > 0)) and np.isclose(float(t.max()), 1.0)
    np.testing.assert_array_equal(_np(t), jeig.degree_precond(deg))


# -- the baselines and the sketch ------------------------------------------

@pytest.mark.parametrize("solver", ["lanczos", "subspace"])
def test_baseline_solvers(solver):
    n, k = 80, 4
    a, lam, _ = _psd(7, n, decay=0.8)
    jmv, tmv = _mv(a)
    key = jax.random.PRNGKey(3)
    b = teig.lobpcg_block_width(n, k, 4)
    ref = jeig.top_k_eigenpairs(jmv, n, k, key, solver=solver,
                                max_iters=150, tol=1e-7)
    got = teig.top_k_eigenpairs(
        tmv, n, k, None, solver=solver, max_iters=150, tol=1e-7,
        x0=np.asarray(jax.random.normal(key, (n, b), jnp.float32)))
    np.testing.assert_allclose(_np(got.theta)[:k], lam[:k], rtol=1e-3,
                               atol=1e-4)
    assert got.iterations == int(ref.iterations)
    _same_pairs(ref, got, k)


def test_lobpcg_beats_subspace_iteration_on_matvecs():
    n, k = 150, 6
    a, _, _ = _psd(11, n, decay=0.97)
    _, tmv = _mv(a)
    x0 = torch.from_numpy(_block(4, n, k))
    lo = teig.lobpcg(tmv, x0, max_iters=500, tol=1e-5)
    su = teig.subspace_iteration(tmv, x0, max_iters=500, tol=1e-5)
    assert lo.iterations < su.iterations


def test_lanczos_reports_true_basis_size_and_honors_tol():
    n, k = 80, 3
    rng = np.random.default_rng(3)
    b = rng.normal(size=(n, 5)).astype(np.float32)
    low = (b @ b.T / n).astype(np.float32)
    jmv, tmv = _mv(low)
    v0 = _block(0, n, 1)
    ref = jeig.lanczos(jmv, jnp.asarray(v0), k, max_iters=60)
    got = teig.lanczos(tmv, torch.from_numpy(v0), k, max_iters=60)
    assert got.iterations <= 8 and got.iterations == int(ref.iterations)
    a, lam, _ = _psd(14, n, decay=0.5)
    jmv, tmv = _mv(a)
    v0 = _block(1, n, 1)
    ref = jeig.lanczos(jmv, jnp.asarray(v0), k, max_iters=70, tol=1e-6)
    got = teig.lanczos(tmv, torch.from_numpy(v0), k, max_iters=70, tol=1e-6)
    assert got.iterations < 70 and got.iterations == int(ref.iterations)
    np.testing.assert_allclose(_np(got.theta), lam[:k], rtol=1e-4, atol=1e-5)
    _same_pairs(ref, got, k)


def test_randomized_matches_dense_and_reference():
    n, k = 120, 4
    a, lam, _ = _psd(17, n, decay=0.5)
    jmv, tmv = _mv(a)
    key = jax.random.PRNGKey(4)
    b = teig.lobpcg_block_width(n, k, 4)
    ref = jeig.top_k_eigenpairs(jmv, n, k, key, solver="randomized")
    got = teig.top_k_eigenpairs(
        tmv, n, k, None, solver="randomized",
        x0=np.asarray(jax.random.normal(key, (n, b), jnp.float32)))
    np.testing.assert_allclose(_np(got.theta), lam[:k], rtol=1e-3, atol=1e-4)
    assert got.iterations == 3
    _same_pairs(ref, got, k)
    np.testing.assert_allclose(_np(got.resnorms), _np(ref.resnorms),
                               rtol=1e-2, atol=1e-5)


@pytest.mark.parametrize("decay", [0.5, 0.97])
def test_auto_solver_correct_on_both_regimes(decay):
    n, k = 120, 4
    a, lam, _ = _psd(18, n, decay=decay)
    jmv, tmv = _mv(a)
    key = jax.random.PRNGKey(5)
    b = teig.lobpcg_block_width(n, k, 4)
    ref = jeig.top_k_eigenpairs(jmv, n, k, key, solver="auto", tol=1e-4,
                                max_iters=400)
    got = teig.top_k_eigenpairs(
        tmv, n, k, None, solver="auto", tol=1e-4, max_iters=400,
        x0=np.asarray(jax.random.normal(key, (n, b), jnp.float32)))
    np.testing.assert_allclose(_np(got.theta), lam[:k], rtol=1e-3, atol=1e-3)
    assert got.iterations >= 3
    # the same branch (sketch alone, or sketch + LOBPCG) in both packages
    assert (got.iterations == 3) == (int(ref.iterations) == 3)
    np.testing.assert_allclose(_np(got.theta), _np(ref.theta), rtol=1e-3)


def test_degenerate_spectrum_exact_multiplicity():
    n = 90
    rng = np.random.default_rng(20)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.concatenate([np.full((3,), 1.0), 0.6 * 0.9 ** np.arange(n - 3)])
    a = ((q * lam[None, :]) @ q.T).astype(np.float32)
    _, tmv = _mv(a)
    res = teig.top_k_eigenpairs(tmv, n, 3, torch.Generator().manual_seed(7),
                                solver="lobpcg", tol=1e-6, max_iters=500)
    np.testing.assert_allclose(_np(res.theta), [1.0, 1.0, 1.0], atol=1e-4)
    s = np.linalg.svd(q[:, :3].T @ _np(res.vectors), compute_uv=False)
    assert s.min() > 0.999


# -- edge cases, warm starts -----------------------------------------------

def test_block_width_clamped_for_small_n():
    for n, k, buf in [(10, 4, 4), (2, 1, 4), (60, 4, 4), (9, 3, 0),
                      (1000, 8, 4)]:
        assert teig.lobpcg_block_width(n, k, buf) == \
            jeig.lobpcg_block_width(n, k, buf)
    assert teig.lobpcg_block_width(10, 4, 4) == 3


def test_dense_fallback_when_n_below_3k():
    n, k = 10, 4
    a, lam, _ = _psd(8, n, decay=0.7)
    _, tmv = _mv(a)
    res = teig.top_k_eigenpairs(tmv, n, k, torch.Generator(),
                                solver="lobpcg")
    np.testing.assert_allclose(_np(res.theta), lam[:k], rtol=1e-5, atol=1e-6)
    assert res.iterations == 1 and tuple(res.vectors.shape) == (n, k)


def test_dense_fallback_chunked():
    n, k = 11, 4
    a, lam, _ = _psd(9, n, decay=0.7)
    sizes = (4, 4, 3)
    mv = lambda u: TChunkedDense.from_array(a @ u.to_array(), sizes)
    res = teig.top_k_eigenpairs(mv, n, k, torch.Generator(), solver="lobpcg",
                                chunk_sizes=sizes)
    np.testing.assert_allclose(_np(res.theta), lam[:k], rtol=1e-5, atol=1e-6)
    assert isinstance(res.vectors, TChunkedDense)


def test_warm_start_same_pairs_fewer_iterations():
    n, k = 150, 5
    a, lam, _ = _psd(12, n, decay=0.9)
    _, tmv = _mv(a)
    cold = teig.top_k_eigenpairs(tmv, n, k, torch.Generator().manual_seed(1),
                                 solver="lobpcg", tol=1e-5, max_iters=500)
    warm = teig.top_k_eigenpairs(tmv, n, k, torch.Generator().manual_seed(2),
                                 solver="lobpcg", tol=1e-5, max_iters=500,
                                 x0=cold)
    assert cold.iterations < 500
    np.testing.assert_allclose(_np(warm.theta), _np(cold.theta), atol=1e-5)
    np.testing.assert_allclose(_np(warm.theta), lam[:k], rtol=1e-4,
                               atol=1e-5)
    assert warm.iterations < cold.iterations


def test_prepare_start_block_shapes():
    g = torch.Generator().manual_seed(0)
    x = np.ones((20, 3), np.float32)
    assert tuple(teig.prepare_start_block(x, 20, 2, g, "cpu").shape) == (20, 2)
    padded = teig.prepare_start_block(x, 20, 6, g, "cpu")
    assert tuple(padded.shape) == (20, 6)
    np.testing.assert_array_equal(_np(padded[:, :3]), x)
    with pytest.raises(ValueError):
        teig.prepare_start_block(x, 21, 3, g, "cpu")


# -- host chunks -----------------------------------------------------------

@pytest.mark.parametrize("solver", ["randomized", "auto", "lobpcg_host"])
def test_chunked_solvers_match_reference(solver):
    """Each host-driven solver over host chunks, from the reference's own
    chunked start block, against the reference on the same chunks and
    against the dense oracle."""
    n, k = 90, 3
    a, lam, _ = _psd(19, n, decay=0.8)
    sizes = (32, 32, 26)
    jmv = lambda u: JChunkedDense.from_array(a @ u.to_array(), sizes)
    tmv = lambda u: TChunkedDense.from_array(a @ u.to_array(), sizes)
    key = jax.random.PRNGKey(6)
    b = teig.lobpcg_block_width(n, k, 4)
    ref = jeig.top_k_eigenpairs(jmv, n, k, key, solver=solver, tol=1e-5,
                                max_iters=300, streaming=True,
                                chunk_sizes=sizes)
    x0 = JChunkedDense.random_normal(key, sizes, b).to_array()
    got = teig.top_k_eigenpairs(tmv, n, k, None, solver=solver, tol=1e-5,
                                max_iters=300, chunk_sizes=sizes, x0=x0)
    assert isinstance(got.vectors, TChunkedDense)
    assert got.vectors.chunk_sizes == sizes
    if solver != "randomized":      # the sketch alone misses tol here
        np.testing.assert_allclose(_np(got.theta), lam[:k], rtol=1e-3,
                                   atol=1e-4)
    assert got.iterations == int(ref.iterations)
    _same_pairs(ref, got, k, angles=solver != "randomized")


def test_chunked_randomized_equals_device_randomized():
    """The chunked sketch is the device sketch with the Grams added up over
    chunks in float64: the same Ritz values from the same start block."""
    n, k = 90, 3
    a, _, _ = _psd(21, n, decay=0.6)
    sizes = (40, 50)
    _, tmv = _mv(a)
    cmv = lambda u: TChunkedDense.from_array(a @ u.to_array(), sizes)
    x0 = _block(8, n, 7)
    dev = teig.randomized(tmv, torch.from_numpy(x0))
    chu = teig._chunked_randomized_impl(
        cmv, TChunkedDense.from_array(x0, sizes))
    np.testing.assert_allclose(_np(chu.theta)[:k], _np(dev.theta)[:k],
                               rtol=1e-4)
    assert _cosines(chu.vectors, dev.vectors, k).min() >= 1 - 1e-3


def test_streaming_rejects_a_device_only_solver():
    mv = lambda u: u
    with pytest.raises(ValueError, match="host-driven"):
        teig.top_k_eigenpairs(mv, 30, 2, torch.Generator(), solver="lanczos",
                              chunk_sizes=(15, 15))


def test_eigensolver_rejects_compressive_and_unknown():
    mv = lambda u: u
    with pytest.raises(ValueError, match="compressive"):
        teig.top_k_eigenpairs(mv, 30, 2, torch.Generator(),
                              solver="compressive")
    with pytest.raises(ValueError, match="unknown solver"):
        teig.top_k_eigenpairs(mv, 30, 2, torch.Generator(), solver="nope")
    assert set(teig.SOLVERS) == set(jeig.SOLVERS)
    assert teig.AUTO_SOLVER == jeig.AUTO_SOLVER


def test_eigensolve_metrics_per_solver():
    n, k = 60, 3
    a, _, _ = _psd(22, n, decay=0.7)
    _, tmv = _mv(a)
    total = obs_metrics.REGISTRY.get("repro_eigensolves_total")
    iters = obs_metrics.REGISTRY.get("repro_solver_iterations")
    for solver in sorted(set(teig.SOLVERS) | {"auto"}):
        before = total.get(solver=solver)
        out = teig.top_k_eigenpairs(tmv, n, k, torch.Generator().manual_seed(0),
                                    solver=solver, tol=1e-4, max_iters=200)
        assert total.get(solver=solver) == before + 1
        assert iters.count(solver=solver) >= 1
        assert obs_metrics.REGISTRY.get("repro_solver_resnorm_max").get(
            solver=solver) == pytest.approx(float(out.resnorms.max()))


# -- whole fits: every solver on device rows, the host-driven ones on chunks

SEED = 3
FIT_CFG = dict(n_clusters=3, n_grids=48, sigma=1.5, d_g=512,
               kmeans_replicates=2, seed=SEED)


@pytest.fixture(scope="module")
def fit_data():
    x, _ = make_blobs(360, 6, 3, seed=4)
    key = jax.random.PRNGKey(SEED)
    params = jrb.make_rb_params(fold_key(key, "rb"), FIT_CFG["n_grids"],
                                x.shape[1], FIT_CFG["sigma"], FIT_CFG["d_g"])
    jmap = jfm.RBMap(n_grids=FIT_CFG["n_grids"], sigma=FIT_CFG["sigma"],
                     d_g=FIT_CFG["d_g"], params=params)
    return x, key, jmap


@pytest.mark.parametrize("solver,chunk_size", [
    ("lobpcg_host", None), ("randomized", None), ("auto", None),
    ("lanczos", None), ("subspace", None),
    ("lobpcg_host", 150), ("randomized", 150), ("auto", 150)])
def test_fit_with_each_solver_matches_reference(fit_data, solver, chunk_size):
    """``executor.execute`` with each solver in both packages, the RB grids
    and the start block of the reference injected into the port: the
    leading Ritz values, the subspace where both reach tol, and the labels
    by ARI."""
    x, key, jmap = fit_data
    k = FIT_CFG["n_clusters"]
    so = dict(solver=solver, tol=1e-4)
    jcfg = jexec.SCRBConfig(**FIT_CFG, chunk_size=chunk_size,
                            solver_options=JSolverOptions(**so))
    tcfg = texec.SCRBConfig(**FIT_CFG, chunk_size=chunk_size,
                            solver_options=TSolverOptions(**so))
    jplan = dataclasses.replace(jexec.plan_from_config(jcfg),
                                feature_map=jmap)
    jres = jexec.execute(jnp.asarray(x), jcfg, jplan, keep_state=True)
    n = x.shape[0]
    b = teig.lobpcg_block_width(n, k, 4)
    ekey = fold_key(key, "eig")
    if chunk_size is None:
        x0 = np.asarray(jax.random.normal(ekey, (n, b), jnp.float32))
    else:
        sizes = jres.state["z"].store.chunk_sizes
        x0 = JChunkedDense.random_normal(ekey, sizes, b).to_array()
    tmap = tfm.RBMap.from_state(jmap.meta_dict(), jmap.state_dict(),
                                device="cpu")
    tplan = dataclasses.replace(texec.plan_from_config(tcfg),
                                feature_map=tmap, eig_x0=x0)
    tres = texec.execute(x, tcfg, tplan, keep_state=True, device="cpu")
    assert tres.diagnostics["solver"] == solver
    assert tres.diagnostics["solver_iterations"] == \
        jres.diagnostics["solver_iterations"]
    jt = np.asarray(jres.singular_values, np.float64) ** 2
    tt = np.asarray(tres.singular_values, np.float64) ** 2
    np.testing.assert_allclose(tt, jt, rtol=1e-4)
    reached = max(np.max(jres.diagnostics["solver_resnorms"]),
                  np.max(tres.diagnostics["solver_resnorms"])) <= 1e-4
    if reached:
        assert _cosines(jres.state["eig"].vectors,
                        tres.state["eig"].vectors, k).min() >= 1 - 1e-3
    ari = metrics.adjusted_rand_index(tres.labels, jres.labels)
    assert ari >= 0.99, ari
