"""The port's compressive cell (``solver="compressive"``) against the JAX
package's.

Mirrors ``tests/test_compressive.py``: the dense Â = Ẑ Ẑᵀ of a small graph
(``z.gram(I)``) is the exact spectrum and projector the polynomial machinery
is checked against. Both packages get the same RB grids (the reference's,
through ``RBMap.from_state``) and, where a parity is held, the same random
draws: the reference's probe block, signal block, subset rows and k-means
seeds go into the port through ``compressive_embed(probe_block=,
signal_block=)`` and ``subset_cluster(rows=, init=)``.

Tolerances: ``step_coeffs``, ``jackson_damping`` and ``eigencount`` to
1e-12 (the same float64 numpy); the moments within 1e-4 relative of their
largest term (float32 Gram products and dot products of N·32 terms); the
filtered block and the embedding within 1e-4 of the block's largest entry
(float32 recurrences of up to 96 steps); the cutoff within 1e-4; labels by
ARI ≥ 0.99 on separated blobs, on device rows and on host chunks.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

from repro.core import compressive as jcomp
from repro.core import executor as jexec
from repro.core import featuremap as jfm
from repro.core import model as jmodel
from repro.core import streaming as jstreaming
from repro.core.kmeans import _plusplus_init as j_plusplus_init
from repro.data.synthetic import make_blobs
from repro.utils import fold_key
from repro_torch.core import compressive as tcomp
from repro_torch.core import executor as texec
from repro_torch.core import featuremap as tfm
from repro_torch.core import metrics
from repro_torch.core import model as tmodel
from repro_torch.core import streaming as tstreaming
from repro_torch.core.eigensolver import top_k_eigenpairs
from repro_torch.core.kmeans import row_normalize as t_row_normalize

CFG = dict(n_clusters=3, n_grids=32, sigma=1.5, d_g=256,
           kmeans_replicates=2, seed=0)
CPU = torch.device("cpu")


def _cfgs(chunk_size=None, **kw):
    """The same config in both packages (flat kwargs, as the reference's
    tests spell them)."""
    kw = dict(CFG, chunk_size=chunk_size, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return jexec.SCRBConfig(**kw), texec.SCRBConfig(**kw)


def _rows(x, chunk_size=None, cfg=None):
    """(reference row matrix, port row matrix, the reference's key) of
    ``x`` as the executors build them, the port on the reference's RB
    grids."""
    jcfg, tcfg = _cfgs(chunk_size) if cfg is None else cfg
    jplan = jexec.plan_from_config(jcfg)
    key = jax.random.PRNGKey(jcfg.seed)
    jrep = jexec.representation(jplan)
    jfeats = jrep.fit_transform(jnp.asarray(x), jfm.from_config(jcfg), jcfg,
                                jplan, key)
    jz = jrep.from_features(jfeats, jcfg, jplan)
    tmap = tfm.RBMap.from_state(jfeats.fmap.meta_dict(),
                                jfeats.fmap.state_dict(), device="cpu")
    tplan = dataclasses.replace(texec.plan_from_config(tcfg),
                                feature_map=tmap)
    trep = texec.representation(tplan)
    xin = torch.from_numpy(x) if chunk_size is None else x
    tfeats = trep.fit_transform(xin, tmap, tcfg, tplan, tcfg.seed, CPU)
    tz = trep.from_features(tfeats, tcfg, tplan, CPU)
    return jz, tz, key


def _dense_spectrum(tz):
    eye = torch.eye(tz.n, dtype=torch.float32)
    a = tz.gram(eye).numpy().astype(np.float64)
    a = 0.5 * (a + a.T)
    lam, v = np.linalg.eigh(a)
    return lam[::-1], v[:, ::-1]


def _np(t):
    if isinstance(t, tstreaming.ChunkedDense) or hasattr(t, "to_array"):
        return t.to_array()
    if isinstance(t, torch.Tensor):
        return t.numpy()
    return np.asarray(t)


def _ref_draws(jz, key, k, cfg):
    """The reference's probe block, signal block, subset rows and k-means
    seeds for a fit of ``jz`` (``key`` = PRNGKey(seed))."""
    ekey, kkey = fold_key(key, "eig"), fold_key(key, "kmeans")
    co = cfg.compressive_options
    probes = _np(jz.random_tall(fold_key(ekey, "count"), co.probes,
                                dist="rademacher"))
    d = min(co.signals or jcomp.default_signals(k), jz.n)
    signals = _np(jz.random_tall(fold_key(ekey, "signals"), d))
    n_sub = int(min(jz.n, max(k, co.subset or jcomp.default_subset(jz.n, k))))
    seed = int(jax.random.randint(fold_key(kkey, "subset"), (), 0,
                                  np.iinfo(np.int32).max))
    rows = np.sort(np.random.default_rng(seed).choice(jz.n, size=n_sub,
                                                      replace=False))
    return probes, signals, rows, fold_key(kkey, "centroids")


def _ref_seeds(ckey, sub, k, reps):
    keys = jax.random.split(ckey, reps)
    return np.stack([np.asarray(j_plusplus_init(kk, jnp.asarray(sub), k))
                     for kk in keys])


@pytest.fixture(scope="module")
def clustered():
    """3 separated blobs: a clean gap after λ_3."""
    x, y = make_blobs(160, 5, 3, seed=0)
    jz, tz, key = _rows(x)
    lam, v = _dense_spectrum(tz)
    return x, y, jz, tz, key, lam, v


@pytest.fixture(scope="module")
def degenerate():
    """4 tight blobs but K = 2: λ_2 ≈ λ_3."""
    x, _ = make_blobs(200, 5, 4, seed=1)
    kw = dict(n_clusters=2, n_grids=32, sigma=0.5, d_g=256, seed=0)
    jz, tz, _ = _rows(x, cfg=(jexec.SCRBConfig(**kw),
                                 texec.SCRBConfig(**kw)))
    lam, _ = _dense_spectrum(tz)
    return jz, tz, lam


# --------------------------------------------------------------------------
# the filters: numpy, copied
# --------------------------------------------------------------------------

def test_jackson_damping_shape_and_reference():
    g = tcomp.jackson_damping(40)
    assert g.shape == (41,)
    assert g[0] == pytest.approx(1.0)
    assert abs(g[-1]) < 5e-3
    assert np.all(np.diff(g) < 1e-12)
    np.testing.assert_allclose(g, jcomp.jackson_damping(40), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("cutoff,degree", [(0.3, 24), (0.81, 40),
                                           (0.5, 96), (1.0, 7)])
def test_step_coeffs_and_eigencount_match_reference(cutoff, degree):
    for damped in (True, False):
        np.testing.assert_allclose(
            tcomp.step_coeffs(cutoff, degree, damped=damped),
            jcomp.step_coeffs(cutoff, degree, damped=damped),
            rtol=0, atol=1e-12)
    mu = np.random.default_rng(degree).normal(size=degree + 1) * 10
    for t in (0.1, cutoff, 0.9):
        assert tcomp.eigencount(mu, 8, t) == pytest.approx(
            jcomp.eigencount(mu, 8, t), abs=1e-12)
    lam = np.linspace(0, 1, 11)
    coeffs = tcomp.step_coeffs(cutoff, degree)
    np.testing.assert_allclose(tcomp.step_eval(coeffs, lam),
                               jcomp.step_eval(coeffs, lam), atol=1e-12)


def test_defaults_scale_and_match_reference():
    assert tcomp.default_signals(2) >= 4
    assert tcomp.default_signals(64) > tcomp.default_signals(4)
    assert tcomp.default_subset(100, 8) == 100
    assert tcomp.default_subset(10**6, 8) < 10**4
    for k in (2, 3, 7, 10, 64):
        assert tcomp.default_signals(k) == jcomp.default_signals(k)
        assert tcomp.default_subset(10**6, k) == \
            jcomp.default_subset(10**6, k)
    est = tcomp.LambdaEstimate(0.9, 0.85, 0.875, None, 0, 0)
    assert tcomp.default_filter_degree(est) == jcomp.default_filter_degree(
        jcomp.LambdaEstimate(0.9, 0.85, 0.875, None, 0, 0))


# --------------------------------------------------------------------------
# the polynomial filter against the exact projector and the reference
# --------------------------------------------------------------------------

def test_chebyshev_sweep_matches_exact_polynomial_and_reference(clustered):
    _, _, jz, tz, _, lam, v = clustered
    cutoff = 0.5 * (lam[2] + lam[3])
    coeffs = tcomp.step_coeffs(cutoff, 60)
    r = _np(jz.random_tall(jax.random.PRNGKey(1), 4))
    filt, _, nmv = tcomp.chebyshev_sweep(tz, torch.from_numpy(r), 60,
                                         coeffs=coeffs)
    assert nmv == 60
    exact = v @ (tcomp.step_eval(coeffs, lam)[:, None] * (v.T @ r))
    assert np.abs(_np(filt) - exact).max() < 1e-4
    ref, _, _ = jcomp.chebyshev_sweep(jz, jnp.asarray(r), 60, coeffs=coeffs)
    scale = np.abs(_np(ref)).max()
    assert np.abs(_np(filt) - _np(ref)).max() < 1e-4 * max(scale, 1.0)


def test_damped_step_approximates_projector(clustered):
    _, _, _, tz, _, lam, v = clustered
    cutoff = 0.5 * (lam[2] + lam[3])
    coeffs = tcomp.step_coeffs(cutoff, 60)
    r = tz.random_tall(torch.Generator().manual_seed(1), 4)
    filt, _, _ = tcomp.chebyshev_sweep(tz, r, 60, coeffs=coeffs)
    fn, rn = _np(filt), _np(r)
    vk = v[:, :3]
    proj = vk @ (vk.T @ rn)
    assert np.linalg.norm(fn - proj) / np.linalg.norm(rn) < 5e-2
    assert np.linalg.norm(vk.T @ fn) / np.linalg.norm(fn) > 0.999


# --------------------------------------------------------------------------
# λ_K estimation by eigencount dichotomy
# --------------------------------------------------------------------------

def test_lambda_k_estimation_clustered(clustered):
    _, _, jz, tz, _, lam, _ = clustered
    key = jax.random.PRNGKey(0)
    est, nmv = tcomp.estimate_lambda_k(tz, 3, 0)
    assert nmv == tcomp.COUNT_DEGREE
    assert est.lambda_k == pytest.approx(lam[2], abs=0.06)
    assert est.lambda_k1 == pytest.approx(lam[3], abs=0.06)
    assert lam[3] < est.cutoff < lam[2]
    count = tcomp.eigencount(est.moments, est.probes, est.cutoff)
    assert count == pytest.approx(3.0, abs=0.75)
    # with the reference's probe block: its moments and its cutoff
    jest, _ = jcomp.estimate_lambda_k(jz, 3, key)
    probes = _np(jz.random_tall(key, jcomp.COUNT_PROBES, dist="rademacher"))
    test, _ = tcomp.estimate_lambda_k(tz, 3, 0, probe_block=probes)
    np.testing.assert_allclose(test.moments, jest.moments, rtol=0,
                               atol=1e-4 * np.abs(jest.moments).max())
    assert test.cutoff == pytest.approx(jest.cutoff, abs=1e-4)
    assert test.probes == jest.probes


def test_lambda_k_estimation_degenerate(degenerate):
    jz, tz, lam = degenerate
    key = jax.random.PRNGKey(0)
    probes = _np(jz.random_tall(key, jcomp.COUNT_PROBES, dist="rademacher"))
    est, _ = tcomp.estimate_lambda_k(tz, 2, 0, probe_block=probes)
    jest, _ = jcomp.estimate_lambda_k(jz, 2, key)
    assert est.lambda_k == pytest.approx(lam[1], abs=0.05)
    assert est.lambda_k1 == pytest.approx(lam[2], abs=0.05)
    assert est.lambda_k1 <= est.cutoff <= est.lambda_k
    assert 24 <= tcomp.default_filter_degree(est) <= 96
    assert est.cutoff == pytest.approx(jest.cutoff, abs=1e-4)


def test_cutoff_on_poker_shaped_rows_matches_reference():
    """Poker-shaped rows (paper Table 1's d = 10, K = 10, blobs; 4,000
    rows, R = 32, d_g = 64, so D = 2,048 < N): with the reference's probe
    block the port's moments are the reference's within 1e-4 relative of
    the largest, and the port's bisection on the reference's moments gives
    the reference's λ_K, λ_K+1 and cutoff to 1e-12. The port's own cutoff
    is held within 1e-3 of the reference's: the smoothed count is nearly
    flat at its crossings here, so float32 differences in the moments move
    the bisection by a few 1e-4. Both cutoffs are printed beside θ_K and
    θ_K+1 of a LOBPCG solve (``pytest -s``); neither is held to that
    bracket, which the N − D null eigenvalues' share of the count can move
    it out of."""
    from repro.core.rb import suggest_sigma
    from repro.data.synthetic import SuiteSpec, generate

    k = 10
    x, _ = generate(SuiteSpec("poker", 10, k, 1_025_010, "blobs"),
                    scale=4000 / 1_025_010, seed=0)
    x = np.asarray(x, np.float32)
    kw = dict(n_clusters=k, n_grids=32, sigma=float(suggest_sigma(x)),
              d_g=64, seed=0)
    jz, tz, key = _rows(x, cfg=(jexec.SCRBConfig(**kw),
                                texec.SCRBConfig(**kw)))
    jest, _ = jcomp.estimate_lambda_k(jz, k, key)
    probes = _np(jz.random_tall(key, jcomp.COUNT_PROBES, dist="rademacher"))
    test, _ = tcomp.estimate_lambda_k(tz, k, 0, probe_block=probes)
    np.testing.assert_allclose(test.moments, jest.moments, rtol=0,
                               atol=1e-4 * np.abs(jest.moments).max())
    lam_k = tcomp._bisect_count(jest.moments, jest.probes, k - 0.5)
    lam_k1 = tcomp._bisect_count(jest.moments, jest.probes, k + 0.5)
    assert lam_k == pytest.approx(jest.lambda_k, abs=1e-12)
    assert lam_k1 == pytest.approx(jest.lambda_k1, abs=1e-12)
    assert 0.5 * (lam_k + lam_k1) == pytest.approx(jest.cutoff, abs=1e-12)
    assert test.cutoff == pytest.approx(jest.cutoff, abs=1e-3)
    eig = top_k_eigenpairs(tz.gram, tz.n, k + 1,
                           torch.Generator().manual_seed(1), tol=1e-5,
                           max_iters=500)
    theta = eig.theta.numpy()
    print(f"poker-shaped, N={tz.n}, D={kw['n_grids'] * kw['d_g']}: "
          f"reference cutoff {jest.cutoff:.6f} (lambda_k {jest.lambda_k:.6f}"
          f", lambda_k1 {jest.lambda_k1:.6f}), port cutoff "
          f"{test.cutoff:.6f}; LOBPCG theta_K {theta[k - 1]:.6f}, "
          f"theta_K+1 {theta[k]:.6f} (resnorm max "
          f"{float(eig.resnorms.max()):.2g})")


# --------------------------------------------------------------------------
# the whole cell, draws injected, against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chunk_size", [None, 48])
def test_injected_draws_reproduce_the_reference(clustered, chunk_size):
    """The reference's probe, signal and subset draws and k-means seeds
    through the port's cell, on device rows and on host chunks: the same
    cutoff and filter degree, the embedding within float32 tolerance, the
    Ritz values and labels of the reference's executor run."""
    x, _, _, _, key, _, _ = clustered
    jcfg, tcfg = _cfgs(chunk_size, solver="compressive")
    jz, tz, _ = _rows(x, chunk_size, cfg=(jcfg, tcfg))
    jres = jexec.execute(jnp.asarray(x), jcfg, keep_state=True)
    probes, signals, rows, ckey = _ref_draws(jz, key, 3, jcfg)

    comp = tcomp.compressive_embed(tz, 3, 0, tcfg, probe_block=probes,
                                   signal_block=signals)
    jd = jres.diagnostics["compressive"]
    assert comp.estimate.cutoff == pytest.approx(jd["cutoff"], abs=1e-4)
    assert comp.filter_degree == jd["filter_degree"]
    assert comp.signals == jd["signals"]
    jemb = _np(jres.state["u_hat"])
    u_hat = tz.map_row_chunks(t_row_normalize, comp.embedding)
    if chunk_size is not None:
        assert isinstance(u_hat, tstreaming.ChunkedDense)
        assert u_hat.chunk_sizes == tz.store.chunk_sizes
    np.testing.assert_allclose(_np(u_hat), jemb, rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.sqrt(np.maximum(comp.theta[:3], 0)),
                               jres.singular_values, rtol=1e-4)

    sub = _np(jres.state["u_hat"])[rows]
    init = _ref_seeds(ckey, sub, 3, jcfg.kmeans_replicates)
    km, diag = tcomp.subset_cluster(tz, u_hat, 0, tcfg, rows=rows,
                                    init=torch.from_numpy(init))
    assert diag == {"kmeans_subset_rows": rows.shape[0]}
    ari = metrics.adjusted_rand_index(km.labels.numpy(), jres.labels)
    assert ari >= 0.99, ari


def test_compressive_clusters_and_reports(clustered):
    x, y, _, _, _, lam, _ = clustered
    jcfg, tcfg = _cfgs(solver="compressive")
    res = texec.execute(x, tcfg, device="cpu")
    assert metrics.accuracy(res.labels, y) > 0.95
    d = res.diagnostics
    assert d["solver"] == "compressive"
    assert d["solver_requested"] == "compressive"
    comp = d["compressive"]
    assert lam[3] < comp["cutoff"] < lam[2]
    assert comp["signals"] >= 4
    assert d["solver_iterations"] == (tcomp.COUNT_DEGREE
                                      + comp["filter_degree"] + 3)
    assert np.asarray(d["solver_resnorms"]).shape == (3,)
    assert np.asarray(d["solver_resnorms"]).max() < 0.05
    assert np.asarray(res.singular_values).shape == (3,)
    assert res.singular_values[0] == pytest.approx(1.0, abs=1e-2)
    # the reference's diagnostics keys (its run is held label for label in
    # test_injected_draws_reproduce_the_reference)
    jres = jexec.execute(jnp.asarray(x), jcfg)
    assert set(d["compressive"]) == set(jres.diagnostics["compressive"])
    assert set(d) >= set(jres.diagnostics) - {"memory"}


def test_lambda_warm_start_skips_eigencount(clustered):
    x, y, _, _, _, _, _ = clustered
    _, cold_cfg = _cfgs(solver="compressive")
    cold = texec.execute(x, cold_cfg, device="cpu")
    cd = cold.diagnostics["compressive"]
    _, cfg = _cfgs(solver="compressive",
                   compressive_lambdas=(cd["lambda_k"], cd["lambda_k1"]))
    warm = texec.execute(x, cfg, device="cpu")
    wd = warm.diagnostics["compressive"]
    assert wd["probes"] == 0
    assert warm.diagnostics["solver_iterations"] == wd["filter_degree"] + 3
    assert wd["cutoff"] == pytest.approx(
        0.5 * (cd["lambda_k"] + cd["lambda_k1"]))
    assert metrics.accuracy(warm.labels, cold.labels) == pytest.approx(1.0)
    assert metrics.accuracy(warm.labels, y) > 0.95


def test_chunked_vs_device_label_parity(clustered):
    x = clustered[0]
    _, cfg = _cfgs(solver="compressive")
    dev = texec.execute(x, cfg, device="cpu")
    cfg_c = dataclasses.replace(cfg, chunk_size=48)
    chu = texec.execute(x, cfg_c, device="cpu")
    assert metrics.accuracy(chu.labels, dev.labels) == pytest.approx(1.0)
    d = chu.diagnostics
    sig = d["compressive"]["signals"]
    assert d["embedding_device_bytes_peak"] == 48 * 4 * sig
    assert d["embedding_device_bytes_peak"] < x.shape[0] * 4 * 3


def test_chunked_draws_do_not_depend_on_prefetch(clustered):
    """A host-chunked random block comes from the generator alone, chunk
    after chunk: the same with and without prefetch, aligned with the
    ELL chunking."""
    x = clustered[0]
    blocks = []
    for prefetch in (True, False):
        _, tcfg = _cfgs(48, prefetch=prefetch)
        _, tz, _ = _rows(x, 48, cfg=(_cfgs(48)[0], tcfg))
        assert tz.store.prefetch == prefetch
        blk = tz.random_tall(torch.Generator().manual_seed(5), 32,
                             dist="rademacher")
        assert blk.chunk_sizes == tz.store.chunk_sizes
        blocks.append(blk.to_array())
    np.testing.assert_array_equal(blocks[0], blocks[1])
    assert set(np.unique(blocks[0])) == {-1.0, 1.0}


def test_auto_routing_by_n(clustered):
    x = clustered[0]
    _, small = _cfgs(solver="auto")
    assert texec.effective_solver(small, x.shape[0]) != "compressive"
    routed = dataclasses.replace(small, compressive_auto_n=100)
    assert texec.effective_solver(routed, x.shape[0]) == "compressive"
    assert texec.effective_solver(
        dataclasses.replace(small, compressive_auto_n=None), 10**9) != \
        "compressive"
    res = texec.execute(x, routed, device="cpu")
    assert res.diagnostics["solver"] == "compressive"
    assert res.diagnostics["solver_requested"] == "auto"


def test_model_oos_path_reproduces_fit(clustered):
    x = clustered[0]
    _, cfg = _cfgs(solver="compressive")
    model = tmodel.SCRBModel.fit(x, cfg, device="cpu")
    np.testing.assert_array_equal(model.predict(x), model.fit_result.labels)
    emb = model.transform(x)
    assert np.abs(emb - np.asarray(model.fit_result.embedding)).max() < 1e-5
    np.testing.assert_array_equal(_np(model.singular_values),
                                  np.ones(model.right_vectors.shape[1]))


def test_compressive_artifact_cross_loads_both_ways(clustered, tmp_path):
    x = clustered[0]
    jcfg, tcfg = _cfgs(solver="compressive")
    tm = tmodel.SCRBModel.fit(x, tcfg, device="cpu")
    path = str(tmp_path / "port.npz")
    tm.save(path)
    jm = jmodel.SCRBModel.load(path)
    np.testing.assert_array_equal(jm.predict(x), tm.predict(x))
    jm2 = jmodel.SCRBModel.fit(jnp.asarray(x), jcfg)
    path2 = str(tmp_path / "ref.npz")
    jm2.save(path2)
    tm2 = tmodel.SCRBModel.load(path2, device="cpu")
    np.testing.assert_array_equal(tm2.predict(x), jm2.predict(x))
    np.testing.assert_allclose(tm2.transform(x[:64]), jm2.transform(x[:64]),
                               atol=1e-5)


def test_k_auto_rejects_compressive(clustered):
    x = clustered[0]
    _, cfg = _cfgs(solver="compressive")
    with pytest.raises(ValueError, match="spectrum"):
        tmodel.SCRBModel.fit(x, cfg, k="auto", device="cpu")


def test_eigensolver_rejects_compressive(clustered):
    tz = clustered[3]
    with pytest.raises(ValueError, match="compressive"):
        top_k_eigenpairs(tz.gram, tz.n, 3, torch.Generator(),
                         solver="compressive")


def test_compressive_requires_laplacian_normalize(clustered):
    tz = clustered[3]
    _, cfg = _cfgs(solver="compressive")
    with pytest.raises(ValueError, match="laplacian_normalize"):
        tcomp.compressive_embed(tz, 3, 0, cfg, laplacian_normalize=False)


@pytest.mark.parametrize("chunk_size", [None, 48])
def test_row_matrix_tall_surface_matches_reference(clustered, chunk_size):
    """``matvec_tall``, ``gram`` on a 32-wide block and ``reduce`` of both
    row matrices against the reference's, on the same grids."""
    x = clustered[0]
    jz, tz, _ = _rows(x, chunk_size)
    rng = np.random.default_rng(7)
    v = rng.normal(size=(tz.degree_dual().shape[0], 5)).astype(np.float32)
    got = tz.matvec_tall(torch.from_numpy(v))
    assert isinstance(got, tstreaming.ChunkedDense) == (chunk_size is not None)
    np.testing.assert_allclose(_np(got), _np(jz.matvec_tall(jnp.asarray(v))),
                               atol=1e-5)
    u = rng.normal(size=(tz.n, 32)).astype(np.float32)
    tu = tcomp._as_tall(tz, u)
    ju = jnp.asarray(u) if chunk_size is None else \
        jstreaming.ChunkedDense.from_array(u, tz.store.chunk_sizes)
    np.testing.assert_allclose(_np(tz.gram(tu)), _np(jz.gram(ju)), atol=1e-5)
    colsum = lambda acc, c: acc + c.sum(0)
    np.testing.assert_allclose(
        _np(tz.reduce(colsum, torch.zeros(32), tu)),
        np.asarray(jz.reduce(colsum, jnp.zeros(32), ju)), rtol=1e-5,
        atol=1e-4)
