"""The port's dense feature maps and Table-2 methods against the JAX
package's, on the CPU.

Inputs are made with numpy from a seed; every random draw of the reference
(RFF frequencies and phases, Nyström landmarks, LSC anchors, RB grids, the
LOBPCG start block) is injected into the port. Tolerances: RFF features
within 1e-6 (sqrt(2/R) ≤ 0.125, a cosine of a sum taken in another
order); kernel blocks within 1e-6 relative; the Laplacian Nyström
whitener and features within 1e-5 (K_mm's smallest eigenvalue is near
0.18 here); the Gaussian Nyström features within 1e-3 of their largest
value (K_mm's smallest eigenvalue is 3e-4 there, and eigh's float32
rounding grows as 1/λ_min); LSC's anchors and kept pattern exact and its
values within 1e-6; dense products within 1e-5 relative; labels of whole
methods by ARI ≥ 0.99 against the reference, no accuracy pinned to a seed
(ROADMAP.md C3). The port's own promises are held bit for bit: a row's
features whatever its batch, and the host-chunked dense store the same
bits for any chunking.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

from repro.core import baselines as jbase
from repro.core import executor as jexec
from repro.core import featuremap as jfm
from repro.core import model as jmodel
from repro.core import nystrom as jnys
from repro.core import rff as jrff
from repro.core.eigensolver import lobpcg_block_width
from repro.core.options import SolverOptions as JSolverOptions
from repro.data.synthetic import make_blobs
from repro.utils import fold_key
from repro_torch.core import baselines as tbase
from repro_torch.core import executor as texec
from repro_torch.core import featuremap as tfm
from repro_torch.core import metrics
from repro_torch.core import model as tmodel
from repro_torch.core import nystrom as tnys
from repro_torch.core import rb as trb
from repro_torch.core import rff as trff
from repro_torch.core import streaming as tstream

SIGMA = 1.5
CFG = dict(n_clusters=4, rank=128, sigma=SIGMA, kmeans_replicates=10, seed=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: torch's intra-op threads only contend, most of all with
    the other test processes of a parallel run."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def blobs():
    return make_blobs(600, 6, 4, seed=0)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


# -- registry ---------------------------------------------------------------

def test_registry_keys_match_reference():
    assert set(tfm.FEATURE_MAPS) == set(jfm.FEATURE_MAPS)
    assert list(tbase.METHODS) == list(jbase.METHODS)
    assert tbase.METHOD_FEATURE_MAPS == jbase.METHOD_FEATURE_MAPS
    for name in tfm.FEATURE_MAPS:
        assert tfm.make_feature_map(name, rank=8, sigma=1.0).name == name
    with pytest.raises(ValueError, match="unknown feature map"):
        tfm.make_feature_map("rbf", rank=8, sigma=1.0)


# -- kernel blocks and maps -------------------------------------------------

@pytest.mark.parametrize("kernel", ["gaussian", "laplacian"])
def test_rff_transform_from_reference_params(blobs, kernel):
    x, _ = blobs
    p = jrff.make_rff_params(jax.random.PRNGKey(1), 128, x.shape[1], SIGMA,
                             kernel=kernel)
    want = np.asarray(jrff.rff_transform(jnp.asarray(x), p))
    got = trff.rff_transform(_t(x), trff.RFFParams(_t(p.w), _t(p.b)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("kernel", ["gaussian", "laplacian"])
def test_rff_draws(kernel):
    """The port's own draws: the shapes, phases in [0, 2π), the same draws
    from the same seed, and E[z zᵀ] near the kernel on a pair of points."""
    p = trff.make_rff_params(7, 4096, 3, SIGMA, kernel=kernel)
    q = trff.make_rff_params(7, 4096, 3, SIGMA, kernel=kernel)
    assert p.w.shape == (3, 4096) and p.b.shape == (4096,)
    assert torch.equal(p.w, q.w) and torch.equal(p.b, q.b)
    assert float(p.b.min()) >= 0.0 and float(p.b.max()) < 2 * np.pi
    pts = torch.tensor([[0.0, 0.0, 0.0], [0.5, -0.3, 0.2]])
    z = trff.rff_transform(pts, p)
    want = tnys.pairwise_kernel(pts[:1], pts[1:], SIGMA, kernel)
    assert abs(float(z[0] @ z[1]) - float(want)) < 0.05


@pytest.mark.parametrize("kernel", ["gaussian", "laplacian"])
def test_pairwise_kernel_matches_reference(blobs, kernel):
    x, _ = blobs
    y = x[::7]
    want = np.asarray(jnys.pairwise_kernel(jnp.asarray(x), jnp.asarray(y),
                                           SIGMA, kernel))
    got = tnys.pairwise_kernel(_t(x), _t(y), SIGMA, kernel).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kernel", ["gaussian", "laplacian"])
def test_pairwise_kernel_blocked_equals_unblocked(blobs, kernel, monkeypatch):
    """Row blocks of any size (here 8 rows: a 2 KB difference block) give
    the one-block broadcast form's values; a block's row count depends on
    (m, d) alone."""
    x, _ = blobs
    xt, yt = _t(x), _t(x[::5])
    whole = tnys._kernel_block(xt, yt, SIGMA, kernel)
    monkeypatch.setattr(tnys, "BLOCK_BYTES", 8 * yt.shape[0] * 6 * 4)
    monkeypatch.setattr(tnys, "ROW_TILE", 8)
    assert tnys.kernel_tile_rows(yt.shape[0], 6, "laplacian") == 8
    blocked = tnys.pairwise_kernel(xt, yt, SIGMA, kernel)
    np.testing.assert_allclose(blocked.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-7)
    monkeypatch.undo()
    assert tnys.kernel_tile_rows(256, 54, "laplacian") == 4096
    assert tnys.kernel_tile_rows(8192, 54, "laplacian") == 128
    assert tnys.kernel_tile_rows(8192, 54, "gaussian") == 4096
    with pytest.raises(ValueError, match="unknown kernel"):
        tnys.pairwise_kernel(xt, yt, SIGMA, "cosine")


@pytest.mark.parametrize("kernel,rank,rel", [("laplacian", 64, None),
                                             ("laplacian", 128, None),
                                             ("gaussian", 64, 1e-3)])
def test_nystrom_map_from_reference_landmarks(blobs, kernel, rank, rel):
    x, _ = blobs
    key = jax.random.PRNGKey(0)
    jmap = jfm.make_feature_map("nystrom", rank=rank, sigma=SIGMA,
                                kernel=kernel).fit(key, jnp.asarray(x))
    # the port's selection from the reference's sample seed is the same
    lm = trb._gather_sample(x, rank, seed=jfm._seed_from_key(key, "nystrom"))
    np.testing.assert_array_equal(lm, np.asarray(jmap.landmarks))
    tmap = tfm.NystromMap(rank=rank, sigma=SIGMA, kernel=kernel)\
        .with_landmarks(_t(jmap.landmarks))
    want = np.asarray(jmap.transform(jnp.asarray(x)))
    got = tmap.transform(_t(x)).numpy()
    if rel is None:
        np.testing.assert_allclose(tmap.whiten.numpy(),
                                   np.asarray(jmap.whiten), atol=1e-5)
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("kernel", ["gaussian", "laplacian"])
def test_lsc_map_from_reference_anchors(blobs, kernel):
    x, _ = blobs
    key = jax.random.PRNGKey(0)
    jmap = jfm.make_feature_map("lsc", rank=64, sigma=SIGMA,
                                kernel=kernel).fit(key, jnp.asarray(x))
    anchors = tfm.lloyd_anchors(x, 64, jfm._seed_from_key(key, "lsc"))
    np.testing.assert_array_equal(anchors.astype(np.float32),
                                  np.asarray(jmap.anchors))
    tmap = tfm.LSCMap(rank=64, sigma=SIGMA, kernel=kernel,
                      anchors=_t(jmap.anchors))
    want = np.asarray(jmap.transform(jnp.asarray(x)))
    got = tmap.transform(_t(x)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    assert (got > 0).sum(1).min() >= 5
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("name", ["rff", "nystrom", "lsc"])
def test_dense_transform_is_batch_invariant(blobs, name):
    """A row's features have the same bits alone, in a small batch, in a
    batch that spans two row tiles, and at another offset."""
    x, _ = blobs
    fm = tfm.make_feature_map(name, rank=64, sigma=SIGMA).fit(
        3, np.concatenate([x] * 8))
    xs = _t(np.concatenate([x] * 8))               # 4,800 rows: two tiles
    whole = fm.transform(xs)
    for a, b in ((0, 1), (5, 6), (17, 80), (4090, 4100), (100, 4800)):
        assert torch.equal(fm.transform(xs[a:b]), whole[a:b]), (a, b)
    dual = torch.rand(64, generator=torch.Generator().manual_seed(0))
    deg = fm.oos_degrees(whole, dual)
    assert torch.equal(fm.oos_degrees(whole[3:9], dual), deg[3:9])


# -- dense operands ---------------------------------------------------------

@pytest.mark.parametrize("laplacian", [True, False])
def test_normalized_dense_features_matvecs(blobs, laplacian):
    x, _ = blobs
    phi = np.asarray(jrff.rff_transform(jnp.asarray(x), jrff.make_rff_params(
        jax.random.PRNGKey(2), 64, x.shape[1], SIGMA, kernel="gaussian")))
    phi = np.abs(phi) + 0.01                 # positive degrees: a kernel's
    jnd = jfm.build_normalized_dense(jnp.asarray(phi), laplacian=laplacian)
    tnd = tfm.build_normalized_dense(_t(phi), laplacian=laplacian)
    rng = np.random.default_rng(0)
    u = rng.normal(size=(600, 5)).astype(np.float32)
    v = rng.normal(size=(64, 5)).astype(np.float32)
    for got, want in ((tnd.colsum, jnd.colsum), (tnd.deg, jnd.deg),
                      (tnd.rowscale, jnd.rowscale),
                      (tnd.rmatmat(_t(u)), jnd.rmatmat(jnp.asarray(u))),
                      (tnd.matmat(_t(v)), jnd.matmat(jnp.asarray(v))),
                      (tnd.gram_matvec(_t(u)),
                       jnd.gram_matvec(jnp.asarray(u)))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_chunked_dense_bit_identical_across_chunkings(blobs, monkeypatch):
    """The host-chunked store (row tiles of 64 rows for the sums) gives the
    same bits for the whole matrix and for chunks of 100, 128 and 77 rows:
    the degree dual, degrees, row scales and every product; Φᵀ1 and the
    degrees also equal the device store's at the same tile; the products
    are the reference's chunked store's within 1e-5 relative."""
    x, _ = blobs
    fm = tfm.make_feature_map("nystrom", rank=48, sigma=SIGMA).fit(1, x)
    phi = fm.transform(_t(x))
    rng = np.random.default_rng(1)
    u = rng.normal(size=(600, 3)).astype(np.float32)
    v = _t(rng.normal(size=(48, 3)))
    monkeypatch.setattr(tfm, "ROW_TILE", 64)
    out = {}
    for chunk in (None, 100, 128, 77):
        store = tfm.build_chunked_dense(tstream.as_row_chunks(phi, chunk),
                                        device="cpu")
        uc = tstream.ChunkedDense.from_array(u, store.chunk_sizes)
        out[chunk] = [store.colsum, store.deg,
                      torch.cat(store.rowscale_chunks),
                      store.rmatmat_chunked(uc),
                      _t(store.matmat_chunked(v).to_array()),
                      _t(store.gram_matvec_chunked(uc).to_array())]
    for chunk in (100, 128, 77):
        for got, want in zip(out[chunk], out[None]):
            assert torch.equal(got, want), chunk
    dev = tfm.build_normalized_dense(phi)
    assert torch.equal(dev.colsum, out[None][0])
    assert torch.equal(dev.deg, out[None][1])
    ref = jfm.build_chunked_dense(
        [np.asarray(phi[i:i + 100]) for i in range(0, 600, 100)])
    want = np.asarray(ref.rmatmat(jnp.asarray(u)))
    np.testing.assert_allclose(out[100][3].numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    want = np.asarray(ref.matmat(jnp.asarray(v.numpy())))
    np.testing.assert_allclose(out[100][4].numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# -- whole methods ----------------------------------------------------------

def _x0(n: int, k: int, seed: int) -> np.ndarray:
    """The reference's LOBPCG start block of a fit with this seed."""
    b = lobpcg_block_width(n, k, JSolverOptions().buffer)
    return np.asarray(jax.random.normal(
        fold_key(jax.random.PRNGKey(seed), "eig"), (n, b), jnp.float32))


def _reference_map(name: str, cfg: dict, x):
    """The map the reference's runner fits (key PRNGKey(seed)), and the
    same map in the port."""
    fm_name = jbase.METHOD_FEATURE_MAPS[name]
    if fm_name == "rb":
        jmap = jfm.RBMap(n_grids=cfg["rank"], sigma=cfg["sigma"]).fit(
            jax.random.PRNGKey(cfg["seed"]), jnp.asarray(x))
    else:
        jmap = jfm.make_feature_map(fm_name, rank=cfg["rank"],
                                    sigma=cfg["sigma"]).fit(
            jax.random.PRNGKey(cfg["seed"]), jnp.asarray(x))
    return jmap, tfm.load_fitted(jmap.meta_dict(), jmap.state_dict(),
                                 device="cpu")


@pytest.mark.parametrize("name", ["sc_rf", "sv_rf", "sc_nys", "sc_lsc",
                                  "sc_rb", "csc_rb"])
def test_spectral_methods_match_reference(blobs, name):
    """Each spectral method through the executor, the reference's map and
    start block injected: the same five stages and the reference's labels
    by ARI."""
    x, _ = blobs
    jcfg, tcfg = jbase.BaselineConfig(**CFG), tbase.BaselineConfig(**CFG)
    want = jbase.METHODS[name](jnp.asarray(x), jcfg)
    _, tmap = _reference_map(name, CFG, x)
    got = tbase.METHODS[name](x, tcfg, device="cpu", feature_map=tmap,
                              x0=_x0(600, 4, CFG["seed"]))
    for stage in ("rb_features", "degrees", "svd", "normalize", "kmeans"):
        assert stage in got.timer.times
    assert metrics.adjusted_rand_index(got.labels, want.labels) >= 0.99


@pytest.mark.parametrize("name", ["kk_rf", "kk_rs"])
def test_feature_kmeans_methods_match_reference(blobs, name):
    """Kernel k-means in the reference's feature space (its map injected;
    10 k-means replicates each): the reference's labels by ARI, and the
    same labels twice."""
    x, _ = blobs
    jcfg, tcfg = jbase.BaselineConfig(**CFG), tbase.BaselineConfig(**CFG)
    want = jbase.METHODS[name](jnp.asarray(x), jcfg)
    _, tmap = _reference_map(name, CFG, x)
    got = tbase.METHODS[name](x, tcfg, device="cpu", feature_map=tmap)
    assert set(got.timer.times) == {"features", "kmeans"}
    assert metrics.adjusted_rand_index(got.labels, want.labels) >= 0.99
    again = tbase.METHODS[name](x, tcfg, device="cpu", feature_map=tmap)
    np.testing.assert_array_equal(got.labels, again.labels)


@pytest.mark.parametrize("name", ["kmeans", "sc"])
def test_methods_without_a_map_match_reference(blobs, name):
    x, _ = blobs
    jcfg, tcfg = jbase.BaselineConfig(**CFG), tbase.BaselineConfig(**CFG)
    want = jbase.METHODS[name](jnp.asarray(x), jcfg)
    got = tbase.METHODS[name](x, tcfg, device="cpu")
    assert set(got.timer.times) == set(want.timer.times)
    assert metrics.adjusted_rand_index(got.labels, want.labels) >= 0.99


def test_csc_rb_resolves_to_lobpcg_as_the_reference_does(blobs):
    """csc_rb asks for solver="compressive" and, in both packages, the
    normalized config's flat solver mirror wins: the runner runs LOBPCG
    (ROADMAP.md C6); its labels are held to the reference's runner in
    test_spectral_methods_match_reference. What the name asks for, the
    compressive cell, is held here against the reference's executor with
    solver="compressive" on the same grids, by ARI."""
    x, _ = blobs
    jbase_cfg = jbase._scrb_config(jbase.BaselineConfig(**CFG))
    jrunner = dataclasses.replace(   # as repro's csc_rb_baseline builds it
        jbase_cfg, solver_options=dataclasses.replace(
            jbase_cfg.solver_options, solver="compressive"))
    tcfg = tbase._csc_rb_config(tbase.BaselineConfig(**CFG))
    assert jrunner.solver_options.solver == "lobpcg"
    assert tcfg.solver_options.solver == "lobpcg"
    jmap, tmap = _reference_map("csc_rb", CFG, x)
    jcell = jexec.SCRBConfig(
        n_clusters=4, n_grids=CFG["rank"], sigma=SIGMA,
        kmeans_replicates=CFG["kmeans_replicates"], seed=0,
        solver_options=JSolverOptions(solver="compressive"))
    want = jexec.execute(jnp.asarray(x), jcell,
                         jexec.ExecutionPlan(feature_map=jmap))
    assert want.diagnostics["solver"] == "compressive"
    tcell = texec.SCRBConfig(
        n_clusters=4, n_grids=CFG["rank"], sigma=SIGMA,
        kmeans_replicates=CFG["kmeans_replicates"], seed=0,
        solver_options=texec.SolverOptions(solver="compressive"))
    got = texec.execute(x, tcell, texec.ExecutionPlan(feature_map=tmap),
                        device="cpu")
    assert got.diagnostics["solver"] == "compressive"
    assert metrics.adjusted_rand_index(got.labels, want.labels) >= 0.99


def test_dense_chunked_fit_matches_device_fit(blobs):
    """A host-chunked fit of a dense map (chunks of 250 rows) against the
    device-resident one with the same map: the same degrees bit for bit,
    the leading Ritz values within 1e-4, labels by ARI ≥ 0.99."""
    x, _ = blobs
    fm = tfm.make_feature_map("nystrom", rank=64, sigma=SIGMA).fit(0, x)
    cfg = texec.SCRBConfig(n_clusters=4, n_grids=64, sigma=SIGMA,
                           kmeans_replicates=4)
    dev = texec.execute(x, cfg, texec.ExecutionPlan(feature_map=fm),
                        keep_state=True, device="cpu")
    chunked = texec.execute(
        x, cfg, texec.ExecutionPlan(feature_map=fm, residency="host_chunked",
                                    chunk_size=250),
        keep_state=True, device="cpu")
    assert torch.equal(chunked.state["z"].store.deg, dev.state["z"].adj.deg)
    assert chunked.diagnostics["n_chunks"] == 3
    assert chunked.diagnostics["nnz"] == 600 * 64
    np.testing.assert_allclose(chunked.singular_values, dev.singular_values,
                               atol=1e-4)
    assert metrics.adjusted_rand_index(chunked.labels, dev.labels) >= 0.99


@pytest.mark.parametrize("fm_name,lap", [("rff", False), ("nystrom", True),
                                         ("lsc", True)])
def test_dense_artifacts_cross_load(blobs, tmp_path, fm_name, lap):
    """A dense-map model saved by either package predicts, in the other,
    the labels it predicts at home; save → load in the port is
    bit-identical."""
    x, _ = blobs
    kw = dict(n_clusters=4, n_grids=64, sigma=SIGMA, kmeans_replicates=2)
    jm = jmodel.SCRBModel.fit(
        jnp.asarray(x), jexec.SCRBConfig(**kw),
        plan=jexec.ExecutionPlan(feature_map=jfm.make_feature_map(
            fm_name, rank=64, sigma=SIGMA), laplacian_normalize=lap))
    jm.save(str(tmp_path / "j.npz"))
    loaded = tmodel.SCRBModel.load(str(tmp_path / "j.npz"), device="cpu")
    assert loaded.feature_map.name == fm_name
    np.testing.assert_array_equal(loaded.predict(x), jm.predict(x))

    tm = tmodel.SCRBModel.fit(
        x, texec.SCRBConfig(**kw),
        plan=texec.ExecutionPlan(feature_map=tfm.make_feature_map(
            fm_name, rank=64, sigma=SIGMA), laplacian_normalize=lap),
        device="cpu")
    tm.save(str(tmp_path / "t.npz"))
    back = jmodel.SCRBModel.load(str(tmp_path / "t.npz"))
    assert back.data_dim == tm.data_dim == 6
    np.testing.assert_array_equal(back.predict(x), tm.predict(x))
    again = tmodel.SCRBModel.load(str(tmp_path / "t.npz"), device="cpu")
    np.testing.assert_array_equal(again.predict(x), tm.predict(x))
    np.testing.assert_array_equal(again.transform(x), tm.transform(x))
