"""The port's host-chunked (streaming) fit against the JAX package's.

On the CPU the port's wrappers take their plain versions. The same numpy
inputs go through both packages, and every random draw of the reference is
injected into the port (RB params through ``RBMap.from_state``, the LOBPCG
start block as an (N, b) array, k-means seeds through
``streaming_kmeans(init=...)``). Tolerances: bin counts, ELL indices and
labels under given centroids exact; degrees bit-identical across the
port's chunkings and within one float32 ulp of the reference's (the row
sums of counts stay below 2^24 here, so they are exact in any order, but
XLA's ``/ R`` rounds as a product by 1/R); chunked products within 2e-5
(float32, another summation order); Ritz values within rtol 1e-4 and
principal-angle cosines ≥ 1 − 1e-3 (both solves stop at tol 1e-3); row
normalization within 1e-6 of the reference (not bits: XLA's CPU result
depends on the shape, ROADMAP.md C4) and bit-identical across the port's
own chunkings; whole-fit labels ≥ 0.99 agreement and k-means inertia
within rtol 1e-4.
"""
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
from repro.core import graph as jgraph
from repro.core import model as jmodel
from repro.core import rb as jrb
from repro.core import streaming as jst
from repro.core.eigensolver import lobpcg_block_width
from repro.core.options import SolverOptions as JSolverOptions
from repro.data.synthetic import make_blobs, make_rings
from repro.kernels import ops as jops
from repro.utils import fold_key
from repro_torch.core import eigensolver as teig
from repro_torch.core import executor as texec
from repro_torch.core import featuremap as tfm
from repro_torch.core import graph as tgraph
from repro_torch.core import metrics
from repro_torch.core import model as tmodel
from repro_torch.core import rowmatrix as trow
from repro_torch.core import streaming as tst
from repro_torch.core.options import SolverOptions as TSolverOptions
from repro_torch.kernels import ops
from repro_torch.utils import prefetch_to_device

# the package __init__ files re-export a ``kmeans`` function over the module
jkm = importlib.import_module("repro.core.kmeans")
jeig = importlib.import_module("repro.core.eigensolver")
tkm = importlib.import_module("repro_torch.core.kmeans")


def _ell(seed, n, r, d_g):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, d_g, size=(n, r))
            + np.arange(r)[None, :] * d_g).astype(np.int32)


def _chunks(a, size):
    return [a[i:i + size] for i in range(0, a.shape[0], size)]


# --------------------------------------------------------------------------
# bin_counts
# --------------------------------------------------------------------------

# tests/test_kernels.py::test_bin_counts_matches_exact's grids
BIN_GRIDS = [(64, 4, 64), (101, 8, 2), (100, 8, 1024)]


@pytest.mark.parametrize("n,r,d_g", BIN_GRIDS)
@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
def test_bin_counts_matches_reference(n, r, d_g, jimpl):
    """Bit for bit against the reference's scatter and its Pallas route
    (the zt kernel with unit weights, interpret mode)."""
    idx = _ell(n + r, n, r, d_g)
    d = r * d_g
    want = np.asarray(jops.bin_counts(jnp.asarray(idx), d=d, d_g=d_g,
                                      impl=jimpl))
    got = ops.bin_counts(torch.from_numpy(idx), d=d, d_g=d_g)
    assert got.dtype == torch.int32 and got.shape == (d,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.bincount(idx.reshape(-1),
                                                    minlength=d))


@pytest.mark.parametrize("chunk", [7, 32, 100])
def test_bin_counts_chunked_sum_equals_single_shot(chunk):
    """Adding each chunk's counts into one buffer (``out=``) gives the
    single-shot counts, as the reference's chunked counts do."""
    n, r, d_g = 101, 8, 64
    idx = _ell(3, n, r, d_g)
    d = r * d_g
    single = ops.bin_counts(torch.from_numpy(idx), d=d, d_g=d_g)
    out = torch.zeros((d,), dtype=torch.int32)
    for c in _chunks(idx, chunk):
        assert ops.bin_counts(torch.from_numpy(c), d=d, d_g=d_g,
                              out=out) is out
    assert torch.equal(out, single)
    want = jst.chunked_bin_counts(_chunks(idx, chunk), d=d, d_g=d_g)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    got = tst.chunked_bin_counts([torch.from_numpy(c) for c in
                                  _chunks(idx, chunk)], d=d, d_g=d_g,
                                  device="cpu")
    assert torch.equal(got, single)


def test_bin_counts_drops_columns_past_d_and_checks_out():
    """A column ≥ D is dropped, as the reference's scatter drops it; a
    wrong ``out`` raises."""
    idx = _ell(5, 40, 4, 16)
    idx[3, 2] = 4 * 16 + 5
    want = np.asarray(jops.bin_counts(jnp.asarray(idx), d=64, d_g=16,
                                      impl="xla"))
    got = ops.bin_counts(torch.from_numpy(idx), d=64, d_g=16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == 40 * 4 - 1
    with pytest.raises(ValueError, match="out must be int32"):
        ops.bin_counts(torch.from_numpy(idx), d=64, d_g=16,
                       out=torch.zeros((64,), dtype=torch.int64))


# --------------------------------------------------------------------------
# degrees and the chunked ELL products, on RB features of ring data
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ell():
    """The reference test file's ELL matrix: RB features of ring data."""
    x, _ = make_rings(500, 2, seed=0)
    params = jrb.make_rb_params(jax.random.PRNGKey(0), 24, 2, 0.15, d_g=1024)
    idx = np.array(jrb.rb_transform(jnp.asarray(x), params))
    return idx, params.n_features, params.d_g


def test_rb_degrees_exact_matches_reference(ell):
    idx, d, d_g = ell
    want = np.asarray(jgraph.rb_degrees_exact(jnp.asarray(idx), d=d,
                                              d_g=d_g))
    got = tgraph.rb_degrees_exact(torch.from_numpy(idx), d=d, d_g=d_g)
    np.testing.assert_allclose(got.numpy(), want, rtol=1.2e-7, atol=0)
    two_products, _ = tgraph.rb_degrees_and_counts(
        torch.from_numpy(idx), d=d, d_g=d_g)
    np.testing.assert_allclose(got.numpy(), two_products.numpy(), rtol=1e-5)


@pytest.mark.parametrize("chunk_size", [64, 100, 128, 500])
def test_chunked_degrees_bit_identical_and_equal_to_reference(ell,
                                                              chunk_size):
    idx, d, d_g = ell
    single = tst.chunked_degrees([torch.from_numpy(idx)], d=d, d_g=d_g,
                                 device="cpu")
    got = tst.chunked_degrees(tst.as_row_chunks(idx, chunk_size), d=d,
                              d_g=d_g, device="cpu")
    assert torch.equal(got, single)
    want = jst.chunked_degrees(_chunks(idx, chunk_size), d=d, d_g=d_g)
    np.testing.assert_allclose(got.numpy(), want, rtol=1.2e-7, atol=0)


def _chunked_pair(ell, chunk_size):
    idx, d, d_g = ell
    adj = jgraph.build_normalized_adjacency(jnp.asarray(idx), d=d, d_g=d_g,
                                            impl="xla")
    scale = np.asarray(adj.rowscale)
    jc = jst.ChunkedELL.from_dense(idx, scale, chunk_size, d=d, d_g=d_g,
                                   impl="xla")
    tc = tst.ChunkedELL.from_dense(idx, scale, chunk_size, d=d, d_g=d_g,
                                   device="cpu")
    return jc, tc


@pytest.mark.parametrize("chunk_size", [32, 77, 128, 499, 500])
def test_chunked_products_match_reference(ell, chunk_size):
    """``gram_matvec_chunked``, ``rmatmat_chunked`` and ``matmat_chunked``
    over divisible, ragged, near-full and full chunkings."""
    idx, d, d_g = ell
    jc, tc = _chunked_pair(ell, chunk_size)
    assert tc.chunk_sizes == jc.chunk_sizes
    assert tc.ell_device_bytes_peak == jc.ell_device_bytes_peak
    rng = np.random.default_rng(chunk_size)
    u = rng.normal(size=(idx.shape[0], 5)).astype(np.float32)
    v = rng.normal(size=(d, 5)).astype(np.float32)
    ju = jst.ChunkedDense.from_array(u, jc.chunk_sizes)
    tu = tst.ChunkedDense.from_array(u, tc.chunk_sizes)
    close = lambda got, want: np.testing.assert_allclose(
        got, np.asarray(want), rtol=2e-5, atol=2e-5)
    close(tc.gram_matvec_chunked(tu).to_array(),
          jc.gram_matvec_chunked(ju).to_array())
    close(tc.rmatmat_chunked(tu).numpy(), jc.rmatmat_chunked(ju))
    close(tc.matmat_chunked(torch.from_numpy(v)).to_array(),
          jc.matmat_chunked(jnp.asarray(v)).to_array())
    with pytest.raises(ValueError, match="chunking mismatch"):
        tc.rmatmat_chunked(tst.ChunkedDense.from_array(u, 7))


def test_chunked_products_match_the_device_representation(ell):
    """The chunked Gram product equals the device representation's
    single-shot one, and ``rmatmat_chunked``/``matmat_chunked`` are
    adjoint."""
    idx, d, d_g = ell
    adj = tgraph.build_normalized_adjacency(torch.from_numpy(idx), d=d,
                                            d_g=d_g)
    tc = tst.ChunkedELL.from_dense(idx, adj.rowscale, 96, d=d, d_g=d_g,
                                   device="cpu")
    g = torch.Generator().manual_seed(0)
    u = torch.randn((idx.shape[0], 3), generator=g)
    v = torch.randn((d, 3), generator=g)
    uc = tst.ChunkedDense.from_array(u, tc.chunk_sizes)
    torch.testing.assert_close(
        torch.from_numpy(tc.gram_matvec_chunked(uc).to_array()),
        adj.gram_matvec(u), rtol=2e-5, atol=2e-5)
    lhs = float(torch.sum(tc.rmatmat_chunked(uc) * v))
    rhs = float(torch.sum(u * torch.from_numpy(
        tc.matmat_chunked(v).to_array())))
    assert abs(lhs - rhs) < 1e-3 * max(abs(lhs), 1.0)


def test_chunked_rb_transform_matches_reference():
    x, _ = make_rings(300, 2, seed=1)
    params = jrb.make_rb_params(jax.random.PRNGKey(4), 16, 2, 0.15, d_g=512)
    want = np.asarray(jrb.rb_transform(jnp.asarray(x), params))
    jmap = jfm.RBMap(n_grids=16, sigma=0.15, d_g=512, params=params)
    tmap = tfm.RBMap.from_state(jmap.meta_dict(), jmap.state_dict(),
                                device="cpu")
    got = tst.chunked_rb_transform(tst.as_row_chunks(x, 90), tmap.params,
                                   device="cpu")
    assert [c.shape[0] for c in got] == [90, 90, 90, 30]
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


def test_build_chunked_adjacency_matches_reference(ell):
    idx, d, d_g = ell
    want = jst.build_chunked_adjacency(_chunks(idx, 128), d=d, d_g=d_g)
    got = tst.build_chunked_adjacency(tst.as_row_chunks(idx, 128), d=d,
                                      d_g=d_g, device="cpu")
    np.testing.assert_allclose(got.deg.numpy(), want.deg, rtol=1.2e-7,
                               atol=0)
    np.testing.assert_array_equal(got.counts.numpy(), want.counts)
    for a, b in zip(got.rowscale_chunks, want.rowscale_chunks):
        np.testing.assert_allclose(a.numpy(), b, rtol=2.4e-7, atol=0)
    assert got.csc_chunks is None           # the CPU's zt reads idx
    assert got.h2d_stats["items"] == 2 * got.n_chunks


def test_prefetch_to_device_contract():
    """Items may be tuples, lists, dataclasses and numpy arrays; the values
    and their order are the same with and without double buffering, and
    ``measure`` counts the items and their bytes."""
    rng = np.random.default_rng(0)
    items = [(rng.normal(size=(5, 3)).astype(np.float32),
              torch.arange(4, dtype=torch.int32), i) for i in range(3)]
    seen = {}
    for enabled in (True, False):
        measure: dict = {}
        out = list(prefetch_to_device(items, device="cpu", enabled=enabled,
                                      measure=measure))
        assert [o[2] for o in out] == [0, 1, 2]
        assert all(isinstance(o[0], torch.Tensor) for o in out)
        assert measure == {"max_item_bytes": 76, "items": 3, "bytes": 228}
        seen[enabled] = out
    for a, b in zip(seen[True], seen[False]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    csc = ops.ell_csc(torch.from_numpy(_ell(0, 6, 2, 4)), 8)
    (moved,) = prefetch_to_device([csc], device="cpu")
    assert isinstance(moved, ops.EllCSC) and moved.n == 6
    assert list(prefetch_to_device([], device="cpu")) == []


# --------------------------------------------------------------------------
# the chunked eigensolver
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chunk_size,precond", [(100, False), (128, True)])
def test_lobpcg_host_chunked_matches_reference(ell, chunk_size, precond):
    """From an injected start block: Ritz values within rtol 1e-4 and the
    leading subspaces within principal-angle cosines ≥ 1 − 1e-3."""
    idx, d, d_g = ell
    jc, tc = _chunked_pair(ell, chunk_size)
    k, b = 2, 6
    x0 = np.random.default_rng(7).normal(size=(idx.shape[0], b)) \
        .astype(np.float32)
    pre = None
    if precond:
        deg = np.asarray(jgraph.rb_degrees_exact(jnp.asarray(idx), d=d,
                                                 d_g=d_g))
        pre = jeig.degree_precond(deg)
    want = jeig.lobpcg_host_chunked(
        jc.gram_matvec_chunked, jst.ChunkedDense.from_array(
            x0, jc.chunk_sizes), max_iters=100, tol=1e-3, precond=pre,
        stable_k=k, conv_k=k)
    got = teig.lobpcg_host_chunked(
        tc.gram_matvec_chunked, tst.ChunkedDense.from_array(
            x0, tc.chunk_sizes), max_iters=100, tol=1e-3,
        precond=None if pre is None else torch.from_numpy(pre),
        stable_k=k, conv_k=k)
    np.testing.assert_allclose(got.theta[:k].numpy(),
                               np.asarray(want.theta)[:k], rtol=1e-4)
    qa, _ = np.linalg.qr(want.vectors.to_array().astype(np.float64)[:, :k])
    qb, _ = np.linalg.qr(got.vectors.to_array().astype(np.float64)[:, :k])
    assert np.linalg.svd(qa.T @ qb, compute_uv=False).min() >= 1 - 1e-3
    assert got.vectors.chunk_sizes == tc.chunk_sizes


def test_top_k_chunked_solvers_and_dense_exact(ell):
    """The chunked branch: randomized and auto run on the chunks (their
    vectors come back as host chunks), a non-host-driven solver is
    refused, and n < 3k solves densely."""
    idx, d, d_g = ell
    _, tc = _chunked_pair(ell, 128)
    g = torch.Generator().manual_seed(0)
    for solver in ("randomized", "auto"):
        got = teig.top_k_eigenpairs(tc.gram_matvec_chunked, tc.n, 2, g,
                                    solver=solver, chunk_sizes=tc.chunk_sizes)
        assert got.vectors.chunk_sizes == tc.chunk_sizes
        assert got.vectors.k == 2 and got.iterations >= 3
        assert bool(torch.all(torch.isfinite(got.theta)))
    with pytest.raises(ValueError, match="host-driven"):
        teig.top_k_eigenpairs(tc.gram_matvec_chunked, tc.n, 2, g,
                              solver="lanczos", chunk_sizes=tc.chunk_sizes)
    small, tiny = _chunked_pair((idx[:5], d, d_g), 2)
    got = teig.top_k_eigenpairs(tiny.gram_matvec_chunked, 5, 2, g,
                                chunk_sizes=tiny.chunk_sizes)
    want = jeig.top_k_eigenpairs(small.gram_matvec_chunked, 5, 2,
                                 jax.random.PRNGKey(0),
                                 chunk_sizes=small.chunk_sizes)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               rtol=1e-5, atol=1e-6)
    assert got.vectors.chunk_sizes == (2, 2, 1)


# --------------------------------------------------------------------------
# chunked k-means
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [64, 100, 503, (200, 200, 103)])
@pytest.mark.parametrize("prefetch", [True, False])
def test_row_normalize_chunks(sizes, prefetch):
    """Within 1e-6 of the reference; the same bits as the port's own
    single-shot ``row_normalize`` for any chunking."""
    u = np.random.default_rng(0).normal(size=(503, 6)).astype(np.float32)
    single = tkm.row_normalize(torch.from_numpy(u)).numpy()
    cd = tst.ChunkedDense.from_array(u, sizes)
    got = tkm.row_normalize_chunks(cd, prefetch=prefetch, device="cpu")
    assert got.chunk_sizes == cd.chunk_sizes
    np.testing.assert_array_equal(got.to_array(), single)
    want = jkm.row_normalize_chunks(jst.ChunkedDense.from_array(u, sizes),
                                    prefetch=prefetch)
    np.testing.assert_allclose(got.to_array(), want.to_array(), rtol=1e-6,
                               atol=1e-6)


def test_reservoir_sample_matches_reference():
    rng = np.random.default_rng(7)
    chunks = [rng.normal(size=(s, 3)).astype(np.float32)
              for s in (40, 35, 25)]
    for pool, seed in ((100, 0), (16, 1)):
        want = jkm._reservoir_sample_chunks(chunks, pool,
                                            np.random.default_rng(seed))
        got = tkm._reservoir_sample_chunks(
            [torch.from_numpy(c) for c in chunks], pool,
            np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)


def _reference_seeds(key, chunks, k, n_replicates):
    """The reference ``streaming_kmeans``' seeds, rebuilt from its key: the
    reservoir pool from its numpy seed, then k-means++ per replicate."""
    seed = int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max))
    n = sum(c.shape[0] for c in chunks)
    pool = jnp.asarray(jkm._reservoir_sample_chunks(
        [np.asarray(c, np.float32) for c in chunks], min(n, max(4 * k, 64)),
        np.random.default_rng(seed)))
    keys = jax.random.split(jax.random.fold_in(key, 1), n_replicates)
    return np.stack([np.asarray(jkm._plusplus_init(rk, pool, k))
                     for rk in keys])


def test_streaming_kmeans_with_reference_seeds():
    """The reference's seeds injected: the same Sculley steps give the
    reference's centroids within 1e-5 and its labels exactly."""
    x, _ = make_blobs(900, 5, 4, seed=3, spread=0.1)
    x = x.astype(np.float32)
    key = jax.random.PRNGKey(5)
    chunks = _chunks(x, 256)
    want = jkm.streaming_kmeans(key, jst.ChunkedDense.from_array(x, 256), 4,
                                n_steps=11, n_replicates=3, impl="xla")
    seeds = _reference_seeds(key, chunks, 4, 3)
    got = tkm.streaming_kmeans(None, tst.ChunkedDense.from_array(x, 256), 4,
                               n_steps=11, init=torch.from_numpy(seeds),
                               device="cpu")
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), atol=1e-5)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                               rtol=1e-5)


def test_streaming_kmeans_draws_its_own_seeds():
    x, y = make_blobs(600, 4, 3, seed=1, spread=0.05)
    g = torch.Generator().manual_seed(2)
    res = tkm.streaming_kmeans(g, [x[:250], x[250:]], 3, n_steps=20,
                               n_replicates=2, device="cpu")
    assert res.labels.dtype == torch.int32 and res.labels.shape == (600,)
    assert metrics.adjusted_rand_index(res.labels.numpy(), y) >= 0.95
    with pytest.raises(ValueError, match="exceeds"):
        tkm.streaming_kmeans(g, [np.zeros((4, 2), np.float32)], 9,
                             device="cpu")


def test_minibatch_kmeans_on_blobs_and_tiny_input():
    x, y = make_blobs(2000, 8, 5, seed=3, spread=0.08)
    g = torch.Generator().manual_seed(0)
    res = tkm.minibatch_kmeans(g, torch.from_numpy(x), 5, batch_size=256,
                               n_steps=60)
    assert metrics.adjusted_rand_index(res.labels.numpy(), y) >= 0.95
    small, _ = make_blobs(20, 3, 3, seed=0, spread=0.05)
    res = tkm.minibatch_kmeans(g, torch.from_numpy(small), 3, batch_size=8,
                               n_steps=10)
    assert res.labels.shape == (20,) and int(res.labels.max()) < 3


# --------------------------------------------------------------------------
# the whole host-chunked fit
# --------------------------------------------------------------------------

SEED = 0
# overlapping blobs (no cluster gap), where the mini-batch k-means of the
# host-chunked fit and Lloyd's settle on different partitions; the
# chunkings give ragged tails of 61, 88 and 100 rows
_OVERLAP = dict(n_clusters=4, n_grids=64, sigma=1.5, d_g=1024)
FIT_CASES = {
    "rings2": dict(data=lambda: make_rings(600, 2, seed=0), chunk=256,
                   cfg=dict(n_clusters=2, n_grids=96, sigma=0.15, d_g=4096)),
    "blobs3": dict(data=lambda: make_blobs(500, 6, 3, seed=0), chunk=128,
                   cfg=dict(n_clusters=3, n_grids=64, sigma=1.5, d_g=1024)),
    "overlap4-77": dict(data=lambda: make_blobs(600, 6, 4, seed=0,
                                                spread=1.2),
                        chunk=77, cfg=_OVERLAP, gapless=True),
    "overlap4-128": dict(data=lambda: make_blobs(600, 6, 4, seed=0,
                                                 spread=1.2),
                         chunk=128, cfg=_OVERLAP, gapless=True),
    "overlap4-500": dict(data=lambda: make_blobs(600, 6, 4, seed=0,
                                                 spread=1.2),
                         chunk=500, cfg=_OVERLAP, gapless=True),
    "overlap4-seed3": dict(data=lambda: make_blobs(800, 6, 4, seed=3,
                                                   spread=1.2),
                           chunk=256, cfg=_OVERLAP, gapless=True),
}
COMMON = dict(kmeans_replicates=2, seed=SEED)


@pytest.fixture(scope="module", params=sorted(FIT_CASES))
def chunked_parity(request):
    """One host-chunked fit of each package on the same data, with the
    reference's grids, start block and k-means draws injected.

    Seeds are coordinates, and the two solves may return an eigenvector
    with the other sign, so the reference's seeds are rebuilt on the port's
    own embedding: its reservoir picks rows by index and its k-means++ by
    distances, which a rotation of the embedding leaves alone. ``lloyd``
    is the device fit's Lloyd k-means from those seeds on that embedding."""
    case = FIT_CASES[request.param]
    x, y = case["data"]()
    chunk = case["chunk"]
    kw = dict(case["cfg"], **COMMON, chunk_size=chunk)
    jcfg = jexec.SCRBConfig(**kw, solver_options=JSolverOptions(tol=1e-3))
    tcfg = texec.SCRBConfig(**kw, solver_options=TSolverOptions(tol=1e-3))
    key = jax.random.PRNGKey(SEED)
    params = jrb.make_rb_params(fold_key(key, "rb"), jcfg.n_grids,
                                x.shape[1], jcfg.sigma, jcfg.d_g)
    jmap = jfm.RBMap(n_grids=jcfg.n_grids, sigma=jcfg.sigma, d_g=jcfg.d_g,
                     params=params)
    sizes = [c.shape[0] for c in _chunks(x, chunk)]
    b = lobpcg_block_width(x.shape[0], jcfg.n_clusters,
                           jcfg.solver_options.buffer)
    x0 = jst.ChunkedDense.random_normal(fold_key(key, "eig"), sizes,
                                        b).to_array()
    jplan = jexec.plan_from_config(jcfg)
    jres = jexec.execute(jnp.asarray(x), jcfg, jexec.ExecutionPlan(
        residency="host_chunked", chunk_size=chunk, feature_map=jmap,
        eig_x0=x0), keep_state=True)
    assert jplan.residency == "host_chunked"
    tmap = tfm.RBMap.from_state(jmap.meta_dict(), jmap.state_dict(),
                                device="cpu")
    seeds = {}

    def inject(g, u, k, **kw):
        seeds["init"] = torch.from_numpy(_reference_seeds(
            fold_key(key, "kmeans"), u.chunks, k, jcfg.kmeans_replicates))
        return tkm.streaming_kmeans(g, u, k, init=seeds["init"], **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trow, "streaming_kmeans", inject)
        tres = texec.execute(x, tcfg, texec.ExecutionPlan(
            residency="host_chunked", chunk_size=chunk, feature_map=tmap,
            eig_x0=x0), keep_state=True, device="cpu")
    lloyd = tkm.kmeans(None, torch.from_numpy(tres.embedding),
                       tcfg.n_clusters, n_iters=tcfg.kmeans_iters,
                       init=seeds["init"])
    return dict(x=x, y=y, jcfg=jcfg, tcfg=tcfg, jres=jres, tres=tres,
                lloyd=lloyd.labels.numpy(),
                gapless=case.get("gapless", False))


def test_sc_rb_chunked_matches_reference(chunked_parity):
    jres, tres = chunked_parity["jres"], chunked_parity["tres"]
    k = chunked_parity["jcfg"].n_clusters
    assert metrics.accuracy(tres.labels, jres.labels) >= 0.99
    np.testing.assert_allclose(tres.singular_values[:k],
                               jres.singular_values[:k], rtol=1e-4)
    for key in ("n_chunks", "chunk_rows_max", "ell_device_bytes_peak",
                "embedding_device_bytes_peak", "kmeans_steps"):
        assert tres.diagnostics[key] == jres.diagnostics[key], key
    assert tres.diagnostics["plan"]["residency"] == "host_chunked"
    assert tres.embedding.shape == jres.embedding.shape
    np.testing.assert_array_equal(
        torch.cat(tres.state["features"].payload).numpy(),
        np.concatenate(jres.state["features"].payload))
    np.testing.assert_allclose(tres.state["z"].store.deg.numpy(),
                               jres.state["z"].store.deg, rtol=1.2e-7,
                               atol=0)


def test_sc_rb_chunked_kmeans_is_the_references(chunked_parity):
    """The whole chunked fit's labels are the reference's (mini-batch
    ``streaming_kmeans``, at least one step per chunk) also where Lloyd's
    k-means from the same seeds on the same embedding gives another
    partition: on the overlapping blobs."""
    jres, tres = chunked_parity["jres"], chunked_parity["tres"]
    assert metrics.accuracy(tres.labels, jres.labels) >= 0.99
    assert tres.diagnostics["kmeans_steps"] == max(
        chunked_parity["tcfg"].kmeans_iters, tres.diagnostics["n_chunks"])
    np.testing.assert_allclose(tres.diagnostics["kmeans_inertia"],
                               jres.diagnostics["kmeans_inertia"], rtol=1e-4)
    if chunked_parity["gapless"]:
        assert metrics.accuracy(chunked_parity["lloyd"], jres.labels) < 0.99


def test_chunked_fit_matches_device_fit_and_prechunked_input():
    x, _ = make_rings(600, 2, seed=2)
    kw = dict(n_clusters=2, n_grids=96, sigma=0.15, d_g=4096,
              kmeans_replicates=2, seed=0,
              solver_options=TSolverOptions(tol=1e-3))
    dev = tmodel.SCRBModel.fit(x, texec.SCRBConfig(**kw), device="cpu")
    chunked = tmodel.SCRBModel.fit(
        x, texec.SCRBConfig(**kw, chunk_size=256), device="cpu")
    assert metrics.accuracy(chunked.fit_result.labels,
                            dev.fit_result.labels) >= 0.99
    blocks = [x[:256], x[256:512], x[512:]]
    pre = tmodel.SCRBModel.fit(
        blocks, texec.SCRBConfig(**kw, chunk_size=256), device="cpu")
    np.testing.assert_array_equal(pre.fit_result.labels,
                                  chunked.fit_result.labels)
    assert pre.fit_result.diagnostics["n_chunks"] == 3
    assert metrics.accuracy(chunked.predict(x),
                            chunked.fit_result.labels) >= 0.99


def test_chunked_fit_refuses_what_is_not_ported():
    x, _ = make_blobs(200, 4, 2, seed=0)
    base = dict(n_clusters=2, n_grids=16, sigma=1.0, d_g=256,
                kmeans_replicates=1, chunk_size=64)
    res = texec.execute(x, texec.SCRBConfig(
        **base, solver_options=TSolverOptions(solver="randomized")),
        device="cpu")
    assert res.diagnostics["solver"] == "randomized"
    with pytest.raises(ValueError, match="host-driven"):
        texec.plan_from_config(texec.SCRBConfig(
            **base, solver_options=TSolverOptions(solver="lanczos")))
    res = texec.execute(x, texec.SCRBConfig(
        **base, solver_options=TSolverOptions(solver="lobpcg_host",
                                              tol=1e-3)), device="cpu")
    assert res.diagnostics["solver"] == "lobpcg_host"
    assert res.labels.shape == (200,)


def test_trace_raises_not_yet_ported(tmp_path):
    """``SCRBConfig(trace=...)`` (ported since the tracer landed) writes a
    Chrome trace for either residency, holding the root ``fit`` span."""
    x, _ = make_blobs(60, 3, 2, seed=0)
    for chunk in (None, 32):
        path = tmp_path / f"fit_{chunk}.json"
        cfg = texec.SCRBConfig(n_clusters=2, n_grids=8, d_g=64,
                               chunk_size=chunk, trace=str(path))
        texec.execute(x, cfg, device="cpu")
        with open(path) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]
                     if e["ph"] == "X"}
        assert {"fit", "svd", "eigensolve"} <= names


def test_chunked_model_artifact_cross_loads(tmp_path):
    """A model fitted on chunks saves the same artifact layout: it loads in
    the reference and predicts the same labels, and the reference's
    chunked model loads in the port."""
    x, _ = make_blobs(500, 6, 4, seed=2)
    base = dict(n_clusters=4, n_grids=32, sigma=1.5, d_g=512,
                kmeans_replicates=2, seed=0, chunk_size=128)
    tm = tmodel.SCRBModel.fit(x, texec.SCRBConfig(
        **base, solver_options=TSolverOptions(tol=1e-3)), device="cpu")
    path = str(tmp_path / "port.npz")
    tm.save(path)
    jm = jmodel.SCRBModel.load(path)
    assert jm.config.chunk_size == 128
    np.testing.assert_array_equal(jm.predict(x), tm.predict(x))
    assert metrics.accuracy(tm.predict(x), tm.fit_result.labels) >= 0.99
    jm2 = jmodel.SCRBModel.fit(jnp.asarray(x), jexec.SCRBConfig(
        **base, solver_options=JSolverOptions(tol=1e-3)))
    path2 = str(tmp_path / "ref.npz")
    jm2.save(path2)
    tm2 = tmodel.SCRBModel.load(path2, device="cpu")
    np.testing.assert_array_equal(tm2.predict(x), jm2.predict(x))
    np.testing.assert_allclose(tm2.transform(x[:64]), jm2.transform(x[:64]),
                               atol=1e-5)


def test_chunked_k_auto_and_spectral_embed():
    from repro_torch.core import pipeline
    x, _ = make_blobs(500, 6, 4, seed=2)
    cfg = texec.SCRBConfig(n_clusters=6, n_grids=32, sigma=1.5, d_g=512,
                           kmeans_replicates=2, seed=0, chunk_size=128,
                           solver_options=TSolverOptions(tol=1e-3))
    m = tmodel.SCRBModel.fit(x, cfg, k="auto", device="cpu")
    chosen = m.fit_result.diagnostics["k_auto"]["k"]
    assert 2 <= chosen <= 5 and m.centroids.shape[0] == chosen
    assert m.fit_result.embedding.shape == (500, chosen)
    emb = pipeline.spectral_embed(x, cfg, device="cpu")
    assert emb.embedding.shape == (500, 6) and emb.labels is None
    assert emb.diagnostics["n_chunks"] == 4
