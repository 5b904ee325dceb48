"""The port's kernels (``repro_torch.kernels``) against the JAX package's.

On the CPU the port's wrappers take their plain PyTorch versions; these are
held, on the same numpy inputs, against ``repro.kernels.ref`` and against
``repro.kernels.ops.*(impl="pallas")`` (interpret mode, as
``tests/test_kernels.py`` runs it), over that file's shape grids.
Tolerances: RB indices and assignment labels exact; float32 products
within 1e-5 (the summation order differs); bfloat16 V within one bfloat16
rounding of the output (2^-8 relative) on top of that. The CUDA kernels
themselves are held against these plain versions in
``tests/test_torch_cuda.py``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

BF16_RTOL = 2.0 ** -8


def _rb_inputs(seed, n, d, r):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 2.0).astype(np.float32)   # negatives too
    widths = (rng.gamma(2.0, size=(r, d)) * 0.5 + 1e-3).astype(np.float32)
    biases = (rng.uniform(size=(r, d)) * widths).astype(np.float32)
    hash_a = (rng.integers(0, 2**31 - 1, size=(r, d)) * 2 + 1).astype(np.uint32)
    hash_c = rng.integers(0, 2**31 - 1, size=(r,)).astype(np.uint32)
    return x, widths, biases, hash_a, hash_c


def _torch_rb(x, widths, biases, hash_a, hash_c):
    bits = lambda a: torch.from_numpy(a.view(np.int32).copy())
    return (torch.from_numpy(x), torch.from_numpy(widths),
            torch.from_numpy(biases), bits(hash_a), bits(hash_c))


def _ell(seed, n, r, d_g):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, d_g, size=(n, r))
            + np.arange(r)[None, :] * d_g).astype(np.int32)


RB_SHAPES = [(64, 2, 8, 64), (100, 3, 16, 128), (256, 7, 4, 256),
             (513, 16, 32, 512)]


@pytest.mark.parametrize("n,d,r,d_g", RB_SHAPES)
def test_rb_binning_plain_matches_reference(n, d, r, d_g):
    inputs = _rb_inputs(n + r, n, d, r)
    want = np.asarray(jref.rb_binning_ref(*map(jnp.asarray, inputs), d_g))
    got = ops.rb_binning(*_torch_rb(*inputs), d_g=d_g)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, r)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,d,r,d_g", RB_SHAPES[:2])
def test_rb_binning_plain_matches_pallas(n, d, r, d_g):
    inputs = _rb_inputs(7 * n, n, d, r)
    want = np.asarray(jops.rb_binning(*map(jnp.asarray, inputs), d_g=d_g,
                                      impl="pallas"))
    np.testing.assert_array_equal(
        ops.rb_binning(*_torch_rb(*inputs), d_g=d_g).numpy(), want)


def test_rb_binning_hash_edge_values():
    """Bins of large magnitude and both signs, multipliers near 2^32: the
    int64 masked hash of the plain version keeps uint32 wraparound."""
    x = np.array([[-1e5, 3e4], [7.5, -0.25], [0.0, 1e6]], np.float32)
    widths = np.array([[0.5, 2.0], [1e-3, 3.0]], np.float32)
    biases = np.array([[0.1, 1.9], [0.0, 0.5]], np.float32)
    hash_a = np.array([[0xFFFFFFFF, 0x80000001], [1, 0xDEADBEEF]], np.uint32)
    hash_c = np.array([0xFFFFFFF0, 0x12345678], np.uint32)
    inputs = (x, widths, biases, hash_a, hash_c)
    for d_g in (1, 2, 1024):
        want = np.asarray(jref.rb_binning_ref(*map(jnp.asarray, inputs), d_g))
        got = ops.rb_binning(*_torch_rb(*inputs), d_g=d_g)
        np.testing.assert_array_equal(got.numpy(), want)


def _rb_planted(seed=0):
    """``ref.rb_hard_cases`` as RB inputs: row i and grid i hold planted
    triple i (d = 1), so the diagonal of the output hashes its bin."""
    x, b, w, kinds = ref.rb_hard_cases(seed)
    rng = np.random.default_rng(seed)
    m = x.shape[0]
    hash_a = (rng.integers(0, 2**31 - 1, size=(m, 1)) * 2 + 1).astype(np.uint32)
    hash_c = rng.integers(0, 2**31 - 1, size=(m,)).astype(np.uint32)
    return (x[:, None], w[:, None], b[:, None], hash_a, hash_c), kinds


def test_rb_hard_cases_are_what_they_claim():
    """The planted triples: every kind present, each as its name says (in
    exact arithmetic), and the naive floor(t * (1/w)) wrong on some."""
    from fractions import Fraction
    x, b, w, kinds = ref.rb_hard_cases(0)
    assert {str(k) for k in kinds} == {"on", "above", "below", "cross"}
    t = x - b
    q = t / w                                        # IEEE float32
    for ti, wi, qi, kind in zip(t, w, q, kinds):
        exact = Fraction(float(ti)) / Fraction(float(wi))
        n = round(exact) if kind != "cross" else int(qi)
        if kind == "on":
            assert exact == n and qi == n
        elif kind == "above":
            assert qi == np.nextafter(np.float32(n), np.float32(np.inf))
        elif kind == "below":
            assert qi == np.nextafter(np.float32(n), np.float32(-np.inf))
        else:                       # the rounding reaches n, the exact not
            assert qi == n and exact < n
    naive = np.floor(t * (np.float32(1.0) / w))
    assert (naive != np.floor(q)).any()


def test_rb_binning_planted_rows_match_reference_and_pallas():
    inputs, _ = _rb_planted(0)
    d_g = 1024
    want = np.asarray(jref.rb_binning_ref(*map(jnp.asarray, inputs), d_g))
    got = ops.rb_binning(*_torch_rb(*inputs), d_g=d_g).numpy()
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(jops.rb_binning(*map(jnp.asarray, inputs), d_g=d_g,
                                        impl="pallas"))
    np.testing.assert_array_equal(got, pallas)
    # the planted bins reach the hash: a bin one lower changes the diagonal
    x, w, b, a, c = inputs
    lower = (x - w, w, b, a, c)
    moved = np.asarray(jref.rb_binning_ref(*map(jnp.asarray, lower), d_g))
    assert (np.diag(moved) != np.diag(want)).mean() > 0.9


Z_SHAPES = [(64, 4, 64, 8), (100, 8, 128, 3), (256, 16, 64, 32),
            (300, 12, 256, 5)]


@pytest.mark.parametrize("n,r,d_g,k", Z_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_z_matmul_plain_matches_reference(n, r, d_g, k, dtype):
    rng = np.random.default_rng(n * r + k)
    idx = _ell(n * r + k, n, r, d_g)
    v = rng.normal(size=(r * d_g, k)).astype(np.float32)
    s = (rng.uniform(size=n) + 0.5).astype(np.float32)
    v_t = torch.from_numpy(v).to(getattr(torch, dtype))
    v_f = v_t.float().numpy()                  # the values the kernel sees
    want = np.asarray(jref.z_matmul_ref(jnp.asarray(idx), jnp.asarray(v_f),
                                        jnp.asarray(s)))
    got = ops.z_matmul(torch.from_numpy(idx), v_t, torch.from_numpy(s),
                       d_g=d_g)
    assert got.dtype == v_t.dtype and tuple(got.shape) == (n, k)
    rtol = 1e-5 if dtype == "float32" else BF16_RTOL + 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=1e-5)


@pytest.mark.parametrize("n,r,d_g,k", Z_SHAPES[:3])
def test_zt_matmul_plain_matches_reference(n, r, d_g, k):
    rng = np.random.default_rng(n + r + k)
    idx = _ell(n + r + k, n, r, d_g)
    u = rng.normal(size=(n, k)).astype(np.float32)
    s = (rng.uniform(size=n) + 0.5).astype(np.float32)
    d = r * d_g
    want = np.asarray(jref.zt_matmul_ref(jnp.asarray(idx), jnp.asarray(u),
                                         jnp.asarray(s), d))
    got = ops.zt_matmul(torch.from_numpy(idx), torch.from_numpy(u),
                        torch.from_numpy(s), d, d_g=d_g)
    assert got.dtype == torch.float32 and tuple(got.shape) == (d, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,r,d_g", [
    (300, 4, 16),      # no long column
    (5000, 2, 2),      # long columns, a ragged last chunk each
    (4097, 1, 1),      # one column of two whole chunks and one nonzero
    (2048, 2, 1),      # columns of exactly ZT_CHUNK nonzeros: not long
    (3, 2, 1024),      # almost every column empty
])
def test_ell_csc_tables_match_a_plain_recomputation(n, r, d_g):
    """ops.ell_csc's tables against numpy, and the zt kernel's reduction
    over those tables against the JAX reference."""
    chunk = ops.ZT_CHUNK
    idx = _ell(n * r + d_g, n, r, d_g)
    d = r * d_g
    csc = ops.ell_csc(torch.from_numpy(idx), d)
    nnz = np.bincount(idx.reshape(-1), minlength=d)
    np.testing.assert_array_equal(csc.colptr.numpy(),
                                  np.concatenate([[0], np.cumsum(nnz)]))
    for c in range(d):
        seg = csc.rows.numpy()[csc.colptr[c]:csc.colptr[c + 1]]
        np.testing.assert_array_equal(seg, np.nonzero((idx == c).any(1))[0])
    long_cols = np.nonzero(nnz > chunk)[0]
    per = -(-nnz[long_cols] // chunk)
    np.testing.assert_array_equal(csc.long_cols.numpy(), long_cols)
    np.testing.assert_array_equal(csc.long_chunk_ptr.numpy(),
                                  np.concatenate([[0], np.cumsum(per)]))
    np.testing.assert_array_equal(csc.chunk_long.numpy(),
                                  np.repeat(np.arange(len(long_cols)), per))
    assert csc.long_cols.dtype == csc.chunk_long.dtype == csc.rows.dtype \
        == torch.int32
    assert (csc.n, csc.d) == (n, d)

    # the kernel's three steps, in numpy: pre-scale, one sum per short
    # column, chunk sums then their sum per long column
    rng = np.random.default_rng(n)
    u = rng.normal(size=(n, 3)).astype(np.float32)
    s = (rng.uniform(size=n) + 0.5).astype(np.float32)
    su = s[:, None] * u
    rows, ptr = csc.rows.numpy(), csc.colptr.numpy()
    q = np.stack([su[rows[ptr[c]:ptr[c + 1]]].sum(0) for c in range(d)])
    for j, c in enumerate(long_cols):
        parts = [su[rows[ptr[c] + i * chunk:min(ptr[c] + (i + 1) * chunk,
                                                ptr[c + 1])]].sum(0)
                 for i in range(per[j])]
        q[c] = np.sum(parts, axis=0)
    want = np.asarray(jref.zt_matmul_ref(jnp.asarray(idx), jnp.asarray(u),
                                         jnp.asarray(s), d))
    np.testing.assert_allclose(q, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,r,d_g,k", [(64, 4, 64, 8), (100, 8, 128, 3)])
def test_gram_matmul_plain_matches_pallas(n, r, d_g, k):
    rng = np.random.default_rng(3 * n + k)
    idx = _ell(3 * n + k, n, r, d_g)
    u = rng.normal(size=(n, k)).astype(np.float32)
    s = (rng.uniform(size=n) + 0.5).astype(np.float32)
    d = r * d_g
    want = np.asarray(jops.gram_matmul(jnp.asarray(idx), jnp.asarray(u),
                                       jnp.asarray(s), d, d_g=d_g,
                                       impl="pallas"))
    got = ops.gram_matmul(torch.from_numpy(idx), torch.from_numpy(u),
                          torch.from_numpy(s), d, d_g=d_g)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,d,k", [(64, 2, 3), (1000, 8, 16), (1025, 16, 7)])
def test_kmeans_assign_plain_matches_reference(n, d, k):
    rng = np.random.default_rng(n + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    want_l, want_d = jref.kmeans_assign_ref(jnp.asarray(x), jnp.asarray(c))
    got_l, got_d = ops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    assert got_l.dtype == torch.int32
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5,
                               atol=1e-5)


def test_kmeans_assign_plain_matches_pallas():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(64, 2)).astype(np.float32)
    c = rng.normal(size=(3, 2)).astype(np.float32)
    want_l, _ = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                                   impl="pallas")
    got_l, _ = ops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


@pytest.mark.parametrize("n,d,k", [(64, 2, 3), (1000, 8, 16), (1025, 7, 7)])
@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
def test_kmeans_assign_stats_plain_matches_reference(n, d, k, jimpl):
    """The statistics form's plain version against the JAX package's
    ``ops.kmeans_assign_stats`` (its XLA path, and the Pallas kernel in
    interpret mode): labels and counts exact; sums and inertia within
    1e-5 of the sum of their absolute terms (another order of addition)."""
    rng = np.random.default_rng(7 * n + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = x[rng.choice(n, size=k, replace=False)] + 0.01
    jl, jc, js, ji = (np.asarray(a) for a in jops.kmeans_assign_stats(
        jnp.asarray(x), jnp.asarray(c), impl=jimpl))
    lab, counts, sums, inertia = ops.kmeans_assign_stats(
        torch.from_numpy(x), torch.from_numpy(c))
    assert (lab.dtype, counts.dtype, sums.dtype, inertia.dtype) == \
        (torch.int32,) + (torch.float32,) * 3
    assert tuple(sums.shape) == (k, d) and inertia.shape == ()
    np.testing.assert_array_equal(lab.numpy(), jl)
    np.testing.assert_array_equal(counts.numpy(), jc)
    onehot = np.eye(k, dtype=np.float64)[jl]
    abs_sums = onehot.T @ np.abs(x).astype(np.float64)
    assert np.all(np.abs(sums.numpy() - js) <= 1e-5 * abs_sums)
    _, dist = jref.kmeans_assign_ref(jnp.asarray(x), jnp.asarray(c))
    assert abs(float(inertia) - float(ji)) <= 1e-5 * float(np.sum(dist))


def test_lloyd_takes_its_statistics_from_kmeans_assign_stats(monkeypatch):
    """A Lloyd step is ``ops.kmeans_assign_stats`` and the centroid update;
    only the last assignment is ``ops.kmeans_assign``. The centroids follow
    a numpy Lloyd loop on the same seeds."""
    tkm = importlib.import_module("repro_torch.core.kmeans")
    calls = {"kmeans_assign_stats": 0, "kmeans_assign": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(ops, name, counted)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(500, 4)).astype(np.float32)
    c0 = x[:3].copy()
    res = tkm._lloyd(torch.from_numpy(x), torch.from_numpy(c0), 6)
    assert calls == {"kmeans_assign_stats": 6, "kmeans_assign": 1}
    cents = c0.astype(np.float64)
    for _ in range(6):
        lab = np.argmin(((x[:, None, :] - cents[None]) ** 2).sum(-1), axis=1)
        for j in range(3):
            if np.any(lab == j):
                cents[j] = x[lab == j].mean(0)
    np.testing.assert_allclose(res.centroids.numpy(), cents, atol=1e-5)


def test_zt_z_adjoint():
    """⟨Z v, u⟩ == ⟨v, Zᵀ u⟩ — the two products are adjoint maps."""
    rng = np.random.default_rng(0)
    n, r, d_g, k = 128, 8, 64, 4
    idx = torch.from_numpy(_ell(0, n, r, d_g))
    s = torch.from_numpy((rng.uniform(size=n) + 0.1).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(r * d_g, k)).astype(np.float32))
    lhs = float(torch.sum(ops.z_matmul(idx, v, s, d_g=d_g) * u))
    rhs = float(torch.sum(ops.zt_matmul(idx, u, s, r * d_g, d_g=d_g) * v))
    assert abs(lhs - rhs) < 1e-4 * max(abs(lhs), 1.0)


def test_z_matmul_rejects_v_off_the_strips():
    """v must have R·d_g rows (the strip contract), on every device."""
    idx = torch.from_numpy(_ell(0, 8, 4, 16))
    s = torch.ones(8)
    for rows in (4 * 16 - 1, 4 * 16 + 16, 16):
        with pytest.raises(ValueError, match="R·d_g"):
            ops.z_matmul(idx, torch.zeros((rows, 3)), s, d_g=16)
        with pytest.raises(ValueError, match="R·d_g"):
            ops.z_matmul_gather(idx, torch.zeros((rows, 3)), s, d_g=16)
    assert ops.z_matmul(idx, torch.zeros((64, 3)), s, d_g=16).shape == (8, 3)


@pytest.mark.parametrize("n,r,d_g,k,dtype,plan", [
    (581_012, 256, 2048, 11, torch.float32, (4, 3)),   # the fit's
    (581_012, 256, 2048, 1, torch.float32, (1, 6)),    # degrees
    (140_000, 8, 4096, 11, torch.float32, (2, 3)),     # narrower groups
    (140_000, 8, 8192, 11, torch.float32, (1, 3)),     # one column a group
    (140_000, 8, 16384, 11, torch.bfloat16, (1, 3)),
    (140_000, 8, 16384, 11, torch.float32, None),      # no strip fits
    (140_000, 12, 2048, 11, torch.float32, None),      # R % 8
    (100_000, 256, 2048, 11, torch.float32, None),     # a smaller batch
])
def test_z_strip_plan_routes_by_shape(n, r, d_g, k, dtype, plan):
    assert ops.z_strip_plan(n, r, d_g, k, dtype) == plan


ENGINE_BUCKETS = (64, 256, 1_024, 4_096)   # ClusterEngine's default buckets


@pytest.mark.parametrize("n", ENGINE_BUCKETS + (56_724, 131_071))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_z_gather_plan_covers_the_shape_within_budget(n, dtype):
    """For K 1..40 and R 1..256: every row and column has a thread, every
    column of a staged warp a folding lane, the block's shared memory fits
    the 48 KB a launch gets without an attribute, and the plan is the same
    on every call (a function of the shape alone)."""
    for k in range(1, 41):
        for r in range(1, 257):
            p = ops.z_gather_plan(n, r, k, dtype)
            assert p == ops.z_gather_plan(n, r, k, dtype)
            assert 1 <= p.warps <= 4
            if n * k >= ops.Z_GATHER_ROWS_MIN_OUTPUTS or r <= 32:
                # the register form: a thread per output
                assert p.route == 1 and p.smem == 0
                threads = p.blocks * p.warps * 32
                assert threads - p.warps * 32 < n * k <= threads
                continue
            assert p.route == 0
            assert p.groups == -(-k // 32)                 # fewest groups
            assert (p.groups - 1) * p.kc < k <= p.groups * p.kc
            assert 1 <= p.rows and p.rows * p.kc <= 32      # folding lanes
            items = -(-n // p.rows) * p.groups
            assert (p.blocks - 1) * p.warps < items <= p.blocks * p.warps
            passes = -(-r // p.chunk)                   # even passes
            assert p.chunk <= ops.Z_GATHER_CHUNK and p.chunk * passes >= r
            assert p.chunk * (passes - 1) < r
            assert p.rows == 1 or p.chunk == r           # one pass if rows > 1
            assert p.stride >= p.chunk and p.stride % 8 == 4
            per_warp = -(-p.rows * p.chunk // 4) * 4 + p.rows * p.kc * p.stride
            assert p.smem == p.warps * per_warp * 4 <= 48 * 1024


@pytest.mark.parametrize("n,r,k,want", [
    (64, 256, 1, (0, 1, 1, 1, 64)),       # the degrees at the smallest bucket
    (64, 256, 7, (0, 7, 1, 1, 64)),       # 64 rows spread over 64 SMs
    (1_024, 256, 7, (0, 7, 1, 4, 256)),
    (768, 256, 11, (0, 11, 1, 4, 192)),   # one group, passes of 128
    (192, 256, 40, (0, 20, 1, 2, 192)),   # two column groups of 20
    (1_000, 36, 1, (0, 1, 2, 2, 250)),    # few grids: 2 rows a warp
    (1_000, 1_000, 3, (0, 3, 1, 4, 250)),  # R > 256: passes of 250 grids
    (4_096, 256, 1, (0, 1, 1, 4, 1_024)),  # the top bucket's degrees
    (4_096, 256, 7, (1, 7, 1, 4, 224)),   # its projection: register form
    (2_048, 256, 7, (1, 7, 1, 2, 224)),   # past the forms' crossover
    (56_724, 256, 11, (1, 11, 1, 4, 4_875)),  # a chunked fit's ragged chunk
    (1, 1, 1, (1, 1, 1, 1, 1)),           # R ≤ 32: register form
])
def test_z_gather_plan_geometry(n, r, k, want):
    p = ops.z_gather_plan(n, r, k, torch.float32)
    assert (p.route, p.kc, p.rows, p.warps, p.blocks) == want


def _gather_walk(lane, rows, rc, kce):
    """The (row, grid, column) gathers lane ``lane`` issues in one pass of
    the staged form (csrc/ell_spmm.cu, z_gather_kernel, step 2): element
    e = (p·rc + g)·kce + kk for e = lane, lane + 32, ..., walked with the
    kernel's own incremental steps."""
    dk, dr = 32 % kce, 32 // kce
    kk, g = lane % kce, lane // kce
    p, g = divmod(g, rc)
    out = []
    for e in range(lane, rows * rc * kce, 32):
        assert e == (p * rc + g) * kce + kk
        out.append((p, g, kk))
        kk, g = kk + dk, g + dr
        if kk >= kce:
            kk, g = kk - kce, g + 1
        if g >= rc:
            p, g = p + g // rc, g % rc
    return out


@pytest.mark.parametrize("rows,rc,kce", [(1, 256, 7), (1, 256, 1),
                                         (1, 128, 11), (32, 5, 1),
                                         (2, 12, 14), (1, 3, 32),
                                         (16, 1, 2), (1, 37, 5),
                                         (4, 9, 8), (1, 140, 20)])
def test_z_gather_walk_issues_every_gather_once(rows, rc, kce):
    """The staged form's lane walk (mirrored in Python) gathers each (row,
    grid, column) of a pass exactly once."""
    seen = [t for lane in range(32) for t in _gather_walk(lane, rows, rc,
                                                           kce)]
    assert sorted(seen) == [(p, g, kk) for p in range(rows)
                            for g in range(rc) for kk in range(kce)]


def test_wrappers_reject_bad_input():
    idx = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="impl"):
        ops.z_matmul(idx, torch.zeros((8, 1)), torch.ones(4), d_g=4,
                     impl="cuda")
    with pytest.raises(ValueError, match="power of two"):
        ops.rb_binning(*_torch_rb(*_rb_inputs(0, 4, 2, 2)), d_g=3)


# --------------------------------------------------------------------------
# flash attention: the plain version (what the CPU path runs) against the
# JAX package's XLA oracle and its Pallas kernel in interpret mode, over
# tests/test_kernels.py's grid; f32 within 2e-5, bf16 within 3e-2 (the JAX
# test's tolerances: bf16 rounds P at another place than the oracle)
# --------------------------------------------------------------------------

FLASH_GRID = [(64, 64, 16, True, None), (128, 128, 32, True, None),
              (64, 64, 16, True, 24), (128, 128, 16, False, None)]


def _flash_inputs(seed, b, s, t, h, hkv, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(b, s, h, hd)), rng.normal(size=(b, t, hkv, hd)),
            rng.normal(size=(b, t, hkv, hd)))
    # round to the working dtype once, so both packages see the same values
    ts = [torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
          for a in arrs]
    js = [jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype))
          for x in ts]
    return ts, js


def _flash_close(got, want, dtype):
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("s,t,hd,causal,window", FLASH_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
def test_flash_attention_plain_matches_reference(s, t, hd, causal, window,
                                                 dtype, jimpl):
    (q, k, v), (jq, jk, jv) = _flash_inputs(s + hd, 2, s, t, 3, 3, hd, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                impl=jimpl)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _flash_close(got, want, dtype)


@pytest.mark.parametrize("s,t,causal,window", [
    (1000, 1000, True, None),    # ragged: no divisor rule on S or T
    (1000, 1000, True, 100),
    (48, 80, True, None),        # S < T, top-left aligned causal mask
    (80, 48, True, None),        # S > T
    (40, 72, False, 16),         # non-causal with a window
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ragged_and_rectangular(s, t, causal, window, dtype):
    b, h, hd = 1, 2, 32
    (q, k, v), (jq, jk, jv) = _flash_inputs(s * t, b, s, t, h, h, hd, dtype)
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(b * h, x.shape[1], hd)
    want = jref.flash_attention_ref(fold(jq), fold(jk), fold(jv),
                                    causal=causal, window=window)
    want = np.asarray(want, np.float32).reshape(b, h, s, hd)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    _flash_close(got, want.transpose(0, 2, 1, 3), dtype)


def test_flash_attention_grouped_kv_matches_repeated():
    """K/V at fewer heads (grouped-query) equal K/V repeated to H heads, the
    JAX package's public layout."""
    (q, k, v), (jq, jk, jv) = _flash_inputs(5, 2, 64, 64, 4, 2, 16,
                                            "float32")
    want = jops.flash_attention(jq, jnp.repeat(jk, 2, axis=2),
                                jnp.repeat(jv, 2, axis=2), impl="xla")
    _flash_close(ops.flash_attention(q, k, v), want, "float32")


def _row_error(got, want):
    """Largest relative L2 error over the rows (last axis)."""
    f32 = lambda x: x.float() if torch.is_tensor(x) \
        else torch.from_numpy(np.asarray(x, np.float32))
    got, want = f32(got), f32(want)
    err = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    return float(err.max())


def test_flash_bf16_row_limit_passes_the_tpu_kernel_and_fails_a_fault():
    """The card's bf16 check holds each (b, s, h) row to relative L2 1e-2.
    The TPU kernel (64×64 blocks, P rounded unnormalised) stays well inside
    it against the plain version; one key too many per row does not."""
    from repro.kernels.flash_attention import flash_attention_pallas
    (q, k, v), (jq, jk, jv) = _flash_inputs(11, 1, 1024, 1024, 2, 2, 128,
                                            "bfloat16")
    fold = lambda x: jnp.transpose(x, (0, 2, 1, 3)).reshape(2, 1024, 128)
    tpu = flash_attention_pallas(fold(jq), fold(jk), fold(jv), block_q=64,
                                 block_kv=64, interpret=True)
    tpu = np.asarray(tpu, np.float32).reshape(1, 2, 1024, 128)
    want = ops.flash_attention(q, k, v)
    assert _row_error(tpu.transpose(0, 2, 1, 3), want) <= 1e-2
    # the causal mask off by one: query i also sees key i + 1
    q1 = torch.cat([torch.zeros_like(q[:, :1]), q], dim=1)
    assert _row_error(ops.flash_attention(q1, k, v)[:, 1:], want) > 1e-2


def test_flash_attention_rejects_bad_input():
    q = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError, match="do not fit"):
        ops.flash_attention(q, torch.zeros((1, 8, 3, 16)),
                            torch.zeros((1, 8, 3, 16)))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, q, q, impl="cuda")


# rows 6.. of S 16, T 4, window 3 see no key (i >= T + window - 1)
KEYLESS = dict(s=16, t=4, window=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_keyless_rows_match_reference(dtype, causal):
    """A windowed row that sees no key: the reference's uniform softmax over
    all T scores of -1e30 gives it mean(V); the plain version agrees."""
    s, t, window = KEYLESS["s"], KEYLESS["t"], KEYLESS["window"]
    (q, k, v), (jq, jk, jv) = _flash_inputs(s + t, 2, s, t, 3, 3, 16, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                impl="xla")
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    _flash_close(got, want, dtype)
    mean_v = v.float().mean(dim=1)                   # (B, H, hd)
    rows = got[:, t + window - 1:].float()
    np.testing.assert_allclose(
        rows.numpy(), mean_v[:, None].expand_as(rows).numpy(),
        rtol=2e-5 if dtype == "float32" else 3e-2,
        atol=2e-5 if dtype == "float32" else 3e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hkv", [3, 1])
def test_flash_keyless_fill_matches_the_plain_version(dtype, hkv):
    """The pass that ``ops.flash_attention`` runs after the kernel for rows
    that see no key writes the plain version's rows there (grouped K/V
    included), and nothing else."""
    s, t, window = KEYLESS["s"], KEYLESS["t"], KEYLESS["window"]
    (q, k, v), _ = _flash_inputs(7 * hkv, 2, s, t, 3, hkv, 32, dtype)
    want = ref.flash_attention_bshd_ref(q, k, v, causal=True, window=window)
    row0 = t + window - 1
    got = want.clone()
    got[:, row0:] = 0
    ops._fill_keyless_rows(got, v, row0)
    torch.testing.assert_close(got[:, :row0], want[:, :row0], rtol=0, atol=0)
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)


def _wrapper_calls(dev):
    """Each kernel wrapper on small inputs on ``dev``: name → (inputs,
    call). The ELL pattern is the plain RB binning's."""
    x, w, b, ha, hc = (t.to(dev) for t in _torch_rb(*_rb_inputs(3, 50, 3,
                                                                 4)))
    d_g, d = 16, 64
    idx = ref.rb_binning_ref(x.cpu(), w.cpu(), b.cpu(), ha.cpu(), hc.cpu(),
                             d_g).to(dev)
    g = torch.Generator().manual_seed(0)
    v, u = (torch.randn(shape, generator=g).to(dev)
            for shape in ((d, 5), (50, 5)))
    rs = torch.rand(50, generator=g).to(dev)
    cents = torch.randn(6, 3, generator=g).to(dev)
    q, k = (torch.randn(shape, generator=g).to(dev, torch.bfloat16)
            for shape in ((2, 40, 4, 16), (2, 40, 2, 16)))
    return {
        "rb_binning": ((x, w, b, ha, hc), lambda *t: ops.rb_binning(
            *t, d_g=d_g)),
        "z_matmul": ((idx, v, rs), lambda *t: ops.z_matmul(*t, d_g=d_g)),
        "z_matmul_gather": ((idx, v, rs), lambda *t: ops.z_matmul_gather(
            *t, d_g=d_g)),
        "zt_matmul": ((idx, u, rs), lambda *t: ops.zt_matmul(
            *t, d, d_g=d_g)),
        "gram_matmul": ((idx, u, rs), lambda *t: ops.gram_matmul(
            *t, d, d_g=d_g)),
        "bin_counts": ((idx,), lambda i: ops.bin_counts(i, d=d, d_g=d_g)),
        "kmeans_assign": ((x, cents), ops.kmeans_assign),
        "kmeans_assign_stats": ((x, cents), ops.kmeans_assign_stats),
        "flash_attention": ((q, k, k), ops.flash_attention),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls("cpu")))
def test_fake_implementation_gives_the_plain_output_shapes(name):
    """Each wrapper given FakeTensors (a dry run's) takes its kernel's
    ``torch.library`` op and its fake: the plain version's output shapes
    and dtypes on the same inputs, with nothing computed."""
    from torch._subclasses.fake_tensor import FakeTensorMode, is_fake
    inputs, call = _wrapper_calls("cpu")[name]
    want = call(*inputs)
    want = want if isinstance(want, tuple) else (want,)
    with FakeTensorMode() as mode:
        got = call(*(mode.from_tensor(t) for t in inputs))
    got = got if isinstance(got, tuple) else (got,)
    assert hasattr(torch.ops.repro_torch, name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert is_fake(g)
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)
