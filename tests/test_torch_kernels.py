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
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops

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


def test_wrappers_reject_bad_input():
    idx = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="impl"):
        ops.z_matmul(idx, torch.zeros((8, 1)), torch.ones(4), d_g=4,
                     impl="cuda")
    with pytest.raises(ValueError, match="power of two"):
        ops.rb_binning(*_torch_rb(*_rb_inputs(0, 4, 2, 2)), d_g=3)
