"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need a card and skip without one (the kernels have no CPU
mode). On the machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

They import neither JAX nor the JAX package. Tolerances: RB indices and
assignment labels exact; float32 products within 1e-6 + 1e-5·Σ|terms| (the
summation order differs, and a sum that cancels is only as exact as its
terms are large); bfloat16 V within one bfloat16 rounding of the output
(2^-8 relative) on top of that. The ``zt`` kernel must give the same bits
on every run (no atomics).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

BF16_RTOL = 2.0 ** -8
RB_SHAPES = [(64, 2, 8, 64), (100, 3, 16, 128), (256, 7, 4, 256),
             (513, 16, 32, 512)]
Z_SHAPES = [(64, 4, 64, 8), (100, 8, 128, 3), (256, 16, 64, 32),
            (300, 12, 256, 5)]


def _rb_inputs(seed, n, d, r):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 2.0).astype(np.float32)   # negatives too
    widths = (rng.gamma(2.0, size=(r, d)) * 0.5 + 1e-3).astype(np.float32)
    biases = (rng.uniform(size=(r, d)) * widths).astype(np.float32)
    hash_a = (rng.integers(0, 2**31 - 1, size=(r, d)) * 2 + 1).astype(np.uint32)
    hash_c = rng.integers(0, 2**31 - 1, size=(r,)).astype(np.uint32)
    bits = lambda a: torch.from_numpy(a.view(np.int32).copy())
    return (torch.from_numpy(x), torch.from_numpy(widths),
            torch.from_numpy(biases), bits(hash_a), bits(hash_c))


def _assert_sum_close(got, want, abs_terms, rtol=1e-5):
    err = (got.float() - want.float()).abs()
    bound = 1e-6 + rtol * abs_terms.float()
    assert bool(torch.all(err <= bound)), float((err - bound).max())


def _ell(seed, n, r, d_g):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, d_g, size=(n, r))
            + np.arange(r)[None, :] * d_g).astype(np.int32)


# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("n,d,r,d_g", RB_SHAPES + [(1, 54, 33, 2048)])
def test_cuda_rb_binning_bit_exact(cuda, n, d, r, d_g):
    t = [a.to(cuda) for a in _rb_inputs(n + r, n, d, r)]
    got = ops.rb_binning(*t, d_g=d_g)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.rb_binning_ref(*t, d_g))


@pytest.mark.parametrize("n,r,d_g,k", Z_SHAPES + [(1000, 5, 16, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_z_matmul(cuda, n, r, d_g, k, dtype):
    rng = np.random.default_rng(n + k)
    idx = torch.from_numpy(_ell(n, n, r, d_g)).to(cuda)
    v = torch.from_numpy(rng.normal(size=(r * d_g, k)).astype(np.float32)
                         ).to(cuda, getattr(torch, dtype))
    s = torch.from_numpy((rng.uniform(size=n) + 0.5).astype(np.float32)
                         ).to(cuda)
    got = ops.z_matmul(idx, v, s, d_g=d_g)
    rtol = 1e-5 if dtype == "float32" else BF16_RTOL + 1e-5
    _assert_sum_close(got, ref.z_matmul_ref(idx, v, s),
                      ref.z_matmul_ref(idx, v.abs(), s).float(), rtol)


@pytest.mark.parametrize("n,r,d_g,k", Z_SHAPES + [
    (1000, 5, 16, 40),     # K > 32: two register passes
    (3, 2, 1024, 1),       # almost every column empty
    (5000, 2, 2, 3),       # columns longer than one chunk
    (5000, 3, 1, 40),      # every row in one column per grid
])
def test_cuda_zt_matmul(cuda, n, r, d_g, k):
    rng = np.random.default_rng(n * k)
    idx = torch.from_numpy(_ell(n, n, r, d_g)).to(cuda)
    u = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(cuda)
    s = torch.from_numpy((rng.uniform(size=n) + 0.5).astype(np.float32)
                         ).to(cuda)
    d = r * d_g
    got = ops.zt_matmul(idx, u, s, d, d_g=d_g)
    _assert_sum_close(got, ref.zt_matmul_ref(idx, u, s, d),
                      ref.zt_matmul_ref(idx, u.abs(), s, d))
    again = ops.zt_matmul(idx, u, s, d, d_g=d_g, csc=ops.ell_csc(idx, d))
    assert torch.equal(got, again)          # fixed order: the same bits


@pytest.mark.parametrize("n,d,k", [(64, 2, 3), (1000, 8, 16), (1025, 16, 7)])
def test_cuda_kmeans_assign(cuda, n, d, k):
    rng = np.random.default_rng(n + d)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)).to(cuda)
    lab, dist = ops.kmeans_assign(x, c)
    want_l, want_d = ref.kmeans_assign_ref(x, c)
    assert torch.equal(lab, want_l)
    torch.testing.assert_close(dist, want_d, rtol=1e-5, atol=1e-5)


def test_cuda_wrappers_reject_mixed_devices(cuda):
    idx = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        ops.z_matmul(idx, torch.zeros((8, 1)), torch.ones(4), d_g=4)


def test_cuda_counts_launches(cuda):
    x = torch.randn((10, 3), device=cuda)
    ops.reset_launch_counts()
    ops.kmeans_assign(x, x[:2].contiguous())
    ref.kmeans_assign_ref(x, x[:2])
    assert ops.launch_counts()["kmeans_assign"] == 1
