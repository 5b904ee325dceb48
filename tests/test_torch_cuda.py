"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need a card and skip without one (the kernels have no CPU
mode). On the machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

They import neither JAX nor the JAX package. Tolerances: RB indices and
assignment labels exact; float32 products within 1e-6 + 1e-5·Σ|terms| (the
summation order differs, and a sum that cancels is only as exact as its
terms are large); bfloat16 V within one bfloat16 rounding of the output
(2^-8 relative) on top of that. The ``zt`` kernel must give the same bits
on every run (no atomics), and ``z_matmul``'s strip kernel the same bits
as its gather kernel (both add the grids in order); the strip route needs
at least ``ops.Z_STRIP_MIN_ROWS`` rows, so its cases are that large.
``rb_binning`` is also held bit for bit on ``ref.rb_hard_cases``' planted
quotients. The fused Gram kernel must give the bits of ``zt_matmul`` then
``z_matmul`` (it keeps both kernels' sums). ``kmeans_assign`` is held on
small integer values, where every distance is exact whatever the order of
the sums, so labels (ties to the first index) and distances agree
exactly; its statistics form's counts equal ``bincount``'s, its sums and
inertia are within 1e-6 + 1e-5·Σ|terms|, and two runs give the same
bits (no float atomics). Flash attention: float32 within 2e-5, bfloat16
within 3e-2 (the JAX package's tolerances; the kernel rounds P to bfloat16
before normalising, the plain version after); its ``torch.library`` fake
(the dry run's shape-only implementation) gives the kernel output's shape,
dtype, strides and device, and launches nothing; so do the SC_RB kernels'
fakes. The LM serving path on the
card: one flash launch per layer in a generate, and float32 logits within
1e-4 of the same model on the CPU (the SSM mixer's outputs and caches
too), greedy tokens equal. LM training on the card: the flash kernel's
forward with the plain backward against autograd through the float32
plain version (float32 within 1e-4, bf16 rows within 1e-2), a float32
smoke-size loss and every gradient within 1e-4 of the CPU's, the kernel
launched once a layer and once more under a recomputing remat, and a
Trainer's restart repeating its losses. Dense feature maps: features within
1e-5 of the CPU's and the same bits in any batch; every Table-2 method's
labels against the CPU's by ARI ≥ 0.99. The serving engine: each CUDA
graph's replay the bits of the same cell run eagerly, every answer the
bits of ``model.predict``/``transform``, and no capture, staging buffer or
device allocation at steady state. The placements: a partitioned fit
against the CPU by ARI ≥ 0.99, one worker against a stream a partition
bit for bit with equal launch counts, and a gloo world of 2 ranks on the
card holding its Gram product within 1e-5 relative of the fused one.
More than one card (skipped below two): each library's kernels on every
card after card 0 in one process, against the plain version and bit-equal
to card 0's output (the kernels' launch setup is per device); a
partitioned fit spread over every card bit-identical to the same fit on
card 0 alone; an NCCL world of 2, one rank a card, holding its Gram
product within 1e-5 relative of the fused one.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as T
from repro_torch.serve import engine as E

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


@pytest.fixture
def cards():
    """The card count, at least two."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.cuda.device_count()


def _library_run(lib: str, dev):
    """One library's entry points on card ``dev``, each output held against
    its plain version on the same card; the outputs on the host. The
    shapes lift each kernel's shared-memory limit above 48 KB where it has
    one: the strip route of z_matmul, kmeans_assign_stats at d 16, K 64,
    the bf16 flash kernel."""
    gen = torch.Generator().manual_seed(21)
    with torch.cuda.device(dev):
        if lib == "rb_binning":
            t = [a.to(dev) for a in _rb_inputs(7, 4096, 54, 64)]
            got = ops.rb_binning(*t, d_g=2048)
            assert torch.equal(got, ref.rb_binning_ref(*t, 2048))
            outs = (got,)
        elif lib == "bin_counts":
            idx = torch.from_numpy(_ell(3, 50_000, 32, 512)).to(dev)
            got = ops.bin_counts(idx, d=32 * 512, d_g=512)
            assert torch.equal(got, ref.bin_counts_ref(idx, 32 * 512))
            outs = (got,)
        elif lib == "ell_spmm":
            n, r, d_g, k = ops.Z_STRIP_MIN_ROWS, 32, 512, 11
            idx = torch.from_numpy(_ell(5, n, r, d_g)).to(dev)
            v = torch.randn((r * d_g, k), generator=gen).to(dev)
            u = torch.randn((n, k), generator=gen).to(dev)
            s = (torch.rand((n,), generator=gen) + 0.5).to(dev)
            y = ops.z_matmul(idx, v, s, d_g=d_g)
            assert torch.equal(y, ops.z_matmul_gather(idx, v, s, d_g=d_g))
            _assert_sum_close(y, ref.z_matmul_ref(idx, v, s),
                              ref.z_matmul_ref(idx, v.abs(), s))
            q = ops.zt_matmul(idx, u, s, d=r * d_g, d_g=d_g)
            _assert_sum_close(q, ref.zt_matmul_ref(idx, u, s, r * d_g),
                              ref.zt_matmul_ref(idx, u.abs(), s, r * d_g))
            g = ops.gram_matmul(idx, u, s, r * d_g, d_g=d_g)
            assert torch.equal(g, ops.z_matmul(idx, q, s, d_g=d_g))
            outs = (y, q, g)
        elif lib == "kmeans_assign":
            rng = np.random.default_rng(9)
            x = torch.from_numpy(rng.integers(-8, 8, size=(20_000, 16))
                                 .astype(np.float32)).to(dev)
            c = torch.from_numpy(rng.integers(-8, 8, size=(64, 16))
                                 .astype(np.float32)).to(dev)
            lab, dist = ops.kmeans_assign(x, c)
            want_l, want_d = ref.kmeans_assign_ref(x, c)
            assert torch.equal(lab, want_l) and torch.equal(dist, want_d)
            st = ops.kmeans_assign_stats(x, c)
            onehot = torch.nn.functional.one_hot(lab.long(), 64).float()
            assert torch.equal(st[0], lab)
            assert torch.equal(st[1], onehot.sum(0))
            assert torch.equal(st[2], onehot.T @ x)
            outs = (lab, dist, *st)
        else:
            q = torch.randn((1, 300, 4, 128), generator=gen).to(
                dev, torch.bfloat16)
            k = torch.randn((1, 300, 2, 128), generator=gen).to(
                dev, torch.bfloat16)
            v = torch.randn((1, 300, 2, 128), generator=gen).to(
                dev, torch.bfloat16)
            got = ops.flash_attention(q, k, v, causal=True)
            want = ref.flash_attention_bshd_ref(q, k, v, causal=True)
            assert float((got.float() - want.float()).abs().max()) <= 3e-2
            outs = (got,)
        torch.cuda.synchronize(dev)
    return [o.cpu() for o in outs]


@pytest.mark.parametrize("lib", ["rb_binning", "ell_spmm", "bin_counts",
                                 "kmeans_assign", "flash_attention"])
def test_cuda_every_library_on_every_card(cards, lib):
    """Each library's kernels on card 0 and then on every other card, in one
    process: each against its plain version, and every card's output the
    bits of card 0's. A kernel whose shared-memory limit was lifted on card
    0 alone would fail to launch on the next card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    first = _library_run(lib, torch.device("cuda", 0))
    for c in range(1, cards):
        got = _library_run(lib, torch.device("cuda", c))
        for a, b in zip(got, first):
            assert torch.equal(a, b), (lib, c)


@pytest.mark.parametrize("n,d,r,d_g", RB_SHAPES + [(1, 54, 33, 2048)])
def test_cuda_rb_binning_bit_exact(cuda, n, d, r, d_g):
    t = [a.to(cuda) for a in _rb_inputs(n + r, n, d, r)]
    got = ops.rb_binning(*t, d_g=d_g)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.rb_binning_ref(*t, d_g))


def test_cuda_rb_binning_hash_edge_values(cuda):
    """tests/test_torch_kernels.py's edge values: bins of large magnitude
    and both signs, multipliers near 2^32."""
    x = torch.tensor([[-1e5, 3e4], [7.5, -0.25], [0.0, 1e6]])
    widths = torch.tensor([[0.5, 2.0], [1e-3, 3.0]])
    biases = torch.tensor([[0.1, 1.9], [0.0, 0.5]])
    bits = lambda a: torch.from_numpy(np.array(a, np.uint32).view(np.int32))
    hash_a = bits([[0xFFFFFFFF, 0x80000001], [1, 0xDEADBEEF]])
    hash_c = bits([0xFFFFFFF0, 0x12345678])
    t = [a.to(cuda) for a in (x, widths, biases, hash_a, hash_c)]
    for d_g in (1, 2, 1024):
        got = ops.rb_binning(*t, d_g=d_g)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.rb_binning_ref(*t, d_g))


def test_cuda_rb_binning_planted_rows(cuda):
    """ref.rb_hard_cases: quotients on an integer, one ulp off it, or
    rounded onto it; row i and grid i hold triple i (d = 1)."""
    x, b, w, _ = ref.rb_hard_cases(0)
    rng = np.random.default_rng(0)
    m = x.shape[0]
    a = (rng.integers(0, 2**31 - 1, size=(m, 1)) * 2 + 1).astype(np.uint32)
    c = rng.integers(0, 2**31 - 1, size=(m,)).astype(np.uint32)
    bits = lambda v: torch.from_numpy(v.view(np.int32).copy())
    t = [torch.from_numpy(x[:, None]), torch.from_numpy(w[:, None]),
         torch.from_numpy(b[:, None]), bits(a), bits(c)]
    t = [v.to(cuda) for v in t]
    got = ops.rb_binning(*t, d_g=1024)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.rb_binning_ref(*t, 1024))


def _strip_case(cuda, n, r, d_g, k, dtype, seed=0):
    """idx with bins at both ends of every strip (rows 0-999 alternate
    g·d_g and g·d_g + d_g − 1), V and row scales from ``seed``."""
    rng = np.random.default_rng(seed)
    idx = _ell(seed, n, r, d_g)
    ends = np.where(np.arange(1000)[:, None] % 2 == 0, 0, d_g - 1)
    idx[:1000] = (ends + np.arange(r)[None, :] * d_g)[:n]
    v = torch.from_numpy(rng.normal(size=(r * d_g, k)).astype(np.float32)
                         ).to(cuda, getattr(torch, dtype))
    s = torch.from_numpy((rng.uniform(size=n) + 0.5).astype(np.float32)
                         ).to(cuda)
    return torch.from_numpy(idx).to(cuda), v, s


@pytest.mark.parametrize("n,r,d_g,k,dtype", [
    (140_001, 8, 64, 1, "float32"),
    (140_001, 8, 64, 4, "float32"),
    (140_001, 8, 64, 11, "float32"),
    (140_001, 8, 64, 12, "float32"),
    (140_001, 8, 64, 40, "float32"),
    (131_072, 16, 2048, 11, "float32"),   # the fit's strip
    (140_001, 8, 4096, 11, "float32"),    # column groups of 2
    (140_001, 8, 8192, 11, "float32"),    # one column a group
    (140_001, 8, 64, 1, "bfloat16"),
    (140_001, 8, 64, 11, "bfloat16"),
    (140_001, 8, 128, 2, "bfloat16"),
])
def test_cuda_z_matmul_strip(cuda, n, r, d_g, k, dtype):
    """The strip kernel: the plain version's sums, and the gather kernel's
    bits (the same order of addition) in float32 and bfloat16."""
    assert ops.z_strip_plan(n, r, d_g, k, getattr(torch, dtype)) is not None
    idx, v, s = _strip_case(cuda, n, r, d_g, k, dtype, seed=n + k)
    ops.reset_launch_counts()
    got = ops.z_matmul(idx, v, s, d_g=d_g)
    gather = ops.z_matmul_gather(idx, v, s, d_g=d_g)
    torch.cuda.synchronize()
    assert ops.launch_counts()["z_matmul"] == 1
    assert ops.launch_counts()["z_matmul_gather"] == 1
    assert got.dtype == v.dtype and got.shape == (n, k)
    assert torch.equal(got, gather)
    rtol = 1e-5 if dtype == "float32" else BF16_RTOL + 1e-5
    _assert_sum_close(got, ref.z_matmul_ref(idx, v, s),
                      ref.z_matmul_ref(idx, v.abs(), s).float(), rtol)


@pytest.mark.parametrize("n,r,d_g", [(140_001, 12, 64),    # R % 8
                                     (1_000, 8, 64),       # few rows
                                     (131_072, 8, 16384)])  # strip too big
def test_cuda_z_matmul_gather_route(cuda, n, r, d_g):
    assert ops.z_strip_plan(n, r, d_g, 11, torch.float32) is None
    idx, v, s = _strip_case(cuda, n, r, d_g, 11, "float32", seed=n)
    ops.reset_launch_counts()
    got = ops.z_matmul(idx, v, s, d_g=d_g)
    torch.cuda.synchronize()
    assert ops.launch_counts()["z_matmul"] == 0
    assert ops.launch_counts()["z_matmul_gather"] == 1
    _assert_sum_close(got, ref.z_matmul_ref(idx, v, s),
                      ref.z_matmul_ref(idx, v.abs(), s))


def _host_fold(idx, v, s):
    """y = diag(s)·Z·v as the kernels promise it, on the host: acc = 0, acc
    += float32(v[idx[:, r]]) for r = 0 ... R-1 in order, then acc · s once,
    rounded to V's dtype."""
    idx, v, s = idx.cpu().long(), v.cpu(), s.cpu()
    acc = torch.zeros((idx.shape[0], v.shape[1]), dtype=torch.float32)
    for g in range(idx.shape[1]):
        acc += v[idx[:, g]].float()
    return (acc * s[:, None]).to(v.dtype)


ENGINE_BUCKETS = (64, 256, 1_024, 4_096)   # ClusterEngine's default buckets


@pytest.mark.parametrize("n", ENGINE_BUCKETS)
@pytest.mark.parametrize("k", [1, 7, 11, 14, 40])
@pytest.mark.parametrize("r", [5, 12, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_z_matmul_gather_is_the_in_order_fold(cuda, n, k, r, dtype):
    """The gather kernel at the engine's buckets gives the bits of the
    in-order float32 fold over the grids, scaled once (the promise the
    strip kernel, the degrees and the engine's bit-identity rest on)."""
    idx, v, s = _strip_case(cuda, n, r, 512, k, dtype, seed=n * k + r)
    ops.reset_launch_counts()
    got = ops.z_matmul_gather(idx, v, s, d_g=512)
    torch.cuda.synchronize()
    assert ops.launch_counts()["z_matmul_gather"] == 1
    assert got.dtype == v.dtype and got.shape == (n, k)
    assert torch.equal(got.cpu(), _host_fold(idx, v, s))


@pytest.mark.parametrize("n,r,d_g,k", [
    (131_071, 256, 2_048, 7),    # one row short of the strip route
    (56_724, 256, 2_048, 11),    # a host-chunked fit's ragged last chunk
    (4_096, 8, 16_384, 7),       # a strip too large for the strip route
    (3_001, 600, 16, 3),         # R > 256: passes of 256 grids
    (777, 1, 8, 40),             # one grid
    (1_000, 36, 16, 1),          # staged, 2 rows a warp
    (16_000, 40, 8, 1),          # staged, 4 rows a warp
])
def test_cuda_z_matmul_gather_in_order_fold_other_shapes(cuda, n, r, d_g, k):
    idx, v, s = _strip_case(cuda, n, r, d_g, k, "float32", seed=n + r)
    got = ops.z_matmul_gather(idx, v, s, d_g=d_g)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), _host_fold(idx, v, s))


@pytest.mark.parametrize("n", [1_024, 4_096])
@pytest.mark.parametrize("k", [1, 7, 11, 40])
@pytest.mark.parametrize("form", ["staged", "register"])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_z_matmul_gather_forms_give_the_fold(cuda, monkeypatch, n, k,
                                                  form, aligned):
    """Both forms of the gather route (``z_gather_plan``'s route, forced
    here at 1,024 and 4,096 rows) on idx rows that are 16-byte aligned or
    not (the idx loads then go 4 bytes at a time): the bits of the
    in-order fold."""
    r, d_g = 255 if not aligned else 256, 512
    idx, v, s = _strip_case(cuda, n, r, d_g, k, "float32", seed=n + k)
    monkeypatch.setattr(ops, "Z_GATHER_ROWS_MIN_OUTPUTS",
                        0 if form == "register" else 1 << 62)
    assert ops.z_gather_plan(n, r, k, torch.float32).route == (
        form == "register")
    got = ops.z_matmul_gather(idx, v, s, d_g=d_g)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), _host_fold(idx, v, s))


@pytest.mark.parametrize("k", [1, 7])
def test_cuda_z_matmul_gather_equals_strip_at_full_width(cuda, k):
    """At the fit's R and d_g, on a shape both routes take: the same bits
    (the degrees' K = 1 and the projection's K = 7)."""
    n, r, d_g = 131_072, 256, 2_048
    assert ops.z_strip_plan(n, r, d_g, k, torch.float32) is not None
    idx, v, s = _strip_case(cuda, n, r, d_g, k, "float32", seed=k)
    strip = ops.z_matmul(idx, v, s, d_g=d_g)
    gather = ops.z_matmul_gather(idx, v, s, d_g=d_g)
    torch.cuda.synchronize()
    assert torch.equal(strip, gather)


def test_cuda_z_matmul_rejects_v_off_the_strips(cuda):
    idx, v, s = _strip_case(cuda, 140_001, 8, 64, 3, "float32")
    with pytest.raises(ValueError, match="R·d_g"):
        ops.z_matmul(idx, v[:-1].contiguous(), s, d_g=64)
    with pytest.raises(ValueError, match="R·d_g"):
        ops.z_matmul(idx, v, s, d_g=32)


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
    (20000, 16, 64, 11),   # the main path's width, ~300 nonzeros a column
    (9000, 4, 2, 11),      # K = 11 with columns longer than one chunk
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


GRAM_STRIP_CASES = [  # n, r, d_g, k: shapes the strip route takes
    (131_072, 16, 256, 11),    # the fit's width, column groups of 4
    (140_001, 8, 16, 11),      # every column longer than ZT_CHUNK
    (131_072, 8, 64, 1),       # column groups of 1
    (131_072, 8, 8, 1),        # groups of 1, every column long
    (140_001, 8, 64, 2),       # groups of 2
    (131_072, 8, 64, 3),       # one group with a pad column
    (131_072, 8, 64, 40),      # 10 groups, 16 lanes a nonzero
    (131_072, 16, 4096, 11),   # groups of 2 (a wide strip)
]


def _gram_case(cuda, n, r, d_g, k):
    rng = np.random.default_rng(n + r + k)
    idx = torch.from_numpy(_ell(n + d_g, n, r, d_g)).to(cuda)
    u = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(cuda)
    s = torch.from_numpy((rng.uniform(size=n) + 0.5).astype(np.float32)
                         ).to(cuda)
    return idx, u, s


@pytest.mark.parametrize("n,r,d_g,k", GRAM_STRIP_CASES)
def test_cuda_gram_matmul_fused(cuda, n, r, d_g, k):
    """The fused Gram kernel: the bits of zt_matmul then z_matmul, the same
    bits on a second run, and the plain version's sums."""
    assert ops.z_strip_plan(n, r, d_g, k, torch.float32) is not None
    idx, u, s = _gram_case(cuda, n, r, d_g, k)
    d = r * d_g
    csc = ops.ell_csc(idx, d)
    ops.reset_launch_counts()
    got = ops.gram_matmul(idx, u, s, d, d_g=d_g, csc=csc)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["gram_matmul"] == 1
    assert counts["zt_matmul"] == counts["z_matmul"] == 0
    assert counts["gram_matmul_composed"] == 0
    want = ops.z_matmul(idx, ops.zt_matmul(idx, u, s, d, d_g=d_g, csc=csc),
                        s, d_g=d_g)
    assert got.shape == (n, k) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(got, ops.gram_matmul(idx, u, s, d, d_g=d_g, csc=csc))
    terms = ref.z_matmul_ref(idx, ref.zt_matmul_ref(idx, u.abs(), s, d), s)
    _assert_sum_close(got, ref.z_matmul_ref(
        idx, ref.zt_matmul_ref(idx, u, s, d), s), terms)


@pytest.mark.parametrize("n,r,d_g,k", [(1000, 8, 64, 11),     # few rows
                                       (140_001, 12, 64, 11)])  # R % 8
def test_cuda_gram_matmul_composed_route(cuda, n, r, d_g, k):
    """Shapes the strip route does not take: zt then z, counted as such."""
    assert ops.z_strip_plan(n, r, d_g, k, torch.float32) is None
    idx, u, s = _gram_case(cuda, n, r, d_g, k)
    d = r * d_g
    ops.reset_launch_counts()
    got = ops.gram_matmul(idx, u, s, d, d_g=d_g)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["gram_matmul"] == 0 and counts["gram_matmul_composed"] == 1
    assert counts["zt_matmul"] == 1
    want = ops.z_matmul(idx, ops.zt_matmul(idx, u, s, d, d_g=d_g), s,
                        d_g=d_g)
    assert torch.equal(got, want)


@pytest.mark.parametrize("d", [1, 2, 7, 16, 33])
@pytest.mark.parametrize("n", [1, 1000, 1025, 131_072])
def test_cuda_kmeans_assign_every_width(cuda, n, d):
    """Every instantiation of the kernel (d 1..16, and the looped form for
    wider rows) against the plain version. Small integer values make every
    distance exact in float32 whatever the order of the sums, so labels
    (ties to the first index included) and distances must agree exactly."""
    rng = np.random.default_rng(n + d)
    x = torch.from_numpy(rng.integers(-3, 4, size=(n, d)).astype(np.float32)
                         ).to(cuda)
    c = torch.from_numpy(rng.integers(-3, 4, size=(7, d)).astype(np.float32)
                         ).to(cuda)
    lab, dist = ops.kmeans_assign(x, c)
    torch.cuda.synchronize()
    want_l, want_d = ref.kmeans_assign_ref(x, c)
    assert torch.equal(lab, want_l)
    assert torch.equal(dist, want_d)


@pytest.mark.parametrize("d", [3, 7])
def test_cuda_kmeans_assign_unaligned_rows(cuda, d):
    """Rows that start off a 16-byte boundary (a view one row in): the
    tile's head and tail take 4-byte loads."""
    rng = np.random.default_rng(d)
    full = torch.from_numpy(rng.integers(-3, 4, size=(5001, d))
                            .astype(np.float32)).to(cuda)
    x = full[1:]
    assert x.is_contiguous() and x.data_ptr() % 16
    c = full[:5].contiguous()
    lab, dist = ops.kmeans_assign(x, c)
    want_l, want_d = ref.kmeans_assign_ref(x, c)
    assert torch.equal(lab, want_l) and torch.equal(dist, want_d)
    lab_s, counts, _, _ = ops.kmeans_assign_stats(x, c)
    assert torch.equal(lab_s, want_l)
    assert torch.equal(counts, torch.bincount(want_l, minlength=5).float())


@pytest.mark.parametrize("n,d,k", [(1, 7, 7), (1000, 2, 3), (1025, 16, 7),
                                   (131_072, 7, 7), (20_000, 33, 5),
                                   (5_000, 16, 40)])
def test_cuda_kmeans_assign_stats(cuda, n, d, k):
    """The statistics form: the assignment kernel's labels, counts exactly
    those of bincount, sums and inertia within 1e-5 of the sum of their
    absolute terms (another order of addition), and the same bits on a
    second run (no float atomics)."""
    rng = np.random.default_rng(n * d + k)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)).to(cuda)
    ops.reset_launch_counts()
    lab, counts, sums, inertia = ops.kmeans_assign_stats(x, c)
    torch.cuda.synchronize()
    assert ops.launch_counts()["kmeans_assign_stats"] == 1
    assert (lab.dtype, counts.shape, sums.shape, inertia.shape) == \
        (torch.int32, (k,), (k, d), ())
    want_l, dist = ops.kmeans_assign(x, c)
    assert torch.equal(lab, want_l)
    assert torch.equal(counts, torch.bincount(lab, minlength=k).float())
    onehot = torch.nn.functional.one_hot(lab.long(), k).float()
    _assert_sum_close(sums, onehot.T @ x, onehot.T @ x.abs())
    _assert_sum_close(inertia, dist.sum(), dist.sum())
    again = ops.kmeans_assign_stats(x, c)
    for a, b in zip((lab, counts, sums, inertia), again):
        assert torch.equal(a, b)


def test_cuda_kmeans_assign_stats_on_two_streams(cuda):
    """Statistics launches in flight on two streams at once: each has its
    own scratch and ticket counters, so every result has the bits of the
    same call made alone."""
    rng = np.random.default_rng(7)
    xs = [torch.from_numpy(rng.normal(size=(n, 7)).astype(np.float32))
          .to(cuda) for n in (131_072, 200_003)]
    cs = [x[:7].clone() for x in xs]
    want = [ops.kmeans_assign_stats(x, c) for x, c in zip(xs, cs)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in xs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    got = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(ops.kmeans_assign_stats(xs[i], cs[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for res in got[i]:
            for a, b in zip(res, want[i]):
                assert torch.equal(a, b)


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


# --------------------------------------------------------------------------
# flash attention and the LM serving path
# --------------------------------------------------------------------------

FLASH_CASES = [  # b, s, t, h, hkv, hd, causal, window
    (2, 64, 64, 3, 3, 16, True, None),
    (2, 128, 128, 3, 3, 32, True, None),
    (2, 64, 64, 3, 3, 16, True, 24),           # sliding window
    (2, 128, 128, 3, 3, 16, False, None),      # non-causal
    (1, 1000, 1000, 2, 2, 64, True, None),     # ragged S and T
    (1, 1000, 1000, 2, 2, 128, True, 100),     # ragged, window across tiles
    (1, 200, 333, 4, 2, 128, True, None),      # S < T, grouped kv
    (1, 333, 200, 4, 2, 160, True, None),      # S > T, head dim 160
    (2, 300, 300, 4, 1, 160, False, 64),       # non-causal window
    (1, 4096, 4096, 2, 1, 128, True, None),    # the prefill's length
    (1, 129, 129, 4, 2, 128, True, None),      # just above a 128-row tile
    (1, 255, 255, 4, 2, 64, True, None),       # just below two tiles
    (1, 150, 250, 4, 2, 128, True, None),      # S < T across two key tiles
    (1, 250, 150, 4, 2, 128, True, 120),       # S > T, window across tiles
    (1, 250, 150, 4, 2, 128, True, 100),       # as above; row 249 sees no
                                               # key (S >= T + window)
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention(cuda, case, dtype):
    b, s, t, h, hkv, hd, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(s * hd + t)
    dt = getattr(torch, dtype)
    q = torch.randn((b, s, h, hd), generator=g, device=cuda).to(dt)
    k = torch.randn((b, t, hkv, hd), generator=g, device=cuda).to(dt)
    v = torch.randn((b, t, hkv, hd), generator=g, device=cuda).to(dt)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention_bshd_ref(q, k, v, causal=causal,
                                        window=window).float()
    tol = 2e-5 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    if dtype == "bfloat16":
        # P and the output round to bf16 at other places than in the plain
        # version: ~3e-3 relative per row; a key too many or too few per
        # row moves a row by far more than 1e-2
        row_err = (got.float() - want).norm(dim=-1) \
            / want.norm(dim=-1).clamp_min(1e-30)
        assert float(row_err.max()) <= 1e-2


@pytest.mark.parametrize("case", [(2, 64, 64, 3, 3, 16, True, None),
                                  (1, 200, 333, 4, 2, 128, True, None),
                                  (2, 256, 256, 16, 4, 160, True, 64)],
                         ids=str)
@pytest.mark.parametrize("grad", [False, True])
def test_cuda_flash_fake_matches_the_kernel_output(cuda, case, grad):
    """The op's fake on FakeTensors made from the same CUDA inputs: the
    kernel output's shape, dtype, strides and device (and the gradients'
    under autograd), no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    b, s, t, h, hkv, hd, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
               .requires_grad_(grad)
               for shape in ((b, s, h, hd), (b, t, hkv, hd), (b, t, hkv, hd)))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    if grad:
        got.float().sum().backward()
    ops.reset_launch_counts()
    inputs = [x.detach() for x in (q, k, v)]
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(x).requires_grad_(grad)
                      for x in inputs)
        fake = ops.flash_attention(fq, fk, fv, causal=causal, window=window)
        if grad:
            fake.float().sum().backward()
    assert ops.launch_counts()["flash_attention"] == 0
    for real, f in ((got, fake),) + (((q.grad, fq.grad), (k.grad, fk.grad))
                                     if grad else ()):
        assert f.shape == real.shape and f.dtype == real.dtype
        assert f.stride() == real.stride() and f.device == real.device


def _sc_rb_calls(dev):
    """Each SC_RB kernel's wrapper on small inputs on ``dev``: name →
    (inputs, call); the ELL pattern is the plain RB binning's."""
    x, w, b, ha, hc = _rb_inputs(3, 50, 3, 4)
    d_g, d = 16, 64
    idx = ref.rb_binning_ref(x, w, b, ha, hc, d_g)
    g = torch.Generator().manual_seed(0)
    v, u = torch.randn((d, 5), generator=g), torch.randn((50, 5), generator=g)
    rs, cents = torch.rand(50, generator=g), torch.randn(6, 3, generator=g)
    x, w, b, ha, hc, idx, v, u, rs, cents = (
        t.to(dev) for t in (x, w, b, ha, hc, idx, v, u, rs, cents))
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
    }


@pytest.mark.parametrize("name", ["rb_binning", "z_matmul", "z_matmul_gather",
                                  "zt_matmul", "gram_matmul", "bin_counts",
                                  "kmeans_assign", "kmeans_assign_stats"])
def test_cuda_sc_rb_fakes_match_the_kernel_outputs(cuda, name):
    """Each SC_RB kernel's ``torch.library`` fake on FakeTensors made from
    the same CUDA inputs: the kernel outputs' shapes, dtypes, strides and
    device, and no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    inputs, call = _sc_rb_calls(cuda)[name]
    real = call(*inputs)
    real = real if isinstance(real, tuple) else (real,)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with FakeTensorMode() as mode:
        fake = call(*(mode.from_tensor(t) for t in inputs))
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert sum(ops.launch_counts().values()) == 0
    assert len(fake) == len(real)
    for f, r in zip(fake, real):
        assert f.shape == r.shape and f.dtype == r.dtype
        assert f.stride() == r.stride() and f.device == r.device


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,hkv", [(16, 3), (128, 1)])
def test_cuda_flash_attention_rows_that_see_no_key(cuda, dtype, hd, hkv):
    """S 16, T 4, window 3, causal: rows 6.. see no key, and get mean(V)
    over all T keys, as the reference's uniform softmax gives them."""
    g = torch.Generator(device=cuda).manual_seed(hd)
    dt = getattr(torch, dtype)
    q = torch.randn((2, 16, 3, hd), generator=g, device=cuda).to(dt)
    k = torch.randn((2, 4, hkv, hd), generator=g, device=cuda).to(dt)
    v = torch.randn((2, 4, hkv, hd), generator=g, device=cuda).to(dt)
    got = ops.flash_attention(q, k, v, causal=True, window=3)
    torch.cuda.synchronize()
    want = ref.flash_attention_bshd_ref(q, k, v, causal=True,
                                        window=3).float()
    tol = 2e-5 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    mean_v = v.float().mean(dim=1).repeat_interleave(3 // hkv, dim=1)
    torch.testing.assert_close(got[:, 6:].float(),
                               mean_v[:, None].expand(2, 10, 3, hd),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("hd", ops.FLASH_HEAD_DIMS)
def test_cuda_flash_bf16_every_head_dim_grouped(cuda, hd):
    # every instantiation of the TMA/wgmma kernel (each slab width and
    # swizzle), with K/V at fewer heads than Q and a ragged edge
    g = torch.Generator(device=cuda).manual_seed(hd)
    q = torch.randn((2, 300, 4, hd), generator=g, device=cuda).bfloat16()
    k = torch.randn((2, 300, 2, hd), generator=g, device=cuda).bfloat16()
    v = torch.randn((2, 300, 2, hd), generator=g, device=cuda).bfloat16()
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = ref.flash_attention_bshd_ref(q, k, v, causal=True).float()
    torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)
    row_err = (got.float() - want).norm(dim=-1) \
        / want.norm(dim=-1).clamp_min(1e-30)
    assert float(row_err.max()) <= 1e-2


def test_cuda_flash_attention_rejects_unbuilt_head_dim(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_generate_launches_flash_once_per_layer(cuda, dtype):
    cfg = dataclasses.replace(configs.smoke_config("internlm2-1.8b"),
                              dtype=dtype)
    model = T.init_params(cfg, 0)
    engine = E.Engine(cfg, model, E.ServeConfig(cache_len=40, batch_size=2))
    prompts = np.arange(64).reshape(2, 32) % cfg.vocab_size
    ops.reset_launch_counts()
    out = engine.generate(prompts, 6)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    assert out.shape == (2, 6)
    assert np.array_equal(out, engine.generate(prompts, 6))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "stablelm-12b"])
def test_cuda_prefill_and_decode_match_cpu(cuda, arch):
    cfg = configs.smoke_config(arch)
    cpu = T.init_params(cfg, 0, device="cpu")
    gpu = T.init_params(cfg, 0, device="cpu").to(cuda)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 33))
    logits = []
    for model in (cpu, gpu):
        caches = T.init_cache(cfg, 2, 40, device=model.device)
        first, caches = T.prefill(cfg, model, {"tokens": toks[:, :32]},
                                  caches)
        nxt, _ = T.decode_step(cfg, model, toks[:, 32], caches, 32)
        logits.append((first.cpu(), nxt.cpu()))
    for want, got in zip(*logits):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", [
    (2, 2048, 25, 5, 64, 1024),     # hymba-1.5b: rep 5, its sliding window
    (2, 2048, 32, 32, 64, None),    # musicgen-large: H = Hkv
], ids=str)
def test_cuda_flash_bf16_at_the_new_models_layouts(cuda, case):
    b, s, h, hkv, hd, window = case
    g = torch.Generator(device=cuda).manual_seed(h * hd)
    q = torch.randn((b, s, h, hd), generator=g, device=cuda).bfloat16()
    k = torch.randn((b, s, hkv, hd), generator=g, device=cuda).bfloat16()
    v = torch.randn((b, s, hkv, hd), generator=g, device=cuda).bfloat16()
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention_bshd_ref(q, k, v, causal=True,
                                        window=window).float()
    torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)
    row_err = (got.float() - want).norm(dim=-1) \
        / want.norm(dim=-1).clamp_min(1e-30)
    assert float(row_err.max()) <= 1e-2


def _cpu_and_card(cuda, arch):
    cfg = configs.smoke_config(arch)
    cpu = T.init_params(cfg, 0, device="cpu")
    return cfg, cpu, T.init_params(cfg, 0, device="cpu").to(cuda)


def test_cuda_ssm_mixer_matches_cpu(cuda):
    """The Mamba2 mixer in float32 on the card against the CPU: a prefill
    of two chunks into a cache (output, state, conv), then decode steps."""
    cfg, cpu, gpu = _cpu_and_card(cuda, "mamba2-370m")
    x = torch.randn((2, 67, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    got = {}
    for name, model in (("cpu", cpu), ("card", gpu)):
        dev = model.device
        mixer = model.segments[0][0].mixer
        cache = {k: v[0] for k, v in
                 T.init_cache(cfg, 2, 8, device=dev)["seg0"].items()}
        outs = [mixer(x[:, :64].to(dev), cache=cache)[0]]
        for i in range(64, 67):
            outs.append(mixer(x[:, i:i + 1].to(dev), cache=cache)[0])
        got[name] = [o.cpu() for o in outs] + [cache["state"].cpu(),
                                               cache["conv"].cpu()]
    for want, have in zip(got["cpu"], got["card"]):
        torch.testing.assert_close(have, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-370m",
                                  "musicgen-large"])
def test_cuda_new_models_prefill_decode_and_greedy_match_cpu(cuda, arch):
    """A smoke model on the card in float32 against the CPU: prefill
    logits, a decode step, greedy tokens; the flash kernel once per layer
    that attends (hymba's windowed layers through its window)."""
    cfg, cpu, gpu = _cpu_and_card(cuda, arch)
    rng = np.random.default_rng(0)
    if cfg.input_mode == "embeds":
        x = rng.normal(size=(2, 33, cfg.d_model)).astype(np.float32)
        key = "embeds"
    else:
        x = rng.integers(0, cfg.vocab_size, (2, 33))
        key = "tokens"
    logits, tokens = [], []
    for model in (cpu, gpu):
        caches = T.init_cache(cfg, 2, 40, device=model.device)
        first, caches = T.prefill(cfg, model, {key: x[:, :32]}, caches)
        nxt, _ = T.decode_step(cfg, model, x[:, 32], caches, 32)
        logits.append((first.cpu(), nxt.cpu()))
        engine = E.Engine(cfg, model, E.ServeConfig(cache_len=40,
                                                    batch_size=2),
                          device=model.device)
        ops.reset_launch_counts()
        tokens.append(engine.generate(x[:, :32], 6))
    for want, got in zip(*logits):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert np.array_equal(tokens[0], tokens[1])
    attending = sum(s.count for s in cfg.segments
                    if s.mixer in ("gqa", "hybrid"))
    assert ops.launch_counts()["flash_attention"] == attending


# --------------------------------------------------------------------------
# LM training: the flash Function's gradients, a step, a restart
# --------------------------------------------------------------------------

FLASH_GRAD_CASES = [  # b, s, h, hkv, hd, window
    (2, 300, 4, 4, 64, None),       # rep 1, ragged edge
    (2, 300, 4, 2, 128, None),      # rep 2
    (1, 257, 5, 1, 64, 64),         # rep 5 (hymba's), a window
    (2, 200, 4, 2, 128, 33),        # a window shorter than a chunk
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_GRAD_CASES, ids=str)
def test_cuda_flash_function_gradients_match_plain(cuda, case, dtype,
                                                  monkeypatch):
    """The kernel's forward with the plain backward (recomputing 64 query
    rows a step, so these shapes take several) against autograd through
    the float32 plain version on the same inputs: float32 within 1e-4,
    bf16 rows within the bf16 row limit 1e-2 (P is rounded to bf16 as the
    dV product's operand, as the forward rounds it)."""
    monkeypatch.setattr(ops, "FLASH_BWD_CHUNK", 64)
    b, s, h, hkv, hd, window = case
    g = torch.Generator(device=cuda).manual_seed(s + h)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(shape, generator=g, device=cuda).to(dt)
                   for shape in ((b, s, h, hd), (b, s, hkv, hd),
                                 (b, s, hkv, hd), (b, s, h, hd)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ops.reset_launch_counts()
    out = ops.flash_attention(*leaves, causal=True, window=window)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    truth = [x.float().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_bshd_ref(
        *truth, causal=True, window=window), truth, do.float())
    for a, w in zip(got, want):
        assert a.dtype == dt and a.shape == w.shape
        if dtype == "float32":
            torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)
        else:
            row = (a.float() - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(
                1e-30)
            assert float(row.max()) <= 1e-2


def test_cuda_flash_without_a_gradient_saves_nothing(cuda):
    q = torch.randn((1, 64, 2, 64), device=cuda, requires_grad=True)
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).grad_fn is None
    assert ops.flash_attention(q.detach(), q.detach(),
                               q.detach()).grad_fn is None
    assert ops.flash_attention(q, q.detach(), q.detach()).grad_fn is not None


def _train_batch(cfg, b=2, s=64, seed=0):
    rng = np.random.default_rng(seed)
    key = "embeds" if cfg.input_mode == "embeds" else "tokens"
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32) \
        if key == "embeds" else rng.integers(0, cfg.vocab_size, (b, s))
    return {key: x, "labels": rng.integers(0, cfg.vocab_size, (b, s))}


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v2-lite-16b",
                                  "mamba2-370m", "hymba-1.5b"])
def test_cuda_training_step_matches_cpu(cuda, arch):
    """One float32 smoke-size loss and backward on the card against the
    CPU: the loss and every gradient leaf within 1e-4 (relative L2); the
    flash kernel once per attending layer (remat "none")."""
    cfg = configs.smoke_config(arch)
    batch = _train_batch(cfg)
    out = []
    for dev in ("cpu", cuda):
        model = T.init_params(cfg, 0, device="cpu", masters=True).to(dev)
        ops.reset_launch_counts()
        loss, _ = T.lm_loss(cfg, model, batch)
        loss.backward()
        out.append((float(loss.detach()), {n: p.grad.cpu() for n, p in
                                           model.named_parameters()},
                    ops.launch_counts()["flash_attention"]))
    (want, gw, _), (got, gg, launches) = out
    assert got == pytest.approx(want, rel=1e-4)
    for n, w in gw.items():
        err = float((gg[n] - w).norm() / w.norm().clamp_min(1e-30))
        assert err < 1e-4, (n, err)
    assert launches == sum(s.count for s in cfg.segments
                           if s.mixer in ("gqa", "hybrid"))


@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("dots", 2),
                                             ("full", 2)])
def test_cuda_training_launches_flash_per_remat(cuda, remat, per_layer):
    """A bf16 training step: the forward launches the kernel once a layer
    and a recomputing remat once more in the backward; the three settings
    give the same loss."""
    cfg = dataclasses.replace(configs.smoke_config("internlm2-1.8b"),
                              dtype="bfloat16", remat=remat)
    model = T.init_params(cfg, 0, masters=True)
    ops.reset_launch_counts()
    loss, _ = T.lm_loss(cfg, model, _train_batch(cfg))
    loss.backward()
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == per_layer * cfg.n_layers
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mamba2-370m",
                                  "hymba-1.5b", "qwen2-vl-7b"])
def test_cuda_bf16_training_step_every_mixer(cuda, arch):
    """A bf16 step with remat "full" for MLA + MoE, the SSM, the hybrid
    (windowed) and embeds input: a finite loss within 2e-2 of the float32
    one, every master's gradient finite and float32, and the flash kernel
    twice per attending layer."""
    base = configs.smoke_config(arch)
    batch = _train_batch(base)
    losses = []
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype, remat="full")
        model = T.init_params(cfg, 0, masters=True)
        ops.reset_launch_counts()
        loss, _ = T.lm_loss(cfg, model, batch)
        loss.backward()
        torch.cuda.synchronize()
        losses.append(float(loss.detach()))
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())
    assert losses[1] == pytest.approx(losses[0], rel=2e-2)
    attending = sum(s.count for s in cfg.segments
                    if s.mixer in ("gqa", "hybrid"))
    assert ops.launch_counts()["flash_attention"] == 2 * attending


def test_cuda_trainer_restart_resumes(cuda, tmp_path):
    """3 steps, a checkpoint, 2 more; a fresh Trainer restores and runs the
    same 2 steps. Losses equal within 1e-6 relative: the backward's
    scatter-adds (the embedding's ``index_put_``) may add in another order
    on the card."""
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = configs.smoke_config("internlm2-1.8b")
    tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=1),
                       checkpoint_every=3, checkpoint_dir=str(tmp_path),
                       log_every=1000)

    def trainer(seed):
        data = SyntheticTokens(vocab_size=cfg.vocab_size, batch=4,
                               seq_len=32, seed=1)
        return Trainer(cfg, tcfg, T.init_params(cfg, seed, masters=True),
                       iter(data)), data
    first, _ = trainer(0)
    first.run(3)
    after = [first.run(1)["loss"] for _ in range(2)]
    second, data = trainer(5)
    assert second.restore() and second.step == 3
    data.step = 3
    again = [second.run(1)["loss"] for _ in range(2)]
    np.testing.assert_allclose(again, after, rtol=1e-6)


# --------------------------------------------------------------------------
# bin_counts, the uploads and the host-chunked fit
# --------------------------------------------------------------------------

BIN_CASES = [  # n, r, d_g
    (1, 3, 16),
    (1000, 8, 16),
    (5_001, 7, 2_048),          # R not a multiple of the grid group
    (70_001, 256, 2_048),       # the fit's R and d_g, ragged rows
    (3_001, 5, 16_384),         # one grid a group
    (2_000, 2, 65_536),         # counters past shared memory: global atomics
    (999, 4, 3),                # d_g not a power of two: global atomics
]


@pytest.mark.parametrize("n,r,d_g", BIN_CASES)
def test_cuda_bin_counts_exact(cuda, n, r, d_g):
    idx = torch.from_numpy(_ell(n + r, n, r, d_g)).to(cuda)
    ops.reset_launch_counts()
    got = ops.bin_counts(idx, d=r * d_g, d_g=d_g)
    torch.cuda.synchronize()
    assert ops.launch_counts()["bin_counts"] == 1
    assert got.dtype == torch.int32
    assert torch.equal(got, ref.bin_counts_ref(idx, r * d_g))


def test_cuda_bin_counts_hot_bin_and_off_range(cuda):
    """One bin of 150,000 rows (past any 16-bit counter), and entries off
    [0, D), which both versions drop."""
    n, r, d_g = 200_000, 8, 2_048
    idx = _ell(1, n, r, d_g)
    idx[:150_000, 3] = 3 * d_g + 7
    idx[5, 1], idx[6, 2] = r * d_g + 3, -5
    idx = torch.from_numpy(idx).to(cuda)
    got = ops.bin_counts(idx, d=r * d_g, d_g=d_g)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.bin_counts_ref(idx, r * d_g))
    assert int(got[3 * d_g + 7]) >= 150_000
    assert int(got.sum()) == n * r - 2


def test_cuda_bin_counts_every_row_in_one_bin_per_grid(cuda):
    """The hottest pattern: at the fit's R and d_g, every row of a grid in
    one bin (each grid its own), so every lane of every warp meets on one
    counter a grid."""
    n, r, d_g = 200_001, 256, 2_048
    hot = np.random.default_rng(3).integers(0, d_g, size=r)
    idx = np.broadcast_to(hot + np.arange(r) * d_g, (n, r)).astype(np.int32)
    idx = torch.from_numpy(np.ascontiguousarray(idx)).to(cuda)
    got = ops.bin_counts(idx, d=r * d_g, d_g=d_g)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.bin_counts_ref(idx, r * d_g))
    want = torch.zeros(r * d_g, dtype=torch.int32)
    want[torch.from_numpy(hot + np.arange(r) * d_g)] = n
    assert torch.equal(got.cpu(), want)


def test_cuda_bin_counts_repeat_two_streams_and_chunks(cuda):
    """The same counts twice, on two streams at once, and as a sum of
    chunks added into one buffer; equal to the CSC's column lengths."""
    n, r, d_g = 300_000, 16, 2_048
    d = r * d_g
    idx = torch.from_numpy(_ell(2, n, r, d_g)).to(cuda)
    want = ops.bin_counts(idx, d=d, d_g=d_g)
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    with torch.cuda.stream(s1):
        a = ops.bin_counts(idx, d=d, d_g=d_g)
    with torch.cuda.stream(s2):
        b = ops.bin_counts(idx, d=d, d_g=d_g)
    torch.cuda.synchronize()
    assert torch.equal(a, want) and torch.equal(b, want)
    assert torch.equal(ops.bin_counts(idx, d=d, d_g=d_g), want)
    out = torch.zeros((d,), dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    for i in range(0, n, 131_072):
        ops.bin_counts(idx[i:i + 131_072], d=d, d_g=d_g, out=out)
    torch.cuda.synchronize()
    assert ops.launch_counts()["bin_counts"] == 3
    assert torch.equal(out, want)
    csc = ops.ell_csc(idx, d)
    assert torch.equal((csc.colptr[1:] - csc.colptr[:-1]).to(torch.int32),
                       want)


def _chunked_case(cuda, n, r, d_g, k, chunk, seed=0):
    from repro_torch.core import streaming
    rng = np.random.default_rng(seed)
    idx = _ell(seed, n, r, d_g)
    s = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    u = rng.normal(size=(n, k)).astype(np.float32)
    store = streaming.ChunkedELL.from_dense(idx, s, chunk, d=r * d_g,
                                            d_g=d_g, device=cuda)
    return store, idx, s, u, streaming.ChunkedDense.from_array(
        u, store.chunk_sizes)


def test_cuda_prefetch_same_bits_with_and_without_double_buffering(cuda):
    from repro_torch.utils import prefetch_to_device
    store, _, _, _, uc = _chunked_case(cuda, 300_000, 16, 2_048, 5, 131_072)
    on = store.gram_matvec_chunked(uc)
    off = dataclasses.replace(store, prefetch=False).gram_matvec_chunked(uc)
    assert all(torch.equal(a, b) for a, b in zip(on.chunks, off.chunks))
    assert all(c.is_pinned() for c in on.chunks)
    plain = [torch.arange(i, i + 1000, dtype=torch.float32) for i in range(3)]
    measure: dict = {}
    got = list(prefetch_to_device(plain, device=cuda, measure=measure))
    torch.cuda.synchronize()
    assert all(g.is_cuda and torch.equal(g.cpu(), p)
               for g, p in zip(got, plain))
    assert measure == {"max_item_bytes": 4000, "items": 3, "bytes": 12000}


@pytest.mark.parametrize("n,chunk", [(131_072, 131_072), (300_000, 131_072),
                                     (300_000, 100_000)])
def test_cuda_chunked_gram_sweep_matches_gram_matmul(cuda, n, chunk):
    """The host-chunked Gram sweep (zt over each chunk's CSC into one
    accumulator, then z chunk by chunk) against the device path's fused
    product, to float32 tolerance (another summation order for q)."""
    r, d_g, k = 32, 2_048, 11
    store, idx, s, u, uc = _chunked_case(cuda, n, r, d_g, k, chunk, seed=n)
    ops.reset_launch_counts()
    got = torch.cat(store.gram_matvec_chunked(uc).chunks).to(cuda)
    counts = ops.launch_counts()
    assert counts["zt_matmul"] == store.n_chunks
    assert counts["z_matmul"] + counts["z_matmul_gather"] == store.n_chunks
    ti, ts, tu = (torch.from_numpy(a).to(cuda) for a in (idx, s, u))
    want = ops.gram_matmul(ti, tu, ts, r * d_g, d_g=d_g)
    terms = ref.z_matmul_ref(ti, ref.zt_matmul_ref(ti, tu.abs(), ts,
                                                   r * d_g), ts)
    _assert_sum_close(got, want, terms)


def test_cuda_chunked_degrees_same_bits_for_any_chunking(cuda):
    """Degrees whose row sums of counts pass 2^24 (four bins a grid over
    300,000 rows): the same bits at chunks of 131,072 and 100,000 rows and
    in one piece."""
    from repro_torch.core import graph, streaming
    n, r, d_g = 300_000, 256, 2_048
    rng = np.random.default_rng(4)
    idx = (rng.integers(0, 4, size=(n, r))
           + np.arange(r)[None, :] * d_g).astype(np.int32)
    d = r * d_g
    whole = graph.rb_degrees_exact(torch.from_numpy(idx).to(cuda), d=d,
                                   d_g=d_g).cpu()
    assert float(whole.max()) * r > 2 ** 24
    for chunk in (131_072, 100_000):
        got = streaming.chunked_degrees(streaming.as_row_chunks(idx, chunk),
                                        d=d, d_g=d_g, device=cuda)
        assert torch.equal(got, whole), chunk


def test_cuda_chunked_fit_matches_device_fit(cuda):
    """The host-chunked fit on the card (a full chunk on the strip route, a
    ragged one on the gather route) against the device-resident fit."""
    from repro_torch.core import SCRBConfig, SCRBModel, metrics
    from repro_torch.data.synthetic import make_blobs
    x, _ = make_blobs(140_000, 6, 3, seed=0)
    kw = dict(n_clusters=3, n_grids=64, sigma=1.5, d_g=1_024,
              kmeans_replicates=2)
    dev = SCRBModel.fit(x, SCRBConfig(**kw))
    ops.reset_launch_counts()
    chunked = SCRBModel.fit(x, SCRBConfig(**kw, chunk_size=131_072))
    counts = ops.launch_counts()
    assert counts["bin_counts"] == 2 and counts["gram_matmul"] == 0
    for name in ("rb_binning", "zt_matmul", "z_matmul", "z_matmul_gather",
                 "kmeans_assign", "kmeans_assign_stats"):
        assert counts[name] > 0, name
    assert metrics.accuracy(chunked.fit_result.labels,
                            dev.fit_result.labels) >= 0.99
    assert chunked.fit_result.diagnostics["n_chunks"] == 2


def test_cuda_streaming_kmeans_matches_the_cpu(cuda):
    """The host-chunked fit's k-means on the card (chunks of 131,072 rows,
    a ragged tail) against its plain version on the CPU, from the same
    injected seeds: labels agree on ≥ 99.9% of the rows, centroids within
    1e-4 (float32 sums in another order)."""
    import importlib

    from repro_torch.core import streaming
    km = importlib.import_module("repro_torch.core.kmeans")
    g = torch.Generator().manual_seed(0)
    centers = torch.randn((7, 7), generator=g) * 2.0
    pick = torch.randint(0, 7, (300_000,), generator=g)
    x = km.row_normalize(centers[pick] + 0.3 * torch.randn((300_000, 7),
                                                           generator=g))
    chunks = streaming.ChunkedDense.from_array(x, 131_072)
    init = torch.stack([x[torch.randperm(300_000, generator=g)[:7]]
                        for _ in range(3)])
    want = km.streaming_kmeans(None, chunks, 7, n_steps=25, init=init,
                               device="cpu")
    ops.reset_launch_counts()
    got = km.streaming_kmeans(None, chunks, 7, n_steps=25, init=init,
                              device=cuda)
    counts = ops.launch_counts()
    assert counts["kmeans_assign_stats"] == 3 * 25
    assert counts["kmeans_assign"] == 3 * chunks.n_chunks
    agree = float((got.labels == want.labels).float().mean())
    assert agree >= 0.999, agree
    torch.testing.assert_close(got.centroids.cpu(), want.centroids,
                               atol=1e-4, rtol=0)


# --------------------------------------------------------------------------
# the solvers and the compressive cell on the card
# --------------------------------------------------------------------------

#: The Gram product's widths on the solvers' path: lanczos' single vector,
#: the compressive cell's d = ceil(4 log2(K + 1)) signals at K = 10, and its
#: 32 Rademacher probes.
GRAM_SOLVER_WIDTHS = (1, 14, 32)


@pytest.mark.parametrize("k", GRAM_SOLVER_WIDTHS)
def test_cuda_gram_matmul_at_the_solvers_widths(cuda, k):
    """The fused Gram kernel at the widths the solvers give it: the bits of
    zt_matmul then z_matmul."""
    test_cuda_gram_matmul_fused(cuda, 131_072, 16, 256, k)


def _blob_fit_cfg(solver, **kw):
    from repro_torch.core import SCRBConfig, SolverOptions
    return SCRBConfig(n_clusters=4, n_grids=32, sigma=1.5, d_g=256,
                      kmeans_replicates=2,
                      solver_options=SolverOptions(solver=solver, tol=1e-4),
                      **kw)


@pytest.mark.parametrize("solver", ["lobpcg_host", "randomized", "auto",
                                    "lanczos", "subspace"])
def test_cuda_solver_fit_matches_the_cpu(cuda, solver):
    """Each solver's fit on the card against the same fit on the CPU (the
    start block is drawn on the CPU either way): Ritz values within 1e-4
    relative, labels by ARI ≥ 0.99."""
    from repro_torch.core import SCRBModel, metrics
    from repro_torch.data.synthetic import make_blobs
    x, _ = make_blobs(3_000, 6, 4, seed=3)
    cfg = _blob_fit_cfg(solver)
    card = SCRBModel.fit(x, cfg).fit_result
    cpu = SCRBModel.fit(x, cfg, device="cpu").fit_result
    assert card.diagnostics["solver"] == solver
    np.testing.assert_allclose(card.singular_values ** 2,
                               cpu.singular_values ** 2, rtol=1e-4)
    assert metrics.adjusted_rand_index(card.labels, cpu.labels) >= 0.99


def test_cuda_compressive_fit_matches_the_cpu(cuda):
    """A small compressive fit on the card against the same fit on the CPU
    (probe and signal blocks drawn on the CPU either way): the same cutoff
    and filter degree, the embedding within 1e-3, labels by ARI ≥ 0.99;
    predict on the training rows gives the fit's labels; on host chunks
    the same cell runs with no Gram kernel launch."""
    from repro_torch.core import SCRBModel, metrics
    from repro_torch.data.synthetic import make_blobs
    x, _ = make_blobs(3_000, 6, 4, seed=3)
    cfg = _blob_fit_cfg("compressive")
    ops.reset_launch_counts()
    card = SCRBModel.fit(x, cfg)
    counts = ops.launch_counts()
    assert counts["gram_matmul"] + counts["gram_matmul_composed"] > 0
    assert counts["kmeans_assign"] > 0 and counts["kmeans_assign_stats"] > 0
    cpu = SCRBModel.fit(x, cfg, device="cpu")
    dc = card.fit_result.diagnostics["compressive"]
    dp = cpu.fit_result.diagnostics["compressive"]
    assert dc["cutoff"] == pytest.approx(dp["cutoff"], abs=1e-4)
    assert dc["filter_degree"] == dp["filter_degree"]
    np.testing.assert_allclose(card.fit_result.embedding,
                               cpu.fit_result.embedding, atol=1e-3)
    assert metrics.adjusted_rand_index(card.fit_result.labels,
                                       cpu.fit_result.labels) >= 0.99
    np.testing.assert_array_equal(card.predict(x), card.fit_result.labels)
    ops.reset_launch_counts()
    chunked = SCRBModel.fit(x, _blob_fit_cfg("compressive", chunk_size=1_024))
    counts = ops.launch_counts()
    assert chunked.fit_result.diagnostics["n_chunks"] == 3
    assert counts["gram_matmul"] == 0 and counts["zt_matmul"] > 0
    assert metrics.adjusted_rand_index(chunked.fit_result.labels,
                                       card.fit_result.labels) >= 0.99


def test_cuda_traced_fit_reports_device_memory(cuda, tmp_path):
    """A traced fit on the card writes the root, stage and eigensolve spans,
    and its memory diagnostics hold the allocator's numbers."""
    import json

    from repro_torch.core import SCRBModel
    from repro_torch.data.synthetic import make_blobs
    x, _ = make_blobs(3_000, 6, 4, seed=3)
    path = tmp_path / "trace.json"
    cfg = dataclasses.replace(_blob_fit_cfg("lobpcg"), trace=str(path))
    mem = SCRBModel.fit(x, cfg).fit_result.diagnostics["memory"]
    assert mem["device_bytes_in_use"] is not None
    assert mem["device_peak_bytes"] >= mem["device_bytes_in_use"]
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e["ph"] == "X"}
    assert {"fit", "rb_features", "degrees", "svd", "normalize", "kmeans",
            "eigensolve"} <= names


# --------------------------------------------------------------------------
# dense feature maps, the Table-2 methods and the serving engine's graphs
# --------------------------------------------------------------------------

def _dense_models(device, x):
    """An RB model and a model of each dense map, fitted on ``device``."""
    from repro_torch.core import SCRBConfig, SCRBModel, executor, featuremap
    kw = dict(n_clusters=4, n_grids=64, sigma=1.5, d_g=512,
              kmeans_replicates=2)
    out = {"rb": SCRBModel.fit(x, SCRBConfig(**kw), device=device)}
    for name in ("rff", "nystrom", "lsc"):
        fm = featuremap.make_feature_map(name, rank=64, sigma=1.5)
        out[name] = SCRBModel.fit(
            x, SCRBConfig(**kw), plan=executor.ExecutionPlan(feature_map=fm),
            device=device)
    return out


@pytest.mark.parametrize("name", ["rff", "nystrom", "lsc"])
def test_cuda_dense_transform_matches_cpu_and_is_batch_invariant(cuda, name):
    """A dense map's features on the card within 1e-5 of the same fitted
    map on the CPU (LSC's kept pattern exact), and a row's bits the same
    in any batch (its products run in fixed row tiles)."""
    from repro_torch.core import featuremap
    from repro_torch.data.synthetic import make_blobs
    x, _ = make_blobs(9_000, 6, 4, seed=0)
    fm = featuremap.make_feature_map(name, rank=64, sigma=1.5).fit(0, x)
    xs = torch.from_numpy(x)
    want = fm.transform(xs)
    dev = fm.to(cuda)
    got = dev.transform(xs.to(cuda))
    assert float((got.cpu() - want).abs().max()) <= 1e-5
    if name == "lsc":
        assert torch.equal(got.cpu() > 0, want > 0)
    for a, b in ((0, 1), (7, 70), (4000, 4200), (100, 9000)):
        assert torch.equal(dev.transform(xs[a:b].to(cuda)), got[a:b])


@pytest.mark.parametrize("name", ["kmeans", "sc", "kk_rf", "kk_rs", "sv_rf",
                                  "sc_lsc", "sc_nys", "sc_rf", "sc_rb",
                                  "csc_rb"])
def test_cuda_baselines_match_the_cpu(cuda, name):
    """Every Table-2 method on the card against the same method on the CPU
    with the same map: labels by ARI ≥ 0.99. At rank 256 every RFF degree
    of this data is positive; at rank 128 some are negative (RFF features
    take both signs), the 1e-8 clamp gives those rows a scale of 1e4 and
    sc_rf a spurious singular value near 1.4e4, and the two devices'
    rounding then picks other vectors (ROADMAP.md C7)."""
    from repro_torch.core import baselines, featuremap, metrics
    from repro_torch.data.synthetic import make_blobs
    x, _ = make_blobs(2_000, 6, 4, seed=1)
    cfg = baselines.BaselineConfig(n_clusters=4, rank=256, sigma=1.5,
                                   kmeans_replicates=4)
    kw = {}
    fm_name = baselines.METHOD_FEATURE_MAPS[name]
    if fm_name is not None:
        kw["feature_map"] = featuremap.make_feature_map(
            fm_name, rank=256, sigma=1.5).fit(0, x)
    if fm_name == "rff":
        phi = kw["feature_map"].transform(torch.from_numpy(x))
        assert float(featuremap.build_normalized_dense(phi).deg.min()) > 0
    want = baselines.METHODS[name](x, cfg, device="cpu", **kw)
    got = baselines.METHODS[name](x, cfg, device="cuda", **kw)
    assert metrics.adjusted_rand_index(got.labels, want.labels) >= 0.99


def _engine_state(eng):
    torch.cuda.synchronize()
    return (eng.total_compiles, eng.stats()["staging_allocations"],
            torch.cuda.memory_stats()["allocation.all.allocated"])


def _engine_traffic(eng, models, x, rng):
    """A mix of requests in both modes; every answer against the model's
    own predict/transform, bit for bit. Returns the engine's state before
    the first submit and after the drain."""
    reqs = []
    for _ in range(24):
        name = list(models)[int(rng.integers(len(models)))]
        mode = ("predict", "transform")[int(rng.integers(2))]
        a = int(rng.integers(0, 2_000))
        reqs.append((name, mode, a, a + int(rng.integers(1, 1_000))))
    before = _engine_state(eng)
    tickets = [eng.submit(name, x[a:b], mode) for name, mode, a, b in reqs]
    eng.drain()
    after = _engine_state(eng)
    for t, (name, mode, a, b) in zip(tickets, reqs):
        want = getattr(models[name], mode)(x[a:b])
        np.testing.assert_array_equal(eng.take(t).values, want)
    return before, after


def test_cuda_engine_graphs_equal_eager_and_allocate_nothing(cuda):
    """The engine on the card: one CUDA graph per (model, bucket, mode),
    each replay bit-identical to the same cell run eagerly and every
    response to model.predict/transform; at steady state no capture, no
    staging buffer and no device allocation."""
    from repro_torch.data.synthetic import make_blobs
    from repro_torch.serve.cluster_engine import ClusterEngine, EngineConfig
    x, _ = make_blobs(3_000, 6, 4, seed=2)
    models = _dense_models("cuda", x)
    buckets = (64, 256, 1_024)
    eng = ClusterEngine(EngineConfig(buckets=buckets), device="cuda")
    for name, mdl in models.items():
        eng.load_model(name, mdl)
        eng.warmup(name, modes=("predict", "transform"))
    assert eng.total_compiles == len(models) * len(buckets) * 2
    for cell in eng._cells.values():
        assert cell.graph is not None
        if cell.out.dtype == torch.int32:           # predict: the assign
            assert cell.launches["kmeans_assign"] == 1
        cell.x.copy_(torch.from_numpy(x[:cell.x.shape[0]]).to(cuda))
        cell.graph.replay()
        eager = cell.fn(cell.x)
        torch.cuda.synchronize()
        assert torch.equal(cell.out, eager)
    rng = np.random.default_rng(0)
    _engine_traffic(eng, models, x, rng)            # a first wave
    before, after = _engine_traffic(eng, models, x, rng)   # steady state
    assert after == before
    assert eng.stats()["replayed_launches"]["rb_binning"] > 0


def test_cuda_engine_lru_refault_copies_state_only(cuda):
    """max_resident_models=1 over two models: every switch evicts and
    re-faults into the model's free slot; answers stay bit-identical and
    nothing is captured again."""
    from repro_torch.data.synthetic import make_blobs
    from repro_torch.serve.cluster_engine import ClusterEngine, EngineConfig
    x, _ = make_blobs(3_000, 6, 4, seed=3)
    models = {k: v for k, v in _dense_models("cuda", x).items()
              if k in ("rb", "nystrom")}
    eng = ClusterEngine(EngineConfig(buckets=(64, 256),
                                     max_resident_models=1), device="cuda")
    for name, mdl in models.items():
        eng.load_model(name, mdl)
        eng.warmup(name)
    compiles = eng.total_compiles
    for rep in range(3):
        for name, mdl in models.items():
            rows = x[rep * 50:rep * 50 + 200]
            np.testing.assert_array_equal(eng.predict(name, rows),
                                          mdl.predict(rows))
    assert eng.total_compiles == compiles
    assert eng.stats()["evictions"] >= 5


def test_cuda_engine_refit_swaps_free_the_old_slot(cuda):
    """Hot-swaps between refits with other sigmas (a new signature each
    time): each swap frees the old slot with its graphs, so the slots and
    cells stay bounded, the device memory in use is the same after every
    second swap, and the answers are the newest model's."""
    import dataclasses

    from repro_torch.core import SCRBConfig, SCRBModel
    from repro_torch.data.synthetic import make_blobs
    from repro_torch.serve.cluster_engine import ClusterEngine, EngineConfig
    x, _ = make_blobs(3_000, 6, 4, seed=4)
    cfg = SCRBConfig(n_clusters=4, n_grids=64, sigma=1.5, d_g=512,
                     kmeans_replicates=2)
    refits = [SCRBModel.fit(x, dataclasses.replace(cfg, sigma=sig),
                            device="cuda") for sig in (1.4, 1.6)]
    buckets = (64, 256)
    eng = ClusterEngine(EngineConfig(buckets=buckets), device="cuda")
    used = []
    for i in range(6):
        m = refits[i % 2]
        eng.load_model("m", m)
        eng.warmup("m")
        np.testing.assert_array_equal(eng.predict("m", x[:200]),
                                      m.predict(x[:200]))
        s = eng.stats()
        assert (s["slots"], s["slots_freed"]) == (1, i)
        assert s["cells"] == len(buckets)
        torch.cuda.synchronize()
        used.append(torch.cuda.memory_allocated())
    assert used[2:] == used[:2] * 2


# --------------------------------------------------------------------------
# The partitioned and mesh placements on the card
# --------------------------------------------------------------------------

def _partitioned_cfg(workers, **kw):
    from repro_torch.core import PartitionOptions
    return _blob_fit_cfg("lobpcg", **kw, partition=PartitionOptions(
        n_partitions=3, workers=workers))


def test_cuda_partitioned_fit_matches_the_cpu(cuda):
    """A partitioned fit on the card against the same fit on the CPU (the
    start blocks are drawn on the CPU either way; the blobs are apart, so
    the k-means seeds, drawn on each device, settle alike): labels by ARI ≥
    0.99, merged singular values within 1e-4 relative; predict on the
    training rows gives the fit's labels."""
    from repro_torch.core import SCRBModel, metrics
    from repro_torch.data.synthetic import make_blobs
    x, _ = make_blobs(6_000, 6, 4, seed=3)
    card = SCRBModel.fit(x, _partitioned_cfg(1))
    cpu = SCRBModel.fit(x, _partitioned_cfg(1), device="cpu").fit_result
    res = card.fit_result
    assert metrics.adjusted_rand_index(res.labels, cpu.labels) >= 0.99
    np.testing.assert_allclose(res.singular_values, cpu.singular_values,
                               rtol=1e-4)
    np.testing.assert_array_equal(card.predict(x), res.labels)


def test_cuda_partitioned_workers_on_streams_same_bits_and_launches(cuda):
    """One worker against a worker (and a CUDA stream) a partition, at
    partitions on the strip route: the same labels, merged singular values
    and embedding bit for bit, and the same launch counts (the counts are
    taken under a lock)."""
    from repro_torch.core import SCRBModel
    from repro_torch.data.synthetic import make_blobs
    x, _ = make_blobs(3 * 140_000, 6, 4, seed=5)
    runs = []
    for workers in (1, 3):
        ops.reset_launch_counts()
        m = SCRBModel.fit(x, _partitioned_cfg(workers))
        runs.append((m.fit_result, ops.launch_counts()))
    (a, ca), (b, cb) = runs
    assert b.diagnostics["partitioned"]["workers"] == 3
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.singular_values, b.singular_values)
    np.testing.assert_array_equal(a.embedding, b.embedding)
    assert ca == cb and ca["gram_matmul"] > 0 and ca["z_matmul"] > 0


def _gloo_gram(x, params, u, rows):
    """On each rank of a gloo world on one card: this rank's rows of the
    sharded Gram product."""
    from repro_torch.core import featuremap as tfm
    from repro_torch.core.distributed import make_degree_pass, make_gram_matvec
    from repro_torch.launch import mesh as lm
    mesh = lm.make_host_mesh()
    lo = lm.data_rank(mesh) * rows
    fmap = tfm.RBMap.from_state(*params, device="cuda")
    idx = fmap.transform(torch.as_tensor(x[lo:lo + rows], device="cuda"))
    deg, counts = make_degree_pass(mesh, idx, fmap.n_features, fmap.d_g)()
    scale = 1.0 / torch.sqrt(float(fmap.n_grids) * deg)
    y = make_gram_matvec(mesh, idx, scale, fmap.n_features, fmap.d_g)(
        torch.as_tensor(u[lo:lo + rows], device="cuda"))
    return y.cpu().numpy(), counts.cpu().numpy()


def test_cuda_gloo_world_gram_matches_the_single_card(cuda):
    """A gloo world of 2 ranks sharing the card (CUDA tensors through
    gloo): the all_reduced counts equal the single card's bin counts, and
    the sharded Gram product is within 1e-5 relative of the fused product
    on one card (at ≥ 131,072 rows a shard: the strip route)."""
    from repro_torch.core import featuremap as tfm
    from repro_torch.core import graph
    from repro_torch.launch.world import run_world
    n = 2 * 140_000
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    u = rng.normal(size=(n, 11)).astype(np.float32)
    fmap = tfm.RBMap(n_grids=32, sigma=1.5, d_g=512).fit(0, x)
    params = (fmap.meta_dict(), fmap.state_dict())
    ranks = run_world(_gloo_gram, 2, backend="gloo", device="cuda:0",
                      args=(x, params, u, n // 2), timeout_s=60.0,
                      join_timeout_s=300.0)
    fmap = fmap.to("cuda")
    idx = fmap.transform(torch.as_tensor(x, device="cuda"))
    counts = ops.bin_counts(idx, d=fmap.n_features, d_g=fmap.d_g)
    deg = graph.degrees_from_counts(idx, counts)
    scale = 1.0 / torch.sqrt(float(fmap.n_grids) * deg)
    want = ops.gram_matmul(idx, torch.as_tensor(u, device="cuda"), scale,
                           fmap.n_features, d_g=fmap.d_g).cpu().numpy()
    got = np.concatenate([r[0] for r in ranks])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for _, c in ranks:
        np.testing.assert_array_equal(c, counts.cpu().numpy())


def test_cuda_partitioned_fit_on_every_card_matches_one_card(cards):
    """A partitioned fit with device="cuda" puts partition i on card i mod
    the cards: at one worker and at a worker a card, the same labels, merged
    singular values and embedding bit for bit as the same fit on card 0
    alone (the kernels are deterministic, and each partition's sub-fit
    reads the shared map from its own card)."""
    from repro_torch.core import PartitionOptions, SCRBModel
    from repro_torch.data.synthetic import make_blobs
    x, _ = make_blobs(cards * 140_000, 6, 4, seed=5)   # the strip route

    def fit(device, workers):
        cfg = _blob_fit_cfg("lobpcg", partition=PartitionOptions(
            n_partitions=cards, workers=workers))
        return SCRBModel.fit(x, cfg, device=device).fit_result

    alone = fit("cuda:0", 1)
    for workers in (1, cards):
        spread = fit("cuda", workers)
        assert spread.diagnostics["partitioned"]["devices"] == cards
        np.testing.assert_array_equal(spread.labels, alone.labels)
        np.testing.assert_array_equal(spread.singular_values,
                                      alone.singular_values)
        np.testing.assert_array_equal(spread.embedding, alone.embedding)


def test_cuda_nccl_world_gram_matches_the_single_card(cards):
    """An NCCL world of 2, rank r on card r: the all_reduced counts equal
    the single card's bin counts, and the sharded Gram product is within
    1e-5 relative of the fused product on one card."""
    from repro_torch.core import featuremap as tfm
    from repro_torch.core import graph
    from repro_torch.launch.world import run_world
    n = 2 * 140_000
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    u = rng.normal(size=(n, 11)).astype(np.float32)
    fmap = tfm.RBMap(n_grids=32, sigma=1.5, d_g=512).fit(0, x)
    params = (fmap.meta_dict(), fmap.state_dict())
    ranks = run_world(_gloo_gram, 2, backend="nccl", device="cuda",
                      args=(x, params, u, n // 2), timeout_s=60.0,
                      join_timeout_s=300.0)
    fmap = fmap.to("cuda")
    idx = fmap.transform(torch.as_tensor(x, device="cuda"))
    counts = ops.bin_counts(idx, d=fmap.n_features, d_g=fmap.d_g)
    deg = graph.degrees_from_counts(idx, counts)
    scale = 1.0 / torch.sqrt(float(fmap.n_grids) * deg)
    want = ops.gram_matmul(idx, torch.as_tensor(u, device="cuda"), scale,
                           fmap.n_features, d_g=fmap.d_g).cpu().numpy()
    got = np.concatenate([r[0] for r in ranks])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for _, c in ranks:
        np.testing.assert_array_equal(c, counts.cpu().numpy())
