"""The port's MoE FFN and MLA mixer (``repro_torch.models.layers``) against
the JAX package's, on the CPU.

Weights are drawn by the JAX package's ``init_params`` for the DeepSeek
smoke configs and carried across with ``transformer.params_from_reference``;
inputs come from numpy with a seed; everything runs in float32. Routing is
discontinuous, so the MoE tests first assert that both packages pick the
same experts, then compare outputs and the aux loss within 1e-5. One MoE
case routes every token to the same experts, so that the JAX run drops
slots past the capacity (asserted) and the drop order is exercised.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

DEEPSEEK = ("deepseek-v2-lite-16b", "deepseek-moe-16b")
TOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _reference_layer(arch, seg, part, seed=0):
    """(port cfg, JAX cfg, JAX params of layer 0 of segment ``seg``'s
    ``part``, the port's module for it)."""
    cfg, jcfg = configs.smoke_config(arch), jsmoke_config(arch)
    tree = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    model = T.params_from_reference(cfg, tree, device="cpu")
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                tree["segments"][f"seg{seg}"][part])
    return cfg, jcfg, jp, getattr(model.segments[seg][0], part)


def _rope(cfg, pos):
    jc, js = JL.rope_tables(jnp.asarray(pos), cfg.rotary_dim, cfg.rope_theta)
    c, s = L.rope_tables(_t(pos), cfg.rotary_dim, cfg.rope_theta)
    return (jc, js), (c, s)


def _positions(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32)[None],
                           (b, s)).copy()


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def _jax_routing(jcfg, jp, x):
    """The JAX package's expert choice and its per-group expert loads."""
    logits = (jnp.asarray(x) @ jp["router"]).astype(jnp.float32)
    _, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.moe.top_k)
    eidx = np.asarray(eidx)
    loads = np.stack([np.bincount(g.reshape(-1),
                                  minlength=jcfg.moe.n_routed)
                      for g in eidx])
    return eidx, loads


@pytest.mark.parametrize("arch", DEEPSEEK)
@pytest.mark.parametrize("case", ["spread", "drops", "decode"])
def test_apply_moe_matches_reference(arch, case):
    cfg, jcfg, jp, p = _reference_layer(arch, 1, "ffn", seed=1)
    rng = np.random.default_rng(2)
    d = cfg.d_model
    if case == "spread":
        x = rng.normal(size=(2, 24, d))
    elif case == "drops":
        # every token near one row: all pick the same top-k experts, so
        # each of those gets S slots in a group, past the capacity
        x = rng.normal(size=(1, 1, d)) + 0.05 * rng.normal(size=(3, 40, d))
    else:
        x = rng.normal(size=(4, 1, d))         # one decode step: cap 1
    x = x.astype(np.float32)
    b, s, _ = x.shape
    cap = L.moe_capacity(cfg, s)
    assert cap == max(math.ceil(s * cfg.moe.top_k
                                * cfg.moe.capacity_factor
                                / cfg.moe.n_routed), 1)

    want_idx, loads = _jax_routing(jcfg, jp, x)
    _, gates, eidx = L.moe_route(cfg, p, _t(x))
    np.testing.assert_array_equal(eidx.numpy(), want_idx)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=TOL)
    _, keep = L.moe_slots(cfg, eidx, cap)
    dropped = int((loads - cap).clip(0).sum())
    assert int((~keep).sum()) == dropped
    if case == "drops":
        assert dropped > 0
    if case == "decode":
        assert cap == 1 and dropped == 0

    want, want_aux = JL.apply_moe(jcfg, jp, jnp.asarray(x))
    got, aux = L.apply_moe(cfg, p, _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL,
                               atol=TOL)


def test_moe_drops_the_latest_tokens_of_an_overfull_expert():
    cfg = configs.smoke_config("deepseek-moe-16b")
    # one group, 6 tokens, top 2: expert 0 is everyone's first choice
    eidx = torch.tensor([[[0, 1], [0, 2], [0, 3], [0, 1], [0, 2], [0, 3]]])
    rank, keep = L.moe_slots(cfg, eidx, 4)
    assert rank[0, :, 0].tolist() == [0, 1, 2, 3, 4, 5]
    assert keep[0, :, 0].tolist() == [True] * 4 + [False] * 2
    assert rank[0, :, 1].tolist() == [0, 0, 0, 1, 1, 1]
    assert bool(keep[..., 1].all())


def test_moe_dispatch_is_the_same_bits_twice():
    cfg, _, _, p = _reference_layer("deepseek-moe-16b", 1, "ffn", seed=3)
    x = _t(np.random.default_rng(4).normal(
        size=(2, 40, cfg.d_model)).astype(np.float32))
    a, aux_a = p(x)
    b, aux_b = p(x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,window", [
    (24, None),       # one query chunk
    (128, None),      # two chunks of attn_chunk = 64 (JAX scans them)
    (48, 16),         # sliding window
])
def test_apply_mla_uncached_matches_reference(s, window):
    cfg, jcfg, jp, p = _reference_layer("deepseek-v2-lite-16b", 0, "mixer",
                                        seed=5)
    b = 2
    x = np.random.default_rng(s).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)
    (jc, js), (c, sn) = _rope(cfg, _positions(b, s))
    want, _ = JL.apply_mla(jcfg, jp, jnp.asarray(x), jc, js, window=window)
    got, _ = L.apply_mla(cfg, p, _t(x), c, sn, window=window)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


def test_apply_mla_cached_matches_reference():
    cfg, jcfg, jp, p = _reference_layer("deepseek-v2-lite-16b", 1, "mixer",
                                        seed=6)
    m = cfg.mla
    rng = np.random.default_rng(7)
    b, s, t = 2, 12, 20
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    (jc, js), (c, sn) = _rope(cfg, _positions(b, s))

    # prefill into the cache at pos 0
    jcache = {"ckv": jnp.zeros((b, t, m.kv_lora_rank)),
              "kr": jnp.zeros((b, t, m.qk_rope_dim))}
    cache = {"ckv": torch.zeros((b, t, m.kv_lora_rank)),
             "kr": torch.zeros((b, t, m.qk_rope_dim))}
    want, jcache = JL.apply_mla(jcfg, jp, jnp.asarray(x), jc, js,
                                cache=jcache, pos=jnp.int32(0))
    got, cache = L.apply_mla(cfg, p, _t(x), c, sn, cache=cache, pos=0)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    for name in ("ckv", "kr"):
        np.testing.assert_allclose(cache[name].numpy(), _np(jcache[name]),
                                   rtol=TOL, atol=TOL)

    # decode steps at pos > 0, then two queries at once
    for pos, n in ((s, 1), (s + 1, 1), (s + 2, 2)):
        x1 = rng.normal(size=(b, n, cfg.d_model)).astype(np.float32)
        (jc1, js1), (c1, s1) = _rope(cfg, _positions(b, n, pos))
        want, jcache = JL.apply_mla(jcfg, jp, jnp.asarray(x1), jc1, js1,
                                    cache=jcache, pos=jnp.int32(pos))
        got, cache = L.apply_mla(cfg, p, _t(x1), c1, s1, cache=cache,
                                 pos=pos)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL,
                                   atol=TOL, err_msg=f"pos {pos}")
        for name in ("ckv", "kr"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       _np(jcache[name]), rtol=TOL,
                                       atol=TOL, err_msg=f"{name} {pos}")
    with pytest.raises(ValueError, match="do not fit"):
        L.apply_mla(cfg, p, _t(x), c, sn, cache=cache, pos=t - 1)


def test_mla_scores_hold_both_terms():
    rng = np.random.default_rng(8)
    ql, qr = (_t(rng.normal(size=(2, 3, 5, n)).astype(np.float32))
              for n in (16, 4))
    ckv, kr = (_t(rng.normal(size=(2, 7, n)).astype(np.float32))
               for n in (16, 4))
    want = torch.einsum("bhcl,btl->bhct", ql, ckv) \
        + torch.einsum("bhcr,btr->bhct", qr, kr)
    got = L.mla_scores(ql, qr, ckv, kr)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 5, 7)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)


def test_bmm_f32_upcasts_bf16_on_the_cpu():
    rng = np.random.default_rng(9)
    a = _t(rng.normal(size=(2, 3, 8)).astype(np.float32)).bfloat16()
    b = _t(rng.normal(size=(2, 8, 4)).astype(np.float32)).bfloat16()
    got = L.bmm_f32(a, b)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, torch.bmm(a.float(), b.float()))


# --------------------------------------------------------------------------
# the modules' parameters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,count", [("deepseek-v2-lite-16b",
                                         15_706_484_224),
                                        ("deepseek-moe-16b",
                                         16_375_728_128)])
def test_full_width_param_count_on_meta(arch, count):
    cfg = configs.get_config(arch)
    model = T.empty_params(cfg, device="meta")
    assert model.device.type == "meta"
    assert sum(p.numel() for p in model.parameters()) == count
    assert cfg.param_count() == count == jget_config(arch).param_count()
    names = {n for n, _ in model.segments[1][0].named_parameters()}
    assert {"ffn.router", "ffn.experts.wg", "ffn.experts.wu",
            "ffn.experts.wd", "ffn.shared.wg"} <= names


@pytest.mark.parametrize("arch", DEEPSEEK)
def test_init_params_draws_every_weight(arch):
    cfg = configs.smoke_config(arch)
    a = T.init_params(cfg, 3, device="cpu")
    b = T.init_params(cfg, 3, device="cpu")
    moe = a.segments[1][0].ffn
    assert isinstance(moe, L.MoE)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        if "ln" not in name:
            assert float(pa.std()) > 0, name
    assert 0.004 < float(moe.router.std()) < 0.008
    assert moe.router.shape == (cfg.d_model, cfg.moe.n_routed)
