"""The port's Mamba2 SSD mixer and Hymba hybrid mixer
(``repro_torch.models.layers``) against the JAX package's, on the CPU.

Weights are drawn by the JAX package's ``init_params`` for the mamba2-370m
and hymba-1.5b smoke configs and carried across with
``transformer.params_from_reference``; inputs come from numpy with a seed;
everything runs in float32. Tolerance 1e-5 (the two frameworks sum in
another order). The chunked scan is also held against a float64
sequential recurrence, written out here, within 1e-5 relative to the
output's scale, at chunks 8, 16 and 32 of one 64-long sequence.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

from repro.configs import smoke_config as jsmoke_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

TOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), _np(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _reference_mixer(arch, seed=0):
    """(port cfg, JAX cfg, JAX params of layer 0's mixer, the port's)."""
    cfg, jcfg = configs.smoke_config(arch), jsmoke_config(arch)
    tree = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    model = T.params_from_reference(cfg, tree, device="cpu")
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                tree["segments"]["seg0"]["mixer"])
    return cfg, jcfg, jp, model.segments[0][0].mixer


def _ssm_cache(cfg, b):
    s, d = cfg.ssm, cfg.d_model
    shapes = {"state": (b, s.n_heads(d), s.d_state, s.head_dim),
              "conv": (b, s.conv_kernel - 1, s.conv_channels(d))}
    port = {k: torch.zeros(v) for k, v in shapes.items()}
    return port, {k: jnp.zeros(v) for k, v in shapes.items()}


# --------------------------------------------------------------------------
# the pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state \
        else None
    want, want_st = JL._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b),
                                    None if st is None else jnp.asarray(st))
    got, got_st = L._causal_conv(_t(x), _t(w), _t(b),
                                 None if st is None else _t(st))
    _close(got, want)
    if with_state:
        _close(got_st, want_st)
        # one position (decode): the state shifts by one
        got1, st1 = L._causal_conv(_t(x[:, :1]), _t(w), _t(b), _t(st))
        want1, wst1 = JL._causal_conv(jnp.asarray(x[:, :1]), jnp.asarray(w),
                                      jnp.asarray(b), jnp.asarray(st))
        _close(got1, want1)
        _close(st1, wst1)
    else:
        assert got_st is None and want_st is None


def test_init_ssm_draws_the_reference_distributions():
    cfg = configs.get_config("mamba2-370m")
    cfg = dataclasses.replace(cfg, dtype="float32")
    p = L.init_ssm(cfg, torch.Generator().manual_seed(0))
    nh = cfg.ssm.n_heads(cfg.d_model)
    assert p.a_log.shape == (nh,)
    torch.testing.assert_close(torch.exp(p.a_log),
                               torch.linspace(1.0, 16.0, nh))
    dt = torch.nn.functional.softplus(p.dt_bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert 0.18 < float(p.conv_w.std()) < 0.22
    assert 0.018 < float(p.w_in.std()) < 0.022
    assert abs(float(p.w_out.std()) * math.sqrt(2 * cfg.n_layers)
               - 0.02) < 0.002
    assert torch.all(p.conv_b == 0) and torch.all(p.d_skip == 1)
    assert torch.all(p.out_ln == 1)


def _recurrence64(da, xdt, bm, cm, state):
    """The SSM recurrence one position at a time, in float64:
    state ← exp(da_t)·state + B_t ⊗ xdt_t, y_t = C_t·state."""
    da, xdt, bm, cm, state = (np.asarray(a, np.float64)
                              for a in (da, xdt, bm, cm, state))
    ys = []
    for t in range(da.shape[1]):
        state = np.exp(da[:, t])[..., None, None] * state \
            + bm[:, t, None, :, None] * xdt[:, t, :, None, :]
        ys.append(np.einsum("bn,bhnp->bhp", cm[:, t], state))
    return np.stack(ys, axis=1), state


def _scan_inputs(seed, b=2, s=64, h=3, n=5, p=4):
    rng = np.random.default_rng(seed)
    da = -rng.uniform(0.0, 0.6, size=(b, s, h)).astype(np.float32)
    xdt = rng.normal(size=(b, s, h, p)).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    state = rng.normal(size=(b, h, n, p)).astype(np.float32)
    return da, xdt, bm, cm, state


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_scan_matches_float64_recurrence(chunk):
    da, xdt, bm, cm, state = _scan_inputs(chunk)
    want_y, want_state = _recurrence64(da, xdt, bm, cm, state)
    y, st = L.ssd_scan(_t(da), _t(xdt), _t(bm), _t(cm), _t(state), chunk)
    assert y.dtype == st.dtype == torch.float32
    scale = np.abs(want_y).max()
    np.testing.assert_allclose(y.numpy(), want_y, rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(st.numpy(), want_state, rtol=0,
                               atol=TOL * np.abs(want_state).max())
    # the one-step form continues the scan's state in place
    st_step = st.clone()
    y_next = L.ssd_step(st_step, _t(da[:, 0]), _t(xdt[:, 0]), _t(bm[:, 0]),
                        _t(cm[:, 0]))
    want_next, want_st2 = _recurrence64(da[:, :1], xdt[:, :1], bm[:, :1],
                                        cm[:, :1], want_state)
    np.testing.assert_allclose(y_next.numpy(), want_next[:, 0], rtol=0,
                               atol=TOL * np.abs(want_next).max())
    np.testing.assert_allclose(st_step.numpy(), want_st2, rtol=0,
                               atol=TOL * np.abs(want_st2).max())


def test_ssd_scan_survives_steep_decay_and_rejects_ragged_length():
    """A decay steep enough that exp(cum_i − cum_j) overflows above the
    diagonal: where() drops those terms, so nothing turns into NaN."""
    da, xdt, bm, cm, state = _scan_inputs(7, s=32)
    da[:] = -30.0
    y, st = L.ssd_scan(_t(da), _t(xdt), _t(bm), _t(cm), _t(state), 32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    want_y, _ = _recurrence64(da, xdt, bm, cm, state)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=0,
                               atol=TOL * np.abs(want_y).max())
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        L.ssd_scan(_t(da[:, :20]), _t(xdt[:, :20]), _t(bm[:, :20]),
                   _t(cm[:, :20]), _t(state), 8)


# --------------------------------------------------------------------------
# the SSM mixer
# --------------------------------------------------------------------------

def test_apply_ssm_matches_reference():
    """Uncached; prefill into a cache (output, final state and conv); then
    decode steps (the one-step recurrence) against JAX's apply_ssm with a
    cache."""
    cfg, jcfg, jp, p = _reference_mixer("mamba2-370m", seed=1)
    rng = np.random.default_rng(2)
    b, s = 2, 64                     # two smoke chunks of 32
    x = rng.normal(size=(b, s + 3, cfg.d_model)).astype(np.float32)
    want, _ = JL.apply_ssm(jcfg, jp, jnp.asarray(x[:, :s]))
    got, _ = L.apply_ssm(cfg, p, _t(x[:, :s]))
    _close(got, want)

    cache, jcache = _ssm_cache(cfg, b)
    want, jcache = JL.apply_ssm(jcfg, jp, jnp.asarray(x[:, :s]), cache=jcache)
    got, cache = L.apply_ssm(cfg, p, _t(x[:, :s]), cache=cache)
    _close(got, want)
    for name in ("state", "conv"):
        _close(cache[name], jcache[name], msg=name)
    state_buf = cache["state"]
    for i in range(s, s + 3):
        want, jcache = JL.apply_ssm(jcfg, jp, jnp.asarray(x[:, i:i + 1]),
                                    cache=jcache)
        got, cache = L.apply_ssm(cfg, p, _t(x[:, i:i + 1]), cache=cache)
        _close(got, want, msg=f"decode {i}")
        for name in ("state", "conv"):
            _close(cache[name], jcache[name], msg=f"decode {i} {name}")
    assert cache["state"] is state_buf      # updated in place


def test_apply_ssm_short_prompt_into_a_cache():
    """A prompt shorter than the chunk (one chunk of S) and than the conv
    kernel's reach, continued by decode."""
    cfg, jcfg, jp, p = _reference_mixer("mamba2-370m", seed=3)
    x = np.random.default_rng(4).normal(
        size=(1, 5, cfg.d_model)).astype(np.float32)
    cache, jcache = _ssm_cache(cfg, 1)
    for lo, hi in ((0, 2), (2, 3), (3, 4), (4, 5)):
        want, jcache = JL.apply_ssm(jcfg, jp, jnp.asarray(x[:, lo:hi]),
                                    cache=jcache)
        got, cache = L.apply_ssm(cfg, p, _t(x[:, lo:hi]), cache=cache)
        _close(got, want, msg=f"positions {lo}:{hi}")
        _close(cache["conv"], jcache["conv"])


# --------------------------------------------------------------------------
# the hybrid mixer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 8])
def test_apply_hybrid_matches_reference(window):
    cfg, jcfg, jp, p = _reference_mixer("hymba-1.5b", seed=5)
    rng = np.random.default_rng(6)
    b, s, t = 2, 32, 40
    x = rng.normal(size=(b, s + 2, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s + 2, dtype=np.int32)[None],
                          (b, s + 2)).copy()
    jc, js = JL.rope_tables(jnp.asarray(pos), cfg.rotary_dim, cfg.rope_theta)
    c, sn = L.rope_tables(_t(pos), cfg.rotary_dim, cfg.rope_theta)

    want, _ = JL.apply_hybrid(jcfg, jp, jnp.asarray(x[:, :s]), jc[:, :s],
                              js[:, :s], window=window)
    got, _ = L.apply_hybrid(cfg, p, _t(x[:, :s]), c[:, :s], sn[:, :s],
                            window=window)
    _close(got, want)

    kv = cfg.n_kv_heads * cfg.head_dim
    cache, jcache = _ssm_cache(cfg, b)
    cache.update(k=torch.zeros((b, t, kv)), v=torch.zeros((b, t, kv)))
    jcache.update(k=jnp.zeros((b, t, kv)), v=jnp.zeros((b, t, kv)))
    want, jcache = JL.apply_hybrid(jcfg, jp, jnp.asarray(x[:, :s]),
                                   jc[:, :s], js[:, :s], window=window,
                                   cache=jcache, pos=jnp.int32(0))
    got, cache = L.apply_hybrid(cfg, p, _t(x[:, :s]), c[:, :s], sn[:, :s],
                                window=window, cache=cache, pos=0)
    _close(got, want)
    for i in range(s, s + 2):
        sl = slice(i, i + 1)
        want, jcache = JL.apply_hybrid(jcfg, jp, jnp.asarray(x[:, sl]),
                                       jc[:, sl], js[:, sl], window=window,
                                       cache=jcache, pos=jnp.int32(i))
        got, cache = L.apply_hybrid(cfg, p, _t(x[:, sl]), c[:, sl],
                                    sn[:, sl], window=window, cache=cache,
                                    pos=i)
        _close(got, want, msg=f"decode {i}")
    assert set(cache) == set(jcache) == {"k", "v", "state", "conv"}
    for name in cache:
        _close(cache[name], jcache[name], msg=name)


def test_hybrid_window_changes_late_rows_only():
    """The window reaches the attention branch: rows before it see every
    key either way, later rows differ."""
    cfg = configs.smoke_config("hymba-1.5b")
    p = T.init_params(cfg, 2, device="cpu").segments[0][0].mixer
    x = torch.randn((1, 32, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3))
    pos = torch.arange(32)[None]
    c, s = L.rope_tables(pos, cfg.rotary_dim, cfg.rope_theta)
    full, _ = p(x, c, s, window=None)
    win, _ = p(x, c, s, window=8)
    assert torch.equal(full[:, :8], win[:, :8])
    assert float((full - win)[:, 8:].abs().amax(-1).min()) > 0


def test_cache_layout_matches_reference():
    """Every cache leaf's shape and dtype for the SSM and hybrid models, at
    bfloat16: the SSM state stays float32 (JAX's init_cache)."""
    for arch in ("mamba2-370m", "hymba-1.5b"):
        cfg = configs.smoke_config(arch)
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
        jcfg = dataclasses.replace(jsmoke_config(arch), dtype="bfloat16")
        got = T.init_cache(cfg, 2, 16, device="cpu")
        want = JT.init_cache(jcfg, 2, 16)
        assert set(got) == set(want)
        for seg in got:
            assert set(got[seg]) == set(want[seg])
            for name, buf in got[seg].items():
                assert tuple(buf.shape) == want[seg][name].shape
                assert str(buf.dtype).split(".")[-1] == \
                    str(want[seg][name].dtype)
