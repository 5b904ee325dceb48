"""The port's LM serving slice (``repro_torch.{configs,models,serve}``)
against the JAX package's, on the CPU, for all ten architectures.

Parameters are drawn by the JAX package's ``init_params`` and carried
across with ``transformer.params_from_reference``; inputs (tokens, or
embeds for qwen2-vl-7b and musicgen-large) come from numpy with a seed;
the same batch runs through both packages, in float32 (the smoke configs'
dtype). The SSM and hybrid mixers' own tests are in
``test_torch_ssm.py``. Tolerances: the layer pieces 1e-5 (float32, the
two frameworks sum in another order), the whole model's logits 1e-4 (the
same, through a few layers and a 256-wide head). The flash kernel itself is
held against its plain version on the card in ``tests/test_torch_cuda.py``.
"""
import dataclasses

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
from repro.serve import engine as JE
from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import Segment
from repro_torch.serve import engine as E

PORTED = ("qwen3-32b", "internlm2-1.8b", "qwen2.5-32b", "stablelm-12b",
          "deepseek-v2-lite-16b", "deepseek-moe-16b", "mamba2-370m",
          "hymba-1.5b", "qwen2-vl-7b", "musicgen-large")
#: the architectures whose layers all use the GQA mixer
GQA = ("qwen3-32b", "internlm2-1.8b", "qwen2.5-32b", "stablelm-12b",
       "deepseek-moe-16b", "qwen2-vl-7b", "musicgen-large")
#: the architectures on embedding input (no ``embed`` table)
EMBEDS = ("qwen2-vl-7b", "musicgen-large")
TOL = 1e-5
MODEL_TOL = 1e-4


def _np(x):
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _reference_model(arch, seed=0):
    cfg = configs.smoke_config(arch)
    tree = JT.init_params(jsmoke_config(arch), jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return cfg, tree, T.params_from_reference(cfg, tree, device="cpu")


def _tokens(cfg, seed, b, s):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _inputs(cfg, seed, b, s):
    """(B, S) tokens, or (B, S, D) float32 embeds for a model on embedding
    input, and the batch key they go under."""
    if cfg.input_mode == "embeds":
        return "embeds", np.random.default_rng(seed).normal(
            size=(b, s, cfg.d_model)).astype(np.float32)
    return "tokens", _tokens(cfg, seed, b, s)


def _image_positions(b, text, rows, cols, tail):
    """Qwen2-VL's M-RoPE positions (3, B, S) of text, then a rows × cols
    patch grid (t fixed, h the row, w the column), then text again."""
    t0 = np.arange(text)
    grid_h, grid_w = np.meshgrid(np.arange(rows), np.arange(cols),
                                 indexing="ij")
    g = [np.full(rows * cols, text), text + grid_h.ravel(),
         text + grid_w.ravel()]
    after = text + max(rows, cols) + np.arange(tail)
    pos = np.stack([np.concatenate([t0, gi, after]) for gi in g])
    return np.broadcast_to(pos[:, None], (3, b, pos.shape[1])).astype(
        np.int32).copy()


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_configs_equal_reference(arch):
    got, want = configs.get_config(arch), jget_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert dataclasses.asdict(configs.smoke_config(arch)) == \
        dataclasses.asdict(jsmoke_config(arch))


def test_unknown_arch_and_unported_layers_raise():
    with pytest.raises(KeyError):
        configs.get_config("gpt-5")
    cfg = dataclasses.replace(configs.smoke_config("internlm2-1.8b"),
                              segments=(Segment("rwkv", "mlp", 1),))
    with pytest.raises(ValueError, match="unknown layers"):
        T.init_params(cfg, 0, device="cpu")
    cfg = dataclasses.replace(configs.smoke_config("internlm2-1.8b"),
                              input_mode="pixels")
    with pytest.raises(ValueError, match="unknown layers"):
        T.init_cache(cfg, 1, 8, device="cpu")


@pytest.mark.parametrize("arch", PORTED)
def test_param_count_matches_modules(arch):
    """The modules hold ``param_count()`` numbers, as the JAX tree does,
    except on embedding input: ``param_count`` counts a vocab × d
    embedding that neither package creates there (ROADMAP.md C10)."""
    cfg = configs.smoke_config(arch)
    gap = cfg.vocab_size * cfg.d_model if arch in EMBEDS else 0
    model = T.init_params(cfg, 0, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() - gap
    tree = JT.init_params(jsmoke_config(arch), jax.random.PRNGKey(0))
    assert sum(a.size for a in jax.tree_util.tree_leaves(tree)) == \
        cfg.param_count() - gap
    assert ("embed" in tree) == (arch not in EMBEDS) == \
        hasattr(model, "embed")


def test_full_width_embeds_gap():
    """The embedding that ``param_count`` counts and no tree holds, at
    full width (ROADMAP.md C10)."""
    gaps = {a: configs.get_config(a).vocab_size * configs.get_config(
        a).d_model for a in EMBEDS}
    assert gaps == {"qwen2-vl-7b": 544_997_376, "musicgen-large": 4_194_304}
    for arch in EMBEDS:
        cfg = configs.get_config(arch)
        n = sum(p.numel() for p in T.empty_params(
            cfg, device="meta").parameters())
        assert n == cfg.param_count() - gaps[arch]


def test_internlm2_full_width_count():
    assert configs.get_config("internlm2-1.8b").param_count() == 1_889_110_016


def test_init_params_draws_from_the_generator():
    cfg = configs.smoke_config("internlm2-1.8b")
    a = T.init_params(cfg, 3, device="cpu")
    b = T.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = T.init_params(cfg, 4, device="cpu")
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if "ln" not in name:
            assert not torch.equal(pa, pc), name
    std = float(a.embed.std())
    assert 0.018 < std < 0.022


# --------------------------------------------------------------------------
# layer pieces
# --------------------------------------------------------------------------

def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32)
    want = JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = L.rmsnorm(_t(x), _t(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", PORTED)
def test_rope_matches_reference(arch):
    cfg = configs.smoke_config(arch)        # stablelm: 25% partial rotary
    pos = np.broadcast_to(np.arange(40, dtype=np.int32)[None] + 3, (2, 40))
    jc, js = JL.rope_tables(jnp.asarray(pos), cfg.rotary_dim, cfg.rope_theta)
    c, s = L.rope_tables(_t(pos.copy()), cfg.rotary_dim, cfg.rope_theta)
    np.testing.assert_allclose(c.numpy(), _np(jc), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.numpy(), _np(js), rtol=TOL, atol=TOL)
    x = np.random.default_rng(1).normal(
        size=(2, 40, cfg.n_heads, cfg.head_dim)).astype(np.float32)
    want = JL.apply_rope(jnp.asarray(x), jc, js)
    got = L.apply_rope(_t(x), c, s)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    if cfg.partial_rotary < 1.0:
        np.testing.assert_array_equal(got.numpy()[..., cfg.rotary_dim:],
                                      x[..., cfg.rotary_dim:])


@pytest.mark.parametrize("layout", ["image", "random", "plain"])
def test_mrope_matches_reference(layout):
    """M-RoPE tables from (3, B, S) positions whose streams differ (an
    image grid among text; independent random streams), and from (B, S)
    positions with the sections set (the plain path, as in JAX)."""
    cfg = configs.smoke_config("qwen2-vl-7b")
    if layout == "image":
        pos = _image_positions(2, 5, 4, 6, 7)
    elif layout == "random":
        pos = np.random.default_rng(3).integers(0, 500, size=(3, 2, 30))
        pos = pos.astype(np.int32)
    else:
        pos = np.broadcast_to(np.arange(30, dtype=np.int32)[None], (2, 30))
        pos = pos.copy()
    jc, js = JL.rope_tables(jnp.asarray(pos), cfg.rotary_dim, cfg.rope_theta,
                            cfg.mrope_sections)
    c, s = L.rope_tables(_t(pos), cfg.rotary_dim, cfg.rope_theta,
                         cfg.mrope_sections)
    assert c.shape == (2, pos.shape[-1], cfg.rotary_dim // 2)
    np.testing.assert_allclose(c.numpy(), _np(jc), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.numpy(), _np(js), rtol=TOL, atol=TOL)
    if layout == "image":
        # the h and w sections read other streams: swapping them matters
        swapped, _ = L.rope_tables(_t(pos[[0, 2, 1]]), cfg.rotary_dim,
                                   cfg.rope_theta, cfg.mrope_sections)
        assert not torch.allclose(swapped, c)


def test_mrope_rejects_bad_positions():
    with pytest.raises(ValueError, match="M-RoPE"):
        L.rope_tables(torch.zeros((3, 1, 4), dtype=torch.long), 8, 1e4)
    with pytest.raises(ValueError, match="M-RoPE"):
        L.rope_tables(torch.zeros((3, 1, 4), dtype=torch.long), 8, 1e4,
                      (2, 1, 2))
    with pytest.raises(ValueError, match="positions must be"):
        L.rope_tables(torch.zeros((4,), dtype=torch.long), 8, 1e4)


def _qkv(seed, b, s, t, h, hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, t, hkv, hd)).astype(np.float32),
            rng.normal(size=(b, t, hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("s,window,chunk", [
    (32, None, 512),      # one chunk
    (48, 24, 512),        # sliding window
    (64, None, 16),       # q-chunked (the port's loop, JAX's scan)
])
def test_causal_attention_uncached_matches_reference(s, window, chunk):
    q, k, v = _qkv(s, 2, s, s, 4, 2, 16)
    want = JL.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               window=window, chunk=chunk)
    got = L.causal_attention(_t(q), _t(k), _t(v), window=window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,pos,window", [
    (1, 17, None),        # one decode step
    (1, 40, 8),           # decode, windowed
    (8, 24, None),        # several queries against the cache
])
def test_causal_attention_cached_matches_reference(s, pos, window):
    t = 64
    q, k, v = _qkv(pos, 2, s, t, 4, 2, 16)
    want = JL.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               q_offset=jnp.int32(pos), window=window,
                               kv_len=jnp.int32(pos + s))
    got = L.causal_attention(_t(q), _t(k), _t(v), q_offset=pos,
                             window=window, kv_len=pos + s)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", GQA)
def test_apply_gqa_matches_reference(arch):
    cfg, tree, model = _reference_model(arch, seed=1)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                tree["segments"]["seg0"]["mixer"])
    p = model.segments[0][0].mixer
    rng = np.random.default_rng(2)
    b, s, t = 2, 12, 20
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    jc, js = JL.rope_tables(jnp.asarray(pos), cfg.rotary_dim, cfg.rope_theta)
    c, sn = L.rope_tables(_t(pos.copy()), cfg.rotary_dim, cfg.rope_theta)
    jcfg = jsmoke_config(arch)

    # uncached: the attention of a prompt, no cache
    want, _ = JL.apply_gqa(jcfg, jp, jnp.asarray(x), jc, js, window=8)
    got, _ = L.apply_gqa(cfg, p, _t(x), c, sn, window=8)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)

    # prefill into a cache at pos 0 (the port attends over the fresh k, v)
    kv = cfg.n_kv_heads * cfg.head_dim
    jcache = {"k": jnp.zeros((b, t, kv)), "v": jnp.zeros((b, t, kv))}
    cache = {"k": torch.zeros((b, t, kv)), "v": torch.zeros((b, t, kv))}
    want, jcache = JL.apply_gqa(jcfg, jp, jnp.asarray(x), jc, js,
                                cache=jcache, pos=jnp.int32(0))
    got, cache = L.apply_gqa(cfg, p, _t(x), c, sn, cache=cache, pos=0)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), _np(jcache[name]),
                                   rtol=TOL, atol=TOL)

    # one decode step against that cache
    x1 = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    p1 = np.full((b, 1), s, np.int32)
    jc1, js1 = JL.rope_tables(jnp.asarray(p1), cfg.rotary_dim, cfg.rope_theta)
    c1, s1 = L.rope_tables(_t(p1), cfg.rotary_dim, cfg.rope_theta)
    want, _ = JL.apply_gqa(jcfg, jp, jnp.asarray(x1), jc1, js1, cache=jcache,
                           pos=jnp.int32(s))
    got, _ = L.apply_gqa(cfg, p, _t(x1), c1, s1, cache=cache, pos=s)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ("internlm2-1.8b", "stablelm-12b"))
def test_apply_mlp_matches_reference(arch):
    cfg, tree, model = _reference_model(arch, seed=2)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[1]),
                                tree["segments"]["seg0"]["ffn"])
    x = np.random.default_rng(3).normal(
        size=(2, 7, cfg.d_model)).astype(np.float32)
    want = JL.apply_mlp(jp, jnp.asarray(x))
    got = L.apply_mlp(model.segments[0][1].ffn, _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_forward_hidden_matches_reference(arch):
    cfg, tree, model = _reference_model(arch, seed=3)
    key, x = _inputs(cfg, 4, 2, 32)
    want, want_aux = JT.forward_hidden(jsmoke_config(arch), tree,
                                       {key: jnp.asarray(x)})
    got, aux = T.forward_hidden(cfg, model, {key: x})
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    # the summed MoE aux loss: 0 without MoE layers
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL,
                               atol=TOL)
    assert (float(aux) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_match_reference(arch):
    cfg, tree, model = _reference_model(arch, seed=5)
    jcfg = jsmoke_config(arch)
    b, s, cache_len = 2, 32, 40
    key, x = _inputs(cfg, 6, b, s + 3)
    jcaches = JT.init_cache(jcfg, b, cache_len)
    want, jcaches = JT.prefill(jcfg, tree, {key: jnp.asarray(x[:, :s])},
                               jcaches)
    caches = T.init_cache(cfg, b, cache_len, device="cpu")
    got, caches = T.prefill(cfg, model, {key: x[:, :s]}, caches)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    for seg, c in caches.items():       # the prompt's caches, every leaf
        assert set(c) == set(jcaches[seg])
        for name in c:
            assert c[name].dtype == torch.float32
            np.testing.assert_allclose(c[name].numpy(),
                                       _np(jcaches[seg][name]),
                                       rtol=MODEL_TOL, atol=MODEL_TOL,
                                       err_msg=f"prefill {seg} {name}")
    for i in range(s, s + 3):
        want, jcaches = JT.decode_step(jcfg, tree, jnp.asarray(x[:, i]),
                                       jcaches, jnp.int32(i))
        got, caches = T.decode_step(cfg, model, x[:, i], caches, i)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=MODEL_TOL,
                                   atol=MODEL_TOL, err_msg=f"decode {i}")
    for seg, c in caches.items():   # {"k","v"}, {"ckv","kr"}, {"state",..}
        assert set(c) == set(jcaches[seg])
        for name in c:
            np.testing.assert_allclose(c[name].numpy(),
                                       _np(jcaches[seg][name]),
                                       rtol=MODEL_TOL, atol=MODEL_TOL)


@pytest.mark.parametrize("arch", PORTED)
def test_decode_matches_forward(arch):
    """Teacher-forced decode reproduces the port's own full forward. A
    prompt's MoE may drop slots past its capacity where a decode step
    (capacity 1 of top_k distinct experts) never does, so for the MoE
    configs the capacity factor is raised to E/k: no forward drops a slot,
    and the two must agree."""
    cfg = configs.smoke_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_routed / cfg.moe.top_k))
    model = T.init_params(cfg, 7, device="cpu")
    b, s = 2, 32
    key, x = _inputs(cfg, 8, b, s)
    h, _ = T.forward_hidden(cfg, model, {key: x})
    ref_logits = (h @ model.head_matrix()).numpy()
    half = s // 2
    caches = T.init_cache(cfg, b, s, device="cpu")
    logits, caches = T.prefill(cfg, model, {key: x[:, :half]}, caches)
    np.testing.assert_allclose(logits.numpy(), ref_logits[:, half - 1],
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    for i in range(half, half + 3):
        logits, caches = T.decode_step(cfg, model, x[:, i], caches, i)
        np.testing.assert_allclose(logits.numpy(), ref_logits[:, i],
                                   rtol=MODEL_TOL, atol=MODEL_TOL,
                                   err_msg=f"{arch} decode step {i}")


def test_mrope_prefill_matches_reference():
    """qwen2-vl-7b's prefill with a ``positions`` (3, B, S) key (an image
    grid among text) against the JAX package's, caches included, then
    decode steps; the hidden states differ from plain RoPE's on the same
    embeds from the grid's second patch on."""
    arch = "qwen2-vl-7b"
    cfg, tree, model = _reference_model(arch, seed=11)
    jcfg = jsmoke_config(arch)
    b, cache_len = 2, 40
    pos = _image_positions(b, 6, 4, 5, 6)            # S = 32
    s = pos.shape[-1]
    _, x = _inputs(cfg, 12, b, s + 2)
    batch = {"embeds": x[:, :s], "positions": pos}
    jcaches = JT.init_cache(jcfg, b, cache_len)
    want, jcaches = JT.prefill(jcfg, tree, {k: jnp.asarray(v) for k, v in
                                            batch.items()}, jcaches)
    caches = T.init_cache(cfg, b, cache_len, device="cpu")
    got, caches = T.prefill(cfg, model, batch, caches)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(caches["seg0"][name].numpy(),
                                   _np(jcaches["seg0"][name]),
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
    for i in range(s, s + 2):
        want, jcaches = JT.decode_step(jcfg, tree, jnp.asarray(x[:, i]),
                                       jcaches, jnp.int32(i))
        got_i, caches = T.decode_step(cfg, model, x[:, i], caches, i)
        np.testing.assert_allclose(got_i.numpy(), _np(want),
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
    h, _ = T.forward_hidden(cfg, model, batch)
    jh, _ = JT.forward_hidden(jcfg, tree, {k: jnp.asarray(v) for k, v in
                                           batch.items()})
    np.testing.assert_allclose(h.numpy(), _np(jh), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    # plain RoPE (no positions key): the text before the grid and the
    # grid's first patch (t = h = w = 6) give the same bits, every later
    # row moves (small smoke weights keep the attention near uniform, so
    # by ~1e-4, far above the ~1e-7 of a float32 reordering)
    plain, _ = T.forward_hidden(cfg, model, {"embeds": x[:, :s]})
    assert torch.equal(plain[:, :7], h[:, :7])
    assert float((plain - h)[:, 7:].abs().amax(-1).min()) > 1e-5


@pytest.mark.parametrize("arch", ("internlm2-1.8b", "qwen3-32b",
                                  "deepseek-v2-lite-16b",
                                  "deepseek-moe-16b", "mamba2-370m",
                                  "hymba-1.5b", "qwen2-vl-7b",
                                  "musicgen-large"))
def test_engine_greedy_matches_reference(arch):
    cfg, tree, model = _reference_model(arch, seed=9)
    _, prompts = _inputs(cfg, 10, 2, 12)
    scfg = E.ServeConfig(cache_len=24, batch_size=2)
    want = JE.Engine(jsmoke_config(arch), tree,
                     JE.ServeConfig(cache_len=24, batch_size=2)
                     ).generate(prompts, 8)
    engine = E.Engine(cfg, model, scfg, device="cpu")
    got = engine.generate(prompts, 8)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, np.asarray(want))
    stats = engine.last_stats
    assert stats["prompt_tokens"] == 24 and stats["decode_steps"] == 7
    # the same prompts as a tensor
    assert np.array_equal(engine.generate(torch.as_tensor(prompts), 8), got)


def test_engine_sampling_follows_the_seed():
    cfg = configs.smoke_config("internlm2-1.8b")
    model = T.init_params(cfg, 0, device="cpu")
    engine = E.Engine(cfg, model, E.ServeConfig(cache_len=20, batch_size=2,
                                                temperature=0.8),
                      device="cpu")
    prompts = _tokens(cfg, 1, 2, 8)
    a = engine.generate(prompts, 10, seed=1)
    assert np.array_equal(a, engine.generate(prompts, 10, seed=1))
    assert not np.array_equal(a, engine.generate(prompts, 10, seed=2))
    assert a.min() >= 0 and a.max() < cfg.vocab_size


def test_engine_stops_at_eos_and_checks_sizes():
    cfg = configs.smoke_config("internlm2-1.8b")
    model = T.init_params(cfg, 0, device="cpu")
    prompts = _tokens(cfg, 2, 2, 8)
    greedy = E.Engine(cfg, model, E.ServeConfig(cache_len=20, batch_size=2),
                      device="cpu").generate(prompts, 6)
    eos = int(greedy[0, 0])
    out = E.Engine(cfg, model, E.ServeConfig(cache_len=20, batch_size=2,
                                             eos_token=eos),
                   device="cpu").generate(prompts, 6)
    assert out[0, 0] == eos and np.all(out[0, 1:] == eos)
    engine = E.Engine(cfg, model, E.ServeConfig(cache_len=10, batch_size=2),
                      device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        engine.generate(prompts, 4)
    with pytest.raises(ValueError, match="slots"):
        engine.generate(prompts[:1], 2)
