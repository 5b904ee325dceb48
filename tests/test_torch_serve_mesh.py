"""Sequence-parallel prefill and vocab-parallel serving of the LM on a
mesh (``transformer.prefill`` / ``decode_step`` through
``launch.specs.build_cell``'s prefill and serve steps, and
``serve.engine.Engine.generate``) against the unsharded port and the JAX
package, on the CPU.

One gloo world of 4 ranks on a (data 2, model 2) mesh serves each case at
smoke width (float32) from the same numpy tree, carried across with
``params_from_reference``:

  - ``qwen3``: qwen3-32b at S = 2,048: the residual split, ``qk_norm``,
    an untied head;
  - ``internlm2``: S = 2,048, split;
  - ``internlm2-1024``: S = 1,024, below the split's threshold;
  - ``internlm2-2049``: S = 2,049, which the model axis does not divide;
  - ``kv3``: internlm2 with 6 heads and 3 KV heads at S = 2,048: the
    attention runs split under the split residual, 4/2 query heads and
    2/1 KV heads a model rank (``sharding.head_ranges``), each caching its
    own KV heads;
  - ``deepseek-moe``: S = 2,048, its experts split over the model axis;
  - ``qwen2-vl``: S = 2,048 of embeds input with M-RoPE positions (3, B,
    S) of text around an image grid;
  - ``tied``: internlm2 with ``tie_embeddings``: the head is the
    embedding's vocab shard;
  - ``mamba2``: the pure-DP ``dp_over_tp`` layout, nothing split.

Each case asserts where the residual is split (every layer of a split
prefill takes (B/dp, S/m, D), as the JAX package's ``_apply_layer``
splits it; any other (B/dp, S, D)), that the logits come back split over
the vocab on ``model`` (replicated there under pure DP), and that no
collective gathers a whole (V, D) table (pure DP gathers it whole, as
every weight). Tolerances are ``test_torch_train_mesh.py``'s: logits 1e-5
against the unsharded port and 1e-4 against the JAX package, equal greedy
tokens; the caches after the prefill and one decode step 1e-5 relative
L2 against the unsharded port's. On qwen3 each planted serving fault of
``chip_smoke.MESH_FAULTS`` (kind "serve") moves the logits or a cache by
more than ``chip_smoke.MESH_LOGIT_REL``, phase 23's limit.

The ranks import this module by name, so it imports no JAX at its top
level.
"""
import dataclasses
import functools
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

from repro_torch import configs
from repro_torch.launch.world import run_world
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]

#: tag → (arch, config overrides, batch, prompt length)
CASES = {
    "qwen3": ("qwen3-32b", {}, 2, 2048),
    "internlm2": ("internlm2-1.8b", {}, 2, 2048),
    "internlm2-1024": ("internlm2-1.8b", {}, 2, 1024),
    # the JAX package's chunked attention needs S to divide by its chunk
    "internlm2-2049": ("internlm2-1.8b", {"attn_chunk": 2049}, 2, 2049),
    "kv3": ("internlm2-1.8b", {"n_heads": 6, "n_kv_heads": 3}, 2, 2048),
    "deepseek-moe": ("deepseek-moe-16b", {}, 2, 2048),
    "qwen2-vl": ("qwen2-vl-7b", {}, 2, 2048),
    "tied": ("internlm2-1.8b", {"tie_embeddings": True}, 2, 2048),
    # pure DP needs a batch that every rank of the mesh divides
    "mamba2": ("mamba2-370m", {}, 4, 2048),
}
#: the cases whose prefill splits the residual over the sequence
SPLIT = ("qwen3", "internlm2", "kv3", "deepseek-moe", "qwen2-vl", "tied")
NEW = 3
LOGIT_TOL, REF_LOGIT_TOL, CACHE_TOL = 1e-5, 1e-4, 1e-5
FAULTED = "qwen3"


def _cfg(tag):
    arch, over, _, _ = CASES[tag]
    return dataclasses.replace(configs.smoke_config(arch), **over)


def _jcfg(tag):
    from repro.configs import smoke_config as jsmoke
    arch, over, _, _ = CASES[tag]
    return dataclasses.replace(jsmoke(arch), **over)


def _image_positions(b, s, rows=8, cols=8, text=100):
    """M-RoPE positions (3, B, S): text, a rows × cols patch grid (t
    fixed, h the row, w the column), then text to S."""
    grid_h, grid_w = np.meshgrid(np.arange(rows), np.arange(cols),
                                 indexing="ij")
    g = [np.full(rows * cols, text), text + grid_h.ravel(),
         text + grid_w.ravel()]
    tail = s - text - rows * cols
    after = text + max(rows, cols) + np.arange(tail)
    pos = np.stack([np.concatenate([np.arange(text), gi, after])
                    for gi in g])
    return np.broadcast_to(pos[:, None], (3, b, s)).astype(np.int32).copy()


@functools.lru_cache(maxsize=None)
def _inputs(tag):
    """The tree (the port's draws in the reference layout, in the serving
    dtype) and the prefill batch, from numpy seeds."""
    cfg = _cfg(tag)
    _, _, b, s = CASES[tag]
    tree = T.params_to_reference(cfg, T.init_params(cfg, 0, device="cpu"))
    rng = np.random.default_rng(4)
    if cfg.input_mode == "tokens":
        batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                        (b, s)).astype(np.int32)}
    else:
        batch = {"embeds": rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)}
    if cfg.mrope_sections is not None:
        batch["positions"] = _image_positions(b, s)
    return tree, batch


def _prompts(batch):
    return batch.get("tokens", batch.get("embeds"))


def _feed(cfg, logits):
    """A decode step's input after the prefill: its greedy token, or zeros
    for a model on embedding input (as ``Engine`` feeds)."""
    if cfg.input_mode == "tokens":
        return np.asarray(logits).argmax(-1).astype(np.int32)
    return np.zeros((logits.shape[0], cfg.d_model), np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _chip_smoke():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _serve_faults():
    return [n for n, (kind, _) in _chip_smoke().MESH_FAULTS.items()
            if kind == "serve"]


def _tables(tag):
    """{name: the (V/m, D) or (D, V/m) shape it is gathered to} of the
    model's embedding and head (an embeds model has no embedding, a tied
    one no head)."""
    cfg = _cfg(tag)
    v, d = cfg.vocab_size, cfg.d_model
    out = {}
    if cfg.input_mode == "tokens":
        out["embed"] = (v // 2, d)
    if not cfg.tie_embeddings:
        out["head"] = (d, v // 2)
    return out


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _whole_caches(caches):
    from repro_torch.models import sharding as S
    return {seg: {n: S.whole(buf).numpy() for n, buf in bufs.items()}
            for seg, bufs in caches.items()}


def _serve_once(tag, model, mesh, batch):
    """The prefill and one decode step through ``build_cell``'s steps:
    both logits made whole, the prefill logits' placements, the caches
    made whole, each layer's input shape a call and every all-gather's
    output shape."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import specs
    from repro_torch.models import sharding as S
    cfg = _cfg(tag)
    _, _, b, s = CASES[tag]
    prefill_step, _, _ = specs.build_cell(
        cfg, dataclasses.replace(SHAPES["prefill_32k"], seq_len=s,
                                 global_batch=b), mesh)
    serve_step, _, _ = specs.build_cell(
        cfg, dataclasses.replace(SHAPES["decode_32k"], seq_len=s + NEW,
                                 global_batch=b), mesh)
    carries, gathers = [], []
    hooks = [layer.register_forward_pre_hook(
        lambda mod, args: carries.append(tuple(args[0].shape)))
        for seg in model.segments for layer in seg]
    right = S.all_gather

    def recording(t, group, n, dim):
        out = right(t, group, n, dim)
        gathers.append(tuple(out.shape))
        return out

    S.all_gather = recording
    try:
        caches = T.init_cache(cfg, b, s + NEW, device="cpu", mesh=mesh)
        S.reset_collectives()
        logits, caches = prefill_step(model, batch, caches)
        prefill_counts = S.collective_counts()
        out = {"prefill": logits.full_tensor().numpy(),
               "placements": [(type(p).__name__, getattr(p, "dim", None))
                              for p in logits.placements],
               "prefill_carries": list(carries)}
        carries.clear()
        S.reset_collectives()
        logits, caches = serve_step(model, _feed(cfg, out["prefill"]),
                                    caches, s)
        out.update(decode=logits.full_tensor().numpy(),
                   decode_carries=list(carries),
                   collectives={"prefill": prefill_counts,
                                "decode": S.collective_counts()})
    finally:
        S.all_gather = right
        for h in hooks:
            h.remove()
    out["gathers"] = gathers
    out["caches"] = _whole_caches(caches)
    return out


def _sharded_run(tag, tree, batch):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = _cfg(tag)
    _, _, b, s = CASES[tag]
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    model = T.shard_params(cfg, T.params_from_reference(
        cfg, tree, device="cpu"), mesh)
    layout = T.layout_of(model)
    out = _serve_once(tag, model, mesh, batch)
    out.update(split=layout.sequence(s) is not None,
               vocab_parallel=sorted(layout.vocab_parallel),
               rows=len(T._local_batch(layout, {"x": _prompts(batch)},
                                       layout.cache_axes(b))["x"]))
    out["tokens"] = Engine(cfg, model, ServeConfig(
        cache_len=s + NEW, batch_size=b), device="cpu").generate(
            _prompts(batch), NEW)
    out["hidden_rows"] = layout.rows(b, layout.cache_axes(b))
    out["hidden"] = T.forward_hidden(cfg, model, batch)[0].numpy()
    if tag == FAULTED:
        C = _chip_smoke()
        out["faults"] = {}
        for name, (kind, plant) in C.MESH_FAULTS.items():
            if kind == "serve":
                with plant(mesh):
                    f = _serve_once(tag, model, mesh, batch)
                out["faults"][name] = {k: f[k] for k in
                                       ("prefill", "decode", "caches")}
    return out


def _ranks(inputs):
    torch.set_num_threads(1)
    return {tag: _sharded_run(tag, *inputs[tag]) for tag in CASES}


# --------------------------------------------------------------------------
# the parent: the unsharded port and the JAX package
# --------------------------------------------------------------------------

def _unsharded(tag):
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = _cfg(tag)
    _, _, b, s = CASES[tag]
    tree, batch = _inputs(tag)
    model = T.params_from_reference(cfg, tree, device="cpu")
    caches = T.init_cache(cfg, b, s + NEW, device="cpu")
    logits, caches = T.prefill(cfg, model, batch, caches)
    out = {"prefill": logits.numpy()}
    logits, caches = T.decode_step(cfg, model, _feed(cfg, out["prefill"]),
                                   caches, s)
    out["decode"] = logits.numpy()
    out["caches"] = {seg: {n: buf.numpy() for n, buf in bufs.items()}
                     for seg, bufs in caches.items()}
    out["tokens"] = Engine(cfg, model, ServeConfig(
        cache_len=s + NEW, batch_size=b), device="cpu").generate(
            _prompts(batch), NEW)
    out["hidden"] = T.forward_hidden(cfg, model, batch)[0].numpy()
    return out


def _reference(tag):
    """The JAX package's prefill and first decode logits on the same tree
    and batch, and its greedy tokens (its Engine's loop on the prompts
    alone: the prefill's argmax, then each decode step's)."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as JT
    cfg, jcfg = _cfg(tag), _jcfg(tag)
    _, _, b, s = CASES[tag]
    tree, batch = _inputs(tag)
    prefill_fn = jax.jit(functools.partial(JT.prefill, jcfg))
    decode_fn = jax.jit(functools.partial(JT.decode_step, jcfg))

    def greedy(jb):
        caches = JT.init_cache(jcfg, b, s + NEW)
        logits, caches = prefill_fn(tree, jb, caches)
        steps = [np.asarray(logits)]
        toks = [_feed(cfg, steps[0])]
        for i in range(NEW - 1):
            logits, caches = decode_fn(tree, jnp.asarray(toks[-1]), caches,
                                       jnp.int32(s + i))
            steps.append(np.asarray(logits))
            toks.append(_feed(cfg, steps[-1]))
        return steps, np.stack([s_.argmax(-1) for s_ in steps], axis=1)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    steps, tokens = greedy(jb)
    out = {"prefill": steps[0], "decode": steps[1], "tokens": tokens}
    if "positions" in batch:
        # Engine's prompts carry no positions: its tokens, from plain
        # positions
        out["tokens"] = greedy({k: v for k, v in jb.items()
                                if k != "positions"})[1]
    return out


@pytest.fixture(scope="module")
def runs():
    """The world of 4 (every case, one spawn) beside the unsharded port
    and the JAX package."""
    inputs = {tag: _inputs(tag) for tag in CASES}
    world = {}
    thread = threading.Thread(target=lambda: world.update(
        results=run_world(_ranks, 4, args=(inputs,), join_timeout_s=600)))
    thread.start()
    try:
        port = {t: _unsharded(t) for t in CASES}
        ref = {t: _reference(t) for t in CASES}
    finally:
        thread.join()
    assert "results" in world, "the world of 4 failed (see its output)"
    return {"ranks": world["results"], "port": port, "ref": ref}


@pytest.mark.parametrize("tag", sorted(CASES))
def test_prefill_splits_the_residual_where_the_reference_does(runs, tag):
    """Every layer of a split prefill takes (B/dp, S/m, D); any other
    prefill (B/dp, S, D); a decode step (B/dp, 1, D)."""
    cfg = _cfg(tag)
    _, _, b, s = CASES[tag]
    for r in runs["ranks"]:
        got = r[tag]
        assert got["split"] == (tag in SPLIT)
        part = s // 2 if tag in SPLIT else s
        assert got["prefill_carries"] == \
            [(got["rows"], part, cfg.d_model)] * cfg.n_layers
        assert got["decode_carries"] == \
            [(got["rows"], 1, cfg.d_model)] * cfg.n_layers
        assert got["rows"] == b // 2


@pytest.mark.parametrize("tag", sorted(CASES))
def test_logits_come_back_split_over_the_vocab(runs, tag):
    """The reference's head spec: the batch over data, the vocab over
    model (replicated there under pure DP, which splits no block)."""
    for r in runs["ranks"]:
        got = r[tag]
        if tag == "mamba2":
            assert got["vocab_parallel"] == []
            assert got["placements"] == [("Shard", 0),
                                         ("Replicate", None)]
        else:
            assert got["vocab_parallel"] == sorted(_tables(tag))
            assert got["placements"] == [("Shard", 0), ("Shard", 1)]


@pytest.mark.parametrize("tag", sorted(CASES))
def test_no_collective_gathers_a_whole_table(runs, tag):
    """The embedding and the head are gathered over the data axis alone,
    to their vocab shard (V/m, D) and (D, V/m); under pure DP each is
    gathered whole, as every weight is."""
    cfg = _cfg(tag)
    v, d = cfg.vocab_size, cfg.d_model
    for r in runs["ranks"]:
        shapes = set(r[tag]["gathers"])
        whole = {(v, d), (d, v)} & shapes
        if tag == "mamba2":
            assert (v, d) in shapes
            continue
        assert not whole
        for name, shape in _tables(tag).items():
            assert shape in shapes, name


@pytest.mark.parametrize("tag", sorted(CASES))
def test_prefill_and_decode_logits_match(runs, tag):
    port, ref = runs["port"][tag], runs["ref"][tag]
    for r in runs["ranks"]:
        for key in ("prefill", "decode"):
            got = r[tag][key]
            np.testing.assert_allclose(got, port[key], rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL)
            np.testing.assert_allclose(got, ref[key], rtol=REF_LOGIT_TOL,
                                       atol=REF_LOGIT_TOL)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_forward_hidden_matches(runs, tag):
    """``forward_hidden`` on the mesh (its residual split as the
    prefill's, gathered at the end): this rank's batch rows, whole over
    the sequence."""
    want = runs["port"][tag]["hidden"]
    for r in runs["ranks"]:
        first, n = r[tag]["hidden_rows"]
        np.testing.assert_allclose(r[tag]["hidden"], want[first:first + n],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_greedy_tokens_equal(runs, tag):
    port, ref = runs["port"][tag]["tokens"], runs["ref"][tag]["tokens"]
    np.testing.assert_array_equal(port, ref)
    for r in runs["ranks"]:
        np.testing.assert_array_equal(r[tag]["tokens"], port)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_caches_match_after_prefill_and_decode(runs, tag):
    """Each cache buffer (the split GQA's own heads, an attention run
    whole, the SSM's state and conv written back per rank) made whole."""
    port = runs["port"][tag]["caches"]
    for r in runs["ranks"]:
        got = r[tag]["caches"]
        assert {k: set(v) for k, v in got.items()} == \
            {k: set(v) for k, v in port.items()}
        for seg, bufs in got.items():
            for name, buf in bufs.items():
                assert _rel(buf, port[seg][name]) < CACHE_TOL, (seg, name)


@pytest.mark.parametrize("fault", _serve_faults())
def test_planted_serving_fault_fails_the_check(runs, fault):
    """Phase 23's check on qwen3's split prefill: the logits or a cache
    buffer beyond ``MESH_LOGIT_REL`` of the unsharded port's."""
    limit = _chip_smoke().MESH_LOGIT_REL
    port = runs["port"][FAULTED]
    for r in runs["ranks"]:
        got = r[FAULTED]["faults"][fault]
        worst = max([_rel(got[k], port[k]) for k in ("prefill", "decode")]
                    + [_rel(buf, port["caches"][seg][name])
                       for seg, bufs in got["caches"].items()
                       for name, buf in bufs.items()])
        assert worst > limit, fault
