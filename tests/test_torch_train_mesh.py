"""The LM on a mesh: the sharded train step, prefill, decode and
checkpoints of the port's FSDP×TP layout (``transformer.shard_params``,
``launch.specs.build_cell``) against the unsharded port and the JAX
package, on one gloo world of 4 CPU ranks on a (data 2, model 2) mesh.

Configs at smoke size (float32): internlm2-1.8b (GQA and an MLP, both
split over the model axis; remat "dots", which keeps the split
attention's partial output product for the recompute), deepseek-moe-16b (its
experts split over the model axis; the MoE aux loss, whose expert fractions
are summed over the batch ranks; remat "full", so the layers' collectives
run again in the recompute), mamba2-370m (the pure-DP
``dp_over_tp`` layout) and internlm2 with 6 heads and 3 KV heads, whose 48
K columns the rule still splits over the model axis although the split
cuts a head: the attention runs split all the same, each model rank on
the heads ``sharding.head_ranges`` deals it (4/2 query heads, 2/1 KV
heads), wk and wv gathered and cut to them, its K/V cache held by its
own KV heads. The same numpy tree, batch and tokens go through each.

Tolerances (float32): sharded against unsharded, the loss 1e-6 relative,
each gradient leaf 1e-5 relative L2 (the sums over batch ranks and over the
model axis run in another order; measured ≤ 3e-6), logits 1e-5; against
the JAX package, gradients 1e-4 and logits 1e-4 (``test_torch_train.py``'s
and ``test_torch_lm.py``'s limits). AdamW's first step divides each
gradient by its own magnitude plus 1e-8, so an entry whose gradient is
near 1e-8 moves by up to lr times its relative error: each leaf's update
(new − old master) is held to 1e-3 relative L2. Greedy tokens are equal.

The ranks import this module by name, so it imports no JAX at its top
level.
"""
import dataclasses
import functools
import tempfile
import threading

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

from repro_torch import configs
from repro_torch.launch.world import run_world
from repro_torch.models import transformer as T

ARCHS = {"internlm2": ("internlm2-1.8b", {"remat": "dots"}),
         "deepseek-moe": ("deepseek-moe-16b", {"remat": "full"}),
         "mamba2": ("mamba2-370m", {}),
         "kv3": ("internlm2-1.8b", {"n_heads": 6, "n_kv_heads": 3})}
B, S_LEN, NEW = 4, 32, 4
LOSS_TOL, GRAD_TOL, LOGIT_TOL = 1e-6, 1e-5, 1e-5
REF_GRAD_TOL, REF_LOGIT_TOL, UPDATE_TOL = 1e-4, 1e-4, 1e-3


def _cfg(tag):
    arch, over = ARCHS[tag]
    return dataclasses.replace(configs.smoke_config(arch), **over)


def _jcfg(tag):
    from repro.configs import smoke_config as jsmoke
    arch, over = ARCHS[tag]
    return dataclasses.replace(jsmoke(arch), **over)


@functools.lru_cache(maxsize=None)
def _inputs(tag):
    """The tree (the port's draws in the reference layout), a batch and
    prompts, from numpy seeds."""
    cfg = _cfg(tag)
    tree = T.params_to_reference(cfg, T.init_params(cfg, 0, device="cpu",
                                                    masters=True))
    rng = np.random.default_rng(1)
    labels = rng.integers(0, cfg.vocab_size, (B, S_LEN)).astype(np.int32)
    labels[0, :3] = -1
    tokens = rng.integers(0, cfg.vocab_size, (B, S_LEN)).astype(np.int32)
    return tree, {"tokens": tokens, "labels": labels}


def _opt():
    """``build_cell``'s AdamW settings (the defaults: lr 3e-4 after 100
    warm-up steps, so 3e-6 at step 1)."""
    from repro_torch.train.optimizer import OptConfig
    return OptConfig()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _sharded_run(tag, tree, batch, ckpt_in, ckpt_out):
    """One config on this rank: the sharded step (through ``build_cell``'s
    step), its gradients and updated masters gathered whole; prefill and
    decode logits and the mesh Engine's greedy tokens; for internlm2 the
    checkpoint round trips."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import TrainConfig, Trainer
    torch.set_num_threads(1)
    cfg = _cfg(tag)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=S_LEN,
                                global_batch=B)
    step, _, _ = specs.build_cell(cfg, shape, mesh)
    model = T.shard_params(cfg, T.params_from_reference(
        cfg, tree, device="cpu", masters=True), mesh, batch_size=B)
    named = dict(model.named_parameters())
    before = {n: p.full_tensor().detach().clone() for n, p in named.items()}
    state = init_opt_state(named, _opt())
    _, state, metrics = step(model, state, batch)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": T.params_to_reference(
               cfg, {n: p.grad for n, p in named.items()}),
           "update": T.params_to_reference(
               cfg, {n: p.full_tensor() - before[n]
                     for n, p in named.items()})}
    serve = T.shard_params(cfg, T.params_from_reference(
        cfg, tree, device="cpu"), mesh)
    caches = T.init_cache(cfg, B, S_LEN + NEW, device="cpu", mesh=mesh)
    logits, caches = T.prefill(cfg, serve, {"tokens": batch["tokens"]},
                               caches)
    out["prefill"] = logits.full_tensor().numpy()
    tok = out["prefill"].argmax(-1)
    logits, caches = T.decode_step(cfg, serve, tok, caches, S_LEN)
    out["decode"] = logits.full_tensor().numpy()
    eng = Engine(cfg, serve, ServeConfig(cache_len=S_LEN + NEW,
                                         batch_size=B), device="cpu")
    out["tokens"] = eng.generate(batch["tokens"], NEW)
    if ckpt_in is not None:
        # an unsharded checkpoint restored into shards, then this run's
        # own checkpoint written sharded (every rank gathers, rank 0 writes)
        tcfg = TrainConfig(opt=_opt(), checkpoint_dir=ckpt_in,
                           log_every=1000)
        fresh = T.shard_params(cfg, T.init_params(
            cfg, 5, device="cpu", masters=True), mesh, batch_size=B)
        tr = Trainer(cfg, tcfg, fresh, iter([]), step_fn=step,
                     device="cpu")
        assert tr.restore()
        out["restored"] = T.params_to_reference(cfg, tr.params)
        out["restored_m"] = T.params_to_reference(cfg, tr.opt_state.m)
        out["restored_step"] = int(tr.step)
        data = iter([batch])
        tr = Trainer(cfg, dataclasses.replace(tcfg, checkpoint_dir=ckpt_out,
                                              checkpoint_every=1),
                     T.shard_params(cfg, T.params_from_reference(
                         cfg, tree, device="cpu", masters=True), mesh,
                         batch_size=B), data, step_fn=step, device="cpu")
        tr.run(1)
        out["saved"] = T.params_to_reference(cfg, tr.params)
    return out


def _ranks(tags, inputs, ckpt_in, ckpt_out):
    out = {}
    for tag in tags:
        tree, batch = inputs[tag]
        out[tag] = _sharded_run(tag, tree, batch,
                                ckpt_in if tag == "internlm2" else None,
                                ckpt_out)
    return out


# --------------------------------------------------------------------------
# the parent: the unsharded port and the JAX package
# --------------------------------------------------------------------------

def _unsharded(tag):
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import TrainConfig, make_train_step
    cfg = _cfg(tag)
    tree, batch = _inputs(tag)
    model = T.params_from_reference(cfg, tree, device="cpu", masters=True)
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    tcfg = TrainConfig(opt=_opt())
    state = init_opt_state(named, tcfg.opt)
    _, state, metrics = make_train_step(cfg, tcfg)(model, state, batch)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": T.params_to_reference(
               cfg, {n: p.grad for n, p in named.items()}),
           "update": T.params_to_reference(
               cfg, {n: p.detach() - before[n] for n, p in named.items()})}
    serve = T.params_from_reference(cfg, tree, device="cpu")
    caches = T.init_cache(cfg, B, S_LEN + NEW, device="cpu")
    logits, caches = T.prefill(cfg, serve, {"tokens": batch["tokens"]},
                               caches)
    out["prefill"] = logits.numpy()
    logits, _ = T.decode_step(cfg, serve, out["prefill"].argmax(-1), caches,
                              S_LEN)
    out["decode"] = logits.numpy()
    out["tokens"] = Engine(cfg, serve, ServeConfig(
        cache_len=S_LEN + NEW, batch_size=B), device="cpu").generate(
            batch["tokens"], NEW)
    return out


def _reference(tag):
    """The JAX package's loss, gradients, AdamW update, prefill and decode
    logits and greedy tokens on the same tree and batch."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as JT
    from repro.serve import engine as JE
    from repro.train import optimizer as JO
    jcfg = _jcfg(tag)
    tree, batch = _inputs(tag)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(jcfg, p, b), has_aux=True))(tree, jb)
    ocfg = JO.OptConfig()
    new, _, _ = jax.jit(JO.apply_updates, static_argnums=3)(
        tree, grads, JO.init_opt_state(tree, ocfg), ocfg)
    update = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b, new,
                                    tree)
    caches = JT.init_cache(jcfg, B, S_LEN + NEW)
    prefill_fn = jax.jit(functools.partial(JT.prefill, jcfg))
    decode_fn = jax.jit(functools.partial(JT.decode_step, jcfg))
    logits, caches = prefill_fn(tree, {"tokens": jb["tokens"]}, caches)
    prefill = np.asarray(logits)
    # the reference Engine's greedy loop on the same compiled steps: the
    # prefill's argmax, then each decode step's at positions P, P + 1, ...
    tok = JE.sample(logits, None, 0.0)
    tokens, decode = [np.asarray(tok)], None
    for i in range(NEW - 1):
        logits, caches = decode_fn(tree, tok, caches, jnp.int32(S_LEN + i))
        decode = np.asarray(logits) if decode is None else decode
        tok = JE.sample(logits, None, 0.0)
        tokens.append(np.asarray(tok))
    return {"loss": float(loss), "grads": jax.tree_util.tree_map(
        np.asarray, grads), "update": update, "prefill": prefill,
        "decode": decode, "tokens": np.stack(tokens, axis=1)}


@pytest.fixture(scope="module")
def runs():
    """The world of 4 (every config, one spawn) beside the unsharded port
    and the JAX package; internlm2's checkpoints round-trip through
    temporary directories."""
    from repro_torch.train.optimizer import OptState, init_opt_state
    from repro_torch.train import checkpoint as ckpt
    inputs = {tag: _inputs(tag) for tag in ARCHS}
    with tempfile.TemporaryDirectory() as ckpt_in, \
            tempfile.TemporaryDirectory() as ckpt_out:
        # an unsharded checkpoint (step 7, moments = the tree + 1)
        cfg = _cfg("internlm2")
        tree, _ = inputs["internlm2"]
        model = T.params_from_reference(cfg, tree, device="cpu",
                                        masters=True)
        named = dict(model.named_parameters())
        st = init_opt_state(named, _opt())
        m = {n: p.detach() + 1 for n, p in named.items()}
        state = {"params": T.params_to_reference(cfg, model),
                 "opt_state": OptState(np.asarray(7, np.int32),
                                       T.params_to_reference(cfg, m),
                                       T.params_to_reference(cfg, st.v),
                                       None)}
        ckpt.save(ckpt_in, state, step=7)
        # the world runs while this process computes the references
        world = {}
        thread = threading.Thread(target=lambda: world.update(
            results=run_world(_ranks, 4, args=(tuple(ARCHS), inputs,
                                               ckpt_in, ckpt_out),
                              join_timeout_s=420)))
        thread.start()
        try:
            port = {t: _unsharded(t) for t in ARCHS}
            ref = {t: _reference(t) for t in ARCHS}
        finally:
            thread.join()
        assert "results" in world, "the world of 4 failed (see its output)"
        results = world["results"]
        # the sharded run's checkpoint restored unsharded
        from repro_torch.train.trainer import TrainConfig, Trainer
        tr = Trainer(cfg, TrainConfig(opt=_opt(), checkpoint_dir=ckpt_out),
                     T.init_params(cfg, 9, device="cpu", masters=True),
                     iter([]), device="cpu")
        assert tr.restore() and tr.step == 1
        unsharded_restore = T.params_to_reference(cfg, tr.params)
    return {"ranks": results, "port": port, "ref": ref,
            "unsharded_restore": unsharded_restore, "tree": inputs}


@pytest.mark.parametrize("tag", sorted(ARCHS))
def test_sharded_loss_matches(runs, tag):
    got = [r[tag]["metrics"] for r in runs["ranks"]]
    port, ref = runs["port"][tag]["metrics"], runs["ref"][tag]["loss"]
    for m in got:                    # every rank reports the global loss
        assert m["loss"] == pytest.approx(port["loss"], rel=LOSS_TOL)
        assert m["ce"] == pytest.approx(port["ce"], rel=LOSS_TOL)
        assert m["aux"] == pytest.approx(port["aux"], rel=LOSS_TOL,
                                         abs=1e-9)
        assert m["tokens"] == port["tokens"]
        assert m["grad_norm"] == pytest.approx(port["grad_norm"],
                                               rel=GRAD_TOL)
        assert m["loss"] == pytest.approx(ref, rel=REF_GRAD_TOL)
    if tag == "deepseek-moe":
        assert got[0]["aux"] > 0


@pytest.mark.parametrize("tag", sorted(ARCHS))
def test_sharded_gradients_match_every_leaf(runs, tag):
    got = dict(_leaves(runs["ranks"][0][tag]["grads"]))
    port = dict(_leaves(runs["port"][tag]["grads"]))
    ref = dict(_leaves(runs["ref"][tag]["grads"]))
    assert set(got) == set(port) == set(ref)
    for path in got:
        assert _rel(got[path], port[path]) < GRAD_TOL, path
        assert _rel(got[path], ref[path]) < REF_GRAD_TOL, path
    for other in runs["ranks"][1:]:          # the same gathered gradients
        for path, g in _leaves(other[tag]["grads"]):
            np.testing.assert_array_equal(g, got[path])


@pytest.mark.parametrize("tag", sorted(ARCHS))
def test_sharded_adamw_update_matches_every_leaf(runs, tag):
    got = dict(_leaves(runs["ranks"][0][tag]["update"]))
    port = dict(_leaves(runs["port"][tag]["update"]))
    ref = dict(_leaves(runs["ref"][tag]["update"]))
    for path in got:
        assert _rel(got[path], port[path]) < UPDATE_TOL, path
        assert _rel(got[path], ref[path]) < UPDATE_TOL, path


@pytest.mark.parametrize("tag", sorted(ARCHS))
def test_sharded_prefill_decode_and_greedy_tokens(runs, tag):
    port, ref = runs["port"][tag], runs["ref"][tag]
    for r in runs["ranks"]:
        got = r[tag]
        for key in ("prefill", "decode"):
            np.testing.assert_allclose(got[key], port[key], rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL)
            np.testing.assert_allclose(got[key], ref[key],
                                       rtol=REF_LOGIT_TOL,
                                       atol=REF_LOGIT_TOL)
        np.testing.assert_array_equal(got["tokens"], port["tokens"])
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])


def test_checkpoints_cross_restore(runs):
    """An unsharded checkpoint restores into shards (the params, AdamW's
    moments and the step bit for bit); a sharded run's checkpoint (rank 0
    writes the gathered tree) restores unsharded to the sharded run's
    masters bit for bit."""
    tree, _ = runs["tree"]["internlm2"]
    for r in runs["ranks"]:
        got = r["internlm2"]
        assert got["restored_step"] == 7
        for path, leaf in _leaves(tree):
            np.testing.assert_array_equal(dict(_leaves(got["restored"]))[path],
                                          leaf)
            np.testing.assert_array_equal(
                dict(_leaves(got["restored_m"]))[path], leaf + 1)
    saved = dict(_leaves(runs["ranks"][0]["internlm2"]["saved"]))
    for path, leaf in _leaves(runs["unsharded_restore"]):
        np.testing.assert_array_equal(leaf, saved[path])
