"""The port's LM training slice (``repro_torch.{train, data.tokens}``,
``transformer.lm_loss``, the float32 masters and the flash backward)
against the JAX package's, on the CPU, with internlm2-1.8b's smoke
configuration. The other mixers' losses and gradients are in
``test_torch_train_mixers.py``.

The same numpy inputs (parameters in the JAX package's tree layout, tokens
and gradients from numpy with a seed) go through both packages in
float32. Tolerances: AdamW's parameters 1e-6 and
moments 1e-6 relative (float32, the same operations; the global norm sums
in another order), the loss and
every gradient leaf 1e-4 relative L2 (float32 through a few layers, summed
in another order; measured ≤ 3e-6), the attention's backward 1e-5, a
trainer's loss trajectory 1e-4 and a restored step 1e-5. The JAX
reference's value-and-grad runs under ``jax.jit`` (eager takes 3-5× as
long), once per module.
"""
import dataclasses
import functools
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

from repro.configs import smoke_config as jsmoke_config
from repro.data import tokens as JD
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import checkpoint as jckpt
from repro.train import optimizer as JO
from repro.train import trainer as JTR
from repro_torch import configs
from repro_torch.data import tokens as D
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as O
from repro_torch.train import trainer as TR

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"
GRAD_TOL = 1e-4
OPT_TOL = 1e-6


@functools.lru_cache(maxsize=None)
def _tree(arch=ARCH, seed=0):
    """Smoke parameters in the JAX package's tree layout (numpy; read,
    never written), drawn by the port (the JAX package's eager
    ``init_params`` takes seconds; either package's draws will do)."""
    cfg = configs.smoke_config(arch)
    return T.params_to_reference(cfg, T.init_params(cfg, seed, device="cpu",
                                                    masters=True))


#: the reference's AdamW step, compiled (eager dispatch takes seconds)
_japply = jax.jit(JO.apply_updates, static_argnums=3)


def _batch(cfg, seed=0, b=2, s=64):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :3] = -1                       # masked positions
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32), "labels": labels}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port_grads(cfg, tree, batch):
    model = T.params_from_reference(cfg, tree, device="cpu", masters=True)
    loss, metrics = T.lm_loss(cfg, model, batch)
    loss.backward()
    grads = T.params_to_reference(
        cfg, {n: p.grad for n, p in model.named_parameters()})
    return float(loss.detach()), {k: float(v.detach())
                                  for k, v in metrics.items()}, grads


@pytest.fixture(scope="module")
def reference():
    """internlm2's smoke tree, a batch, and the JAX package's loss,
    metrics and gradient tree on it."""
    cfg = configs.smoke_config(ARCH)
    tree, batch = _tree(), _batch(cfg)
    jcfg = jsmoke_config(ARCH)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(jcfg, p, b), has_aux=True))
    (loss, metrics), grads = fn(tree, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    return {"cfg": cfg, "tree": tree, "batch": batch, "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jax.tree_util.tree_map(np.asarray, grads)}


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 10, 55, 100, 140])
def test_schedule_matches_reference(step):
    """Warm-up (0, 1), peak (10), cosine (55), end (100) and past it."""
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = float(O.schedule(O.OptConfig(**kw), torch.tensor(step)))
    want = float(JO.schedule(JO.OptConfig(**kw), jnp.int32(step)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


#: a model-like set of leaves: stacked per-layer leaves (ndim 1 and 2 in
#: the port, one more in the reference), a matrix, and the final norm
OPT_SHAPES = {"embed": (40, 8), "final_ln": (8,), "head": (8, 40),
              "segments.0.0.ln1": (8,), "segments.0.1.ln1": (8,),
              "segments.0.0.mixer.wq": (8, 16),
              "segments.0.1.mixer.wq": (8, 16)}


def _opt_trees(values):
    """The port's {name: tensor} and the reference's tree (layers stacked)
    of the same numpy values."""
    port = {n: torch.tensor(a) for n, a in values.items()}
    return port, T.params_to_reference(None, port)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "bf16"])
def test_apply_updates_matches_reference(compress):
    rng = np.random.default_rng(3)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6,
              compress_grads=compress)
    cfg, jcfg = O.OptConfig(**kw), JO.OptConfig(**kw)
    params, jparams = _opt_trees({n: rng.normal(size=s).astype(np.float32)
                                  for n, s in OPT_SHAPES.items()})
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    state, jstate = O.init_opt_state(params, cfg), \
        JO.init_opt_state(jparams, jcfg)
    for _ in range(5):
        grads, jgrads = _opt_trees({
            n: (rng.normal(size=s) * 3).astype(np.float32)
            for n, s in OPT_SHAPES.items()})
        params, state, stats = O.apply_updates(params, grads, state, cfg)
        jparams, jstate, jstats = _japply(
            jparams, jax.tree_util.tree_map(jnp.asarray, jgrads), jstate,
            jcfg)
        assert float(stats["lr"]) == pytest.approx(float(jstats["lr"]),
                                                   rel=1e-6)
        assert float(stats["grad_norm"]) == pytest.approx(
            float(jstats["grad_norm"]), rel=1e-6)
    assert int(state.step) == int(jstate.step) == 5
    got = T.params_to_reference(None, params)
    for a, b in zip(ckpt.tree_leaves(got),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=OPT_TOL)
    for mine, theirs in ((state.m, jstate.m), (state.v, jstate.v)):
        for a, b in zip(ckpt.tree_leaves(T.params_to_reference(None, mine)),
                        jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-8)


def test_global_norm_holds_at_large_tensors():
    """The clip's norm over 2^24 + 2^20 elements within 1e-6 of float64
    (a single running float32 total, as ``torch._foreach_norm`` keeps on
    the CPU, is 6.5e-4 off here)."""
    g = torch.Generator().manual_seed(0)
    ts = [torch.randn(1 << 24, generator=g), torch.randn(1 << 20, generator=g)]
    want = float(torch.sqrt(sum((t.double() ** 2).sum() for t in ts)))
    assert float(O.global_norm(ts)) == pytest.approx(want, rel=1e-6)


def test_decay_follows_the_reference_rank():
    """With zero gradients AdamW's step is lr·wd·p on exactly the decayed
    leaves. The reference decays every stacked layer leaf (norm scales
    included: (count, D)) and not ``final_ln``; so must the port
    (``test_apply_updates_matches_reference`` holds the same leaves'
    updates to the reference's)."""
    cfg = configs.smoke_config(ARCH)
    model = T.params_from_reference(cfg, _tree(), device="cpu",
                                    masters=True)
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    ocfg = O.OptConfig(lr=1e-2, warmup_steps=0, weight_decay=0.5)
    O.apply_updates(named, {n: torch.zeros_like(p) for n, p in named.items()},
                    O.init_opt_state(named, ocfg), ocfg)
    moved = {n for n in named if not torch.equal(named[n], before[n])}
    assert moved == set(named) - {"final_ln"}
    assert "segments.0.0.ln1" in moved and "segments.0.1.ln2" in moved
    assert [O.decayed(n, p) for n, p in named.items()
            if n.endswith("ln1") or n == "final_ln"] == [False, True, True]


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("host", [(0, 1), (1, 2)], ids=["one", "host1of2"])
def test_synthetic_tokens_equal_reference(host):
    kw = dict(vocab_size=97, batch=4, seq_len=8, seed=1, host_index=host[0],
              host_count=host[1])
    mine, theirs = D.SyntheticTokens(**kw), JD.SyntheticTokens(**kw)
    for step in (0, 3):
        a, b = mine.batch_at(step), theirs.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(next(iter(mine))["tokens"],
                                  theirs.batch_at(0)["tokens"])


def test_memmap_tokens_equal_reference(tmp_path):
    corpus = np.random.default_rng(0).integers(0, 100, size=10_000)
    D.MemmapTokens.write_corpus(str(tmp_path / "a"), corpus, n_shards=3)
    JD.MemmapTokens.write_corpus(str(tmp_path / "b"), corpus, n_shards=3)
    for name in os.listdir(tmp_path / "a"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes()
    for hi, hc in ((0, 1), (1, 2)):
        mine = D.MemmapTokens(str(tmp_path / "a"), batch=4, seq_len=16,
                              seed=3, host_index=hi, host_count=hc)
        theirs = JD.MemmapTokens(str(tmp_path / "a"), batch=4, seq_len=16,
                                 seed=3, host_index=hi, host_count=hc)
        for step in (0, 5):
            a, b = mine.batch_at(step), theirs.batch_at(step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------------------
# checkpoint and the reference's layout
# --------------------------------------------------------------------------

def test_checkpoint_round_trip_and_gc(tmp_path):
    tree = {"b": {"c": np.ones((4,), np.int32)},
            "a": torch.arange(6.0).reshape(2, 3),
            "s": O.OptState(np.asarray(7, np.int32), {"x": np.zeros(2)},
                            {"x": np.ones(2)}, None)}
    path = ckpt.save(str(tmp_path), tree, step=7)
    assert os.path.exists(os.path.join(path, "manifest.json"))
    restored, step = ckpt.restore_latest(str(tmp_path), like=tree)
    assert step == 7 and isinstance(restored["s"], O.OptState)
    np.testing.assert_array_equal(restored["a"], np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(restored["b"]["c"], tree["b"]["c"])
    assert int(restored["s"].step) == 7 and restored["s"].err is None
    # the leaves are numbered in the JAX package's flatten order
    jtree = {"b": {"c": 0}, "a": 1, "s": JO.OptState(2, {"x": 3}, {"x": 4},
                                                     None)}
    assert [np.load(os.path.join(path, f"leaf_{i}.npy")).shape
            for i in range(5)] == [(2, 3), (4,), (), (2,), (2,)]
    assert jax.tree_util.tree_leaves(jtree) == [1, 0, 2, 3, 4]
    for s in (8, 9, 10):
        ckpt.save(str(tmp_path), {"a": np.zeros(2)}, step=s, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 10
    assert sorted(os.listdir(tmp_path)) == ["step_00000009", "step_00000010"]
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), 10, like={"a": 0, "b": 1})


def test_params_to_reference_round_trips():
    """The JAX package's ``init_params`` tree (its structure, shapes and
    order) is what ``params_to_reference`` gives, and
    ``params_to_reference(params_from_reference(tree))`` is the tree bit
    for bit (float32 masters). The other mixers:
    ``test_torch_train_mixers.py``."""
    cfg = configs.smoke_config(ARCH)
    shapes = jax.eval_shape(lambda: JT.init_params(
        jsmoke_config(ARCH), jax.random.PRNGKey(0)))
    tree = jax.tree_util.tree_map(
        lambda a: np.random.default_rng(a.size).normal(
            size=a.shape).astype(np.float32), shapes)
    model = T.params_from_reference(cfg, tree, device="cpu", masters=True)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in model.parameters())
    back = T.params_to_reference(cfg, model)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(ckpt.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    like = T.reference_like(model)
    assert [tuple(x.shape) for x in ckpt.tree_leaves(like)] == \
        [a.shape for a in jax.tree_util.tree_leaves(tree)]


# --------------------------------------------------------------------------
# the loss, its gradients and the remat settings
# --------------------------------------------------------------------------

def test_lm_loss_and_every_gradient_match_reference(reference):
    cfg = reference["cfg"]
    loss, metrics, grads = _port_grads(cfg, reference["tree"],
                                       reference["batch"])
    assert loss == pytest.approx(reference["loss"], rel=GRAD_TOL)
    assert metrics["tokens"] == reference["metrics"]["tokens"] == 125
    assert metrics["ce"] == pytest.approx(reference["metrics"]["ce"],
                                          rel=GRAD_TOL)
    flat = jax.tree_util.tree_flatten_with_path(reference["grads"])[0]
    mine = ckpt.tree_leaves(grads)
    assert len(mine) == len(flat)
    for (path, want), got in zip(flat, mine):
        assert _rel(got, want) < GRAD_TOL, jax.tree_util.keystr(path)


def test_remat_settings_give_equal_loss_and_gradients(reference):
    out = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(reference["cfg"], remat=remat)
        out[remat] = _port_grads(cfg, reference["tree"], reference["batch"])
    for remat in ("dots", "full"):
        assert out[remat][0] == out["none"][0]
        for a, b in zip(ckpt.tree_leaves(out[remat][2]),
                        ckpt.tree_leaves(out["none"][2])):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


def test_serving_forward_stays_without_gradients(reference):
    cfg = reference["cfg"]
    model = T.params_from_reference(cfg, reference["tree"], device="cpu",
                                    masters=True)
    h, _ = T.forward_hidden(cfg, model, reference["batch"])
    assert not h.requires_grad
    h_train, _ = T.forward_hidden(cfg, model, reference["batch"],
                                  training=True)
    assert h_train.requires_grad
    torch.testing.assert_close(h, h_train.detach(), rtol=0, atol=0)


def test_accumulation_matches_one_batch(reference):
    """accum_steps=4 sums the microbatches' float32 gradients and divides
    by 4: with no masked label every microbatch has as many tokens, so the
    mean of their CE gradients is the whole batch's."""
    cfg = reference["cfg"]
    batch = _batch(cfg, seed=5, b=4, s=16)
    batch["labels"] = np.abs(batch["labels"])
    grads, metrics = {}, {}
    for accum in (1, 4):
        model = T.params_from_reference(cfg, reference["tree"], device="cpu",
                                        masters=True)
        step = TR.make_train_step(cfg, TR.TrainConfig(accum_steps=accum))
        state = O.init_opt_state(dict(model.named_parameters()),
                                 O.OptConfig())
        _, _, metrics[accum] = step(model, state, batch)
        grads[accum] = {n: p.grad.clone() for n, p in
                        model.named_parameters()}
    for n in grads[1]:
        assert _rel(grads[4][n], grads[1][n]) < 1e-5, n
    assert float(metrics[4]["loss"]) == pytest.approx(
        float(metrics[1]["loss"]), rel=1e-6)
    assert float(metrics[4]["tokens"]) == 0 and float(metrics[1]["tokens"]) \
        == 64
    assert float(metrics[4]["grad_norm"]) == pytest.approx(
        float(metrics[1]["grad_norm"]), rel=1e-5)


# --------------------------------------------------------------------------
# the attention's backward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("h,hkv,window,chunk", [
    (4, 4, None, 512),    # GQA rep 1, one chunk
    (4, 2, None, 16),     # rep 2, q-chunked
    (4, 2, 24, 16),       # a sliding window
    (6, 2, 7, 64),        # rep 3, a window shorter than a chunk
], ids=str)
def test_flash_backward_matches_autograd_and_reference(h, hkv, window, chunk):
    b, s, hd = 2, 48, 16
    rng = np.random.default_rng(h * 10 + hkv)
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) for shape in (
        (b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd), (b, s, h, hd)))
    got = ref.flash_attention_bwd_ref(*map(torch.tensor, (q, k, v, do)),
                                      causal=True, window=window,
                                      chunk=chunk)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = ref.flash_attention_bshd_ref(*leaves, causal=True, window=window)
    autograd = torch.autograd.grad(out, leaves, torch.tensor(do))
    _, vjp = jax.vjp(lambda q_, k_, v_: JL.causal_attention(
        q_, k_, v_, window=window, chunk=chunk), q, k, v)
    jax_grads = vjp(jnp.asarray(do))
    for mine, a, j in zip(got, autograd, jax_grads):
        np.testing.assert_allclose(mine.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(mine.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


def test_causal_attention_gradients_through_the_layer():
    """``layers.causal_attention`` is differentiable on the CPU (the plain
    version under autograd) and agrees with the plain backward."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(size=s).astype(np.float32),
                            requires_grad=True)
               for s in ((1, 40, 4, 16), (1, 40, 2, 16), (1, 40, 2, 16)))
    out = L.causal_attention(q, k, v, chunk=16)
    do = torch.ones_like(out)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                       do, chunk=16)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

TRAIN_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)
TRAIN_DATA = dict(batch=4, seq_len=16, seed=2)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The JAX package's Trainer over 3 steps from the smoke tree, with a
    checkpoint at step 2: its losses, its checkpoint directory and the
    Trainer itself (for its compiled step)."""
    cfg = configs.smoke_config(ARCH)
    jcfg = jsmoke_config(ARCH)
    tmp = str(tmp_path_factory.mktemp("jax_ckpt"))
    tcfg = JTR.TrainConfig(opt=JO.OptConfig(**TRAIN_OPT), checkpoint_every=2,
                           checkpoint_dir=tmp, log_every=1000)
    data = JD.SyntheticTokens(vocab_size=cfg.vocab_size, **TRAIN_DATA)
    trainer = JTR.Trainer(jcfg, tcfg, jax.tree_util.tree_map(
        jnp.asarray, _tree()), iter(data))
    losses = [trainer.run(1)["loss"] for _ in range(3)]
    return {"cfg": cfg, "losses": losses, "dir": tmp, "trainer": trainer}


def _port_trainer(cfg, tmp=None, every=100, tree=None):
    tcfg = TR.TrainConfig(opt=O.OptConfig(**TRAIN_OPT), checkpoint_every=every,
                          checkpoint_dir=tmp, log_every=1000)
    data = D.SyntheticTokens(vocab_size=cfg.vocab_size, **TRAIN_DATA)
    model = T.params_from_reference(cfg, tree if tree is not None
                                    else _tree(), device="cpu", masters=True)
    return TR.Trainer(cfg, tcfg, model, iter(data), device="cpu"), data


def test_trainer_loss_trajectory_matches_reference(reference_run):
    trainer, _ = _port_trainer(reference_run["cfg"])
    losses = [trainer.run(1)["loss"] for _ in range(3)]
    np.testing.assert_allclose(losses, reference_run["losses"], rtol=1e-4)
    assert trainer.step == 3 and int(trainer.opt_state.step) == 3


def test_port_restores_a_reference_checkpoint(reference_run):
    """The JAX Trainer's step-2 checkpoint, restored by the port's Trainer
    (into other weights), trains step 3 to the JAX loss."""
    cfg = reference_run["cfg"]
    trainer, data = _port_trainer(cfg, reference_run["dir"],
                                  tree=_tree(seed=9))
    assert trainer.restore() and trainer.step == 2
    data.step = trainer.step
    assert int(trainer.opt_state.step) == 2
    loss = trainer.run(1)["loss"]
    assert loss == pytest.approx(reference_run["losses"][2], rel=1e-5)


def test_reference_restores_a_port_checkpoint(reference_run, tmp_path):
    """The port's step-2 checkpoint, restored by
    ``repro.train.checkpoint.restore`` with a JAX ``like``, trains step 3
    through the JAX Trainer's compiled step to the port's loss."""
    cfg = reference_run["cfg"]
    trainer, data = _port_trainer(cfg, str(tmp_path), every=2)
    trainer.run(2)
    want = trainer.run(1)["loss"]
    jt = reference_run["trainer"]
    like = {"params": jt.params, "opt_state": jt.opt_state}
    state = jckpt.restore(str(tmp_path), 2, like=like)
    state = jax.tree_util.tree_map(jnp.asarray, state)
    batch = {k: jnp.asarray(v) for k, v in data.batch_at(2).items()}
    _, _, metrics = jt._jit_step(state["params"], state["opt_state"], batch)
    assert float(metrics["loss"]) == pytest.approx(want, rel=1e-5)


def test_trainer_restart_resumes_exactly(tmp_path):
    cfg = configs.smoke_config(ARCH)
    first, data = _port_trainer(cfg, str(tmp_path), every=3)
    first.run(3)                                   # checkpoints at step 3
    after = [first.run(1)["loss"] for _ in range(2)]
    second, data2 = _port_trainer(cfg, str(tmp_path), every=3,
                                  tree=_tree(seed=9))
    assert second.restore() and second.step == 3
    data2.step = second.step
    again = [second.run(1)["loss"] for _ in range(2)]
    assert again == after
    for (n, a), (_, b) in zip(first.params.named_parameters(),
                              second.params.named_parameters()):
        assert torch.equal(a, b), n


def test_sigterm_checkpoints_and_stops(tmp_path):
    cfg = configs.smoke_config(ARCH)
    trainer, _ = _port_trainer(cfg, str(tmp_path), every=1000)
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        trainer.install_signal_handlers()
        trainer.run(2)
        os.kill(os.getpid(), signal.SIGTERM)
        trainer.run(50)
    finally:
        for s, handler in saved.items():
            signal.signal(s, handler)
    assert trainer.step == 3
    assert ckpt.latest_step(str(tmp_path)) == 3
    again, _ = _port_trainer(cfg, str(tmp_path), tree=_tree(seed=7))
    assert again.restore() and again.step == 3


def test_trainer_takes_float32_masters_only():
    cfg = configs.smoke_config(ARCH)
    serving = T.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="masters"):
        TR.Trainer(cfg, TR.TrainConfig(), serving, iter([]), device="cpu")
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    assert T.init_params(bf16, 0, device="cpu",
                         masters=True).embed.dtype == torch.float32


def test_train_module_runs_two_steps_on_the_cpu(tmp_path):
    # two threads run it as fast as eight here, and leave the cores to the
    # other test workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.train", "--device", "cpu",
         "--steps", "2", "--batch", "2", "--seq", "16", "--ckpt-dir",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "final: step=2" in out.stdout
