"""Megatron's sequence and vocab parallelism in the port's training step on
a mesh (``models.sharding``: ``ModelSplit`` with ``seq``,
``vocab_embedding``, ``VocabSplit``), against the unsharded port and the
JAX package, on the CPU.

One gloo world of 4 ranks on a (data 2, model 2) mesh runs the sharded
step (``launch.specs.build_cell``'s) of each config at smoke width
(float32), with the same numpy tree and batch as the unsharded port and
the JAX package:

  - ``internlm2``: S = 2,048 with remat "dots": the residual split over
    the sequence, attention and MLP split over the model axis;
  - ``deepseek-moe``: S = 2,048 with remat "full": the MoE enters and
    leaves through the sequence split, its experts split over the model
    axis (its router and aux loss see the whole sequence);
  - ``kv3``: internlm2 with 6 heads and 3 KV heads at S = 2,048: the
    model axis divides neither the 3 KV heads nor the rule's shard of wk
    (1.5 heads), so each model rank runs the heads
    ``sharding.head_ranges`` deals it (4/2 query heads, 2/1 KV heads),
    entering and leaving through the sequence split, the MLP split;
  - ``mamba2``: S = 2,048 under ``dp_over_tp``: no split;
  - ``internlm2-1024``: S = 1,024, below the split's threshold;
  - ``internlm2-2049``: S = 2,049, which the model axis does not divide.

Every config with tokens runs the vocab-parallel embedding and loss (the
smoke vocab of 256 divides the model axis). Tolerances are
``test_torch_train_mesh.py``'s: the loss 1e-6 relative and every gradient
leaf 1e-5 relative L2 against the unsharded port, 1e-4 against the JAX
package; each leaf's AdamW update 1e-3. The embedding gives the bits of
the whole table's lookup, in float32 and bfloat16, and each checkpointed
layer keeps (B/dp, S/m, D) of the carry when the residual is split,
(B/dp, S, D) otherwise.

A world of 2 ranks on a model axis of 2 holds the pieces alone: the
sequence's entry and exit (and a whole block's) forward and backward
against the gathered reference, and the vocab-parallel cross-entropy's
value and gradients against ``transformer._chunk_nll`` on the whole head
(labels < 0 masked, labels in every rank's range).

The ranks import this module by name, so it imports no JAX at its top
level.
"""
import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

from repro_torch import configs
from repro_torch.launch.world import run_world
from repro_torch.models import transformer as T

#: tag → (arch, config overrides, global batch, sequence)
CASES = {
    "internlm2": ("internlm2-1.8b", {"remat": "dots"}, 2, 2048),
    "deepseek-moe": ("deepseek-moe-16b", {"remat": "full"}, 2, 2048),
    "kv3": ("internlm2-1.8b", {"n_heads": 6, "n_kv_heads": 3,
                               "remat": "full"}, 2, 2048),
    "mamba2": ("mamba2-370m", {"remat": "full"}, 4, 2048),
    "internlm2-1024": ("internlm2-1.8b", {"remat": "full"}, 2, 1024),
    # one attention chunk and one loss chunk a row: the JAX package's
    # chunked attention needs S to divide by its chunk, and 2,049 = 3 · 683
    # has no divisor between 3 and 683, so the smoke loss chunk (256) would
    # take chunks of 3 tokens (of 6 unsharded), whose 683 float32 partial
    # sums alone part the two runs' losses by 1.1e-6
    "internlm2-2049": ("internlm2-1.8b", {"remat": "dots",
                                          "attn_chunk": 2049,
                                          "loss_chunk": 2049}, 2, 2049),
}
#: the cases whose residual is split over the sequence
SPLIT = ("internlm2", "deepseek-moe", "kv3")
LOSS_TOL, GRAD_TOL = 1e-6, 1e-5
REF_TOL, UPDATE_TOL = 1e-4, 1e-3


def _cfg(tag):
    arch, over, _, _ = CASES[tag]
    return dataclasses.replace(configs.smoke_config(arch), **over)


@functools.lru_cache(maxsize=None)
def _inputs(tag):
    """The tree (the port's draws in the reference layout) and a batch,
    from numpy seeds."""
    cfg = _cfg(tag)
    _, _, b, s = CASES[tag]
    tree = T.params_to_reference(cfg, T.init_params(cfg, 0, device="cpu",
                                                    masters=True))
    rng = np.random.default_rng(2)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :5] = -1
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return tree, {"tokens": tokens, "labels": labels}


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
# the world of 4: the sharded step of every case
# --------------------------------------------------------------------------

def _embedding(model, layout, tokens, seq):
    """The vocab-parallel embedding of this rank's batch rows made whole
    over the sequence, beside the whole table's lookup, in float32 and
    bfloat16."""
    import torch.nn.functional as F

    from repro_torch.models import sharding as S
    out = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            part = layout.use("embed", model.embed, dtype)
            x = S.vocab_embedding(tokens, part, seq or layout.split)
            if seq is not None:
                x = seq.gather(x)
            whole = S.whole(model.embed).to(dtype)
            out[str(dtype)] = (x.float().numpy(),
                               F.embedding(tokens, whole).float().numpy())
    return out


def _case(tag, tree, batch):
    """One case on this rank: the sharded step's metrics, gradients and
    updates gathered whole, the carry each checkpointed layer kept, the
    embedding's bits."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    cfg = _cfg(tag)
    _, _, b, s = CASES[tag]
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=s,
                                global_batch=b)
    step, _, _ = specs.build_cell(cfg, shape, mesh)
    cfg = specs.effective_config(cfg, shape, mesh)
    model = T.shard_params(cfg, T.params_from_reference(
        cfg, tree, device="cpu", masters=True), mesh, batch_size=b)
    layout = T.layout_of(model)
    named = dict(model.named_parameters())
    before = {n: p.full_tensor().detach().clone() for n, p in named.items()}
    carries = []
    checkpoint = T.ckpt.checkpoint

    def recording(fn, *args, **kwargs):
        if fn.__name__ == "run":                  # a layer, not a loss chunk
            carries.append(tuple(args[0].shape))
        return checkpoint(fn, *args, **kwargs)

    T.ckpt.checkpoint = recording
    try:
        _, _, metrics = step(model, init_opt_state(named, OptConfig()), batch)
    finally:
        T.ckpt.checkpoint = checkpoint
    rows = T._local_batch(layout, batch, layout.batch_axes)["tokens"]
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "carries": carries, "rows": int(rows.shape[0]),
           "model": layout.sizes[layout.model_dim],
           "split": layout.sequence(s) is not None,
           "vocab_parallel": sorted(layout.vocab_parallel),
           "grads": T.params_to_reference(
               cfg, {n: p.grad for n, p in named.items()}),
           "update": T.params_to_reference(
               cfg, {n: p.full_tensor() - before[n]
                     for n, p in named.items()})}
    if "embed" in layout.vocab_parallel:
        out["embedding"] = _embedding(model, layout, rows.long(),
                                      layout.sequence(s))
    return out


def _ranks(inputs):
    torch.set_num_threads(1)
    return {tag: _case(tag, *inputs[tag]) for tag in CASES}


# --------------------------------------------------------------------------
# the parent: the unsharded port and the JAX package
# --------------------------------------------------------------------------

def _unsharded(tag):
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import TrainConfig, make_train_step
    cfg = _cfg(tag)
    tree, batch = _inputs(tag)
    model = T.params_from_reference(cfg, tree, device="cpu", masters=True)
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    tcfg = TrainConfig()
    _, _, metrics = make_train_step(cfg, tcfg)(
        model, init_opt_state(named, tcfg.opt), batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": T.params_to_reference(
                cfg, {n: p.grad for n, p in named.items()}),
            "update": T.params_to_reference(
                cfg, {n: p.detach() - before[n] for n, p in named.items()})}


def _reference(tag):
    """The JAX package's loss, gradients and AdamW update on the same tree
    and batch."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as jsmoke
    from repro.models import transformer as JT
    from repro.train import optimizer as JO
    arch, over, _, _ = CASES[tag]
    jcfg = dataclasses.replace(jsmoke(arch), **over)
    tree, batch = _inputs(tag)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(jcfg, p, b), has_aux=True))(tree, jb)
    ocfg = JO.OptConfig()
    new, _, _ = jax.jit(JO.apply_updates, static_argnums=3)(
        tree, grads, JO.init_opt_state(tree, ocfg), ocfg)
    return {"loss": float(loss),
            "grads": jax.tree_util.tree_map(np.asarray, grads),
            "update": jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b,
                                             new, tree)}


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
def test_sequence_split_where_the_reference_splits(runs, tag):
    """The residual is split over the sequence exactly in the cases that
    meet the reference's rule; the vocab-parallel tables where the model
    axis splits the vocab (every case but pure-DP mamba2)."""
    for r in runs["ranks"]:
        assert r[tag]["split"] == (tag in SPLIT)
        want = [] if tag == "mamba2" else ["embed", "head"]
        assert r[tag]["vocab_parallel"] == want


@pytest.mark.parametrize("tag", sorted(CASES))
def test_loss_matches(runs, tag):
    port, ref = runs["port"][tag]["metrics"], runs["ref"][tag]["loss"]
    for r in runs["ranks"]:
        m = r[tag]["metrics"]
        assert m["loss"] == pytest.approx(port["loss"], rel=LOSS_TOL)
        assert m["ce"] == pytest.approx(port["ce"], rel=LOSS_TOL)
        assert m["aux"] == pytest.approx(port["aux"], rel=LOSS_TOL, abs=1e-9)
        assert m["tokens"] == port["tokens"]
        assert m["grad_norm"] == pytest.approx(port["grad_norm"],
                                               rel=GRAD_TOL)
        assert m["loss"] == pytest.approx(ref, rel=REF_TOL)
    if tag == "deepseek-moe":
        assert runs["ranks"][0][tag]["metrics"]["aux"] > 0


@pytest.mark.parametrize("tag", sorted(CASES))
def test_gradients_match_every_leaf(runs, tag):
    got = dict(_leaves(runs["ranks"][0][tag]["grads"]))
    port = dict(_leaves(runs["port"][tag]["grads"]))
    ref = dict(_leaves(runs["ref"][tag]["grads"]))
    assert set(got) == set(port) == set(ref)
    for path in got:
        assert _rel(got[path], port[path]) < GRAD_TOL, path
        assert _rel(got[path], ref[path]) < REF_TOL, path
    for other in runs["ranks"][1:]:          # the same gathered gradients
        for path, g in _leaves(other[tag]["grads"]):
            np.testing.assert_array_equal(g, got[path])


@pytest.mark.parametrize("tag", sorted(CASES))
def test_adamw_update_matches_every_leaf(runs, tag):
    got = dict(_leaves(runs["ranks"][0][tag]["update"]))
    port = dict(_leaves(runs["port"][tag]["update"]))
    ref = dict(_leaves(runs["ref"][tag]["update"]))
    for path in got:
        assert _rel(got[path], port[path]) < UPDATE_TOL, path
        assert _rel(got[path], ref[path]) < UPDATE_TOL, path


@pytest.mark.parametrize("tag", sorted(t for t in CASES if t != "mamba2"))
def test_vocab_parallel_embedding_is_the_whole_lookup(runs, tag):
    for r in runs["ranks"]:
        for dtype, (got, want) in r[tag]["embedding"].items():
            np.testing.assert_array_equal(got, want, err_msg=dtype)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_saved_carry_is_this_ranks_part(runs, tag):
    """Each checkpointed layer keeps (B/dp, S/m, D) of the carry when the
    residual is split over the sequence, (B/dp, S, D) otherwise."""
    cfg = _cfg(tag)
    _, _, _, s = CASES[tag]
    for r in runs["ranks"]:
        got = r[tag]
        m = got["model"] if tag in SPLIT else 1
        assert got["carries"] == [(got["rows"], s // m, cfg.d_model)] \
            * cfg.n_layers


# --------------------------------------------------------------------------
# the world of 2: the pieces alone, on a model axis of 2
# --------------------------------------------------------------------------

B2, S2, D2, C2, V2 = 2, 8, 6, 12, 10


def _draws():
    rng = np.random.default_rng(3)
    f = functools.partial(rng.standard_normal, dtype=np.float32)
    labels = rng.integers(0, V2, C2)
    labels[:2] = (-1, -7)                     # masked
    labels[2:4] = (0, V2 - 1)                 # the two ranks' ranges
    return {"x": f((B2, S2, D2)), "partial": f((2, B2, S2, D2)),
            "g": f((2, B2, S2, D2)), "g_part": f((2, B2, S2 // 2, D2)),
            "hc": f((C2, D2)), "head": f((D2, V2)), "labels": labels}


def _pieces(d):
    """This rank's results of every piece (forward outputs, gradients)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding as S
    torch.set_num_threads(1)
    mesh = make_mesh((2,), ("model",), device_type="cpu")
    r = dist.get_rank()
    seq = S.ModelSplit(mesh.get_group(0), 2, r, seq=True)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    half = slice(r * S2 // 2, (r + 1) * S2 // 2)
    out = {}
    # a split block's entry and exit
    x = t["x"][:, half].clone().requires_grad_()
    y = seq.enter(x)
    y.backward(t["g"][r])
    out["enter"], out["enter_grad"] = y.detach(), x.grad
    p = t["partial"][r].clone().requires_grad_()
    y = seq.exit(p)
    y.backward(t["g_part"][r])
    out["exit"], out["exit_grad"] = y.detach(), p.grad
    # a whole block's: the same gathered x, the same gradient everywhere
    x = t["x"][:, half].clone().requires_grad_()
    y = seq.whole(x)
    y.backward(t["g"][0])
    out["whole"], out["whole_grad"] = y.detach(), x.grad
    p = t["partial"][0].clone().requires_grad_()
    y = seq.own(p)
    y.backward(t["g_part"][r])
    out["own"], out["own_grad"] = y.detach(), p.grad
    # the vocab-parallel cross-entropy on this rank's head columns
    vocab = S.VocabSplit(mesh.get_group(0), 2, r)
    hc = t["hc"].clone().requires_grad_()
    head = t["head"][:, r * V2 // 2:(r + 1) * V2 // 2].clone() \
        .requires_grad_()
    nll = vocab.nll(hc, t["labels"], head)
    nll.backward()
    out["nll"], out["nll_hc"], out["nll_head"] = nll.detach(), hc.grad, \
        head.grad
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def pieces():
    d = _draws()
    return d, run_world(_pieces, 2, args=(d,), join_timeout_s=240)


def test_sequence_entry_and_exit_against_the_gathered_reference(pieces):
    d, ranks = pieces
    x, g, p, gp = d["x"], d["g"], d["partial"], d["g_part"]
    half = S2 // 2
    for r, got in enumerate(ranks):
        part = slice(r * half, (r + 1) * half)
        # entry: the whole sequence; its gradient the ranks' sum, cut
        np.testing.assert_array_equal(got["enter"], x)
        np.testing.assert_allclose(got["enter_grad"], g.sum(0)[:, part],
                                   rtol=1e-6, atol=1e-6)
        # exit: the ranks' sum, cut; its gradient the parts gathered
        np.testing.assert_allclose(got["exit"], p.sum(0)[:, part],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["exit_grad"],
                                      np.concatenate(list(gp), axis=1))


def test_whole_block_boundary_against_the_gathered_reference(pieces):
    d, ranks = pieces
    half = S2 // 2
    for r, got in enumerate(ranks):
        part = slice(r * half, (r + 1) * half)
        np.testing.assert_array_equal(got["whole"], d["x"])
        np.testing.assert_array_equal(got["whole_grad"], d["g"][0][:, part])
        np.testing.assert_array_equal(got["own"], d["partial"][0][:, part])
        np.testing.assert_array_equal(got["own_grad"],
                                      np.concatenate(list(d["g_part"]), 1))


def test_vocab_parallel_cross_entropy_against_the_whole_head(pieces):
    """The value on every rank, the gradient into the hidden states summed
    over the ranks and each rank's head columns' gradient, against
    ``_chunk_nll`` on the whole head and autograd."""
    d, ranks = pieces
    hc = torch.from_numpy(d["hc"]).requires_grad_()
    head = torch.from_numpy(d["head"]).requires_grad_()
    labels = torch.from_numpy(d["labels"])
    want = T._chunk_nll(hc, labels, head)
    want.backward()
    assert d["labels"].min() < 0
    assert {int(l) * 2 // V2 for l in d["labels"] if l >= 0} == {0, 1}
    for r, got in enumerate(ranks):
        assert float(got["nll"]) == pytest.approx(want.item(), rel=1e-6)
        cols = slice(r * V2 // 2, (r + 1) * V2 // 2)
        np.testing.assert_allclose(got["nll_head"], head.grad[:, cols],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sum(g["nll_hc"] for g in ranks), hc.grad,
                               rtol=1e-5, atol=1e-6)
