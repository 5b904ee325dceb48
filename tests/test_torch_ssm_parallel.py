"""Mamba2's SSD mixer split over its SSD heads on the model axis
(``sharding.ssm_heads``, ``Layout``'s "ssm" blocks, ``Plan.select``'s
pieces, ``ModelSplit.total``, a split SSM's ``sharding.HeadCache``), alone
and inside hymba's hybrid, against the unsharded port and the JAX package,
on gloo worlds of 2 and 4 CPU ranks; and the split at full width on a fake
(16, 16) world.

Cases at smoke width (float32), the same numpy tree, batch and prompts
through each, carried across with ``params_from_reference``:

  hymba-1x2    hymba-1.5b's smoke config widened to d_model 80 (10 SSD
               heads of hd 16; 4/2 attention heads) on (data 1, model 2),
               S = 1,024: 5/5 SSD heads, w_out keeping its row shard
  hymba-1x4    the same on (1, 4), S = 2,048, one row (the residual split
               over the sequence; remat "dots"): 3/3/2/2 SSD heads
  hymba-2x2    the same on (2, 2), S = 1,024
  mamba2-1x4   mamba2-370m's smoke config (8 SSD heads) with dp_over_tp
               off on (1, 4), S = 2,048, one row (remat "full"): a pure
               SSM mixer split under the sequence split, 2 heads a rank

Each case holds ``test_torch_attn_parallel.py``'s tolerances: the training
step through ``launch.specs.build_cell``'s step (loss 1e-6 relative, every
gradient leaf 1e-5 relative L2) and serving (the prefill's and one decode
step's logits 1e-5, the greedy tokens of NEW steps equal, every cache
buffer made whole after the prefill and after the decode step 1e-5
relative L2) against the unsharded port; every AdamW update 1e-5 from one
process's AdamW on the step's own gradients gathered whole; the loss and
the logits within 1e-4 of the JAX package's. Each case also asserts every
rank's SSD heads (``ssm_heads``, against the figures written here), the
shapes of its weights as the SSM computes with them and of its caches,
and, through ``sharding.COLLECTIVES``, that neither the prefill nor a
decode step gathers an SSM cache buffer. Each planted "ssm" fault of
``chip_smoke.MESH_FAULTS`` is caught on hymba-1x2: the gated norm's
squares not summed and B/C gradients from one model rank only (the step),
the decode state written into another head's slot (serving). hymba runs
its first two layers (layer 0 global, layer 1 windowed), as
``chip_smoke.py`` phase 24's check does.

The ranks import this module by name, so it imports no JAX at its top
level.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

from repro_torch import configs
from repro_torch.launch.world import run_world
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]

#: tag → (arch, config overrides, mesh (data, model), batch, sequence)
HYMBA = ("hymba-1.5b", {"d_model": 80})
CASES = {
    "hymba-1x2": HYMBA + ((1, 2), 2, 1024),
    "hymba-1x4": ("hymba-1.5b", {"d_model": 80, "remat": "dots"}, (1, 4),
                  1, 2048),
    "hymba-2x2": HYMBA + ((2, 2), 2, 1024),
    "mamba2-1x4": ("mamba2-370m", {"dp_over_tp": False, "remat": "full"},
                   (1, 4), 1, 2048),
}
#: every model rank's (first SSD head, count)
SSM_HEADS = {"hymba-1x2": [(0, 5), (5, 5)],
             "hymba-1x4": [(0, 3), (3, 3), (6, 2), (8, 2)],
             "hymba-2x2": [(0, 5), (5, 5)],
             "mamba2-1x4": [(0, 2), (2, 2), (4, 2), (6, 2)]}
WORLDS = {2: ("hymba-1x2",), 4: ("hymba-1x4", "hymba-2x2", "mamba2-1x4")}
#: the case that runs the planted faults of the step and of decode
FAULTED = "hymba-1x2"
#: the cases whose greedy tokens also come from ``Engine.generate``
ENGINE = ("hymba-1x2", "mamba2-1x4")
NEW = 3
LOSS_TOL, GRAD_TOL, UPDATE_TOL = 1e-6, 1e-5, 1e-5
LOGIT_TOL, CACHE_TOL, REF_TOL = 1e-5, 1e-5, 1e-4


def _first_two(cfg):
    """hymba's smoke config cut to its first two layers (layer 0 global,
    layer 1 windowed), each segment keeping its kind and window."""
    if cfg.name != "hymba-1.5b":
        return cfg
    return dataclasses.replace(cfg, segments=tuple(
        dataclasses.replace(seg, count=1) for seg in cfg.segments[:2]))


def _cfg(tag):
    arch, over = CASES[tag][:2]
    return _first_two(dataclasses.replace(configs.smoke_config(arch),
                                          **over))


def _jcfg(tag):
    from repro.configs import smoke_config as jsmoke
    arch, over = CASES[tag][:2]
    return _first_two(dataclasses.replace(jsmoke(arch), **over))


def _key(tag):
    """Cases with one config, batch and sequence share their inputs and
    their unsharded and reference runs (remat changes no value)."""
    arch, over, _, b, s = CASES[tag]
    width = over.get("d_model")
    return next(t for t, (a, o, _, b2, s2) in CASES.items()
                if (a, o.get("d_model"), b2, s2) == (arch, width, b, s))


@functools.lru_cache(maxsize=None)
def _inputs(tag):
    """The tree (the port's float32 draws in the reference layout), a
    training batch and prompts, from numpy seeds."""
    cfg = _cfg(tag)
    _, _, _, b, s = CASES[tag]
    tree = T.params_to_reference(cfg, T.init_params(cfg, 0, device="cpu",
                                                    masters=True))
    rng = np.random.default_rng(11)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :4] = -1
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


def _chip_smoke():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _faults(serving):
    C = _chip_smoke()
    return [n for n, (kind, _) in C.MESH_FAULTS.items()
            if kind == "ssm" and (n in C.SERVE_PATH_FAULTS) == serving]


def _with_bc(tag, grads):
    """Every gradient leaf (path → array) and, as leaves of their own, an
    SSM's B and C parts of w_in, conv_w and conv_b
    (``chip_smoke.ssm_bc_part``), which are a small share of their
    leaves."""
    C = _chip_smoke()
    out = dict(_leaves(grads))
    for path, g in list(out.items()):
        part = C.ssm_bc_part(_cfg(tag), path[-1])
        if part is not None:
            _, start, count = part
            out[path + ("B and C",)] = g[..., start:start + count]
    return out


def _ssm_prefix(layout):
    """Layer 0's split SSM block (a hybrid's ``mixer.ssm.``, a pure SSM's
    ``mixer.``), or None."""
    return next((p for p, k in layout.split_blocks.items()
                 if k == "ssm" and p.startswith("segments.0.0.")), None)


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _train(tag, mesh, tree, batch):
    """The sharded step from the tree: metrics, gradients and updates
    gathered whole, and this rank's layer-0 SSM weights' shapes as the SSM
    computes with them."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import specs
    from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                             init_opt_state)
    cfg = _cfg(tag)
    _, _, _, b, s = CASES[tag]
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=s,
                                global_batch=b)
    step, _, _ = specs.build_cell(cfg, shape, mesh)
    model = T.shard_params(cfg, T.params_from_reference(
        cfg, tree, device="cpu", masters=True), mesh, batch_size=b)
    layout = T.layout_of(model)
    named = dict(model.named_parameters())
    before = {n: p.full_tensor().detach().clone() for n, p in named.items()}
    _, _, metrics = step(model, init_opt_state(named, OptConfig()), batch)
    # one process's AdamW on the step's own gradients, gathered whole
    own = {n: w.clone() for n, w in before.items()}
    apply_updates(own, {n: S.whole(p.grad) for n, p in named.items()},
                  init_opt_state(own, OptConfig()), OptConfig())
    ssm = _ssm_prefix(layout)
    used = {} if ssm is None else {
        n[len(ssm):]: tuple(layout.use(n, named[n], None).shape)
        for n in named if n.startswith(ssm) and "." not in n[len(ssm):]}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": T.params_to_reference(
                cfg, {n: p.grad for n, p in named.items()}),
            "update": T.params_to_reference(
                cfg, {n: p.full_tensor() - before[n]
                      for n, p in named.items()}),
            "own_update": T.params_to_reference(
                cfg, {n: own[n] - before[n] for n in named}),
            "used": used, "seq": layout.sequence(s) is not None,
            "blocks": sorted(layout.split_blocks.items()),
            "ssm_heads": layout.ssm_heads}


def _whole_caches(caches):
    return {f"{seg}.{n}": S.whole(buf).numpy().copy()
            for seg, bufs in caches.items() for n, buf in bufs.items()}


def _greedy(tag, model, prompts, mesh=None, engine=False, record=None):
    """Greedy serving of ``prompts``: the prefill's and the first decode
    step's logits, every cache buffer made whole after each, then NEW − 2
    more decode steps; the greedy tokens (B, NEW) of the loop, and of
    ``Engine.generate`` with ``engine``. ``record(what, call)``: runs the
    prefill (``what`` "prefill") and the first decode step ("decode")."""
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = _cfg(tag)
    _, _, _, b, s = CASES[tag]
    record = record or (lambda what, call: call())
    caches = T.init_cache(cfg, b, s + NEW, device="cpu", mesh=mesh)
    logits, caches = record("prefill", lambda: T.prefill(
        cfg, model, {"tokens": prompts}, caches))
    steps = [S.whole(logits).numpy()]
    out = {"caches_prefill": _whole_caches(caches)}
    if mesh is not None:
        out["local"] = {f"{seg}.{n}": (type(buf).__name__,
                                       tuple(buf.to_local().shape))
                        for seg, bufs in caches.items()
                        for n, buf in bufs.items()}
    for i in range(NEW - 1):
        tok = steps[-1].argmax(-1)
        if i == 0:
            logits, caches = record("decode", lambda: T.decode_step(
                cfg, model, tok, caches, s))
        else:
            logits, caches = T.decode_step(cfg, model, tok, caches, s + i)
        steps.append(S.whole(logits).numpy())
        if i == 0:
            out["caches_decode"] = _whole_caches(caches)
    out.update(prefill=steps[0], decode=steps[1],
               tokens=np.stack([x.argmax(-1) for x in steps], axis=1))
    if engine:
        out["engine"] = Engine(cfg, model, ServeConfig(
            cache_len=s + NEW, batch_size=b), device="cpu").generate(
                prompts, NEW)
    return out


def _serve(tag, mesh, tree, batch, engine=False):
    """Greedy serving of the sharded model (``_greedy``); for the prefill
    and the first decode step, the collectives by kind
    (``sharding.COLLECTIVES``), the all-gathers that ``Layout.use`` issued
    for the weights, and the output shape of every other all-gather."""
    cfg = _cfg(tag)
    model = T.shard_params(cfg, T.params_from_reference(
        cfg, tree, device="cpu"), mesh)
    seen = {}
    right_gather, right_use = S.all_gather, S.Layout.use
    inside = []

    def gather(t, group, n, dim):
        res = right_gather(t, group, n, dim)
        if not inside:
            seen["other"].append(tuple(res.shape))
        return res

    def use(self, *args, **kwargs):
        inside.append(1)
        before = S.collective_counts()["all-gather"]["count"]
        try:
            return right_use(self, *args, **kwargs)
        finally:
            inside.pop()
            seen["weights"] += S.collective_counts()["all-gather"][
                "count"] - before

    def record(what, call):
        seen.clear()
        seen.update(weights=0, other=[])
        S.reset_collectives()
        S.all_gather, S.Layout.use = gather, use
        try:
            res = call()
        finally:
            S.all_gather, S.Layout.use = right_gather, right_use
        collected[what] = dict(seen, counts=S.collective_counts())
        return res
    collected = {}
    out = _greedy(tag, model, batch["tokens"], mesh, engine, record)
    out["collectives"] = collected
    return out


def _ranks(inputs, tags):
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    C = _chip_smoke()
    out = {}
    for tag in tags:
        mesh = make_mesh(CASES[tag][2], ("data", "model"),
                         device_type="cpu")
        tree, batch = inputs[_key(tag)]
        out[tag] = {"train": _train(tag, mesh, tree, batch),
                    "serve": _serve(tag, mesh, tree, batch, tag in ENGINE)}
        out[tag]["faults"] = {}
        if tag != FAULTED:
            continue
        for name in _faults(False):
            with C.MESH_FAULTS[name][1](mesh):
                out[tag]["faults"][name] = _train(tag, mesh, tree, batch)
        for name in _faults(True):
            with C.MESH_FAULTS[name][1](mesh):
                out[tag]["faults"][name] = _serve(tag, mesh, tree, batch)
    return out


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
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": T.params_to_reference(
               cfg, {n: p.grad for n, p in named.items()}),
           "update": T.params_to_reference(
               cfg, {n: p.detach() - before[n] for n, p in named.items()})}
    serve = T.params_from_reference(cfg, tree, device="cpu")
    out.update(_greedy(tag, serve, batch["tokens"],
                       engine=any(_key(t) == tag for t in ENGINE)))
    return out


def _reference(tag):
    """The JAX package's loss, prefill and first decode logits on the same
    tree and batch."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as JT
    jcfg = _jcfg(tag)
    _, _, _, b, s = CASES[tag]
    tree, batch = _inputs(tag)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, _ = jax.jit(lambda p, x: JT.lm_loss(jcfg, p, x))(tree, jb)
    caches = JT.init_cache(jcfg, b, s + NEW)
    logits, caches = jax.jit(functools.partial(JT.prefill, jcfg))(
        tree, {"tokens": jb["tokens"]}, caches)
    prefill = np.asarray(logits)
    logits, _ = jax.jit(functools.partial(JT.decode_step, jcfg))(
        tree, jnp.asarray(prefill.argmax(-1)), caches, jnp.int32(s))
    return {"loss": float(loss), "prefill": prefill,
            "decode": np.asarray(logits)}


@pytest.fixture(scope="module")
def runs():
    """The worlds of 2 and 4 (every case, one spawn each) beside the
    unsharded port and the JAX package, once a distinct input."""
    keys = sorted({_key(t) for t in CASES})
    inputs = {k: _inputs(k) for k in keys}
    worlds = {}

    def spawn():
        for n, tags in WORLDS.items():
            worlds[n] = run_world(_ranks, n, args=(inputs, tags),
                                  join_timeout_s=600)
    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        port = {k: _unsharded(k) for k in keys}
        ref = {k: _reference(k) for k in keys}
    finally:
        thread.join()
    assert set(worlds) == set(WORLDS), "a world failed (see its output)"
    ranks = {tag: [r[tag] for r in worlds[n]]
             for n, tags in WORLDS.items() for tag in tags}
    return {"ranks": ranks, "port": {t: port[_key(t)] for t in CASES},
            "ref": {t: ref[_key(t)] for t in CASES}}


def _model_ranks(tag, ranks):
    """One rank of each model coordinate (data rank 0's)."""
    _, m = CASES[tag][2]
    return [ranks[i] for i in range(m)]


# --------------------------------------------------------------------------
# the rule, as a pure function
# --------------------------------------------------------------------------

class _Mesh:
    def __init__(self, **sizes):
        self.shape = sizes


#: (arch, config overrides, (data, model)) → every model rank's heads, or
#: None where the SSM runs whole
RULE = {
    ("hymba-1.5b", (), (16, 4)): [(0, 13), (13, 13), (26, 12), (38, 12)],
    ("hymba-1.5b", (), (1, 2)): [(0, 25), (25, 25)],
    ("hymba-1.5b", (), (16, 16)): [(0, 4), (4, 4)] + [
        (8 + 3 * i, 3) for i in range(14)],
    ("hymba-1.5b", (), (4, 1)): None,
    ("mamba2-370m", (), (16, 16)): None,             # dp_over_tp
    ("mamba2-370m", (("dp_over_tp", False),), (16, 16)): [
        (2 * i, 2) for i in range(16)],
    ("mamba2-370m", (("dp_over_tp", False),), (1, 64)): None,   # 32 heads
    ("internlm2-1.8b", (), (1, 4)): None,                        # no SSM
}


@pytest.mark.parametrize("arch,over,mesh", sorted(RULE))
def test_ssm_heads_deal_whole_heads_where_the_rule_splits_w_out(arch, over,
                                                                 mesh):
    """``ssm_heads`` deals every SSD head to one model rank, contiguous,
    the shares differing by at most one, the larger first; None without an
    SSM, under ``dp_over_tp``, on a model axis of 1 or wider than the
    heads."""
    cfg = dataclasses.replace(configs.get_config(arch), **dict(over))
    got = S.ssm_heads(cfg, _Mesh(data=mesh[0], model=mesh[1]))
    want = RULE[(arch, over, mesh)]
    assert (None if got is None else [tuple(h) for h in got]) == want
    if want is not None:
        nh = cfg.ssm.n_heads(cfg.d_model)
        assert [h0 for h0, _ in want] == [sum(n for _, n in want[:i])
                                          for i in range(len(want))]
        assert sum(n for _, n in want) == nh
        assert want == [S.head_ranges(nh, nh, mesh[1], i)[:2]
                        for i in range(mesh[1])]


# --------------------------------------------------------------------------
# the worlds
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tag", sorted(CASES))
def test_each_model_rank_runs_the_ssm_heads_it_is_dealt(runs, tag):
    """Every layer's SSM is an "ssm" block; the layout's heads are the
    figures written here (``ssm_heads``); the SSM computes with its heads'
    pieces: w_in (D, 2·hn·P + 2·N + hn), the conv (K, hn·P + 2·N), out_ln
    (hn·P,), w_out (hn·P, D), a_log, d_skip and dt_bias (hn,)."""
    cfg = _cfg(tag)
    sc, d = cfg.ssm, cfg.d_model
    p, bc = sc.head_dim, 2 * sc.n_groups * sc.d_state
    for i, r in enumerate(_model_ranks(tag, runs["ranks"][tag])):
        tr = r["train"]
        blocks = dict(tr["blocks"])
        assert sum(k == "ssm" for k in blocks.values()) == cfg.n_layers
        if cfg.name == "hymba-1.5b":
            assert sum(k == "gqa" for k in blocks.values()) == cfg.n_layers
        assert [tuple(h) for h in tr["ssm_heads"]] == SSM_HEADS[tag]
        hn = SSM_HEADS[tag][i][1]
        assert tr["used"] == {
            "w_in": (d, 2 * hn * p + bc + hn),
            "conv_w": (sc.conv_kernel, hn * p + bc),
            "conv_b": (hn * p + bc,), "out_ln": (hn * p,),
            "w_out": (hn * p, d), "a_log": (hn,), "d_skip": (hn,),
            "dt_bias": (hn,)}
        assert tr["seq"] == (CASES[tag][4] >= 2048)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_training_step_matches(runs, tag):
    """The loss, the grad norm and every gradient leaf (an SSM's B and C
    parts on their own too) against the unsharded step's; every AdamW
    update against one process's AdamW on the step's own gradients
    gathered whole. (Against the unsharded step's update, an entry whose
    gradient lies below AdamW's eps (1e-8) takes an update that the
    gradients' float32 noise moves: ``ROADMAP.md`` C16.)"""
    port = runs["port"][tag]
    pg = _with_bc(tag, port["grads"])
    for r in runs["ranks"][tag]:
        m = r["train"]["metrics"]
        assert m["loss"] == pytest.approx(port["metrics"]["loss"],
                                          rel=LOSS_TOL)
        assert m["loss"] == pytest.approx(runs["ref"][tag]["loss"],
                                          rel=REF_TOL)
        assert m["grad_norm"] == pytest.approx(port["metrics"]["grad_norm"],
                                               rel=GRAD_TOL)
        got = _with_bc(tag, r["train"]["grads"])
        assert set(got) == set(pg)
        for path in got:
            assert _rel(got[path], pg[path]) < GRAD_TOL, path
        own = dict(_leaves(r["train"]["own_update"]))
        for path, u in _leaves(r["train"]["update"]):
            assert _rel(u, own[path]) < UPDATE_TOL, path


@pytest.mark.parametrize("tag", sorted(CASES))
def test_serving_matches(runs, tag):
    port, ref = runs["port"][tag], runs["ref"][tag]
    for r in runs["ranks"][tag]:
        sv = r["serve"]
        for key in ("prefill", "decode"):
            assert _rel(sv[key], port[key]) < LOGIT_TOL, key
            assert _rel(sv[key], ref[key]) < REF_TOL, key
        np.testing.assert_array_equal(sv["tokens"], port["tokens"])
        if tag in ENGINE:
            np.testing.assert_array_equal(sv["engine"], port["engine"])
            np.testing.assert_array_equal(sv["engine"], port["tokens"])
        for when in ("caches_prefill", "caches_decode"):
            assert set(sv[when]) == set(port[when])
            for name, buf in sv[when].items():
                assert _rel(buf, port[when][name]) < CACHE_TOL, \
                    (when, name)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_split_ssm_cache_holds_the_ranks_heads_and_gathers_nothing(runs,
                                                                     tag):
    """A split SSM's state is a ``HeadCache`` of (L, B_local, hn, N, P)
    and its conv inputs one of (L, B_local, K−1, hn·P + 2·N); by
    ``sharding.COLLECTIVES``, a decode step's all-gathers are the weights'
    (``Layout.use``) alone, and no all-gather of the prefill or of the
    decode step has a layer's whole state or conv shape."""
    cfg = _cfg(tag)
    sc, d = cfg.ssm, cfg.d_model
    (dp, m), b, s = CASES[tag][2:]
    bl = b // dp
    whole = {(bl, sc.n_heads(d), sc.d_state, sc.head_dim),
             (bl, sc.conv_kernel - 1, sc.conv_channels(d))}
    for i, r in enumerate(runs["ranks"][tag]):
        sv = r["serve"]
        hn = SSM_HEADS[tag][i % m][1]
        held = {k: v for k, v in sv["local"].items()
                if k.endswith((".state", ".conv"))}
        assert len(held) == 2 * len(cfg.segments)
        for name, (kind, shape) in held.items():
            assert kind == "HeadCache"
            count = shape[0]
            want = (count, bl, hn, sc.d_state, sc.head_dim) \
                if name.endswith(".state") else \
                (count, bl, sc.conv_kernel - 1,
                 hn * sc.head_dim + 2 * sc.n_groups * sc.d_state)
            assert shape == want, name
        col = sv["collectives"]
        dec = col["decode"]
        assert dec["other"] == []
        assert dec["counts"]["all-gather"]["count"] == dec["weights"]
        for what in ("prefill", "decode"):
            assert not whole & set(col[what]["other"]), what
            assert col[what]["counts"]["all-gather"]["count"] == \
                col[what]["weights"] + len(col[what]["other"])


@pytest.mark.parametrize("fault", _faults(False))
def test_planted_ssm_fault_of_the_step_is_caught(runs, fault):
    """Each planted "ssm" fault of the train step puts a gradient leaf, or
    an SSM's B and C part of one, beyond ``chip_smoke.MESH_GRAD_REL`` from
    the unsharded port's."""
    C = _chip_smoke()
    got = _with_bc(FAULTED,
                   runs["ranks"][FAULTED][0]["faults"][fault]["grads"])
    port = _with_bc(FAULTED, runs["port"][FAULTED]["grads"])
    worst = max(_rel(got[p], port[p]) for p in port)
    assert worst > C.MESH_GRAD_REL, worst


@pytest.mark.parametrize("fault", _faults(True))
def test_planted_ssm_fault_of_decode_is_caught(runs, fault):
    """The planted decode fault (each rank holds five SSD heads and
    writes the new state into the next head's slot) moves a state buffer
    after the decode step beyond the tolerance, while the prefill's logits
    stay right."""
    port = runs["port"][FAULTED]
    got = runs["ranks"][FAULTED][0]["faults"][fault]
    state = [n for n in port["caches_decode"] if n.endswith(".state")]
    worst = max(_rel(got["caches_decode"][n], port["caches_decode"][n])
                for n in state)
    assert worst > CACHE_TOL, worst
    assert _rel(got["prefill"], port["prefill"]) < LOGIT_TOL


# --------------------------------------------------------------------------
# full width on a fake (16, 16) world
# --------------------------------------------------------------------------

FAKE = r"""
import dataclasses, json, torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch import configs
from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = make_mesh((16, 16), ("data", "model"), device_type="cpu")
cfg = configs.get_config("hymba-1.5b")
lay = S.Layout(cfg, mesh, T.empty_params(cfg, device="meta"))
with FakeTensorMode(allow_non_fake_inputs=True):
    caches = T.init_cache(cfg, 32, 4096, device="cpu", mesh=mesh)
out = {"blocks": sorted(lay.split_blocks.values()),
       "heads": lay.ssm_heads,
       "cache": {f"{g}.{n}": [type(b).__name__, list(b.to_local().shape)]
                 for g, bs in caches.items() for n, b in bs.items()}}
# one step at full width, two layers (global, windowed), a row of 4,096
# tokens a data rank: the SSM split, then run whole on every model rank
two = dataclasses.replace(cfg, segments=tuple(
    dataclasses.replace(s, count=1) for s in cfg.segments[:2]))
shape = dataclasses.replace(SHAPES["train_4k"], global_batch=16)
grid = ((16, 16), ("data", "model"))
split = dryrun.run_cell(two, shape, False, None, mesh_shape=grid)
right = S.ssm_heads
S.ssm_heads = lambda cfg, mesh: None
whole = dryrun.run_cell(two, shape, False, None, mesh_shape=grid)
S.ssm_heads = right
out["flops"] = [split["cost"]["flops"], whole["cost"]["flops"]]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake16():
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", FAKE], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_full_width_ssm_splits_on_16_model_ranks(fake16):
    """At (16, 16) hymba's SSM runs split in every layer: its 50 SSD heads
    dealt 4/4/3/…; each rank's state and conv cache of a decode_32k-sized
    batch (32 over 16 data ranks) hold its 4 heads, (L, 2, 4, 16, 64) and
    (L, 2, 3, 4·64 + 32)."""
    cfg = configs.get_config("hymba-1.5b")
    assert fake16["blocks"].count("ssm") == cfg.n_layers
    assert [tuple(h) for h in fake16["heads"]] == RULE[
        ("hymba-1.5b", (), (16, 16))]
    held = {n: v for n, v in fake16["cache"].items()
            if n.endswith((".state", ".conv"))}
    assert len(held) == 2 * len(cfg.segments)
    for name, (kind, shape) in held.items():
        assert kind == "HeadCache"
        want = [2, 4, 16, 64] if name.endswith(".state") else [2, 3, 288]
        assert shape[1:] == want, name


def test_full_width_ssm_split_cuts_the_flops_a_rank(fake16):
    """A step of hymba's first two layers at full width, 4,096 tokens a
    rank: rank 0 runs 4 of the 50 SSD heads, so its flops fall by most of
    the SSM's share (the whole SSM is ~33 M flops a token a layer
    forward, the split attention, MLP and head's share a few M)."""
    split, whole = fake16["flops"]
    assert 0 < split < 0.7 * whole, (split, whole)
