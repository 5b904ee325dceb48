"""GQA attention split over the model axis where the axis does not divide
its heads or KV heads (``sharding.head_ranges``, ``sharding.gqa_heads``,
``Layout``'s "gqa" blocks, ``sharding.HeadCache``), against the unsharded
port and the JAX package, on gloo worlds of 2 and 4 CPU ranks; and the
split at full width on a fake (16, 16) world.

Cases at smoke width (float32), the same numpy tree, batch and prompts
through each, carried across with ``params_from_reference``:

  hymba-1x2   hymba-1.5b's published 25/5 heads at hd 16 on (data 1,
              model 2), S = 1,024: 15/10 query heads, 3/2 KV heads
  hymba-1x4   the same on (1, 4), S = 2,048, one row (the residual split
              over the sequence; remat "dots"): 10/5/5/5 query heads,
              2/1/1/1 KV heads
  hymba-2x2   the same on (2, 2), S = 1,024
  gqa8-1x4    internlm2 with 8/2 heads on (1, 4), S = 1,024 (remat
              "full"): 2 query heads a rank, each KV head shared by two
  gqa10-1x4   internlm2 with 10/2 heads on (1, 4), S = 1,024: 3/2/3/2
              query heads, the query heads uneven within a group
  whole-1x4   internlm2 with 2/1 heads on (1, 4), S = 1,024: the model
              axis is wider than the heads, so the attention runs whole

Each case holds ``test_torch_train_mesh.py``'s and
``test_torch_serve_mesh.py``'s tolerances: the training step through
``launch.specs.build_cell``'s step (loss 1e-6 relative, every gradient
leaf 1e-5 relative L2, every AdamW update 1e-3) and serving (the prefill's
and one decode step's logits 1e-5, the greedy tokens of NEW steps
equal, every cache buffer after the prefill and after the decode step 1e-5
relative L2) against the unsharded port; the loss and the logits within
1e-4 of the JAX package's. Each case also asserts every rank's head ranges
(``head_ranges``, against the figures written here), the local shapes of
its weights and caches, and that a decode step issues no collective on a
split layer's K/V (no all-gather has the cache's length). Each planted
"attn" fault of ``chip_smoke.MESH_FAULTS`` is caught: the two of the
train step on gqa8-1x4, the decode step's on hymba-1x2.
hymba runs its first two layers (layer 0 global, layer 1 windowed), as
``chip_smoke.py`` phase 24's check does; the greedy tokens of hymba-1x2
and gqa8-1x4 also come through ``Engine.generate``.

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
HYMBA = ("hymba-1.5b", {"n_heads": 25, "n_kv_heads": 5})
CASES = {
    "hymba-1x2": HYMBA + ((1, 2), 2, 1024),
    "hymba-1x4": ("hymba-1.5b", {"n_heads": 25, "n_kv_heads": 5,
                                 "remat": "dots"}, (1, 4), 1, 2048),
    "hymba-2x2": HYMBA + ((2, 2), 2, 1024),
    "gqa8-1x4": ("internlm2-1.8b", {"n_heads": 8, "n_kv_heads": 2,
                                    "remat": "full"}, (1, 4), 2, 1024),
    "gqa10-1x4": ("internlm2-1.8b", {"n_heads": 10, "n_kv_heads": 2},
                  (1, 4), 2, 1024),
    "whole-1x4": ("internlm2-1.8b", {"n_heads": 2, "n_kv_heads": 1},
                  (1, 4), 2, 1024),
}
#: every model rank's (first query head, count, first KV head, count)
HEADS = {
    "hymba-1x2": [(0, 15, 0, 3), (15, 10, 3, 2)],
    "hymba-1x4": [(0, 10, 0, 2), (10, 5, 2, 1), (15, 5, 3, 1),
                  (20, 5, 4, 1)],
    "hymba-2x2": [(0, 15, 0, 3), (15, 10, 3, 2)],
    "gqa8-1x4": [(0, 2, 0, 1), (2, 2, 0, 1), (4, 2, 1, 1), (6, 2, 1, 1)],
    "gqa10-1x4": [(0, 3, 0, 1), (3, 2, 0, 1), (5, 3, 1, 1), (8, 2, 1, 1)],
    "whole-1x4": None,
}
WORLDS = {2: ("hymba-1x2",),
          4: ("hymba-1x4", "hymba-2x2", "gqa8-1x4", "gqa10-1x4",
              "whole-1x4")}
#: the case that runs the two planted faults of the train step, and the
#: one that runs the decode fault (which needs a rank holding two or more
#: KV heads)
FAULTED = ("gqa8-1x4",)
SERVE_FAULTED = ("hymba-1x2",)
#: the cases whose greedy tokens also come from ``Engine.generate``
ENGINE = ("hymba-1x2", "gqa8-1x4")
NEW = 3
LOSS_TOL, GRAD_TOL, UPDATE_TOL = 1e-6, 1e-5, 1e-3
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
    heads = (over["n_heads"], over["n_kv_heads"])
    return next(t for t, (a, o, _, b2, s2) in CASES.items()
                if (a, (o["n_heads"], o["n_kv_heads"]), b2, s2)
                == (arch, heads, b, s))


@functools.lru_cache(maxsize=None)
def _inputs(tag):
    """The tree (the port's float32 draws in the reference layout), a
    training batch and prompts, from numpy seeds."""
    cfg = _cfg(tag)
    _, _, _, b, s = CASES[tag]
    tree = T.params_to_reference(cfg, T.init_params(cfg, 0, device="cpu",
                                                    masters=True))
    rng = np.random.default_rng(7)
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
            if kind == "attn" and (n in C.SERVE_PATH_FAULTS) == serving]


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _train(tag, mesh, tree, batch):
    """The sharded step from the tree: metrics, gradients and updates
    gathered whole, and this rank's local weight shapes as the attention
    computes with them."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import specs
    from repro_torch.train.optimizer import OptConfig, init_opt_state
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
    attn = next(n[:-len("wq")] for n in named if n.endswith(".wq"))
    used = {n[len(attn):]: tuple(layout.use(n, named[n], None).shape)
            for n in named if n.startswith(attn)}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": T.params_to_reference(
                cfg, {n: p.grad for n, p in named.items()}),
            "update": T.params_to_reference(
                cfg, {n: p.full_tensor() - before[n]
                      for n, p in named.items()}),
            "used": used, "seq": layout.sequence(s) is not None,
            "kinds": sorted(set(layout.split_blocks.values())),
            "heads": layout.heads, "all_heads": layout.gqa_heads}


def _whole_caches(caches):
    return {f"{seg}.{n}": S.whole(buf).numpy().copy()
            for seg, bufs in caches.items() for n, buf in bufs.items()}


def _greedy(tag, model, prompts, mesh=None, engine=False, record=None):
    """Greedy serving of ``prompts``: the prefill's and the first decode
    step's logits, every cache buffer made whole after each, then NEW − 2
    more decode steps; the greedy tokens (B, NEW) of the loop, and of
    ``Engine.generate`` with ``engine``. ``record``: a function wrapped
    around the first decode step."""
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = _cfg(tag)
    _, _, _, b, s = CASES[tag]
    caches = T.init_cache(cfg, b, s + NEW, device="cpu", mesh=mesh)
    logits, caches = T.prefill(cfg, model, {"tokens": prompts}, caches)
    steps = [S.whole(logits).numpy()]
    out = {"caches_prefill": _whole_caches(caches)}
    if mesh is not None:
        out["local"] = {f"{seg}.{n}": (type(buf).__name__,
                                       tuple(buf.to_local().shape))
                        for seg, bufs in caches.items()
                        for n, buf in bufs.items()}
    for i in range(NEW - 1):
        tok = steps[-1].argmax(-1)
        if i == 0 and record is not None:
            logits, caches = record(lambda: T.decode_step(
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
    """Greedy serving of the sharded model (``_greedy``), with every
    all-gather's output shape in the first decode step."""
    cfg = _cfg(tag)
    model = T.shard_params(cfg, T.params_from_reference(
        cfg, tree, device="cpu"), mesh)
    gathers, right = [], S.all_gather

    def recording(t, group, n, dim):
        res = right(t, group, n, dim)
        gathers.append(tuple(res.shape))
        return res

    def record(step):
        S.all_gather = recording
        try:
            return step()
        finally:
            S.all_gather = right
    out = _greedy(tag, model, batch["tokens"], mesh, engine, record)
    out["decode_gathers"] = gathers
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
        for name in _faults(False) if tag in FAULTED else ():
            with C.MESH_FAULTS[name][1](mesh):
                out[tag]["faults"][name] = _train(tag, mesh, tree,
                                                  batch)["grads"]
        for name in _faults(True) if tag in SERVE_FAULTED else ():
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
    d, m = CASES[tag][2]
    return [ranks[i] for i in range(m)]


# --------------------------------------------------------------------------
# the head rule, as a pure function
# --------------------------------------------------------------------------

@pytest.mark.parametrize("h,g,m", [(25, 5, 1), (25, 5, 2), (25, 5, 4),
                                   (25, 5, 5), (25, 5, 16), (25, 5, 25),
                                   (64, 8, 16), (40, 8, 16), (32, 8, 16),
                                   (6, 3, 2), (10, 2, 4), (12, 3, 8)])
def test_head_ranges_deal_whole_heads(h, g, m):
    """Every query head is run by exactly one rank; each rank's query
    heads lie in its whole KV heads, a whole number on each (its local H
    a multiple of its local Hkv); the shares differ by at most one group
    (m ≤ g) or one query head within a group (m > g)."""
    got = [S.head_ranges(h, g, m, i) for i in range(m)]
    r = h // g
    q_next = 0
    for q0, qn, k0, kn in got:
        assert q0 == q_next and qn >= 1 and kn >= 1
        q_next += qn
        assert qn % kn == 0
        assert k0 * r <= q0 and q0 + qn <= (k0 + kn) * r
        if kn > 1:
            assert (q0, qn) == (k0 * r, kn * r)
    assert q_next == h
    if m <= g:
        assert max(k for *_, k in got) - min(k for *_, k in got) <= 1
        assert sum(k for *_, k in got) == g
    else:
        for k in range(g):
            qs = [qn for _, qn, k0, _ in got if k0 == k]
            assert sum(qs) == r and max(qs) - min(qs) <= 1


def test_head_ranges_refuse_an_axis_wider_than_the_heads():
    with pytest.raises(ValueError):
        S.head_ranges(2, 1, 4, 0)


# --------------------------------------------------------------------------
# the worlds
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tag", sorted(CASES))
def test_each_model_rank_runs_the_heads_it_is_dealt(runs, tag):
    """The layout's head ranges (``head_ranges``) and the attention's
    weights as it computes with them: wq and wo on the rank's query heads,
    wk and wv on its KV heads; a whole attention all heads."""
    cfg = _cfg(tag)
    hd, d = cfg.head_dim, cfg.d_model
    _, m = CASES[tag][2]
    for i, r in enumerate(_model_ranks(tag, runs["ranks"][tag])):
        tr = r["train"]
        want = HEADS[tag]
        if want is None:
            assert tr["all_heads"] is None and "gqa" not in tr["kinds"]
            qn, kn = cfg.n_heads, cfg.n_kv_heads
        else:
            assert "gqa" in tr["kinds"]
            assert [tuple(x) for x in tr["all_heads"]] == want
            assert tuple(tr["heads"]) == want[i] == \
                S.head_ranges(cfg.n_heads, cfg.n_kv_heads, m, i)
            _, qn, _, kn = want[i]
        assert tr["used"]["wq"] == (d, qn * hd)
        assert tr["used"]["wk"] == tr["used"]["wv"] == (d, kn * hd)
        assert tr["used"]["wo"] == (qn * hd, d)
        assert tr["seq"] == (CASES[tag][4] >= 2048)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_training_step_matches(runs, tag):
    port = runs["port"][tag]
    pg = dict(_leaves(port["grads"]))
    pu = dict(_leaves(port["update"]))
    for r in runs["ranks"][tag]:
        m = r["train"]["metrics"]
        assert m["loss"] == pytest.approx(port["metrics"]["loss"],
                                          rel=LOSS_TOL)
        assert m["loss"] == pytest.approx(runs["ref"][tag]["loss"],
                                          rel=REF_TOL)
        assert m["grad_norm"] == pytest.approx(port["metrics"]["grad_norm"],
                                               rel=GRAD_TOL)
        got = dict(_leaves(r["train"]["grads"]))
        assert set(got) == set(pg)
        for path in got:
            assert _rel(got[path], pg[path]) < GRAD_TOL, path
        for path, u in _leaves(r["train"]["update"]):
            assert _rel(u, pu[path]) < UPDATE_TOL, path


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
def test_split_kv_cache_holds_the_ranks_heads_and_gathers_nothing(runs, tag):
    """A split GQA's K/V is a ``HeadCache`` of (L, B_local, T, kvn·hd), a
    whole attention's a DTensor split as ``cache_specs`` says; a decode
    step all-gathers no buffer of the cache's length (a split GQA's K/V
    stays where it is; the whole attention's channel shards are gathered
    for its layer)."""
    cfg = _cfg(tag)
    (dp, m), b, s = CASES[tag][2:]
    t = s + NEW
    for i, r in enumerate(runs["ranks"][tag]):
        sv = r["serve"]
        kv = [k for k in sv["local"] if k.endswith((".k", ".v"))]
        assert kv
        gathered = [g for g in sv["decode_gathers"] if t in g]
        if HEADS[tag] is None:
            for k in kv:
                assert sv["local"][k][0] == "DTensor"
            assert gathered
            continue
        _, _, _, kn = HEADS[tag][i % m]
        for k in kv:
            kind, shape = sv["local"][k]
            assert kind == "HeadCache"
            assert shape[1:] == (b // dp, t, kn * cfg.head_dim)
        assert not gathered, gathered


@pytest.mark.parametrize("fault", _faults(False))
@pytest.mark.parametrize("tag", FAULTED)
def test_planted_attn_fault_of_the_step_is_caught(runs, tag, fault):
    """Each planted "attn" fault of the train step puts a gradient leaf
    beyond ``chip_smoke.MESH_GRAD_REL`` from the unsharded port's."""
    C = _chip_smoke()
    got = dict(_leaves(runs["ranks"][tag][0]["faults"][fault]))
    port = dict(_leaves(runs["port"][tag]["grads"]))
    worst = max(_rel(got[p], port[p]) for p in port)
    assert worst > C.MESH_GRAD_REL, worst


@pytest.mark.parametrize("fault", _faults(True))
@pytest.mark.parametrize("tag", SERVE_FAULTED)
def test_planted_attn_fault_of_decode_is_caught(runs, tag, fault):
    """The planted decode fault (each rank holds two or more KV heads and
    writes the new rows into another's slot) moves a K/V cache buffer
    after the decode step beyond the tolerance, while the prefill's
    logits stay right."""
    port = runs["port"][tag]
    got = runs["ranks"][tag][0]["faults"][fault]
    kv = [n for n in port["caches_decode"] if n.endswith((".k", ".v"))]
    worst = max(_rel(got["caches_decode"][n], port["caches_decode"][n])
                for n in kv)
    assert worst > CACHE_TOL, worst
    assert _rel(got["prefill"], port["prefill"]) < LOGIT_TOL


# --------------------------------------------------------------------------
# full width on a fake (16, 16) world
# --------------------------------------------------------------------------

FAKE = r"""
import json, torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch import configs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = make_mesh((16, 16), ("data", "model"), device_type="cpu")
out = {}
for arch in ("qwen3-32b", "stablelm-12b", "qwen2.5-32b", "hymba-1.5b"):
    cfg = configs.get_config(arch)
    lay = S.Layout(cfg, mesh, T.empty_params(cfg, device="meta"))
    with FakeTensorMode(allow_non_fake_inputs=True):
        caches = T.init_cache(cfg, 32, 4096, device="cpu", mesh=mesh)
    out[arch] = {"kinds": sorted(set(lay.split_blocks.values())),
                 "heads": lay.gqa_heads,
                 "cache": {f"{g}.{n}": [type(b).__name__,
                                        list(b.to_local().shape)]
                           for g, bs in caches.items()
                           for n, b in bs.items()}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake16():
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", FAKE], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


#: arch → rank 0's heads and (query heads, KV heads) of the largest share
FULL = {"qwen3-32b": ((0, 4, 0, 1), 4),
        "stablelm-12b": ((0, 2, 0, 1), 2),
        "qwen2.5-32b": ((0, 3, 0, 1), 3),
        "hymba-1.5b": ((0, 2, 0, 1), 2)}


@pytest.mark.parametrize("arch", sorted(FULL))
def test_full_width_attention_splits_on_16_model_ranks(fake16, arch):
    """At (16, 16) each of the four attentions runs split: rank 0's heads,
    the largest share, every rank one KV head; each rank's K/V cache of a
    decode_32k-sized batch (32 over 16 data ranks) holds its one KV head,
    (L, 2, 4,096, hd)."""
    cfg = configs.get_config(arch)
    got = fake16[arch]
    assert "gqa" in got["kinds"]
    heads = [tuple(h) for h in got["heads"]]
    first, most = FULL[arch]
    assert heads[0] == first
    assert heads == [S.head_ranges(cfg.n_heads, cfg.n_kv_heads, 16, i)
                     for i in range(16)]
    assert max(qn for _, qn, _, _ in heads) == most
    assert {kn for *_, kn in heads} == {1}
    for name, (kind, shape) in got["cache"].items():
        if name.endswith((".k", ".v")):
            assert kind == "HeadCache"
            assert shape[1:] == [2, 4096, cfg.head_dim]
