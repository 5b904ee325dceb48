"""Expert parallelism: the MoE's routed experts split over the model axis
(``sharding.Layout``'s "moe" blocks, ``layers.MoE`` with ``tp``), against
the unsharded port and the JAX package, on one gloo world of 4 CPU ranks.

Cases at smoke size (float32, remat "full", 8 routed experts, top 2):

  moe        deepseek-moe-16b on (data 2, model 2): 4 experts a model rank
  v2-lite    deepseek-v2-lite-16b on (data 2, model 2): the same MoE, MLA
             split over its 4 heads (2 a model rank)
  moe-seq    deepseek-moe-16b at S = 2,048, where the residual is split over
             the sequence and the MoE enters and exits through that split
  moe-whole  deepseek-moe-16b with 6 experts on (data 1, model 4): the axis
             does not divide E, so the experts are gathered and run whole

Each case's sharded train step (loss, aux loss, every gradient leaf, each
AdamW update) and greedy tokens are held to ``test_torch_train_mesh.py``'s
tolerances: the loss 1e-6 relative, a gradient leaf 1e-5 relative L2
against the port and 1e-4 against the JAX package, each update 1e-3,
greedy tokens equal. During the step each rank counts its expert products
(the batch dim of each ``torch.bmm`` in ``moe_experts``) and digests the
routing (``moe_route``'s expert ids), which must be the same bits on the
ranks that share a batch group. For ``moe`` and ``moe-seq`` each rank
also counts one MoE layer's collectives (``LAYER_COLLECTIVES``).

The ranks import this module by name, so it imports no JAX at its top
level.
"""
import dataclasses
import functools
import hashlib
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
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
#: case → (arch, MoE fields replaced, mesh (data, model), sequence length)
CASES = {"moe": ("deepseek-moe-16b", {}, (2, 2), 32),
         "v2-lite": ("deepseek-v2-lite-16b", {}, (2, 2), 32),
         "moe-seq": ("deepseek-moe-16b", {}, (2, 2), 2048),
         "moe-whole": ("deepseek-moe-16b", {"n_routed": 6}, (1, 4), 32)}
SERVED = ("moe", "v2-lite", "moe-whole")
#: the collectives of one MoE layer of deepseek-moe-16b on (2, 2) in a
#: sharded train step (remat "full"), by pass and kind (``_by_pass``).
#: Forward: 11 all-gathers over data of the layer's weights (wq, wk, wv,
#: wo, the router, the three expert stacks and the shared experts' three;
#: the norms are whole), and the MoE's one exit, its routed partial joined
#: to its shared experts' row-parallel one: with the attention's, two
#: all-reduces over model, and the aux loss's batch statistics'. Split
#: over the sequence (S = 2,048) the two exits are reduce-scatters and
#: the two entries all-gathers of it. The backward recomputes the forward
#: and adds the gradients' reduce-scatters and all-reduces.
LAYER_COLLECTIVES = {
    "moe": {"forward all-gather": 11, "forward all-reduce": 3,
            "backward all-gather": 11, "backward all-reduce": 7,
            "backward reduce-scatter": 11},
    "moe-seq": {"forward all-gather": 13, "forward all-reduce": 1,
                "forward reduce-scatter": 2, "backward all-gather": 15,
                "backward all-reduce": 6, "backward reduce-scatter": 14}}
B, NEW = 4, 4
LOSS_TOL, GRAD_TOL = 1e-6, 1e-5
REF_GRAD_TOL, UPDATE_TOL = 1e-4, 1e-3


def _replace(cfg, tag):
    arch, moe, _, _ = CASES[tag]
    return dataclasses.replace(cfg, remat="full", moe=dataclasses.replace(
        cfg.moe, **moe))


def _cfg(tag):
    return _replace(configs.smoke_config(CASES[tag][0]), tag)


def _jcfg(tag):
    from repro.configs import smoke_config as jsmoke
    return _replace(jsmoke(CASES[tag][0]), tag)


@functools.lru_cache(maxsize=None)
def _inputs(tag):
    """The tree (the port's draws in the reference layout) and a batch,
    from numpy seeds."""
    cfg = _cfg(tag)
    s = CASES[tag][3]
    tree = T.params_to_reference(cfg, T.init_params(cfg, 0, device="cpu",
                                                    masters=True))
    rng = np.random.default_rng(2)
    labels = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    labels[0, :3] = -1
    tokens = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    return tree, {"tokens": tokens, "labels": labels}


def _opt():
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

def _counting(record):
    """``layers.moe_experts`` and ``moe_route`` wrapped to record each call's
    first expert and the batch dims of its products, and a digest of the
    expert ids routed."""
    from repro_torch.models import layers as L
    experts, route = L.moe_experts, L.moe_route

    def counted(cfg, p, x, gates, eidx, **kw):
        dims, bmm = [], torch.bmm

        def rec(a, b, *args, **kwargs):
            dims.append(a.shape[0])
            return bmm(a, b, *args, **kwargs)
        torch.bmm = rec
        try:
            out = experts(cfg, p, x, gates, eidx, **kw)
        finally:
            torch.bmm = bmm
        record["products"].append((kw.get("first", 0), tuple(dims)))
        return out

    def digested(cfg, p, x):
        probs, gates, eidx = route(cfg, p, x)
        record["routes"].append(hashlib.sha256(
            eidx.contiguous().numpy().tobytes()).hexdigest())
        return probs, gates, eidx

    L.moe_experts, L.moe_route = counted, digested
    return lambda: setattr(L, "moe_experts", experts) or setattr(
        L, "moe_route", route)


def _by_pass(run):
    """``run()`` (a train step) with each collective it issues counted by
    (pass, kind): "forward" before the backward, "backward" inside the
    autograd engine (remat's recompute of the forward, then the
    transposes and the gradient reduce-scatters), "update" after it."""
    from repro_torch.models import sharding as S
    counts, right, seen = {}, S._count, []

    def count(kind, t):
        if torch._C._current_graph_task_id() != -1:
            seen.append(True)
            what = "backward"
        else:
            what = "update" if seen else "forward"
        counts[f"{what} {kind}"] = counts.get(f"{what} {kind}", 0) + 1
        right(kind, t)
    S._count = count
    try:
        run()
    finally:
        S._count = right
    return counts


def _one_moe_layer(tag, mesh, batch, step):
    """The collectives of one MoE layer in a sharded train step: the
    step's with the case's MoE layers less the step's with one MoE layer
    fewer, by (pass, kind)."""
    from repro_torch.train.optimizer import init_opt_state

    def counted(cfg):
        model = T.init_params(cfg, 0, device="cpu", masters=True, mesh=mesh,
                              batch_size=B)
        state = init_opt_state(dict(model.named_parameters()), _opt())
        return _by_pass(lambda: step(cfg)(model, state, batch))
    cfg = _cfg(tag)
    fewer = dataclasses.replace(cfg, segments=tuple(
        dataclasses.replace(g, count=g.count - (g.ffn == "moe"))
        for g in cfg.segments))
    full, less = counted(cfg), counted(fewer)
    return {k: full.get(k, 0) - less.get(k, 0)
            for k in sorted(set(full) | set(less))
            if full.get(k, 0) != less.get(k, 0)}


def _sharded_run(tag, tree, batch):
    """One case on this rank: the sharded step, its gradients and updates
    gathered whole, the products and routing it ran; greedy tokens."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import TrainConfig, make_train_step
    torch.set_num_threads(1)
    cfg = _cfg(tag)
    _, _, shape, s = CASES[tag]
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    model = T.shard_params(cfg, T.params_from_reference(
        cfg, tree, device="cpu", masters=True), mesh, batch_size=B)
    layout = T.layout_of(model)
    named = dict(model.named_parameters())
    before = {n: p.full_tensor().detach().clone() for n, p in named.items()}
    state = init_opt_state(named, _opt())
    record = {"products": [], "routes": []}
    restore = _counting(record)
    try:
        _, state, metrics = make_train_step(cfg, TrainConfig(opt=_opt()))(
            model, state, batch)
    finally:
        restore()
    out = {"coord": tuple(layout.coord), "record": record,
           "kinds": sorted(set(layout.split_blocks.values())),
           "seq": layout.sequence(s) is not None,
           "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": T.params_to_reference(
               cfg, {n: p.grad for n, p in named.items()}),
           "update": T.params_to_reference(
               cfg, {n: p.full_tensor() - before[n]
                     for n, p in named.items()})}
    if tag in LAYER_COLLECTIVES:
        out["layer_collectives"] = _one_moe_layer(
            tag, mesh, batch,
            lambda c: make_train_step(c, TrainConfig(opt=_opt())))
    if tag in SERVED:
        serve = T.shard_params(cfg, T.params_from_reference(
            cfg, tree, device="cpu"), mesh)
        out["tokens"] = Engine(cfg, serve, ServeConfig(
            cache_len=s + NEW, batch_size=B), device="cpu").generate(
                batch["tokens"], NEW)
    return out


def _ranks(inputs):
    return {tag: _sharded_run(tag, *inputs[tag]) for tag in CASES}


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
    _, _, metrics = make_train_step(cfg, TrainConfig(opt=_opt()))(
        model, init_opt_state(named, _opt()), batch)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": T.params_to_reference(
               cfg, {n: p.grad for n, p in named.items()}),
           "update": T.params_to_reference(
               cfg, {n: p.detach() - before[n] for n, p in named.items()})}
    if tag in SERVED:
        serve = T.params_from_reference(cfg, tree, device="cpu")
        out["tokens"] = Engine(cfg, serve, ServeConfig(
            cache_len=CASES[tag][3] + NEW, batch_size=B),
            device="cpu").generate(batch["tokens"], NEW)
    return out


def _reference(tag):
    """The JAX package's loss, aux loss, gradients, AdamW update and greedy
    tokens (its Engine's loop: the prefill's argmax, then each decode
    step's) on the same tree and batch."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as JT
    from repro.serve import engine as JE
    from repro.train import optimizer as JO
    jcfg = _jcfg(tag)
    tree, batch = _inputs(tag)
    s = CASES[tag][3]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(jcfg, p, b), has_aux=True))(tree, jb)
    ocfg = JO.OptConfig()
    new, _, _ = jax.jit(JO.apply_updates, static_argnums=3)(
        tree, grads, JO.init_opt_state(tree, ocfg), ocfg)
    out = {"loss": float(loss), "aux": float(metrics["aux"]),
           "grads": jax.tree_util.tree_map(np.asarray, grads),
           "update": jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b,
                                            new, tree)}
    if tag in SERVED:
        caches = JT.init_cache(jcfg, B, s + NEW)
        decode_fn = jax.jit(functools.partial(JT.decode_step, jcfg))
        logits, caches = jax.jit(functools.partial(JT.prefill, jcfg))(
            tree, {"tokens": jb["tokens"]}, caches)
        tok = JE.sample(logits, None, 0.0)
        tokens = [np.asarray(tok)]
        for i in range(NEW - 1):
            logits, caches = decode_fn(tree, tok, caches, jnp.int32(s + i))
            tok = JE.sample(logits, None, 0.0)
            tokens.append(np.asarray(tok))
        out["tokens"] = np.stack(tokens, axis=1)
    return out


@pytest.fixture(scope="module")
def runs():
    """The world of 4 (every case, one spawn) beside the unsharded port and
    the JAX package."""
    inputs = {tag: _inputs(tag) for tag in CASES}
    world = {}
    thread = threading.Thread(target=lambda: world.update(
        results=run_world(_ranks, 4, args=(inputs,), join_timeout_s=420)))
    thread.start()
    try:
        port = {t: _unsharded(t) for t in CASES}
        ref = {t: _reference(t) for t in CASES}
    finally:
        thread.join()
    assert "results" in world, "the world of 4 failed (see its output)"
    return {"ranks": world["results"], "port": port, "ref": ref}


@pytest.mark.parametrize("tag", sorted(CASES))
def test_expert_parallel_loss_and_aux_match(runs, tag):
    port, ref = runs["port"][tag]["metrics"], runs["ref"][tag]
    for r in runs["ranks"]:             # every rank reports the global loss
        m = r[tag]["metrics"]
        assert m["loss"] == pytest.approx(port["loss"], rel=LOSS_TOL)
        assert m["aux"] == pytest.approx(port["aux"], rel=LOSS_TOL, abs=1e-9)
        assert m["loss"] == pytest.approx(ref["loss"], rel=REF_GRAD_TOL)
        assert m["aux"] == pytest.approx(ref["aux"], rel=REF_GRAD_TOL)
        assert m["grad_norm"] == pytest.approx(port["grad_norm"],
                                               rel=GRAD_TOL)
        assert m["loss"] == runs["ranks"][0][tag]["metrics"]["loss"]
    assert port["aux"] > 0


@pytest.mark.parametrize("tag", sorted(CASES))
def test_expert_parallel_gradients_match_every_leaf(runs, tag):
    got = dict(_leaves(runs["ranks"][0][tag]["grads"]))
    port = dict(_leaves(runs["port"][tag]["grads"]))
    ref = dict(_leaves(runs["ref"][tag]["grads"]))
    assert set(got) == set(port) == set(ref)
    assert any("router" in p for p in got)
    for path in got:
        assert _rel(got[path], port[path]) < GRAD_TOL, path
        assert _rel(got[path], ref[path]) < REF_GRAD_TOL, path
    for other in runs["ranks"][1:]:
        for path, g in _leaves(other[tag]["grads"]):
            np.testing.assert_array_equal(g, got[path])


@pytest.mark.parametrize("tag", sorted(CASES))
def test_expert_parallel_adamw_update_matches_every_leaf(runs, tag):
    got = dict(_leaves(runs["ranks"][0][tag]["update"]))
    port = dict(_leaves(runs["port"][tag]["update"]))
    ref = dict(_leaves(runs["ref"][tag]["update"]))
    for path in got:
        assert _rel(got[path], port[path]) < UPDATE_TOL, path
        assert _rel(got[path], ref[path]) < UPDATE_TOL, path


@pytest.mark.parametrize("tag", sorted(SERVED))
def test_expert_parallel_greedy_tokens_equal(runs, tag):
    for r in runs["ranks"]:
        np.testing.assert_array_equal(r[tag]["tokens"],
                                      runs["port"][tag]["tokens"])
        np.testing.assert_array_equal(r[tag]["tokens"],
                                      runs["ref"][tag]["tokens"])


@pytest.mark.parametrize("tag", sorted(CASES))
def test_each_model_rank_runs_its_own_experts(runs, tag):
    """Split: each model rank's three expert products a call are over its
    E/m experts, from expert coord·E/m; the axis does not divide E: every
    rank runs all E. Either way the ranks of a batch group route every
    token to the same experts (the same digests, call by call)."""
    cfg = _cfg(tag)
    e, m = cfg.moe.n_routed, CASES[tag][2][1]
    split = e % m == 0
    groups = {}
    for r in runs["ranks"]:
        got = r[tag]
        data, model = got["coord"]
        assert ("moe" in got["kinds"]) == split
        assert got["seq"] == (CASES[tag][3] >= 2048)
        n = e // m if split else e
        first = model * n if split else 0
        # two MoE layers, each run again in its recompute (remat "full")
        assert got["record"]["products"] == [(first, (n, n, n))] * 4
        groups.setdefault(data, []).append(got["record"]["routes"])
    for routes in groups.values():
        assert len(routes) == m and all(x == routes[0] for x in routes)


@pytest.mark.parametrize("tag", sorted(LAYER_COLLECTIVES))
def test_one_moe_layer_collectives(runs, tag):
    """One MoE layer's collectives a step, the same on every rank: its
    MoE's routed and shared partials cross the model axis in one exit, so
    the layer exits twice a forward, as a dense layer does."""
    got = [r[tag]["layer_collectives"] for r in runs["ranks"]]
    assert all(g == got[0] for g in got)
    assert got[0] == LAYER_COLLECTIVES[tag], got[0]


LAYOUTS = r"""
import json
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
out = {}
for arch in ("deepseek-moe-16b", "deepseek-v2-lite-16b"):
    cfg = get_config(arch)
    meta = T.empty_params(cfg, device="meta", masters=True)
    for shape in ((16, 16), (4, 64), (2, 128)):
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        lay = S.Layout(cfg, mesh, meta, batch_size=256)
        pre = "segments.1.0.ffn."
        out[f"{arch}:{shape[1]}"] = {
            "kind": lay.split_blocks.get(pre),
            "gathers": [list(lay.plans[pre + w].gathers)
                        for w in ("experts.wg", "experts.wd", "router")],
            "partial": [list(lay.plans[pre + w].partial)
                        for w in ("experts.wg", "router")]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def full_width_layouts():
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-c", LAYOUTS], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("model", [16, 64, 128])
def test_full_width_expert_split_follows_the_rule(full_width_layouts, arch,
                                                  model):
    """At full width in a fake world of 256: the 64 experts split over a
    model axis of 16 or 64 (their stacks gathered over data alone, the
    expert gradients summed over data alone, the router's over model
    too); on 128, which does not divide 64, the rule leaves the expert dim
    unsplit and the MoE runs whole: its stacks are gathered whole (split
    over data alone) and their gradients summed over data alone."""
    got = full_width_layouts[f"{arch}:{model}"]
    if model == 128:
        assert got["kind"] is None
        assert got["gathers"] == [[[0, 1]], [[0, 2]], [[0, 0]]]
        assert got["partial"] == [[0], [0]]
    else:
        assert got["kind"] == "moe"
        assert got["gathers"] == [[[0, 1]], [[0, 2]], [[0, 0]]]
        assert got["partial"] == [[0, 1], [0, 1]]
