"""MLA split over its heads on the model axis (``sharding.Layout``'s "mla"
blocks, ``layers.MLA`` with ``tp``), against the unsharded port and the JAX
package's ``repro.models.layers.apply_mla``, on gloo worlds of 2 and 4 CPU
ranks; the sharded MoE serving check of ``chip_smoke.py``; and the dry run
of deepseek-v2-lite-16b on a fake (16, 16) world.

Layer cases at smoke size (float32, remat "full"; deepseek-v2-lite-16b's
MLA: 4 heads, kv_lora 32, qk 16 + 8, v 16), each one MLA layer (a ``Layer``
of ln1 and MLA, no FFN) trained by ``transformer._train_layer`` on the same
numpy input and output gradient:

  1x2    (data 1, model 2), S = 32, a world of 2: 2 heads a model rank
  2x2    (data 2, model 2), S = 32, a world of 4
  seq    (data 2, model 2), S = 2,048: the residual split over the
         sequence, so the layer enters and exits through that split
  whole  6 heads on (data 1, model 4): the rule splits wq's 144 columns
         over the model axis but the split would cut a head, so MLA runs
         whole, its weights gathered

Each case's output, input gradient and every gradient leaf (ln1 and the
six MLA weights) are held to ``test_torch_train_mesh.py``'s tolerances:
1e-5 relative L2 against the unsharded port, 1e-4 against the JAX
package's ``x + apply_mla(rmsnorm(x))`` by ``jax.vjp``. Each rank records
the heads it scores (``layers.mla_scores``' query heads). For ``2x2`` and
``seq`` each rank counts the layer's collectives by pass and kind
(``LAYER_COLLECTIVES``), and runs the layer again under each of
``chip_smoke.MESH_FAULTS``' "mla" faults, which must put a gradient leaf
beyond ``chip_smoke.MESH_GRAD_REL`` from the unsharded port's.

Serving (``SERVE_CASES``): deepseek-moe-16b and deepseek-v2-lite-16b at
smoke size in bf16, whole depth, on (2, 2) at two seeds: greedy prefill +
decode sharded (``chip_smoke.lm_greedy``) against one card routed as the
mesh routed (``chip_smoke.routes_as`` with the mesh's expert ids of every
MoE call, gathered by ``chip_smoke.batch_routes``), held by
``chip_smoke.hold_greedy`` (logits within ``MESH_LOGIT_REL``, tokens equal
but at near-ties); and one card's own routing's reroutes in the first MoE
layer must be near-ties (``chip_smoke.routing_against``).

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
from repro_torch.models import transformer as T
from repro_torch.models.config import Segment

ROOT = Path(__file__).resolve().parents[1]
ARCH = "deepseek-v2-lite-16b"
PREFIX = "segments.0.0."
#: case → (heads, mesh (data, model), batch, sequence length)
CASES = {"1x2": (4, (1, 2), 4, 32),
         "2x2": (4, (2, 2), 4, 32),
         "seq": (4, (2, 2), 2, 2048),
         "whole": (6, (1, 4), 4, 32)}
#: the cases each world runs
WORLDS = {2: ("1x2",), 4: ("2x2", "seq", "whole")}
FAULTED = ("2x2", "seq")
#: the collectives of one split MLA layer on (2, 2) in a train step (remat
#: "full"), by pass and kind (the layer's forward, then autograd's backward,
#: which recomputes the forward up to the last tensor it saves, so not the
#: exit). Forward: all-gathers over data of wq's rows and wo's columns (each
#: keeps its model shard), over model and data of w_dkv, w_uk and w_uv
#: (gathered whole; w_uk and w_uv then cut to this rank's heads' columns),
#: 8 in all; the exit's all-reduce over model (ln1 and kv_ln are whole).
#: Backward: the recompute's 8 all-gathers; the entry's all-reduce of the
#: input gradient over model; the reduce-scatters of wq and wo over data,
#: of w_dkv, w_uk and w_uv over data and model (8); all-reduces of kv_ln
#: over data and model and of ln1 over data. Split over the sequence (S =
#: 2,048) the entry is an all-gather of the sequence (again in the
#: recompute; its backward a reduce-scatter), the exit a reduce-scatter of
#: it (its backward an all-gather), and ln1, on this rank's part of the
#: sequence, takes its all-reduce over model too.
LAYER_COLLECTIVES = {
    "2x2": {"forward all-gather": 8, "forward all-reduce": 1,
            "backward all-gather": 8, "backward all-reduce": 4,
            "backward reduce-scatter": 8},
    "seq": {"forward all-gather": 9, "forward reduce-scatter": 1,
            "backward all-gather": 10, "backward all-reduce": 4,
            "backward reduce-scatter": 9}}
GRAD_TOL, REF_TOL = 1e-5, 1e-4
#: serving: arch → prompts (B, S), new tokens; seeds
SERVE_ARCHS = ("deepseek-moe-16b", "deepseek-v2-lite-16b")
SERVE_PROMPT, SERVE_NEW, SERVE_SEEDS = (2, 64), 4, (0, 1)
SERVE_CASES = [f"{a}:{s}" for a in SERVE_ARCHS for s in SERVE_SEEDS]


def _cfg(tag):
    heads = CASES[tag][0]
    cfg = configs.smoke_config(ARCH)
    return dataclasses.replace(cfg, n_heads=heads, n_kv_heads=heads,
                               remat="full",
                               segments=(Segment("mla", "none", 1),))


def _jcfg(tag):
    from repro.configs import smoke_config as jsmoke
    cfg = jsmoke(ARCH)
    heads = CASES[tag][0]
    return dataclasses.replace(cfg, n_heads=heads, n_kv_heads=heads)


@functools.lru_cache(maxsize=None)
def _inputs(tag):
    """The one layer's tree (the port's draws in the reference layout), the
    input x (B, S, D) and the output's gradient, from numpy seeds."""
    cfg = _cfg(tag)
    _, _, b, s = CASES[tag]
    tree = T.params_to_reference(cfg, T.init_params(cfg, 0, device="cpu",
                                                    masters=True))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return tree, x, dy


def _rope(cfg, b, s):
    from repro_torch.models import layers as L
    pos = torch.arange(s)[None].expand(b, s)
    return L.rope_tables(pos, cfg.rotary_dim, cfg.rope_theta)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _chip_smoke():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _by_pass(run):
    """``run()`` with each collective it issues counted by (pass, kind):
    "forward" outside the autograd engine, "backward" inside it."""
    from repro_torch.models import sharding as S
    counts, right = {}, S._count

    def count(kind, t):
        what = "backward" if torch._C._current_graph_task_id() != -1 \
            else "forward"
        counts[f"{what} {kind}"] = counts.get(f"{what} {kind}", 0) + 1
        right(kind, t)
    S._count = count
    try:
        run()
    finally:
        S._count = right
    return counts


def _sharded_layer(tag, mesh, tree, x, dy):
    """The layer on this rank: its output and input gradient (this rank's
    rows and part of the sequence, with their place), every gradient leaf
    made whole, the query heads it scored and the collectives by pass."""
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as S
    cfg = _cfg(tag)
    b, s = x.shape[:2]
    model = T.shard_params(cfg, T.params_from_reference(
        cfg, tree, device="cpu", masters=True), mesh, batch_size=b)
    layout = T.layout_of(model)
    layer = model.segments[0][0]
    first, n = layout.rows(b, layout.batch_axes)
    seq = layout.sequence(s)
    xs = torch.from_numpy(x[first:first + n])
    gs = torch.from_numpy(dy[first:first + n])
    part = (0, s)
    if seq is not None:
        xs, gs = seq.part(xs), seq.part(gs)
        part = (seq.index * (s // seq.n), s // seq.n)
    xs.requires_grad_(True)
    heads, scores = [], L.mla_scores

    def counted(q_lat, *args):
        heads.append(q_lat.shape[1])
        return scores(q_lat, *args)
    out = {}

    def step():
        y, _ = T._train_layer(cfg, layer, xs, _rope(cfg, n, s), layout,
                              PREFIX, seq)
        (y * gs).sum().backward()
        out["y"] = y.detach().numpy()
    L.mla_scores = counted
    try:
        collectives = _by_pass(step)
    finally:
        L.mla_scores = scores
    named = dict(model.named_parameters())
    return {"coord": tuple(layout.coord), "rows": (first, n), "part": part,
            "kinds": sorted(set(layout.split_blocks.values())),
            "seq": seq is not None, "y": out["y"],
            "dx": xs.grad.numpy(), "heads": heads,
            "grads": {k: S.whole(p.grad).numpy().copy()
                      for k, p in named.items() if k.startswith(PREFIX)},
            "collectives": collectives}


def _faulted(tag, mesh, tree, x, dy):
    """The layer's gradient leaves under each "mla" fault of
    ``chip_smoke.MESH_FAULTS``."""
    C = _chip_smoke()
    out = {}
    for name, (kind, plant) in C.MESH_FAULTS.items():
        if kind == "mla":
            with plant(mesh):
                out[name] = _sharded_layer(tag, mesh, tree, x, dy)["grads"]
    return out


def _serve(arch, seed, mesh):
    """Greedy serving of the bf16 smoke model sharded, and on rank 0 one
    card routed as the mesh routed and by its own router, as
    ``chip_smoke.lm_mesh_rank``'s serving check does."""
    import torch.distributed as dist
    C = _chip_smoke()
    cfg = dataclasses.replace(configs.smoke_config(arch), dtype="bfloat16")
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, SERVE_PROMPT))
    routes = []
    served = T.init_params(cfg, seed, mesh=mesh, device="cpu")
    with C.routes_as(None, routes):
        got = C.lm_greedy(cfg, served, prompts, SERVE_NEW)
    coord = tuple(mesh.get_coordinate())
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, (coord, None, routes))
    if dist.get_rank() != 0:
        return None
    mesh_routes = C.batch_routes(everyone)
    one = T.init_params(cfg, seed, device="cpu")
    free_routes, as_mesh = [], []
    with C.routes_as(None, free_routes):
        free = C.lm_greedy(cfg, one, prompts, SERVE_NEW)
    with C.routes_as([e for e, _ in mesh_routes], as_mesh):
        want = C.lm_greedy(cfg, one, prompts, SERVE_NEW)
    return {"got": got, "want": want, "free": free,
            "mesh_routes": mesh_routes, "free_routes": free_routes,
            "as_mesh": as_mesh}


def _ranks(inputs, tags, serve):
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    out = {}
    for tag in tags:
        mesh = make_mesh(CASES[tag][1], ("data", "model"), device_type="cpu")
        out[tag] = _sharded_layer(tag, mesh, *inputs[tag])
        if tag in FAULTED:
            out[tag]["faults"] = _faulted(tag, mesh, *inputs[tag])
    if serve:
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        out["serve"] = {case: _serve(case.split(":")[0],
                                     int(case.split(":")[1]), mesh)
                        for case in SERVE_CASES}
    return out


# --------------------------------------------------------------------------
# the parent: the unsharded port and the JAX package
# --------------------------------------------------------------------------

def _unsharded(tag):
    cfg = _cfg(tag)
    tree, x, dy = _inputs(tag)
    model = T.params_from_reference(cfg, tree, device="cpu", masters=True)
    layer = model.segments[0][0]
    xs = torch.from_numpy(x).requires_grad_(True)
    y, _ = T._train_layer(cfg, layer, xs, _rope(cfg, *x.shape[:2]))
    (y * torch.from_numpy(dy)).sum().backward()
    return {"y": y.detach().numpy(), "dx": xs.grad.numpy(),
            "grads": {k: p.grad.numpy().copy()
                      for k, p in model.named_parameters()
                      if k.startswith(PREFIX)}}


def _reference(tag):
    """x + apply_mla(rmsnorm(x, ln1)) of the JAX package and its vjp on
    the same tree, input and output gradient."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as JL
    jcfg = _jcfg(tag)
    tree, x, dy = _inputs(tag)
    seg = tree["segments"]["seg0"]
    mixer = {k: jnp.asarray(v[0]) for k, v in seg["mixer"].items()}
    b, s = x.shape[:2]
    cos, sin = JL.rope_tables(jnp.broadcast_to(jnp.arange(s)[None], (b, s)),
                              jcfg.rotary_dim, jcfg.rope_theta)

    def layer(x_, ln1, p):
        h = JL.rmsnorm(x_, ln1, jcfg.norm_eps)
        return x_ + JL.apply_mla(jcfg, p, h, cos, sin)[0]
    y, vjp = jax.vjp(layer, jnp.asarray(x), jnp.asarray(seg["ln1"][0]),
                     mixer)
    dx, dln1, dp = vjp(jnp.asarray(dy))
    grads = {f"{PREFIX}mixer.{k}": np.asarray(v) for k, v in dp.items()}
    grads[f"{PREFIX}ln1"] = np.asarray(dln1)
    return {"y": np.asarray(y), "dx": np.asarray(dx), "grads": grads}


def _whole(tag, ranks, key):
    """``key`` ("y" or "dx") of every rank put in place: its rows and its
    part of the sequence."""
    _, x, _ = _inputs(tag)
    out = np.full(x.shape, np.nan, np.float32)
    for r in ranks:
        (first, n), (s0, sn) = r["rows"], r["part"]
        out[first:first + n, s0:s0 + sn] = r[key]
    assert not np.isnan(out).any()
    return out


@pytest.fixture(scope="module")
def runs():
    """The worlds of 2 and 4 (every case, one spawn each) beside the
    unsharded port and the JAX package."""
    inputs = {tag: _inputs(tag) for tag in CASES}
    worlds = {}

    def spawn():
        for n, tags in WORLDS.items():
            worlds[n] = run_world(_ranks, n, args=(inputs, tags, n == 4),
                                  join_timeout_s=420)
    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        port = {t: _unsharded(t) for t in CASES}
        ref = {t: _reference(t) for t in CASES}
    finally:
        thread.join()
    assert set(worlds) == set(WORLDS), "a world failed (see its output)"
    ranks = {tag: [r[tag] for r in worlds[n]]
             for n, tags in WORLDS.items() for tag in tags}
    return {"ranks": ranks, "port": port, "ref": ref,
            "serve": worlds[4][0]["serve"]}


@pytest.mark.parametrize("tag", sorted(CASES))
def test_split_mla_layer_output_matches(runs, tag):
    for key in ("y", "dx"):
        got = _whole(tag, runs["ranks"][tag], key)
        assert _rel(got, runs["port"][tag][key]) < GRAD_TOL, key
        assert _rel(got, runs["ref"][tag][key]) < REF_TOL, key


@pytest.mark.parametrize("tag", sorted(CASES))
def test_split_mla_gradients_match_every_leaf(runs, tag):
    got = runs["ranks"][tag][0]["grads"]
    port, ref = runs["port"][tag]["grads"], runs["ref"][tag]["grads"]
    assert set(got) == set(port) == set(ref)
    assert len(got) == 7             # ln1, wq, w_dkv, kv_ln, w_uk, w_uv, wo
    for name in got:
        assert _rel(got[name], port[name]) < GRAD_TOL, name
        assert _rel(got[name], ref[name]) < REF_TOL, name
    for other in runs["ranks"][tag][1:]:
        for name, g in other["grads"].items():
            np.testing.assert_array_equal(g, got[name])


@pytest.mark.parametrize("tag", sorted(CASES))
def test_each_model_rank_scores_its_own_heads(runs, tag):
    """Split: each model rank scores h/m heads, in the forward and in its
    remat recompute; the axis does not divide the heads: every rank scores
    all h, and the layout marks no block "mla"."""
    heads, (_, m), _, s = CASES[tag]
    split = heads % m == 0
    chunks = -(-s // _cfg(tag).attn_chunk)
    for r in runs["ranks"][tag]:
        assert ("mla" in r["kinds"]) == split
        assert r["seq"] == (s >= 2048)
        assert r["heads"] == [heads // m if split else heads] * (2 * chunks)


@pytest.mark.parametrize("tag", sorted(LAYER_COLLECTIVES))
def test_one_mla_layer_collectives(runs, tag):
    got = [r["collectives"] for r in runs["ranks"][tag]]
    assert all(g == got[0] for g in got)
    assert got[0] == LAYER_COLLECTIVES[tag], got[0]


def _mla_faults():
    C = _chip_smoke()
    return [n for n, (kind, _) in C.MESH_FAULTS.items() if kind == "mla"]


@pytest.mark.parametrize("fault", _mla_faults())
@pytest.mark.parametrize("tag", FAULTED)
def test_planted_mla_fault_fails_the_check(runs, tag, fault):
    """Each planted "mla" fault of ``chip_smoke.MESH_FAULTS`` puts a
    gradient leaf of the split layer beyond ``MESH_GRAD_REL`` from the
    unsharded port's, the limit of ``chip_smoke.py``'s 2-layer check."""
    C = _chip_smoke()
    got = runs["ranks"][tag][0]["faults"][fault]
    port = runs["port"][tag]["grads"]
    worst = max(_rel(got[n], port[n]) for n in port)
    assert worst > C.MESH_GRAD_REL, worst


@pytest.mark.parametrize("case", SERVE_CASES)
def test_sharded_serving_holds_against_one_card_routed_as_the_mesh(runs,
                                                                   case):
    """``chip_smoke.hold_greedy``'s gate (logits within MESH_LOGIT_REL of
    one card's, tokens equal but at near-ties) on the bf16 smoke model, one
    card routed as the mesh routed: it ran every MoE call of the prefill
    and of each decode step at the mesh's experts; and one card's own
    router parts from the mesh in the first MoE layer only at near-ties."""
    C = _chip_smoke()
    sv = runs["serve"][case]
    cfg = configs.smoke_config(case.split(":")[0])
    n_moe = sum(g.count for g in cfg.segments if g.ffn == "moe")
    assert len(sv["mesh_routes"]) == len(sv["as_mesh"]) \
        == len(sv["free_routes"]) == n_moe * SERVE_NEW
    C.hold_greedy(f"[{case}] sharded serving", sv["got"], sv["want"])
    assert C.routing_against(sv["mesh_routes"][:1],
                             sv["free_routes"][:1])["not_tie"] == 0


DRYRUN = r"""
import json, sys
from repro_torch.launch import dryrun
from repro_torch.models import sharding as S
if sys.argv[1] == "whole":
    right = S.Layout._split_blocks
    S.Layout._split_blocks = lambda self, shapes: {
        k: v for k, v in right(self, shapes).items() if v != "mla"}
r = dryrun.run_cell("deepseek-v2-lite-16b", "train_4k", False, "")
print(json.dumps({"memory": r["memory"], "flops": r["cost"]["flops"],
                  "collectives": r["collectives"]}))
"""


@pytest.fixture(scope="module")
def dryruns():
    """The dry run of deepseek-v2-lite-16b x train_4k on a fake (16, 16)
    world, with MLA split and with MLA run whole (``_split_blocks`` made to
    drop the "mla" blocks), in two processes at once."""
    env = dict(os.environ, PYTHONPATH="src")
    procs = {how: subprocess.Popen([sys.executable, "-c", DRYRUN, how],
                                   env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True,
                                   cwd=ROOT)
             for how in ("split", "whole")}
    out = {}
    for how, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-3000:]
        out[how] = json.loads(stdout.strip().splitlines()[-1])
    return out


def test_dryrun_split_mla_cuts_flops_not_arguments(dryruns):
    """At (16, 16) each model rank scores 1 of the 16 heads: the flops a
    rank fall, while the arguments (the parameter, AdamW and batch shards
    of the reference's specs) are the same bytes."""
    split, whole = dryruns["split"], dryruns["whole"]
    assert split["memory"]["argument_bytes"] == \
        whole["memory"]["argument_bytes"]
    assert split["flops"] < 0.5 * whole["flops"]
    assert split["memory"]["temp_bytes"] < whole["memory"]["temp_bytes"]
