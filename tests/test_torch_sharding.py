"""The port's sharding rules (``repro_torch.models.sharding``), its cell
builders (``launch.specs``) and its dry run (``launch.dryrun``) against the
JAX package's, on the CPU.

The rules are pure functions of a mesh's axis names and sizes, so stub
meshes stand in for the production ones: every parameter's spec, the
batch's and the caches' must equal the reference's exactly, for all ten
architectures at full width. A gloo world of 4 CPU ranks holds the
placements against numpy slices of the whole tensor; a fake world of 8 runs
the small-mesh dry run (the reference's ``test_small_mesh_dryrun_compiles``)
and its argument bytes against what the reference's specs imply.

The ranks import this module by name, so it imports no JAX at its top
level.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
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


class StubMesh:
    """Axis names and sizes alone, as the reference's test stubs a mesh."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)


MESHES = {
    "16x16": dict(data=16, model=16),
    "2x16x16": dict(pod=2, data=16, model=16),
    "2x2": dict(data=2, model=2),
    "4": dict(data=4),
}


def _norm(spec):
    """A reference PartitionSpec as the port writes specs: a tuple of None
    or axis tuples."""
    return tuple(None if a is None else (a,) if isinstance(a, str)
                 else tuple(a) for a in spec)


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    """The reference's parameter shapes at full width (``eval_shape``: no
    memory), as {leaf path: shape}."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import transformer as JT
    cfg = jget(arch)
    pshape = jax.eval_shape(functools.partial(JT.init_params, cfg),
                            jax.random.PRNGKey(0))
    return cfg, pshape


def _reference_specs(arch, mesh):
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.models import sharding as jsh
    cfg, pshape = _reference_params(arch)
    specs = jsh.param_specs(cfg, mesh, pshape)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(k.key for k in path): _norm(spec) for path, spec in flat}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_pick_axes_matches_reference(mesh):
    from repro.models import sharding as jsh
    stub = StubMesh(**MESHES[mesh])
    prefs = [("model",), ("pod", "data"), ("pod", "data", "model"),
             ("data",)]
    for dim in (1, 2, 3, 8, 25, 64, 320, 1280, 50_280, 151_936):
        for pref in prefs:
            for second in (None, ("pod", "data")):
                args = (pref,) if second is None else (pref, second)
                assert S.pick_axes(stub, dim, *args) == \
                    jsh.pick_axes(stub, dim, *args), (dim, args)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_match_reference_on_every_leaf(arch, mesh):
    """Every port parameter takes its reference leaf's spec, less the
    stacked layer dim; every reference leaf is covered."""
    stub = StubMesh(**MESHES[mesh])
    cfg = configs.get_config(arch)
    model = T.empty_params(cfg, device="meta", masters=True)
    port = S.param_specs(cfg, stub, model)
    want = _reference_specs(arch, stub)
    paths = T.reference_paths(port)
    assert set(paths) == set(want)
    for path, names in paths.items():
        ref = want[path]
        if path[0] == "segments":
            assert ref[:1] in ((None,), ()), (path, ref)
            ref = ref[1:]
        for name in names:
            assert port[name] == ref, (name, port[name], ref)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_cache_specs_match_reference(mesh):
    import jax
    from repro.configs import get_config as jget
    from repro.models import sharding as jsh
    from repro.models import transformer as JT
    stub = StubMesh(**MESHES[mesh])
    for arch in configs.ARCH_IDS:
        cfg, jcfg = configs.get_config(arch), jget(arch)
        for b in (None, 1, 8, 32, 128, 256, 512):
            got = S.batch_specs(cfg, stub, b)
            want = {k: _norm(v) for k, v in
                    jsh.batch_specs(jcfg, stub, b).items()}
            assert got == want, (arch, b)
        for b, t in ((8, 256), (128, 32_768)):
            cshape = jax.eval_shape(lambda: JT.init_cache(jcfg, b, t))
            want = jax.tree_util.tree_map(
                _norm, jsh.cache_specs(jcfg, stub, cshape),
                is_leaf=lambda x: type(x).__name__ == "PartitionSpec")
            port_shapes = T._cache_shapes(cfg, b, t)
            for seg, bufs in port_shapes.items():
                for name, buf in bufs.items():
                    assert tuple(buf.shape) == tuple(cshape[seg][name].shape)
            assert S.cache_specs(cfg, stub, port_shapes) == want, (arch, b)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    stub = StubMesh(pod=2, data=2, model=2)
    assert S.placements(stub, ((("pod", "data")), ("model",))) == (
        Shard(0), Shard(0), Shard(1))
    assert S.placements(stub, (None, ("data",))) == (
        Replicate(), Shard(1), Replicate())
    assert S.placements(stub, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        S.placements(stub, (("data", "pod"),))


def test_dp_over_tp_falls_back_when_the_batch_does_not_divide():
    from repro_torch.configs import SHAPES
    from repro_torch.launch import specs
    cfg = configs.get_config("mamba2-370m")
    assert cfg.dp_over_tp
    stub = StubMesh(data=16, model=16)
    assert specs.effective_config(cfg, SHAPES["train_4k"], stub).dp_over_tp
    assert not specs.effective_config(cfg, SHAPES["prefill_32k"],
                                      stub).dp_over_tp


# --------------------------------------------------------------------------
# placements on a gloo world of 4 CPU ranks
# --------------------------------------------------------------------------

def _placement_rank():
    """Each rank's shards, by ``distribute_tensor`` and by
    ``sharding.local_slice``, of a tensor under three specs on a (pod 2,
    data 2) mesh and one on (data 2, model 2)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    out = {}
    for shape, axes, specs in (
            ((2, 2), ("pod", "data"),
             {"both": (("pod", "data"), None), "pod": (("pod",), None),
              "cols": (None, ("data",))}),
            ((2, 2), ("data", "model"),
             {"2d": (("data",), ("model",))})):
        mesh = make_mesh(shape, axes, device_type="cpu")
        for tag, spec in specs.items():
            pls = S.placements(mesh, spec)
            dt = distribute_tensor(full, mesh, pls)
            mine = S.local_slice(full, mesh, pls, mesh.get_coordinate())
            out[tag] = (dt.to_local().numpy(), mine.numpy(),
                        tuple(mesh.get_coordinate()))
    return out


def test_placements_on_a_gloo_world_are_numpy_slices():
    """("pod", "data") on one dim: rank (p, d) holds block 2p + d of four,
    JAX's major-to-minor split; every shard is the numpy slice of the
    whole."""
    results = run_world(_placement_rank, 4, join_timeout_s=240)
    full = np.arange(48, dtype=np.float32).reshape(8, 6)
    for res in results:
        for tag, (dtensor, mine, (i, j)) in res.items():
            want = {"both": full[2 * (2 * i + j):2 * (2 * i + j) + 2],
                    "pod": full[4 * i:4 * i + 4],
                    "cols": full[:, 3 * j:3 * j + 3],
                    "2d": full[4 * i:4 * i + 4, 3 * j:3 * j + 3]}[tag]
            np.testing.assert_array_equal(dtensor, want)
            np.testing.assert_array_equal(mine, want)


# --------------------------------------------------------------------------
# the small-mesh dry run: a fake world of 8 on (pod 2, data 2, model 2)
# --------------------------------------------------------------------------

SMALL_DRYRUN = r"""
import dataclasses, json
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import SHAPES, smoke_config
from repro_torch.launch import dryrun
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=128, global_batch=8)
decode = dataclasses.replace(SHAPES["decode_32k"], seq_len=256,
                             global_batch=8)
results = {}
for arch in ["internlm2-1.8b", "deepseek-moe-16b", "mamba2-370m",
             "hymba-1.5b"]:
    cfg = dataclasses.replace(smoke_config(arch), remat="full")
    for sp in (shape, decode):
        r = dryrun.run_cell(cfg, sp, False, None,
                            mesh_shape=((2, 2, 2), ("pod", "data", "model")))
        results[f"{arch}:{sp.kind}"] = r
print(json.dumps(results))
"""


def _spec_bytes(shape, dtype_bytes, spec, sizes):
    n = 1
    for d, size in enumerate(shape):
        axes = spec[d] if d < len(spec) else None
        n *= size // math.prod(sizes[a] for a in axes or ())
    return n * dtype_bytes


def _reference_argument_bytes(arch, kind, b, s):
    """This rank's bytes of the step's tensor arguments by the reference's
    specs (its param, batch and cache specs on the reference's shapes), in
    the port's dtypes: float32 masters, AdamW's moments and int32 step for
    train; the smoke config's float32 weights and caches for decode; int32
    tokens. The decode position is a host int in the port (4 bytes in the
    reference). A split SSM's conv inputs are the port's own runtime
    layout (``sharding.HeadCache``): this rank's heads' x channels beside
    the B and C channels, where the reference's spec splits the channels
    evenly."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.configs import smoke_config as jsmoke
    from repro.models import sharding as jsh
    from repro.models import transformer as JT
    sizes = dict(pod=2, data=2, model=2)
    stub = StubMesh(**sizes)
    jcfg = dataclasses.replace(jsmoke(arch), remat="full")
    if jcfg.dp_over_tp and b % 8:
        jcfg = dataclasses.replace(jcfg, dp_over_tp=False)
    pshape = jax.eval_shape(functools.partial(JT.init_params, jcfg),
                            jax.random.PRNGKey(0))
    pspecs = jsh.param_specs(jcfg, stub, pshape)
    leaves = jax.tree_util.tree_leaves(pshape)
    specs = jax.tree_util.tree_leaves(pspecs,
                                      is_leaf=lambda x: isinstance(x, P))
    params = sum(_spec_bytes(x.shape, 4, _norm(sp), sizes)
                 for x, sp in zip(leaves, specs))
    if kind == "train":
        bspecs = jsh.batch_specs(jcfg, stub, batch_size=b)
        batch = 2 * _spec_bytes((b, s), 4, _norm(bspecs["tokens"]), sizes)
        return 3 * params + 4 + batch
    cshape = jax.eval_shape(lambda: JT.init_cache(jcfg, b, s))
    cspecs = jsh.cache_specs(jcfg, stub, cshape)
    heads = S.ssm_heads(jcfg, stub)

    def cache_bytes(path, x, sp):
        shape, sp = x.shape, _norm(sp)
        if heads is not None and path[-1].key == "conv":
            sc = jcfg.ssm
            shape = shape[:3] + (heads[0][1] * sc.head_dim
                                 + 2 * sc.n_groups * sc.d_state,)
            sp = sp[:3] + (None,)
        return _spec_bytes(shape, x.dtype.itemsize, sp, sizes)
    caches = sum(cache_bytes(path, x, sp)
                 for (path, x), sp in zip(
                     jax.tree_util.tree_leaves_with_path(cshape),
                     jax.tree_util.tree_leaves(
                         cspecs, is_leaf=lambda x: isinstance(x, P))))
    dp = jsh.pick_axes(stub, b, ("pod", "data"))
    return params + caches + _spec_bytes((b,), 4, (dp,), sizes)


@pytest.fixture(scope="module")
def small_dryrun():
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    out = subprocess.run([sys.executable, "-c", SMALL_DRYRUN], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", [
    f"{a}:{k}" for a in ("internlm2-1.8b", "deepseek-moe-16b", "mamba2-370m",
                         "hymba-1.5b") for k in ("train", "decode")])
def test_small_mesh_dryrun_runs(small_dryrun, cell):
    """Each cell's step ran in the fake world; its argument bytes are the
    reference's specs' shards; it issued collectives and counted flops."""
    r = small_dryrun[cell]
    arch, kind = cell.split(":")
    assert r["status"] == "ok"
    b, s = (8, 128) if kind == "train" else (8, 256)
    assert r["memory"]["argument_bytes"] == \
        _reference_argument_bytes(arch, kind, b, s)
    assert r["memory"]["temp_bytes"] > 0 and r["cost"]["flops"] > 0
    assert r["collectives"]["all-gather"]["count"] > 0
    if kind == "train":
        assert r["collectives"]["reduce-scatter"]["count"] > 0
