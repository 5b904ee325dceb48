"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU when asked for the card."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:[\s.,]|$)",
                       re.MULTILINE)

FIT_SCRIPT = """
import sys
import numpy as np
from repro_torch.core import SCRBConfig, SCRBModel, metrics
from repro_torch.data.synthetic import make_blobs
x, y = make_blobs(300, 4, 3, seed=0)
cfg = SCRBConfig(n_clusters=3, n_grids=16, sigma=1.5, d_g=256,
                 kmeans_replicates=1)
m = SCRBModel.fit(x, cfg, device="cpu")
assert m.predict(x[:50]).shape == (50,)
assert metrics.accuracy(m.fit_result.labels, y) > 0.9
loaded = [name for name in sys.modules
          if name.split(".")[0] in ("jax", "jaxlib", "repro")]
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""

GENERATE_SCRIPT = """
import sys
import numpy as np
from repro_torch import configs
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine, ServeConfig
# + MLA, MoE; the SSM, hybrid, M-RoPE and embeds paths
for arch in ("internlm2-1.8b", "deepseek-v2-lite-16b", "mamba2-370m",
             "hymba-1.5b", "qwen2-vl-7b", "musicgen-large"):
    cfg = configs.smoke_config(arch)
    model = T.init_params(cfg, 0, device="cpu")
    engine = Engine(cfg, model, ServeConfig(cache_len=16, batch_size=2),
                    device="cpu")
    if cfg.input_mode == "embeds":
        prompts = np.ones((2, 8, cfg.d_model), np.float32)
    else:
        prompts = np.arange(16).reshape(2, 8) % cfg.vocab_size
    out = engine.generate(prompts, 4)
    assert out.shape == (2, 4)
cfg = configs.smoke_config("qwen2-vl-7b")
model = T.init_params(cfg, 0, device="cpu")
pos = np.broadcast_to(np.arange(8)[None, None], (3, 2, 8)).copy()
pos[1:, :, 4:] += np.arange(4)            # h, w streams part ways
T.prefill(cfg, model, {"embeds": np.ones((2, 8, cfg.d_model), np.float32),
                       "positions": pos}, T.init_cache(cfg, 2, 8,
                                                       device="cpu"))
loaded = [name for name in sys.modules
          if name.split(".")[0] in ("jax", "jaxlib", "repro")]
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""


SOLVERS_SCRIPT = """
import json, os, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(1)   # hundreds of tiny ops: threads only contend
from repro_torch.core import SCRBConfig, SCRBModel, SolverOptions, metrics
from repro_torch.data.synthetic import make_blobs
x, y = make_blobs(300, 4, 3, seed=0)
for solver in ("lobpcg_host", "randomized", "auto", "lanczos", "subspace",
               "compressive"):
    for chunk in ((None,) if solver in ("lanczos", "subspace")
                  else (None, 100)):
        cfg = SCRBConfig(n_clusters=3, n_grids=16, sigma=1.5, d_g=256,
                         kmeans_replicates=1, chunk_size=chunk,
                         solver_options=SolverOptions(solver=solver))
        m = SCRBModel.fit(x, cfg, device="cpu")
        assert m.predict(x[:50]).shape == (50,)
path = os.path.join(tempfile.mkdtemp(), "trace.json")
cfg = SCRBConfig(n_clusters=3, n_grids=16, sigma=1.5, d_g=256,
                 kmeans_replicates=1, trace=path)
SCRBModel.fit(x, cfg, device="cpu")
assert json.load(open(path))["traceEvents"]
loaded = [name for name in sys.modules
          if name.split(".")[0] in ("jax", "jaxlib", "repro")]
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""

#: Modules that the source check must cover: observability, the solvers
#: and the compressive cell.
SOLVER_OBS_MODULES = ("obs/__init__.py", "obs/metrics.py", "obs/trace.py",
                 "obs/memory.py", "core/compressive.py", "core/eigensolver.py")


def _run_alone(script: str) -> None:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cpu_fit_in_a_fresh_process_loads_no_jax():
    _run_alone(FIT_SCRIPT)


def test_cpu_generate_in_a_fresh_process_loads_no_jax():
    _run_alone(GENERATE_SCRIPT)


def test_every_solver_and_a_traced_fit_in_a_fresh_process_load_no_jax():
    _run_alone(SOLVERS_SCRIPT)


def test_source_check_covers_obs_and_compressive():
    checked = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES if "repro_torch" in p.parts}
    assert set(SOLVER_OBS_MODULES) <= checked


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax_or_reference(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.core import SCRBConfig, SCRBModel, sc_rb
    x = np.zeros((30, 2), np.float32)
    cfg = SCRBConfig(n_clusters=2, n_grids=4, d_g=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SCRBModel.fit(x, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc_rb(x, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SCRBModel.load(str(ROOT / "tests" / "data" / "tiny_model_v1.npz"))

    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine, ServeConfig
    for arch in ("internlm2-1.8b", "mamba2-370m", "hymba-1.5b",
                 "musicgen-large"):
        lm = configs.smoke_config(arch)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.init_params(lm, 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.init_cache(lm, 1, 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.empty_params(lm)
        model = T.init_params(lm, 0, device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(lm, model, ServeConfig(cache_len=8, batch_size=1))


BASELINES_SCRIPT = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)   # small ops: threads only contend
from repro_torch.core import BaselineConfig, METHODS, metrics
from repro_torch.data.synthetic import make_blobs
from repro_torch.serve.cluster_engine import ClusterEngine, EngineConfig
x, y = make_blobs(300, 4, 3, seed=0)
cfg = BaselineConfig(n_clusters=3, rank=64, sigma=1.5, kmeans_replicates=2)
for name, run in METHODS.items():
    assert run(x, cfg, device="cpu").labels.shape == (300,), name
from repro_torch.core import ExecutionPlan, SCRBConfig, SCRBModel
from repro_torch.core import make_feature_map
m = SCRBModel.fit(x, SCRBConfig(n_clusters=3, sigma=1.5),
                  plan=ExecutionPlan(feature_map=make_feature_map(
                      "nystrom", rank=64, sigma=1.5)), device="cpu")
eng = ClusterEngine(EngineConfig(buckets=(64, 256)), device="cpu")
eng.load_model("m", m)
assert (eng.predict("m", x[:100]) == m.predict(x[:100])).all()
loaded = [name for name in sys.modules
          if name.split(".")[0] in ("jax", "jaxlib", "repro")]
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""


def test_baselines_and_engine_in_a_fresh_process_load_no_jax():
    _run_alone(BASELINES_SCRIPT)


@pytest.mark.parametrize("name", ["kmeans", "sc", "kk_rs", "kk_rf", "sv_rf",
                                  "sc_lsc", "sc_nys", "sc_rf", "sc_rb",
                                  "csc_rb"])
def test_baselines_raise_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.core import BaselineConfig, METHODS
    x = np.zeros((30, 2), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        METHODS[name](x, BaselineConfig(n_clusters=2, rank=8))


def test_cluster_engine_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.serve.cluster_engine import ClusterEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterEngine()


#: The placement modules: the partitioned fit, the mesh collectives and the
#: launchers.
PLACEMENT_MODULES = ("core/partitioned.py", "core/distributed.py",
                     "launch/__init__.py", "launch/mesh.py",
                     "launch/world.py")

PLACEMENT_SCRIPT = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.core import (PartitionOptions, SCRBConfig, SCRBModel,
                              MeshRows, PartitionedRows, metrics)
from repro_torch.core import distributed, partitioned
from repro_torch.launch import mesh, world
from repro_torch.data.synthetic import make_blobs
x, y = make_blobs(300, 4, 3, seed=0)
cfg = SCRBConfig(n_clusters=3, n_grids=16, sigma=1.5, d_g=256,
                 kmeans_replicates=1,
                 partition=PartitionOptions(n_partitions=3, workers=2))
m = SCRBModel.fit(x, cfg, device="cpu")
assert (m.predict(x) == m.fit_result.labels).all()
assert metrics.accuracy(m.fit_result.labels, y) > 0.9
loaded = [name for name in sys.modules
          if name.split(".")[0] in ("jax", "jaxlib", "repro")]
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""


#: the LM serving slice's modules, the SSM, hybrid, M-RoPE and embeds
#: paths and the four configurations that need them included
LM_MODULES = ("configs/__init__.py", "configs/mamba2_370m.py",
              "configs/hymba_1p5b.py", "configs/qwen2_vl_7b.py",
              "configs/musicgen_large.py", "models/config.py",
              "models/layers.py", "models/transformer.py", "serve/engine.py")


def test_source_check_covers_the_lm_modules():
    checked = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES if "repro_torch" in p.parts}
    assert set(LM_MODULES) <= checked


def test_source_check_covers_the_placements():
    checked = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES if "repro_torch" in p.parts}
    assert set(PLACEMENT_MODULES) <= checked


def test_partitioned_fit_in_a_fresh_process_loads_no_jax():
    _run_alone(PLACEMENT_SCRIPT)


def test_partitioned_fit_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.core import PartitionOptions, SCRBConfig, SCRBModel
    x = np.zeros((30, 2), np.float32)
    cfg = SCRBConfig(n_clusters=2, n_grids=4, d_g=16,
                     partition=PartitionOptions(n_partitions=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SCRBModel.fit(x, cfg)


def _fitted_state(name: str):
    from repro_torch.core import make_feature_map
    x = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    kw = {"d_g": 16} if name == "rb" else {}
    fm = make_feature_map(name, rank=8, sigma=1.0, **kw).fit(0, x)
    return fm.meta_dict(), fm.state_dict()


def _exported_calls():
    """Each exported streaming, k-means and map-loading entry point, called
    as the JAX package's counterpart is called: with no ``device``."""
    import importlib
    from repro_torch.core import featuremap as fm
    from repro_torch.core import streaming as st
    # the package exports a function ``kmeans`` that hides the module
    km = importlib.import_module("repro_torch.core.kmeans")
    x = [np.ones((8, 2), np.float32)]
    idx = [np.zeros((8, 2), np.int32)]
    return {
        "streaming_kmeans": lambda: km.streaming_kmeans(None, x, 2),
        "row_normalize_chunks": lambda: km.row_normalize_chunks(x),
        "chunked_transform": lambda: st.chunked_transform(lambda c: c, x),
        "chunked_rb_transform": lambda: st.chunked_rb_transform(
            x, fm.RBMap.from_state(*_fitted_state("rb"),
                                   device="cpu").params),
        "chunked_bin_counts": lambda: st.chunked_bin_counts(idx, d=8,
                                                            d_g=4),
        "chunked_degrees": lambda: st.chunked_degrees(idx, d=8, d_g=4),
        "build_chunked_adjacency": lambda: st.build_chunked_adjacency(
            idx, d=8, d_g=4),
        "ChunkedELL.from_dense": lambda: st.ChunkedELL.from_dense(
            idx[0], np.ones(8, np.float32), 4, d=8, d_g=4),
        "build_chunked_dense": lambda: fm.build_chunked_dense(x),
        "load_fitted": lambda: fm.load_fitted(*_fitted_state("rb")),
        "RBMap.from_state": lambda: fm.RBMap.from_state(
            *_fitted_state("rb")),
        "RFFMap.from_state": lambda: fm.RFFMap.from_state(
            *_fitted_state("rff")),
        "NystromMap.from_state": lambda: fm.NystromMap.from_state(
            *_fitted_state("nystrom")),
        "LSCMap.from_state": lambda: fm.LSCMap.from_state(
            *_fitted_state("lsc")),
    }


@pytest.mark.parametrize("name", [
    "streaming_kmeans", "row_normalize_chunks", "chunked_transform",
    "chunked_rb_transform", "chunked_bin_counts", "chunked_degrees",
    "build_chunked_adjacency", "ChunkedELL.from_dense",
    "build_chunked_dense", "load_fitted", "RBMap.from_state",
    "RFFMap.from_state", "NystromMap.from_state", "LSCMap.from_state"])
def test_exported_entry_points_raise_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    call = _exported_calls()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


#: the training slice's modules
TRAIN_MODULES = ("train/__init__.py", "train/__main__.py",
                 "train/optimizer.py", "train/checkpoint.py",
                 "train/trainer.py", "data/tokens.py")

TRAIN_SCRIPT = """
import sys, tempfile
import numpy as np
from repro_torch import configs
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import TrainConfig, Trainer
cfg = configs.smoke_config("internlm2-1.8b")
tmp = tempfile.mkdtemp()
tcfg = TrainConfig(opt=OptConfig(warmup_steps=1), checkpoint_every=1,
                   checkpoint_dir=tmp, log_every=1000)
data = SyntheticTokens(vocab_size=cfg.vocab_size, batch=2, seq_len=8)
trainer = Trainer(cfg, tcfg, T.init_params(cfg, 0, device="cpu",
                                           masters=True), iter(data),
                  device="cpu")
trainer.run(1)
again = Trainer(cfg, tcfg, T.init_params(cfg, 1, device="cpu",
                                         masters=True), iter(data),
                device="cpu")
assert again.restore() and again.step == 1
for arch in ("deepseek-v2-lite-16b", "hymba-1.5b", "qwen2-vl-7b"):
    c = configs.smoke_config(arch)
    model = T.init_params(c, 0, device="cpu", masters=True)
    x = (np.ones((2, 8, c.d_model), np.float32) if c.input_mode == "embeds"
         else np.ones((2, 8), np.int32))
    key = "embeds" if c.input_mode == "embeds" else "tokens"
    loss, _ = T.lm_loss(c, model, {key: x, "labels": np.ones((2, 8),
                                                             np.int32)})
    loss.backward()
loaded = [name for name in sys.modules
          if name.split(".")[0] in ("jax", "jaxlib", "repro")]
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""


def test_source_check_covers_the_train_modules():
    checked = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES if "repro_torch" in p.parts}
    assert set(TRAIN_MODULES) <= checked


def test_training_in_a_fresh_process_loads_no_jax():
    _run_alone(TRAIN_SCRIPT)


def test_trainer_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = configs.smoke_config("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg, 0, masters=True)
    model = T.init_params(cfg, 0, device="cpu", masters=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainConfig(), model, iter([]))


#: the LM sharding slice's modules
SHARDING_MODULES = ("models/sharding.py", "launch/specs.py",
                    "launch/dryrun.py")

DRYRUN_SCRIPT = """
import dataclasses, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import SHAPES, smoke_config
from repro_torch.launch import dryrun
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
cfg = smoke_config("internlm2-1.8b")
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=4)
r = dryrun.run_cell(cfg, shape, False, None,
                    mesh_shape=((2, 2), ("data", "model")))
assert r["status"] == "ok" and r["memory"]["argument_bytes"] > 0
loaded = [name for name in sys.modules
          if name.split(".")[0] in ("jax", "jaxlib", "repro")]
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""


def test_source_check_covers_the_sharding_modules():
    checked = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES if "repro_torch" in p.parts}
    assert set(SHARDING_MODULES) <= checked


def test_dry_run_in_a_fresh_process_loads_no_jax():
    _run_alone(DRYRUN_SCRIPT)


def test_mesh_entry_points_raise_without_a_card():
    """The sharded init, caches and shards of a model on "meta" ask for the
    card unless given the CPU; without one they raise before touching the
    mesh."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch import configs
    from repro_torch.models import transformer as T
    cfg = configs.smoke_config("internlm2-1.8b")
    no_mesh = object()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg, 0, masters=True, mesh=no_mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(cfg, 2, 8, mesh=no_mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.shard_params(cfg, T.empty_params(cfg, device="meta"), no_mesh)
