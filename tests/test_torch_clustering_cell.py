"""The port's clustering cell (``core.distributed.lower_clustering_cell``)
against the JAX package's, which its roofline benchmark compiles.

The reference lowers one distributed eigensolver iteration on a mesh of 8
CPU devices (``--xla_force_host_platform_device_count=8``) and reads XLA's
memory and cost analyses and the collectives of the compiled HLO; the port
runs the same iteration on fake tensors in a ``fake`` process group of 8
ranks on (data 8). Both in subprocesses: the fake group is a process-wide
default group, and XLA's device count is fixed when JAX starts. Exact:
argument bytes, the count and bytes of the all-reduce (compressed: the
bfloat16 payload, the reference's ``coll_analytic_bytes``), the port's
operations against its stated formula (printed beside XLA's, which counts
another lowering of the products). At the production mesh (16, 16) and the
reference benchmark's shape (n 25 M, R 256, d_g 4,096, K 16) the record
shows 1,706,250,000 argument bytes a rank and one all-reduce of
67,108,864 bytes (33,554,432 compressed).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch_threads  # noqa: F401  (one thread under xdist)

from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(n=8_192, k=4, n_grids=64, d_g=1_024)
PROD = dict(n=25_000_000, k=16, n_grids=256, d_g=4_096)
#: the keys of the reference benchmark's record (benchmarks/
#: clustering_cell.py) but its compile time: the port compiles nothing
RECORD_KEYS = {"arch", "shape", "mesh", "n_devices", "status", "kind",
               "memory", "cost", "collectives", "params", "active_params",
               "tokens", "clustering", "coll_analytic_bytes"}

REFERENCE = """
import json
from repro.core.distributed import lower_clustering_cell
from repro.launch.dryrun import parse_collectives
from repro.utils import make_mesh_compat
mesh = make_mesh_compat((8,), ("data",))
out = {}
for compress in (False, True):
    comp = lower_clustering_cell(mesh, dim=0, compress=compress,
                                 **%(small)r).compile()
    mem = comp.memory_analysis()
    cost = comp.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    out[str(compress)] = {
        "argument_bytes": int(mem.argument_size_in_bytes),
        "output_bytes": int(mem.output_size_in_bytes),
        "flops": float(cost.get("flops", -1.0)),
        "collectives": parse_collectives(comp.as_text())}
print("RESULT " + json.dumps(out))
"""

PORT = """
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.core.distributed import lower_clustering_cell
from repro_torch.launch import mesh as M
out = {}
for name, dims, axes, shape in (
        ("small", (8,), ("data",), %(small)r),
        ("prod", (16, 16), ("data", "model"), %(prod)r),
        ("multi_pod", (2, 16, 16), ("pod", "data", "model"), %(prod)r)):
    n = 1
    for d in dims:
        n *= d
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    mesh = M.make_mesh(dims, axes, device_type="cpu")
    for compress in (False, True):
        out[name + str(compress)] = lower_clustering_cell(
            mesh, dim=0, compress=compress, **shape)
    dist.destroy_process_group()
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "repro")]
print("RESULT " + json.dumps({"records": out, "loaded": loaded}))
"""


def _run(script: str, env: dict) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env)
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    line = [s for s in out.stdout.splitlines() if s.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def cells():
    ref = _run(REFERENCE % {"small": SMALL}, {
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    port = _run(PORT % {"small": SMALL, "prod": PROD}, {})
    return {"ref": ref, "port": port["records"], "loaded": port["loaded"]}


def _bytes_of(rec: dict, kind: str) -> tuple:
    c = rec["collectives"][kind]
    return c["count"], c["bytes"]


@pytest.mark.parametrize("compress", [False, True])
def test_argument_bytes_equal_the_reference(cells, compress):
    got = cells["port"]["small" + str(compress)]["memory"]
    want = cells["ref"][str(compress)]
    assert got["argument_bytes"] == want["argument_bytes"]
    assert got["output_bytes"] == want["output_bytes"]
    assert got["peak_bytes_per_device"] == \
        got["argument_bytes"] + got["temp_bytes"]


def test_one_all_reduce_of_the_block_as_the_reference(cells):
    d, k = SMALL["n_grids"] * SMALL["d_g"], SMALL["k"]
    got = cells["port"]["smallFalse"]
    want = cells["ref"]["False"]["collectives"]
    assert _bytes_of(got, "all-reduce") == (1, d * k * 4)
    assert (want["all-reduce"]["count"], want["all-reduce"]["bytes"]) == \
        (1, d * k * 4)
    assert all(v["count"] == 0 for kind, v in got["collectives"].items()
               if kind != "all-reduce")
    assert all(v["count"] == 0 for kind, v in want.items()
               if kind != "all-reduce")


def test_compressed_payload_is_the_reference_analytic_bytes(cells):
    """The port counts the bfloat16 payload it sends; the reference's CPU
    HLO widens it to float32, so its record carries the payload as
    ``coll_analytic_bytes``."""
    d, k = SMALL["n_grids"] * SMALL["d_g"], SMALL["k"]
    got = cells["port"]["smallTrue"]
    ref_analytic = SMALL["n_grids"] * SMALL["d_g"] * SMALL["k"] * 2
    assert _bytes_of(got, "all-reduce") == (1, ref_analytic)
    assert got["coll_analytic_bytes"] == ref_analytic == d * k * 2
    assert cells["ref"]["True"]["collectives"]["all-reduce"]["count"] == 1


@pytest.mark.parametrize("compress", [False, True])
def test_flops_are_the_stated_formula(cells, compress):
    rows = SMALL["n"] // 8
    r, k = SMALL["n_grids"], SMALL["k"]
    d = r * SMALL["d_g"]
    got = cells["port"]["small" + str(compress)]["cost"]
    zt_b, zt_ops = ops.zt_matmul_cost(rows, r, d, k)
    z_b, z_ops = ops.z_matmul_cost(rows, r, d, k)
    assert got["flops"] == zt_ops + z_ops
    assert got["bytes_accessed"] == zt_b + z_b
    print(f"port flops {got['flops']:.0f} (zt {zt_ops} + z {z_ops}); "
          f"XLA's {cells['ref'][str(compress)]['flops']:.0f}")


@pytest.mark.parametrize("compress", [False, True])
def test_production_mesh_record(cells, compress):
    rec = cells["port"]["prod" + str(compress)]
    assert RECORD_KEYS <= set(rec)
    assert rec["mesh"] == "pod16x16" and rec["n_devices"] == 256
    assert rec["data_axes"] == ["data"]
    assert rec["memory"]["argument_bytes"] == 1_706_250_000
    payload = 33_554_432 if compress else 67_108_864
    assert _bytes_of(rec, "all-reduce") == (1, payload)
    assert rec["coll_analytic_bytes"] == payload
    assert rec["clustering"] == {"n": PROD["n"], "r": PROD["n_grids"],
                                 "d_g": PROD["d_g"], "k": PROD["k"]}
    assert rec["shape"] == ("eigeniter_bf16" if compress else "eigeniter")


def test_multi_pod_shards_rows_over_pod_and_data(cells):
    rec = cells["port"]["multi_podFalse"]
    assert rec["mesh"] == "pod2x16x16" and rec["n_devices"] == 512
    assert rec["data_axes"] == ["pod", "data"]
    assert rec["memory"]["argument_bytes"] == 1_706_250_000 // 2
    assert _bytes_of(rec, "all-reduce") == (1, 67_108_864)


def test_cell_loads_no_jax(cells):
    assert cells["loaded"] == []
