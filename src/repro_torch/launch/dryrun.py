"""Multi-pod dry run: one step of every (arch × input-shape) cell on the
production meshes, with no card and no memory, and the record of what it
would take: the JAX package's ``repro.launch.dryrun``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out-dir dryrun_results]

``--all`` runs one subprocess per cell (crash isolation and resumability:
existing result JSONs are skipped).

A cell's process joins rank 0 of a ``fake`` process group
(``torch.testing._internal.distributed.fake_pg``) of 256 ranks (512 with
``--multi-pod``), builds ``launch.mesh.make_production_mesh`` and runs one
step of ``launch.specs.build_cell`` under ``FakeTensorMode``: every tensor
a fake on the CPU (shapes, dtypes, no data), every collective a no-op that
returns a fake, the flash kernel its ``torch.library`` fake. The record
keeps the reference's keys (``memory``, ``cost``, ``collectives``,
``params``, ``tokens``, ``status``, ``skip_reason``):

  - ``memory.argument_bytes``: this rank's shards of the step's arguments
    (parameters, AdamW's state, batch, caches), exact from the placements;
    ``cache_bytes``: the caches' alone (a prefill or decode cell; a split
    GQA's K/V and a split SSM's state and conv inputs held by this rank's
    own heads, ``sharding.HeadCache``);
    ``output_bytes``: the tensors the step returns that are not its
    arguments; ``temp_bytes``: the largest sum of live bytes of the
    tensors the step created (each op's fresh outputs, counted from the
    op until Python frees the tensor; views add nothing); ``peak_bytes_
    per_device``: argument + temp bytes. The caching allocator's rounding
    and fragmentation are not counted.
  - ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode``, the
    flash op counted by ``ops.flash_flops`` (its visible (query, key)
    pairs, the ELL products by their ``ops.*_cost`` operations);
    ``bytes_accessed`` is -1 (nothing measures it here).
  - ``collectives``: count and output bytes of each kind, counted where the
    port issues them (``models.sharding.COLLECTIVES``).

The reference compiles the step and reads XLA's memory and cost analyses
and the collectives of the post-partitioning HLO text; PyTorch runs
eagerly and has no HLO, so nothing here parses one.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import weakref


def _flop_formula():
    """Formulas for ``FlopCounterMode`` (registered once a process): the
    flash op's (``ops.flash_flops``) and the ELL products' operations
    (``ops.zt_matmul_cost``, ``z_matmul_cost``, ``gram_matmul_cost``)."""
    import torch
    from torch.utils import flop_counter
    from torch.utils.flop_counter import register_flop_formula

    from repro_torch.kernels import ops
    lib = torch.ops.repro_torch

    def register(packet, formula):
        if packet not in flop_counter.flop_registry \
                and packet.default not in flop_counter.flop_registry:
            register_flop_formula(packet)(formula)

    def flash(q_shape, k_shape, v_shape, causal, window, *args, **kwargs):
        b, s, h, hd = q_shape
        return ops.flash_flops(b, s, k_shape[1], h, hd, causal, window)

    def z(idx_shape, v_shape, s_shape, d_g, *args, **kwargs):
        return ops.z_matmul_cost(*idx_shape, *v_shape)[1]

    def zt(idx_shape, u_shape, s_shape, d, d_g, *args, **kwargs):
        return ops.zt_matmul_cost(*idx_shape, d, u_shape[1])[1]

    def gram(idx_shape, u_shape, s_shape, d, d_g, *args, **kwargs):
        return ops.gram_matmul_cost(*idx_shape, d, u_shape[1])[1]

    register(lib.flash_attention, flash)
    register(lib.z_matmul, z)
    register(lib.z_matmul_gather, z)
    register(lib.zt_matmul, zt)
    register(lib.gram_matmul, gram)


def _live_bytes_mode():
    """A dispatch mode that tracks the bytes of the tensors ops create and
    Python still holds, and their peak."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class LiveBytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.live = self.peak = 0

        def _free(self, n):
            self.live -= n

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            schema = func._schema
            fresh = [r.alias_info is None for r in schema.returns]
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for t, new in zip(outs, fresh):
                if new and isinstance(t, torch.Tensor):
                    n = t.numel() * t.element_size()
                    self.live += n
                    weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
            return out

    return LiveBytes()


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_path: str,
             *, mesh_shape=None) -> dict:
    """One cell in a fake world: ``mesh_shape`` ((shape), (axes)) replaces
    the production mesh (a test's small mesh)."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import specs
    from repro_torch.models import sharding as sh

    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if mesh_shape is None:
        mesh_shape = M.production_mesh_shape(multi_pod=multi_pod)
    dims, axes = mesh_shape
    n = 1
    for d in dims:
        n *= d
    mesh_name = "x".join(f"{a}{d}" for a, d in zip(axes, dims)) \
        if mesh_shape != M.production_mesh_shape(multi_pod=multi_pod) \
        else ("pod2x16x16" if multi_pod else "pod16x16")
    record = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
              "n_devices": n}
    skip = specs.shape_applicable(cfg, shape)
    if skip is not None:
        record["status"] = "skipped"
        record["skip_reason"] = skip
        _write(out_path, record)
        return record

    _flop_formula()
    own_group = not dist.is_initialized()
    if own_group:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    try:
        mesh = M.make_mesh(dims, axes, device_type="cpu")
        t0 = time.time()
        step, args, placements = specs.build_cell(cfg, shape, mesh)
        # the mesh's own rank tables are real tensors
        with FakeTensorMode(allow_non_fake_inputs=True):
            sharded = specs.shard_args(cfg, shape, mesh, args, placements,
                                       device="cpu")
            record["build_s"] = round(time.time() - t0, 2)
            arg_bytes = specs.argument_bytes(sharded)
            sh.reset_collectives()
            live = _live_bytes_mode()
            t0 = time.time()
            with live, FlopCounterMode(display=False) as fc:
                out = step(*sharded)
            record["run_s"] = round(time.time() - t0, 2)
            outs = out[-1] if shape.kind == "train" else out[0]
            out_bytes = specs.argument_bytes(outs)
            record["memory"] = {
                "argument_bytes": int(arg_bytes),
                "output_bytes": int(out_bytes),
                "temp_bytes": int(live.peak),
                "peak_bytes_per_device": int(arg_bytes + live.peak),
                "cache_bytes": 0 if shape.kind == "train"
                else int(specs.argument_bytes(sharded[2])),
            }
            record["cost"] = {"flops": float(fc.get_total_flops()),
                              "bytes_accessed": -1.0}
            record["collectives"] = sh.collective_counts()
    finally:
        if own_group:
            dist.destroy_process_group()
    record["params"] = cfg.param_count()
    record["active_params"] = cfg.active_param_count()
    record["tokens"] = (shape.global_batch if shape.kind == "decode"
                        else shape.tokens)
    record["kind"] = shape.kind
    record["status"] = "ok"
    print(f"[{cfg.name} × {shape.name} × {mesh_name}] "
          f"run {record['run_s']}s, "
          f"peak/device {record['memory']['peak_bytes_per_device']/2**30:.2f} "
          f"GiB (caches {record['memory']['cache_bytes']/2**30:.2f} GiB), "
          f"flops {record['cost']['flops']:.3e}")
    _write(out_path, record)
    return record


def _write(path: str, record: dict) -> None:
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(record, f, indent=1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="dryrun_results")
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args()

    if args.all:
        from repro_torch.configs import ARCH_IDS, SHAPES
        failures = []
        for arch in ARCH_IDS:
            for shape in SHAPES:
                mesh_tag = "pod2x16x16" if args.multi_pod else "pod16x16"
                out = os.path.join(args.out_dir,
                                   f"{arch}__{shape}__{mesh_tag}.json")
                if os.path.exists(out):
                    print(f"skip existing {out}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       "--out-dir", args.out_dir]
                if args.multi_pod:
                    cmd.append("--multi-pod")
                print(">>", " ".join(cmd), flush=True)
                r = subprocess.run(cmd, timeout=args.timeout)
                if r.returncode != 0:
                    failures.append((arch, shape))
                    print(f"!! FAILED {arch} × {shape}", flush=True)
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        print("all cells OK")
        return

    mesh_tag = "pod2x16x16" if args.multi_pod else "pod16x16"
    out = os.path.join(args.out_dir,
                       f"{args.arch}__{args.shape}__{mesh_tag}.json")
    run_cell(args.arch, args.shape, args.multi_pod, out)


if __name__ == "__main__":
    main()
