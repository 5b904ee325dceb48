#!/usr/bin/env python3
"""``chip_smoke.py`` phase 23's full-depth qwen3-32b generate on four GPUs
for this tree and another (for example a parent commit), alternating.

    python3 tools/serve_ab.py PARENT          # PARENT: a checkout of this repo
    python3 tools/serve_ab.py --gen SRC TAG   # one tree's generate alone

Unpack the other tree with ``git archive`` into a directory that
``.gitignore`` lists first. The script runs phases 0 and 1 (this tree's
kernels, copied into the other tree's ``kernels/build/``: the CUDA sources
must be the same), then the other tree's generate, this tree's phase 23,
this tree's generate and the other tree's again, each generate in a
process of its own: this tree's ``chip_smoke.lm_mesh_rank`` (its
``generate`` part, ``SERVE_GENERATE``) with that tree's ``src`` first on
``sys.path``, printed by ``chip_smoke.hold_serve_generate`` (whose gates
a tree that keeps the residual whole fails after printing: reported, not
fatal here). Each step prints the host's CPU count, model and load.
"""
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def host(tag: str) -> None:
    import chip_smoke as C
    name = [line for line in open("/proc/cpuinfo")
            if line.startswith("model name")]
    C.log(f"[{tag}] host: {os.cpu_count()} cpus, "
          f"{name[0].strip() if name else '?'}, load {os.getloadavg()}")


def one_generate(src: str, tag: str) -> None:
    """One tree's full-depth generate on four cards (NCCL, mesh (2, 2))."""
    sys.path[:0] = [src, str(ROOT)]
    import torch

    import chip_smoke as C
    torch.backends.cuda.matmul.allow_tf32 = False
    import repro_torch
    from repro_torch import configs
    from repro_torch.launch.world import run_world
    C.log(f"[{tag}] repro_torch from {repro_torch.__file__}")
    cfg = configs.get_config(C.SERVE_MESH_ARCH)
    spec = {"arch": C.SERVE_MESH_ARCH, "mesh": (2, 2), "check_layers": 0,
            "serve_layers": None, "train_steps": 0, "seed": 0,
            "batch": C.SERVE_GENERATE[0], "seq": C.SERVE_GENERATE[1],
            "prompt": None, "new": 0, "faults": (),
            "generate": C.SERVE_GENERATE}
    ranks = run_world(C.lm_mesh_rank, 4, backend="nccl", device="cuda",
                      args=(spec,), timeout_s=300.0, join_timeout_s=900.0)
    try:
        C.hold_serve_generate(f"[{tag}]", cfg, ranks, 4, {}, None)
    except SystemExit as e:
        C.log(f"[{tag}] {e}")


def generate(src: Path, tag: str) -> None:
    import chip_smoke as C
    host(tag)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, __file__, "--gen", str(src), tag])
    C.log(f"[{tag}] exit {r.returncode}, {time.perf_counter() - t0:.1f}s")


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as C
    other = Path(sys.argv[1]).resolve() / "src"
    card = C.phase0_card()
    C.phase1_build()
    build = ROOT / "src/repro_torch/kernels/build"
    dst = other / "repro_torch/kernels/build"
    dst.mkdir(parents=True, exist_ok=True)
    for so in build.glob("*.so"):
        shutil.copy(so, dst / so.name)
    torch.backends.cuda.matmul.allow_tf32 = False
    generate(other, "parent 1")
    t0 = time.perf_counter()
    host("phase 23")
    try:
        C.phase23_serve_cards(4, 0)
    except SystemExit as e:
        C.log(f"[phase 23] {e}")
    C.log(f"[phase 23] {time.perf_counter() - t0:.1f}s")
    generate(ROOT / "src", "change 2")
    generate(other, "parent 2")
    print(card["smi"])


if __name__ == "__main__":
    if sys.argv[1] == "--gen":
        one_generate(sys.argv[2], sys.argv[3])
    else:
        main()
