#!/usr/bin/env python3
"""``chip_smoke.py`` phase 23's full-depth qwen3-32b generate, or phase 24's
full-depth hymba-1.5b generate and training steps, on four GPUs for this
tree and another (for example a parent commit), alternating.

    python3 tools/serve_ab.py PARENT [--phase 24]   # PARENT: a checkout
    python3 tools/serve_ab.py --gen SRC TAG PHASE   # one tree's run alone

Unpack the other tree with ``git archive`` into a directory that
``.gitignore`` lists first. The script runs phases 0 and 1 (this tree's
kernels, copied into the other tree's ``kernels/build/``: the CUDA sources
must be the same), then the other tree's run, this tree's phase (23 or
24), this tree's run and the other tree's again, each run in a process of
its own: this tree's ``chip_smoke.lm_mesh_rank`` (its ``generate`` part,
``SERVE_GENERATE`` or ``ATTN_GENERATE``, and for phase 24 its ``train``
part, TRAIN_STEPS steps) with that tree's ``src`` first on ``sys.path``,
printed by ``chip_smoke.hold_serve_generate`` and
``chip_smoke.hold_mesh_train`` (whose gates a tree that lacks the change
may fail after printing: reported, not fatal here). Each step prints the
host's CPU count, model and load.
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


def one_run(src: str, tag: str, phase: int) -> None:
    """One tree's full-depth run on four cards (NCCL): phase 23's generate
    on (2, 2), or phase 24's generate and steps on (1, 4)."""
    sys.path[:0] = [src, str(ROOT)]
    import torch

    import chip_smoke as C
    torch.backends.cuda.matmul.allow_tf32 = False
    import repro_torch
    from repro_torch import configs
    from repro_torch.launch.world import run_world
    C.log(f"[{tag}] repro_torch from {repro_torch.__file__}")
    arch, mesh, gen, steps = (
        (C.SERVE_MESH_ARCH, (2, 2), C.SERVE_GENERATE, 0) if phase == 23
        else (C.ATTN_MESH_ARCH, C.ATTN_MESH, C.ATTN_GENERATE, C.TRAIN_STEPS))
    cfg = configs.get_config(arch)
    spec = {"arch": arch, "mesh": mesh, "check_layers": 0,
            "serve_layers": None, "train_steps": steps, "seed": 0,
            "batch": C.TRAIN_BATCH if steps else gen[0],
            "seq": C.TRAIN_SEQ if steps else gen[1],
            "prompt": None, "new": 0, "faults": (), "generate": gen}
    ranks = run_world(C.lm_mesh_rank, 4, backend="nccl", device="cuda",
                      args=(spec,), timeout_s=300.0, join_timeout_s=900.0)
    try:
        C.hold_serve_generate(f"[{tag}]", cfg, ranks, 4, {}, None,
                              gen=gen, mesh=mesh)
    except SystemExit as e:
        C.log(f"[{tag}] {e}")
    if steps:
        embed = cfg.vocab_size * cfg.d_model
        try:
            C.hold_mesh_train(f"[{tag}]", cfg, ranks, 4,
                              cfg.param_count() - embed,
                              "parameters less the embedding")
        except SystemExit as e:
            C.log(f"[{tag}] {e}")


def run(src: Path, tag: str, phase: int) -> None:
    import chip_smoke as C
    host(tag)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, __file__, "--gen", str(src), tag,
                        str(phase)])
    C.log(f"[{tag}] exit {r.returncode}, {time.perf_counter() - t0:.1f}s")


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as C
    other = Path(sys.argv[1]).resolve() / "src"
    phase = int(sys.argv[3]) if sys.argv[2:3] == ["--phase"] else 23
    card = C.phase0_card()
    C.phase1_build()
    build = ROOT / "src/repro_torch/kernels/build"
    dst = other / "repro_torch/kernels/build"
    dst.mkdir(parents=True, exist_ok=True)
    for so in build.glob("*.so"):
        shutil.copy(so, dst / so.name)
    torch.backends.cuda.matmul.allow_tf32 = False
    run(other, "parent 1", phase)
    t0 = time.perf_counter()
    host(f"phase {phase}")
    try:
        (C.phase23_serve_cards if phase == 23 else C.phase24_attn_cards)(4, 0)
    except (SystemExit, Exception) as e:
        C.log(f"[phase {phase}] {type(e).__name__}: {e}")
    C.log(f"[phase {phase}] {time.perf_counter() - t0:.1f}s")
    run(ROOT / "src", "change 2", phase)
    run(other, "parent 2", phase)
    print(card["smi"])


if __name__ == "__main__":
    if sys.argv[1] == "--gen":
        one_run(sys.argv[2], sys.argv[3], int(sys.argv[4]))
    else:
        main()
