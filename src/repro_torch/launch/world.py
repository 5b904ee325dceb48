"""Start a process group of ranks on one host and collect their results.

    results = run_world(fn, 2, backend="gloo", args=(...,))

runs ``fn(*args)`` on every rank of a fresh world of ``world_size``
processes and returns each rank's return value, in rank order. The ranks
are started by ``torch.multiprocessing`` with the ``spawn`` start method
(a parent that has initialised CUDA cannot ``fork``); they meet through a
``FileStore`` in a temporary directory of their own, not a TCP port, so
two worlds on one host never collide; ``init_process_group`` gets a
bounded ``timeout``, and the parent's join a deadline after which every
rank is killed and the call raises. A rank that raises fails the call
with its traceback. Nothing falls back: a group that does not start
raises.

``fn`` and its arguments are pickled into the children, so ``fn`` must be
importable by name (a module-level function). Results come back through
files in the same directory (``pickle``): CPU tensors and numpy arrays.

On one card, ``device="cuda:0"`` puts every rank on that card (a gloo
world: NCCL refuses two ranks on one GPU); ``device="cuda"`` gives rank r
card ``r mod device_count``, the layout of an NCCL world.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def init_world(rank: int, world_size: int, store_path: str, *,
               backend: str = "gloo", timeout_s: float = 60.0) -> None:
    """Join rank ``rank`` of a ``world_size`` world that meets at the
    ``FileStore`` ``store_path``; a rank that does not arrive within
    ``timeout_s`` fails the others' first collective."""
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str,
               tmp: str, timeout_s: float, args: Sequence[Any],
               device: Optional[str]) -> None:
    if device is not None and device.startswith("cuda"):
        dev = torch.device(device)
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    init_world(rank, world_size, os.path.join(tmp, "store"),
               backend=backend, timeout_s=timeout_s)
    try:
        out = fn(*args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, world_size: int, *, backend: str = "gloo",
              args: Sequence[Any] = (), device: Optional[str] = None,
              timeout_s: float = 60.0, join_timeout_s: float = 600.0
              ) -> List[Any]:
    """``fn(*args)`` on each rank of a spawned world; the ranks' return
    values in rank order. Raises if a rank raises or dies, or if the world
    has not finished ``join_timeout_s`` seconds after it started (every
    rank is then killed)."""
    with tempfile.TemporaryDirectory(prefix="repro_world_") as tmp:
        ctx = mp.start_processes(
            _rank_main,
            args=(fn, world_size, backend, tmp, timeout_s, tuple(args),
                  device),
            nprocs=world_size, start_method="spawn", join=False)
        deadline = time.monotonic() + join_timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.05)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"a world of {world_size} ({backend}) ran past "
                        f"{join_timeout_s:.0f} s; its ranks were killed")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
