"""AdamW written out (no ``torch.optim``): float32 masters and moments.

The JAX package's ``repro.train.optimizer``: global-norm clipping, decoupled
weight decay, linear warm-up then cosine decay, and an optional bf16
gradient compression with error feedback. The update keeps the
reference's order of operations (clip, moments, bias correction,
``delta + wd·p``, then ``p − lr·delta``), with the schedule and the bias
corrections computed in float32 on the parameters' device (no host sync).

Parameters, gradients and moments are ``{name: tensor}`` maps (a model's
``named_parameters()``); the update writes the parameters and moments in
place (the reference returns new trees), which saves a model-sized copy.

Weight decay follows the rank of the reference's leaf, not the port's
tensor: the JAX package stacks every layer of a segment along a leading
layer axis, so a layer's norm scale (D,) is a (count, D) leaf there and is
decayed (``ndim >= 2``). A leaf named ``segments.*`` (the port's
``TransformerLM``: ``segments.<i>.<j>.<leaf>``) counts one more dimension;
``embed`` and ``head`` are matrices; ``final_ln`` is not decayed.

On a mesh the parameters, gradients and moments are DTensors with the
same placements (``models.sharding``): the update runs on the local
shards, and ``global_norm`` all-reduces the local sums of squares over the
mesh, each replicated shard counted once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import sharding as S

Tensors = Dict[str, torch.Tensor]

#: Elements a group of ``torch._foreach_*`` updates covers: its float32
#: temporaries stay near 1 GiB whatever the model's size.
_GROUP_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # gradient compression for the DP all-reduce (bf16 + error feedback)
    compress_grads: bool = False


class OptState(NamedTuple):
    step: torch.Tensor           # scalar int32
    m: Tensors                   # first moment, float32, mirrors params
    v: Tensors                   # second moment, float32, mirrors params
    err: Optional[Tensors]       # error-feedback residual (compress_grads)


def decayed(name: str, p: torch.Tensor) -> bool:
    """Whether AdamW decays ``name``: the reference decays leaves of rank
    ≥ 2 ("matrices only"), and stacks a layer's leaves along their
    segment's layer axis, one more dimension than the port's tensor."""
    return p.dim() + (1 if name.startswith("segments.") else 0) >= 2


def init_opt_state(params: Mapping[str, torch.Tensor],
                   cfg: OptConfig) -> OptState:
    zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)
                     for n, p in params.items()}
    dev = next(iter(params.values())).device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev), zeros(),
                    zeros(), zeros() if cfg.compress_grads else None)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (float32): linear warm-up, then cosine
    decay to ``min_lr_ratio · lr`` at ``total_steps``."""
    step_f = torch.as_tensor(step).to(torch.float32)
    warm = step_f / max(cfg.warmup_steps, 1)
    prog = (step_f - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step_f < cfg.warmup_steps, warm, decay)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def _copies(t: torch.Tensor) -> int:
    """How many ranks hold each element of a DTensor (1 for a tensor)."""
    if not hasattr(t, "placements"):
        return 1
    sizes = tuple(t.device_mesh.mesh.shape)
    return math.prod(n for n, pl in zip(sizes, t.placements)
                     if getattr(pl, "dim", None) is None)


def global_norm(tensors) -> torch.Tensor:
    """√(Σ g²) over every tensor, float32: each tensor's sum of squares,
    as the reference writes it, accumulated in float64 and rounded once,
    so that one card and a mesh's shards, which sum in other orders, get
    clip factors that agree up to float32 rounding (their float64 totals
    may still differ in the last bits). (``torch._foreach_norm`` and
    ``linalg.vector_norm`` sum float32 in one running total on the CPU:
    2% off at 95M elements.) DTensors: the local sums, each over the
    number of ranks holding its shard, all-reduced over the mesh."""
    tensors = list(tensors)
    if not any(hasattr(t, "placements") for t in tensors):
        return _sqrt32(sum(_squares(t) for t in tensors))
    return _mesh_norm([_local(t) for t in tensors],
                      [_copies(t) for t in tensors], tensors[0].device_mesh)


def _squares(t: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(t.float()), dtype=torch.float64)


def _sqrt32(total: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(total).to(torch.float32)


def _mesh_norm(locals_, copies, mesh) -> torch.Tensor:
    total = sum(_squares(t) / c for t, c in zip(locals_, copies))
    sizes = tuple(mesh.mesh.shape)
    for i, n in enumerate(sizes):
        total = S.all_reduce(total, mesh.get_group(i), n)
    return _sqrt32(total)


def compress_bf16(grads: Mapping[str, torch.Tensor], err: Tensors
                  ) -> Tuple[Tensors, Tensors]:
    """bf16 quantization with error feedback: g_q = bf16(g + e); e' = g + e
    − g_q. Returns the quantized gradients and the new residuals."""
    comp, new_err = {}, {}
    for n, g in grads.items():
        total = g.float() + err[n]
        q = total.to(torch.bfloat16)
        comp[n], new_err[n] = q, total - q.float()
    return comp, new_err


def _groups(names: List[str], params: Mapping[str, torch.Tensor]
            ) -> List[List[str]]:
    """``names`` cut into consecutive groups of at most ``_GROUP_ELEMS``
    elements (a larger tensor alone)."""
    out, cur, size = [], [], 0
    for n in names:
        k = params[n].numel()
        if cur and size + k > _GROUP_ELEMS:
            out.append(cur)
            cur, size = [], 0
        cur.append(n)
        size += k
    return out + [cur] if cur else out


@torch.no_grad()
def apply_updates(params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], state: OptState,
                  cfg: OptConfig
                  ) -> Tuple[Mapping[str, torch.Tensor], OptState,
                             Dict[str, torch.Tensor]]:
    """One AdamW step; ``params`` and ``state``'s moments are updated in
    place. Returns the parameters, the new state and ``{"grad_norm",
    "lr"}`` (0-d float32 tensors)."""
    step = state.step + 1
    lr = schedule(cfg, step)
    names = list(params)
    mesh = next((p.device_mesh for p in params.values()
                 if hasattr(p, "device_mesh")), None)
    copies = {n: _copies(params[n]) for n in names}
    params = {n: _local(p) for n, p in params.items()}
    grads = {n: _local(g) for n, g in grads.items()}
    moments_m = {n: _local(t) for n, t in state.m.items()}
    moments_v = {n: _local(t) for n, t in state.v.items()}

    err = state.err
    if cfg.compress_grads:
        grads, new_err = compress_bf16(
            grads, {n: _local(t) for n, t in err.items()})
        if mesh is None:
            err = new_err
        else:                       # the residuals stay DTensors
            for n, t in new_err.items():
                _local(err[n]).copy_(t)

    if mesh is None:
        gnorm = global_norm([grads[n] for n in names])
    else:
        gnorm = _mesh_norm([grads[n] for n in names],
                           [copies[n] for n in names], mesh)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    step_f = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=step.device), step_f)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=step.device), step_f)

    for group in _groups(names, params):
        ps = [params[n] for n in group]
        ms = [moments_m[n] for n in group]
        vs = [moments_v[n] for n in group]
        g = torch._foreach_mul([grads[n].float() for n in group], clip)
        torch._foreach_mul_(ms, cfg.b1)
        torch._foreach_add_(ms, torch._foreach_mul(g, 1 - cfg.b1))
        g2 = torch._foreach_mul(g, 1 - cfg.b2)
        torch._foreach_mul_(g2, g)
        del g
        torch._foreach_mul_(vs, cfg.b2)
        torch._foreach_add_(vs, g2)
        del g2
        delta = torch._foreach_div(ms, b1c)                      # m̂
        den = torch._foreach_sqrt(torch._foreach_div(vs, b2c))   # √v̂
        torch._foreach_add_(den, cfg.eps)
        torch._foreach_div_(delta, den)
        del den
        dec = [i for i, n in enumerate(group) if decayed(n, ps[i])]
        if dec:
            wd = torch._foreach_mul([ps[i] for i in dec], cfg.weight_decay)
            torch._foreach_add_([delta[i] for i in dec], wd)
            del wd
        torch._foreach_mul_(delta, lr)
        torch._foreach_sub_(ps, delta)
    stats = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step, state.m, state.v, err), stats
