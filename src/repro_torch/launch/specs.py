"""Stand-ins and sharded step builders for a (architecture × input shape ×
mesh) cell: the JAX package's ``repro.launch.specs``.

``input_specs(cfg, shape)`` gives the batch's stand-ins (tensors on
``"meta"``: shapes and dtypes, no memory); ``params_and_specs`` the
parameters' (``transformer.empty_params(device="meta")``) and their
specs; ``build_cell`` assembles ``(step, args, placements)``: train takes
``make_train_step``, prefill ``make_prefill_step``, decode
``make_serve_step`` (one token against a ``seq_len``-deep cache), each
with the DTensor placements of its arguments on a ``DeviceMesh``. Unlike
the reference's, which only lowers, the port's step runs: ``shard_args``
turns the stand-ins into this rank's (uninitialised) shards on a device,
and the step takes them, or any sharded model with the same layout
(``transformer.shard_params``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs import ShapeSpec
from repro_torch.models import sharding as sh
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import make_prefill_step, make_serve_step
from repro_torch.train.optimizer import OptConfig, OptState, init_opt_state
from repro_torch.train.trainer import TrainConfig, make_train_step


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the cell runs, else the reason it is skipped (the
    reference's ``configs.shape_applicable``)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full quadratic attention at 524k context — out of scope per "
                "assignment (sub-quadratic archs only)")
    return None


def _meta(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Batch stand-ins for one step at this input shape."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        if cfg.input_mode == "tokens":
            return {"token": _meta((b,), torch.int32)}
        return {"token": _meta((b, cfg.d_model), torch.float32)}
    batch: Dict[str, torch.Tensor] = {}
    if cfg.input_mode == "tokens":
        batch["tokens"] = _meta((b, s), torch.int32)
    else:
        batch["embeds"] = _meta((b, s, cfg.d_model), torch.float32)
    if shape.kind == "train":
        batch["labels"] = _meta((b, s), torch.int32)
    if cfg.mrope_sections is not None:
        batch["positions"] = _meta((3, b, s), torch.int32)
    return batch


def params_and_specs(cfg: ModelConfig, mesh, *, masters: bool = True):
    """The model's modules on ``"meta"`` and ``{name: spec}``."""
    pshape = T.empty_params(cfg, device="meta", masters=masters)
    return pshape, sh.param_specs(cfg, mesh, pshape)


def effective_config(cfg: ModelConfig, shape: ShapeSpec, mesh
                     ) -> ModelConfig:
    """``cfg`` as the cell runs it: pure DP (``dp_over_tp``) pays only when
    every rank owns whole sequences, so a batch the mesh does not divide
    falls back to the TP layout."""
    mesh_size = math.prod(sh.mesh_sizes(mesh).values())
    if cfg.dp_over_tp and shape.global_batch % mesh_size != 0:
        return dataclasses.replace(cfg, dp_over_tp=False)
    return cfg


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
               train: Optional[TrainConfig] = None
               ) -> Tuple[Any, Tuple, Tuple]:
    """(step, argument stand-ins, their placements) for one cell. The
    parameters' placements are ``{name: placements}``; AdamW's state is an
    ``OptState`` of them (its step replicated); a cache tree's and a
    batch's mirror their stand-ins. A train cell's step uses ``train``
    (the reference's default ``TrainConfig(opt=OptConfig())`` if None)."""
    cfg = effective_config(cfg, shape, mesh)
    batch = input_specs(cfg, shape)

    if shape.kind == "train":
        pshape, pspecs = params_and_specs(cfg, mesh, masters=True)
        pls = {n: sh.placements(mesh, s) for n, s in pspecs.items()}
        tcfg = train or TrainConfig(opt=OptConfig())
        step = make_train_step(cfg, tcfg)
        oshape = init_opt_state(dict(pshape.named_parameters()), tcfg.opt)
        rep = tuple(Replicate() for _ in mesh.mesh_dim_names)
        ols = OptState(rep, pls, pls, None)
        bspecs = sh.batch_specs(cfg, mesh, batch_size=shape.global_batch)
        bls = {k: sh.placements(mesh, bspecs[k]) for k in batch}
        return step, (pshape, oshape, batch), (pls, ols, bls)

    pshape, pspecs = params_and_specs(cfg, mesh, masters=False)
    pls = {n: sh.placements(mesh, s) for n, s in pspecs.items()}
    cshape = T._cache_shapes(cfg, shape.global_batch, shape.seq_len)
    cls = sh.shardings(mesh, sh.cache_specs(cfg, mesh, cshape))
    if shape.kind == "prefill":
        bspecs = sh.batch_specs(cfg, mesh, batch_size=shape.global_batch)
        bls = {k: sh.placements(mesh, bspecs[k]) for k in batch}
        return make_prefill_step(cfg), (pshape, batch, cshape), \
            (pls, bls, cls)

    # decode: one new token against a seq_len-deep cache
    tok = batch["token"]
    dp = sh.pick_axes(mesh, tok.shape[0], ("pod", "data"))
    tok_spec = (dp,) if tok.dim() == 1 else (dp, None)
    rep = tuple(Replicate() for _ in mesh.mesh_dim_names)
    return make_serve_step(cfg), (pshape, tok, cshape, 0), \
        (pls, sh.placements(mesh, tok_spec), cls, rep)


def _shard(t: torch.Tensor, mesh, pls, device) -> DTensor:
    """An uninitialised (zero) DTensor of ``t``'s shape with placements
    ``pls``: this rank's shard alone on ``device``."""
    local = torch.zeros(sh.local_shape(t.shape, mesh, pls), dtype=t.dtype,
                        device=device)
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=t.shape, stride=t.stride())


def shard_args(cfg: ModelConfig, shape: ShapeSpec, mesh, args: Tuple,
               placements_: Tuple, *, device) -> Tuple:
    """``build_cell``'s stand-ins as this rank's shards on ``device``
    (zeros; under ``FakeTensorMode`` fakes with no memory): the sharded
    model (``transformer.shard_params``), AdamW's state over it, the batch
    or token as DTensors, and the caches as ``transformer.init_cache``
    makes them on the mesh (``build_cell``'s cache placements are the
    reference's rule; a split GQA's K/V and a split SSM's state and conv
    inputs are held by this rank's own heads instead,
    ``sharding.HeadCache``)."""
    cfg = effective_config(cfg, shape, mesh)

    def tree(t, pls):
        if isinstance(t, dict):
            return {k: tree(v, pls[k]) for k, v in t.items()}
        return _shard(t, mesh, pls, device)

    params = T.shard_params(cfg, args[0], mesh,
                            batch_size=shape.global_batch, device=device)
    if shape.kind == "train":
        opt = init_opt_state(dict(params.named_parameters()), OptConfig())
        return params, opt, tree(args[2], placements_[2])
    caches = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                          device=device, mesh=mesh)
    if shape.kind == "prefill":
        return params, tree(args[1], placements_[1]), caches
    return (params, _shard(args[1], mesh, placements_[1], device),
            caches, args[3])


def argument_bytes(args: Any) -> int:
    """Bytes of this rank's shards of every tensor in ``args`` (a sharded
    model, an ``OptState``, nested dicts and tuples of (D)Tensors)."""
    if isinstance(args, torch.nn.Module):
        return argument_bytes(list(args.parameters()))
    if isinstance(args, dict):
        return argument_bytes(list(args.values()))
    if isinstance(args, (tuple, list)):
        return sum(argument_bytes(a) for a in args)
    if isinstance(args, sh.HeadCache):
        return argument_bytes(args.to_local())
    if isinstance(args, torch.Tensor):
        t = args.to_local() if hasattr(args, "to_local") else args
        return t.numel() * t.element_size()
    return 0
