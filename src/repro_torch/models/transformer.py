"""LM assembly: embeddings, segments of layers, the head, the loss.

Public entry points (the JAX package's ``repro.models.transformer``, for
layers of a GQA, MLA, SSM or hybrid mixer and an MLP, MoE or no FFN, on
token or embedding input):
  - ``init_params``          weights drawn from a ``torch.Generator``
  - ``params_from_reference`` the JAX package's parameter tree (numpy) as
                             this port's modules
  - ``params_to_reference``  the inverse: a numpy tree in the JAX layout
  - ``empty_params``         the modules, uninitialised (on ``"meta"``: the
                             shapes alone, no memory)
  - ``forward_hidden``       (B, S, D) final hidden states (+ MoE aux loss)
  - ``lm_loss``              token-chunked cross-entropy (+ aux), never all
                             (T, V) logits at once
  - ``init_cache``           decode caches for all segments
  - ``prefill``              fill the caches from a prompt, last logits
  - ``decode_step``          one token against the caches

Serving holds the weights in ``cfg.dtype`` without gradients and runs
under ``torch.no_grad``. Training holds float32 masters that take a
gradient (``masters=True``); ``forward_hidden(training=True)`` and
``lm_loss`` cast each master to ``cfg.dtype`` under autograd, as the JAX
package's ``_cast_params`` does, so the gradients arrive in float32,
rounded through ``cfg.dtype``. Each layer then runs under ``cfg.remat``
(``torch.utils.checkpoint``). A layer is an ``nn.Module``, a segment a
``ModuleList``, and layers run in a Python loop (the JAX package scans
them). Caches are updated in place and returned.

On a ``torch.distributed`` mesh (``shard_params``, or ``init_params(...,
mesh=)``) the parameters are DTensors in the reference's FSDP×TP layout
(``models.sharding``) and the model carries its ``sharding.Layout``;
every entry point below then runs this rank's share: ``lm_loss`` on the
batch rows ``batch_specs`` gives it (the CE's token count and the MoE aux
loss's statistics summed over the batch ranks; at a sequence of 2,048 or
more that the model axis divides, the residual between layers split over
the sequence too; the embedding and the loss on this rank's vocab shard
where the model axis splits the vocab), ``init_cache`` makes
``cache_specs``' DTensor caches (a split GQA's K/V held by this rank's
own KV heads instead, a split SSM's state and conv inputs by its own SSD
heads), and ``prefill`` and ``decode_step`` run
the rows of the caches' batch split (a prefill's residual split over the
sequence by training's rule, the embedding and the head on this rank's
vocab shard) and return DTensor logits, split over the vocab on
``model`` where the head is. Batches come whole (the global batch on
every rank) or as DTensors.

Entry points run on the card unless given ``device="cpu"``; without a card
they raise.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils import checkpoint as ckpt

from repro_torch.models import layers as L
from repro_torch.models import sharding as S
from repro_torch.models.config import ModelConfig, Segment
from repro_torch.utils import DeviceLike, resolve_device

Caches = Dict[str, Dict[str, torch.Tensor]]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


#: the mixers, FFNs and input modes of the JAX package's layers
MIXERS = {"gqa": (L.GQA, L.init_gqa), "mla": (L.MLA, L.init_mla),
          "ssm": (L.SSM, L.init_ssm), "hybrid": (L.Hybrid, L.init_hybrid)}
FFNS = ("mlp", "moe", "none")
INPUT_MODES = ("tokens", "embeds")


def check_layers(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a mixer, FFN or input mode that the JAX
    package does not have either."""
    bad = sorted({(s.mixer, s.ffn) for s in cfg.segments
                  if s.mixer not in MIXERS or s.ffn not in FFNS})
    if bad or cfg.input_mode not in INPUT_MODES:
        raise ValueError(
            f"{cfg.name}: unknown layers {bad} or input "
            f"{cfg.input_mode!r}; mixers {sorted(MIXERS)}, FFNs {FFNS}, "
            f"inputs {INPUT_MODES}")


Mixer = Union[L.GQA, L.MLA, L.SSM, L.Hybrid]
FFN = Union[L.MLP, L.MoE]


class Layer(nn.Module):
    """Pre-norm residual layer: x + mixer(norm(x)), then x + ffn(norm(x)).
    Returns the new x and the FFN's MoE aux loss (None for an MLP). A
    layer without an FFN (Mamba2's) has no ``ln2`` and ``ffn`` is None.

    ``seq`` (a training step on a mesh whose residual is split over the
    sequence: ``sharding.Layout.sequence``): x is this rank's part of the
    sequence, and the norms and residual adds run on it. A block split
    over the model axis (an MoE split over its experts, an SSM or a
    hybrid over its heads, whose scan reads the sequence its entry
    gathers, too) enters and exits through ``seq``; any other runs whole
    on the gathered sequence
    and keeps this rank's part of its output (``ModelSplit.whole`` /
    ``own``). An MoE's router and aux loss so see the whole sequence, as
    without the split."""

    def __init__(self, cfg: ModelConfig, seg: Segment, mixer: Mixer,
                 ffn: Optional[FFN]) -> None:
        super().__init__()
        self.cfg, self.window = cfg, seg.window
        w = next(mixer.parameters())
        kw = dict(device=w.device, dtype=w.dtype, fill=1.0)
        self.ln1 = L.param(cfg.d_model, **kw)
        self.mixer = mixer
        if ffn is not None:
            self.ln2 = L.param(cfg.d_model, **kw)
        self.ffn = ffn

    def forward(self, x: torch.Tensor, rope, cache=None, pos=None,
                seq=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cos, sin = rope
        eps = self.cfg.norm_eps
        mix = self._block(self.mixer, L.rmsnorm(x, self.ln1, eps), seq,
                          cos, sin, window=self.window, cache=cache,
                          pos=pos)[0]
        x = x + mix
        if self.ffn is None:
            return x, None
        y = self._block(self.ffn, L.rmsnorm(x, self.ln2, eps), seq)
        if isinstance(self.ffn, L.MoE):
            y, aux = y
            return x + y, aux
        return x + y, None

    @staticmethod
    def _block(block: nn.Module, h: torch.Tensor, seq, *args, **kwargs):
        if seq is None:
            return block(h, *args, **kwargs)
        if getattr(block, "tp", None) is not None:
            return block(h, *args, tp=seq, **kwargs)
        out = block(seq.whole(h), *args, **kwargs)
        if isinstance(out, tuple):            # (output, cache or aux)
            return (seq.own(out[0]),) + out[1:]
        return seq.own(out)


class TransformerLM(nn.Module):
    """The parameters of one model: ``embed`` (V, D) for token input,
    ``head`` (D, V) unless tied, ``final_ln`` (D,), and ``segments[i][j]``
    the ``Layer`` j of segment i. A model on embedding input
    (``input_mode="embeds"``) has no ``embed``, as in the JAX package
    (whose ``param_count`` counts one all the same)."""

    def __init__(self, cfg: ModelConfig, segments: nn.ModuleList, *,
                 device, dtype: torch.dtype) -> None:
        super().__init__()
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab_size
        if cfg.input_mode == "tokens":
            self.embed = L.param(v, d, device=device, dtype=dtype)
        if not cfg.tie_embeddings:
            self.head = L.param(d, v, device=device, dtype=dtype)
        self.final_ln = L.param(d, device=device, dtype=dtype, fill=1.0)
        self.segments = segments

    @property
    def device(self) -> torch.device:
        return self.final_ln.device

    def head_matrix(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.head


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer(cfg: ModelConfig, seg: Segment, dev: torch.device,
           dtype: torch.dtype, generator: Optional[torch.Generator]
           ) -> Layer:
    """One layer of ``seg``: drawn from ``generator`` (mixer, then FFN, as
    the JAX package splits its key), or uninitialised without one."""
    kw = dict(dtype=dtype)
    empty, init = MIXERS[seg.mixer]
    ffn = None
    if generator is not None:
        mixer = init(cfg, generator, **kw)
        if seg.ffn == "moe":
            ffn = L.init_moe(cfg, generator, **kw)
        elif seg.ffn == "mlp":
            ffn = L.init_mlp(cfg, generator, seg.d_ff, **kw)
    else:
        mixer = empty(cfg, device=dev, **kw)
        if seg.ffn == "moe":
            ffn = L.MoE(cfg, device=dev, **kw)
        elif seg.ffn == "mlp":
            ffn = L.MLP(cfg, seg.d_ff, device=dev, **kw)
    return Layer(cfg, seg, mixer, ffn)


def _weights_dtype(cfg: ModelConfig, masters: bool) -> torch.dtype:
    return torch.float32 if masters else _dtype(cfg)


def empty_params(cfg: ModelConfig, *, device: DeviceLike = "cuda",
                 masters: bool = False) -> TransformerLM:
    """The modules of ``cfg`` in ``cfg.dtype`` on ``device`` (float32
    masters that take a gradient with ``masters=True``), their weights
    uninitialised (norms 1). ``device="meta"`` gives the shapes alone, with
    no memory: ``sum(p.numel() for p in model.parameters())`` counts a
    full-width model."""
    check_layers(cfg)
    dev = torch.device(device) if str(device) == "meta" \
        else resolve_device(device)
    dtype = _weights_dtype(cfg, masters)
    segments = nn.ModuleList(
        nn.ModuleList(_layer(cfg, seg, dev, dtype, None)
                      for _ in range(seg.count)) for seg in cfg.segments)
    return TransformerLM(cfg, segments, device=dev,
                         dtype=dtype).requires_grad_(masters)


def init_params(cfg: ModelConfig, generator: "torch.Generator | int" = 0, *,
                device: DeviceLike = "cuda", masters: bool = False,
                mesh=None, batch_size: Optional[int] = None
                ) -> TransformerLM:
    """Weights of ``cfg`` in ``cfg.dtype`` on ``device``: N(0, 0.02²) (the
    output projections scaled by 1/√(2·n_layers), a MoE router N(0,
    0.006²), an SSM's as ``layers.init_ssm``), norms 1, biases 0, as the
    JAX package's ``init_params``. With ``masters=True`` they stay float32
    (the draws unrounded) and take a gradient: the trainer's masters.
    ``generator`` is a ``torch.Generator`` on ``device`` or an int seed for
    one; it cannot replay ``jax.random``, so the two packages draw
    different weights from the same seed (the tests carry weights across
    with ``params_from_reference``).

    With ``mesh`` (a ``DeviceMesh``; ``batch_size`` the training batch's,
    see ``shard_params``) every rank draws each tensor whole, in the same
    order, keeps its shard and frees the rest before the next layer: the
    shards of the unsharded draws, with one layer (and ``embed``) whole
    at a time."""
    check_layers(cfg)
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, device {dev}")
    dtype = _weights_dtype(cfg, masters)
    layout = None if mesh is None else S.Layout(
        cfg, mesh, empty_params(cfg, device="meta", masters=masters),
        batch_size=batch_size)
    segments = nn.ModuleList()
    model = TransformerLM(cfg, segments, device=dev, dtype=dtype)
    model.requires_grad_(masters)
    if cfg.input_mode == "tokens":
        L.normal_(model.embed, generator)
    if not cfg.tie_embeddings:
        L.normal_(model.head, generator)
    if layout is not None:
        _shard_module(model, "", layout, dev)
    for i, seg in enumerate(cfg.segments):
        layers = nn.ModuleList()
        segments.append(layers)
        for j in range(seg.count):
            layer = _layer(cfg, seg, dev, dtype, generator)
            layer.requires_grad_(masters)
            if layout is not None:
                _shard_module(layer, f"segments.{i}.{j}.", layout, dev)
            layers.append(layer)
    if layout is not None:
        _attach(model, layout)
    return model


# ---------------------------------------------------------------------------
# the JAX package's parameter tree
# ---------------------------------------------------------------------------

Path = Tuple[str, ...]


def reference_paths(names) -> Dict[Path, List[str]]:
    """Each leaf of the JAX package's parameter tree (its path of dict
    keys) and the port's parameter names that fill it, in the reference's
    flatten order (keys sorted at every level). ``segments.<i>.<j>.<rest>``
    is layer j of the stacked leaf ``("segments", "seg<i>", *rest)``
    (``rest`` may nest: ``ffn.experts.wg``); any other name is its own
    leaf. The same map serves the parameters and AdamW's moments."""
    paths: Dict[Path, List[str]] = {}
    stacked: Dict[Path, Dict[int, str]] = {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "segments":
            path = ("segments", f"seg{parts[1]}", *parts[3:])
            stacked.setdefault(path, {})[int(parts[2])] = name
        else:
            paths[tuple(parts)] = [name]
    for path, layers in stacked.items():
        if sorted(layers) != list(range(len(layers))):
            raise ValueError(f"layers {sorted(layers)} of {path}")
        paths[path] = [layers[j] for j in range(len(layers))]
    return {p: paths[p] for p in sorted(paths)}


def _is_stacked(path: Path) -> bool:
    return path[0] == "segments"


def _named(params: Union[TransformerLM, Mapping[str, torch.Tensor]]
           ) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def params_to_reference(cfg: ModelConfig,
                        params: Union[TransformerLM,
                                      Mapping[str, torch.Tensor]], *,
                        lazy: bool = False) -> Dict[str, Any]:
    """``params`` (the modules, or a ``{name: tensor}`` map such as AdamW's
    moments) as the JAX package's tree of numpy arrays, each segment's
    layers stacked along a leading axis (copies, never views of the
    tensors): the inverse of ``params_from_reference`` (float32 masters
    round-trip bit for bit; bf16 comes out as float32, which numpy can
    hold). DTensors (a model on a mesh) are gathered whole, one tensor at
    a time; with ``lazy`` each leaf is a function that builds it, for
    ``checkpoint.save`` to call as it writes."""
    named = _named(params)

    def host(name: str) -> np.ndarray:
        t = S.whole(named[name].detach())
        # a copy: a CPU tensor's .numpy() would share the live weights
        t = t.cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    def leaf(path: Path, names: List[str]) -> np.ndarray:
        return np.stack([host(n) for n in names]) if _is_stacked(path) \
            else host(names[0])

    if lazy:
        return _reference_tree(named, lambda path, names: functools.partial(
            leaf, path, names))
    return _reference_tree(named, leaf)


def reference_like(params: Union[TransformerLM, Mapping[str, torch.Tensor]]
                   ) -> Dict[str, Any]:
    """``params_to_reference``'s tree with its shapes alone: each leaf an
    empty tensor on ``"meta"`` (no memory, no copy), for a checkpoint's
    ``restore(like=...)``."""
    named = _named(params)

    def shape(path: Path, names: List[str]) -> torch.Tensor:
        lead = (len(names),) if _is_stacked(path) else ()
        return torch.empty(lead + tuple(named[names[0]].shape),
                           device="meta")
    return _reference_tree(named, shape)


def _reference_tree(named: Mapping[str, torch.Tensor], leaf
                    ) -> Dict[str, Any]:
    """The nested dict of ``leaf(path, names)`` at each reference path."""
    tree: Dict[str, Any] = {}
    for path, names in reference_paths(named).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf(path, names)
    return tree


def _count_leaves(tree: Any) -> int:
    if isinstance(tree, Mapping):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def load_reference(params: Union[TransformerLM, Mapping[str, torch.Tensor]],
                   tree: Mapping[str, Any]) -> None:
    """Copy the JAX package's tree (numpy leaves, or anything
    ``np.asarray`` reads) into ``params``' tensors in place, each rounded
    to its tensor's dtype. Every leaf must have its tensor, and the shapes
    must agree. A DTensor (a model on a mesh) takes its shard of the
    leaf."""
    named = _named(params)
    paths = reference_paths(named)
    if _count_leaves(tree) != len(paths):
        raise ValueError(f"the tree holds {_count_leaves(tree)} leaves, the "
                         f"parameters fill {len(paths)}")

    def put(w: torch.Tensor, a) -> None:
        if tuple(np.shape(a)) != tuple(w.shape):
            raise ValueError(f"reference leaf of shape {tuple(np.shape(a))} "
                             f"for a weight of shape {tuple(w.shape)}")
        if hasattr(w, "to_local"):
            a = S.local_slice(a, w.device_mesh, w.placements,
                              w.device_mesh.get_coordinate())
        a = torch.from_numpy(np.array(a))
        with torch.no_grad():
            (w.to_local() if hasattr(w, "to_local") else w).copy_(a)

    for path, names in paths.items():
        leaf = tree
        for key in path:
            leaf = leaf[key]
        if _is_stacked(path):
            for j, name in enumerate(names):
                put(named[name], np.asarray(leaf)[j])
        else:
            put(named[names[0]], leaf)


def params_from_reference(cfg: ModelConfig, tree: Mapping[str, Any], *,
                          device: DeviceLike = "cuda",
                          masters: bool = False) -> TransformerLM:
    """The JAX package's parameter tree as this port's modules.

    ``tree`` is ``repro.models.transformer.init_params``'s output with its
    leaves as numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``):
    ``embed`` (token input), ``head``, ``final_ln`` and
    ``segments.seg<i>.{ln1, mixer, ln2, ffn}`` (no ``ln2`` and ``ffn``
    without an FFN), each stacked along the segment's layer axis (the
    MoE's ``experts`` and ``shared`` and the hybrid's ``attn`` and ``ssm``
    are nested dicts there, submodules here).
    Leaves are rounded to ``cfg.dtype``, as the JAX package casts them at
    the forward boundary; with ``masters=True`` they load unrounded as
    float32 masters that take a gradient."""
    model = empty_params(cfg, device=device, masters=masters)
    load_reference(model, tree)
    return model


# ---------------------------------------------------------------------------
# a mesh: the reference's FSDP×TP layout (models.sharding)
# ---------------------------------------------------------------------------

def layout_of(params: TransformerLM) -> Optional[S.Layout]:
    """The ``sharding.Layout`` of a model on a mesh, None for one card."""
    return getattr(params, "layout", None)


def _shard_module(module: nn.Module, prefix: str, layout: S.Layout,
                  device: Optional[torch.device]) -> None:
    """Each parameter of ``module`` (named ``prefix`` + its name in the
    model) replaced by a DTensor parameter holding this rank's shard, a
    copy; the whole tensor is freed when nothing else holds it. A
    parameter on ``"meta"`` gets an uninitialised shard on ``device``."""
    from torch.distributed.tensor import DTensor
    for name, p in list(module.named_parameters()):
        pls = layout.plans[prefix + name].placements
        if p.device.type == "meta":
            local = torch.empty(S.local_shape(p.shape, layout.mesh, pls),
                                dtype=p.dtype, device=device)
        else:
            local = S.local_slice(p.detach(), layout.mesh, pls,
                                  layout.coord).clone()
        dt = DTensor.from_local(local, layout.mesh, pls, run_check=False,
                                shape=p.shape,
                                stride=torch.empty(p.shape,
                                                   device="meta").stride())
        owner, leaf = (module.get_submodule(name.rsplit(".", 1)[0]),
                       name.rsplit(".", 1)[1]) if "." in name \
            else (module, name)
        owner._parameters[leaf] = nn.Parameter(
            dt, requires_grad=p.requires_grad)


def _attach(model: TransformerLM, layout: S.Layout) -> None:
    """The layout on the model, the model-axis split on each block that
    runs split (an attention, an SSM, an MLP, an MoE over its experts, a
    hybrid whose attention and SSM both do), the batch statistics on each
    MoE."""
    for prefix in layout.split_blocks:
        model.get_submodule(prefix[:-1]).tp = layout.split
    for mod in model.modules():
        if isinstance(mod, L.MoE):
            mod.batch_stats = layout.batch_stats
        elif isinstance(mod, L.Hybrid) and mod.attn.tp is not None \
                and mod.ssm.tp is not None:
            mod.tp = layout.split
    model.layout = layout


def shard_params(cfg: ModelConfig, params: TransformerLM, mesh, *,
                 batch_size: Optional[int] = None,
                 device: DeviceLike = "cuda") -> TransformerLM:
    """``params`` on ``mesh``, in place: every parameter a DTensor with
    ``sharding.param_specs``' placements (this rank's shard a copy, the
    whole tensor freed as it goes), the model carrying its
    ``sharding.Layout``. ``batch_size`` is the training batch's (the axes
    ``batch_specs`` splits it over; None: all of FSDP's). A model on
    ``"meta"`` gets uninitialised shards on ``device`` (the card unless
    asked for the CPU); any other keeps its parameters' device."""
    dev = resolve_device(device) \
        if any(p.device.type == "meta" for p in params.parameters()) else None
    layout = S.Layout(cfg, mesh, params, batch_size=batch_size)
    _shard_module(params, "", layout, dev)
    _attach(params, layout)
    return params


def _rows(layout: S.Layout, t, axes: Tuple[int, ...], dim: int = 0
          ) -> torch.Tensor:
    """This rank's rows (along ``dim``) of a whole batch entry split over
    mesh dims ``axes``: a DTensor already split so is its local shard, any
    other DTensor is made whole first (an all-gather)."""
    if hasattr(t, "full_tensor"):
        want = tuple(getattr(pl, "dim", None) == dim if i in axes
                     else getattr(pl, "dim", None) is None
                     for i, pl in enumerate(t.placements))
        if all(want):
            return t.to_local()
        t = S.whole(t)
    t = torch.as_tensor(t)
    first, n = layout.rows(t.shape[dim], axes)
    return t.narrow(dim, first, n)


def _local_batch(layout: S.Layout, batch: Mapping[str, Any],
                 axes: Tuple[int, ...]) -> Dict[str, torch.Tensor]:
    """This rank's rows of every batch entry (``positions`` (3, B, S) along
    its dim 1)."""
    return {k: _rows(layout, v, axes,
                     len(v.shape) - 2 if k == "positions" else 0)
            for k, v in batch.items()}


def _dtensor(layout: S.Layout, local: torch.Tensor, spec: S.Spec,
             shape: Tuple[int, ...]):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(
        local, layout.mesh, S.placements(layout.mesh, spec), run_check=False,
        shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed(params: TransformerLM, tokens) -> torch.Tensor:
    return params.embed[torch.as_tensor(tokens, device=params.device).long()]


def _embed_inputs(cfg: ModelConfig, params: TransformerLM,
                  batch: Mapping[str, Any]) -> torch.Tensor:
    """(B, S, D) in ``cfg.dtype``: the embedded ``batch["tokens"]``, or
    ``batch["embeds"]`` for a model on embedding input."""
    if cfg.input_mode == "tokens":
        return _embed(params, batch["tokens"])
    return torch.as_tensor(batch["embeds"], device=params.device).to(
        _dtype(cfg))


def _sharded_inputs(cfg: ModelConfig, params: TransformerLM,
                    layout: S.Layout, inputs: torch.Tensor,
                    seq: Optional[S.ModelSplit]) -> torch.Tensor:
    """Serving's residual on a mesh from this rank's rows of ``inputs``
    (tokens (B, S), or embeds (B, S, D)), in ``cfg.dtype``: this rank's
    part of the sequence under ``seq``. A vocab-parallel embedding sums
    the model ranks' rows (``vocab_embedding``: an all-reduce, or a
    reduce-scatter into the part); a table the model axis does not split
    is gathered whole and embeds alike on every model rank."""
    if cfg.input_mode == "tokens":
        table = layout.use("embed", params.embed, None)
        if "embed" in layout.vocab_parallel:
            return S.vocab_embedding(inputs.long(), table,
                                     seq or layout.split)
        x = F.embedding(inputs.long(), table)
    else:
        x = inputs.to(_dtype(cfg))
    return x if seq is None else seq.part(x)


def _rope_for(cfg: ModelConfig, positions: torch.Tensor):
    return L.rope_tables(positions, cfg.rotary_dim, cfg.rope_theta,
                         cfg.mrope_sections)


def _prompt_rope(cfg: ModelConfig, batch: Mapping[str, Any],
                 x: torch.Tensor):
    """RoPE tables of ``batch["positions"]`` ((B, S), or (3, B, S) under
    M-RoPE) where given, else of 0..S−1 (plain RoPE, M-RoPE or not), for
    the (B, S) of x's first two dims (the whole sequence: a residual split
    over it meets the tables in blocks that see it gathered)."""
    if "positions" in batch:
        return _rope_for(cfg, torch.as_tensor(batch["positions"],
                                              device=x.device).long())
    b, s = x.shape[:2]
    return _rope_for(cfg, torch.arange(s, device=x.device)[None].expand(b, s))


def _run(params: TransformerLM, x: torch.Tensor, rope,
         caches: Optional[Caches], pos: Optional[int]
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x through every layer, and the summed MoE aux loss (float32)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, seg in enumerate(params.segments):
        c = caches[f"seg{i}"] if caches is not None else None
        for j, layer in enumerate(seg):
            # layer j's own cache: {"k","v"}, {"ckv","kr"}, {"state",
            # "conv"} or all four (hybrid)
            cache = {name: buf[j] for name, buf in c.items()} \
                if c is not None else None
            x, aux = layer(x, rope, cache, pos)   # writes into c in place
            if aux is not None:
                aux_total = aux_total + aux
    return x, aux_total


#: The matrix products whose outputs ``remat="dots"`` saves (the JAX
#: package's ``checkpoint_dots`` policy); everything else is recomputed.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _train_layer(cfg: ModelConfig, layer: Layer, x: torch.Tensor, rope,
                 layout: Optional[S.Layout] = None, prefix: str = "",
                 seq: Optional[S.ModelSplit] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``layer`` on x with gradients: each float32 master cast to
    ``cfg.dtype`` inside the function that ``cfg.remat`` wraps, so
    ``"full"`` recomputes the cast with the layer (the bf16 copies are not
    kept between forward and backward) and the gradients reach the
    masters through it. ``"dots"`` keeps the matrix products' outputs,
    ``"none"`` keeps everything; the three give the same values.

    On a mesh the function also all-gathers each cast shard
    (``layout.use``, ``prefix`` the layer's name in the model), so under
    ``"full"`` the gathered weights live only while the layer runs, in
    the forward and again in its recompute, and their gradients are
    reduce-scattered to the shards during the backward, layer by layer.
    With ``seq`` x is this rank's part of the sequence (``Layer``), the
    carry each layer keeps for its recompute."""
    names, masters = zip(*layer.named_parameters())
    dtype = _dtype(cfg)
    if layout is None:
        cast_fn = lambda n, w: w.to(dtype)                    # noqa: E731
    else:
        masters = tuple(w.to_local() for w in masters)
        cast_fn = lambda n, w: layout.use(                    # noqa: E731
            prefix + n, w, dtype, seq=seq is not None)

    def run(x_, *ws):
        cast = {n: cast_fn(n, w) for n, w in zip(names, ws)}
        return functional_call(layer, cast, (x_, rope), {"seq": seq})

    if cfg.remat == "none":
        return run(x, *masters)
    if cfg.remat == "full":
        return ckpt.checkpoint(run, x, *masters, use_reentrant=False)
    if cfg.remat == "dots":
        return ckpt.checkpoint(
            run, x, *masters, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"remat {cfg.remat!r}; options full, dots, none")


def _forward_train(cfg: ModelConfig, params: TransformerLM,
                   batch: Mapping[str, Any]
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[S.ModelSplit]]:
    """The final hidden states, the summed MoE aux loss, and the split of
    the residual over the sequence (None: the hidden states are whole
    over the sequence; else they are this rank's part of it)."""
    dtype = _dtype(cfg)
    layout = layout_of(params)
    tokens = cfg.input_mode == "tokens"
    if layout is not None:
        batch = _local_batch(layout, batch, layout.batch_axes)
    inputs = torch.as_tensor(batch["tokens" if tokens else "embeds"],
                             device=params.device)
    rope = _prompt_rope(cfg, batch, inputs)
    seq = None if layout is None else layout.sequence(inputs.shape[1])
    if layout is None:
        cast = lambda n, w: w.to(dtype)                       # noqa: E731
    else:
        cast = lambda n, w: layout.use(                       # noqa: E731
            n, w, dtype, seq=seq is not None)
    if tokens and layout is not None and "embed" in layout.vocab_parallel:
        # each model rank embeds the tokens of its vocab rows; the sum over
        # the ranks lands split over the sequence when seq is
        x = S.vocab_embedding(inputs.long(), cast("embed", params.embed),
                              seq or layout.split)
    else:
        # the gather as F.embedding: its backward on the card sums a
        # token's rows in a fixed order (indexing's backward, index_put_
        # with accumulate, adds with atomics in any order)
        x = F.embedding(inputs.long(), cast("embed", params.embed)) \
            if tokens else inputs.to(dtype)
        if seq is not None:
            x = seq.own(x)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, seg in enumerate(params.segments):
        for j, layer in enumerate(seg):
            x, aux = _train_layer(cfg, layer, x, rope, layout,
                                  f"segments.{i}.{j}.", seq)
            if aux is not None:
                aux_total = aux_total + aux
    return L.rmsnorm(x, cast("final_ln", params.final_ln),
                     cfg.norm_eps), aux_total, seq


def forward_hidden(cfg: ModelConfig, params: TransformerLM,
                   batch: Mapping[str, Any], *, training: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final hidden states (B, S, D) and the summed MoE aux loss (0 for a
    model without MoE layers). Serving (``training=False``) runs under
    ``torch.no_grad``; ``training=True`` records the graph, casting float32
    masters to ``cfg.dtype`` and wrapping each layer by ``cfg.remat``."""
    if training:
        h, aux, seq = _forward_train(cfg, params, batch)
        return (h if seq is None else seq.whole(h)), aux
    layout = layout_of(params)
    if layout is not None:
        with torch.no_grad():
            b = len(next(iter(batch.values())))
            batch = _local_batch(layout, batch, layout.cache_axes(b))
            inputs = _prompt_inputs(cfg, params, batch)
            seq = layout.sequence(inputs.shape[1])
            x, aux = _run_sharded(
                params, layout, _sharded_inputs(cfg, params, layout, inputs,
                                                seq),
                _prompt_rope(cfg, batch, inputs), None, None, seq)
            h = L.rmsnorm(x, layout.use("final_ln", params.final_ln, None),
                          cfg.norm_eps)
            return (h if seq is None else seq.gather(h)), aux
    with torch.no_grad():
        x = _embed_inputs(cfg, params, batch)
        x, aux = _run(params, x, _prompt_rope(cfg, batch, x), None, None)
        return L.rmsnorm(x, params.final_ln, cfg.norm_eps), aux


def _pick_chunk(t: int, want: int) -> int:
    c = min(want, t)
    while t % c != 0:
        c -= 1
    return c


def _chunk_nll(hc: torch.Tensor, lc: torch.Tensor,
               head: torch.Tensor) -> torch.Tensor:
    """Σ −log p(label) over one chunk's tokens (C, D) → scalar float32;
    labels < 0 count nothing. The (C, V) logits are formed in ``head``'s
    dtype, then float32, as the JAX package's ``lm_loss`` body."""
    logits = (hc @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, lc.clamp(min=0)[:, None])[:, 0]
    valid = (lc >= 0).float()
    return ((lse - gold) * valid).sum()


def lm_loss(cfg: ModelConfig, params: TransformerLM,
            batch: Mapping[str, Any]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-chunked cross-entropy plus the MoE aux loss: ``(loss, {"ce",
    "aux", "tokens"})``, float32 scalars. ``batch`` holds ``labels`` (B,
    S) (< 0 masked) beside the inputs. The T = B·S tokens go in chunks of
    ``_pick_chunk(T, cfg.loss_chunk)``; each chunk's logits are
    recomputed in the backward (``torch.utils.checkpoint``), so the (T, V)
    logits never exist at once.

    On a mesh whose model axis splits the head's vocab
    (``Layout.vocab_parallel``) each model rank keeps its head columns and
    forms only their logits (``sharding.VocabSplit.nll``); the hidden
    states are all-gathered over the sequence first when the residual is
    split over it, and the gradient into them is summed over the model
    axis (by that gather's backward, or by ``ModelSplit.enter``'s)."""
    h, aux, seq = _forward_train(cfg, params, batch)
    layout = layout_of(params)
    dtype = _dtype(cfg)
    nll = _chunk_nll
    if layout is None:
        head = params.head_matrix().to(dtype)
    else:
        batch = _local_batch(layout, batch, layout.batch_axes)
        head = _sharded_head(cfg, params, layout, dtype)
        if _head_name(cfg) in layout.vocab_parallel:
            h = (seq or layout.split).enter(h)
            nll = layout.vocab.nll
        elif seq is not None:
            h = seq.whole(h)
    b, s, d = h.shape
    t = b * s
    hf = h.reshape(t, d)
    labels = torch.as_tensor(batch["labels"],
                             device=h.device).long().reshape(t)
    chunk = _pick_chunk(t, cfg.loss_chunk)
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, t, chunk):
        nll_sum = nll_sum + ckpt.checkpoint(
            nll, hf[c0:c0 + chunk], labels[c0:c0 + chunk], head,
            use_reentrant=False)
    n_tok = (labels >= 0).sum().float()
    if layout is None:
        ce = nll_sum / torch.clamp(n_tok, min=1.0)
        return ce + aux, {"ce": ce, "aux": aux, "tokens": n_tok}
    # this rank's share of the global mean: its tokens' NLL over the global
    # token count; the shares (and their gradients) sum to the global loss
    # over the batch ranks, and are equal on the model ranks
    n_tok = layout.batch_stats.sum(n_tok)
    ce = nll_sum / torch.clamp(n_tok, min=1.0)
    share = ce + aux
    ce_all = layout.batch_stats.sum(ce.detach().clone())
    aux_all = layout.batch_stats.sum(aux.detach().clone())
    return share, {"ce": ce_all, "aux": aux_all, "tokens": n_tok,
                   "loss": ce_all + aux_all}


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int, *,
               device: DeviceLike = "cuda", mesh=None) -> Caches:
    """Zeroed caches for every segment, stacked along the layer count:
    ``{"seg<i>": {"k", "v"}}`` of (count, B, cache_len, Hkv·hd) for a GQA
    segment, ``{"ckv", "kr"}`` of (count, B, cache_len, kv_lora_rank) and
    (count, B, cache_len, qk_rope_dim) for an MLA one, ``{"state",
    "conv"}`` of (count, B, H, N, P) float32 and (count, B, K−1, C) for an
    SSM one, all four for a hybrid one. With ``mesh`` each buffer is a
    DTensor of zeros with ``sharding.cache_specs``' placements (this rank's
    shard alone is allocated), except the buffers of blocks that run split
    over the model axis by heads, each a ``sharding.HeadCache`` of this
    rank's batch rows and its own heads: a split GQA's K/V
    (``sharding.gqa_heads``), (count, B_local, cache_len, kvn·hd); a split
    SSM's (``sharding.ssm_heads``) state, (count, B_local, hn, N, P), and
    conv, (count, B_local, K−1, hn·P + 2·G·N), its heads' x channels and
    the B and C channels."""
    check_layers(cfg)
    dev = resolve_device(device)
    if mesh is not None:
        return _sharded_cache(cfg, batch_size, cache_len, dev, mesh)
    return {seg: {name: torch.zeros(meta.shape, dtype=meta.dtype, device=dev)
                  for name, meta in bufs.items()}
            for seg, bufs in _cache_shapes(cfg, batch_size,
                                           cache_len).items()}


def _head_held(cfg: ModelConfig, mesh) -> Dict[str, tuple]:
    """{buffer name: (every model rank's (first head, count), a head's
    width, the buffer's dim that holds the heads, the entries every rank
    holds after them)} of the cache buffers held by the rank's own heads
    (``sharding.HeadCache``)."""
    out: Dict[str, tuple] = {}
    gqa = S.gqa_heads(cfg, mesh)
    if gqa is not None:
        kv = ([(r[2], r[3]) for r in gqa], cfg.head_dim, 3, 0)
        out.update(k=kv, v=kv)
    ssm = S.ssm_heads(cfg, mesh)
    if ssm is not None:
        sc = cfg.ssm
        out.update(state=(ssm, 1, 2, 0),
                   conv=(ssm, sc.head_dim, 3, 2 * sc.n_groups * sc.d_state))
    return out


def _sharded_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
                   dev: torch.device, mesh) -> Caches:
    from torch.distributed.tensor import DTensor
    shapes = _cache_shapes(cfg, batch_size, cache_len)
    specs = S.cache_specs(cfg, mesh, shapes)
    held = _head_held(cfg, mesh)
    if held:
        model_dim = mesh.mesh_dim_names.index("model")
        rank = mesh.get_coordinate()[model_dim]
    out: Caches = {}
    for seg, bufs in shapes.items():
        out[seg] = {}
        for name, meta in bufs.items():
            spec = specs[seg][name]
            if name in held:
                # the batch split as the reference's; the rest this rank's
                # own heads
                heads, width, dim, shared = held[name]
                pls = S.placements(mesh, tuple(
                    a if i == 1 else None for i, a in enumerate(spec)))
                shape = list(S.local_shape(meta.shape, mesh, pls))
                shape[dim] = heads[rank][1] * width + shared
                out[seg][name] = S.HeadCache(
                    torch.zeros(shape, dtype=meta.dtype, device=dev),
                    meta.shape, mesh, pls, model_dim, heads, width, dim=dim,
                    shared=shared)
                continue
            pls = S.placements(mesh, spec)
            local = torch.zeros(S.local_shape(meta.shape, mesh, pls),
                                dtype=meta.dtype, device=dev)
            out[seg][name] = DTensor.from_local(
                local, mesh, pls, run_check=False, shape=meta.shape,
                stride=meta.stride())
    return out


def _cache_shapes(cfg: ModelConfig, batch_size: int, cache_len: int
                  ) -> Caches:
    """``init_cache``'s buffers on ``"meta"``: the shapes alone."""
    dtype = _dtype(cfg)
    out: Caches = {}
    for i, seg in enumerate(cfg.segments):
        shapes = {}
        if seg.mixer in ("gqa", "hybrid"):
            kv = (cache_len, cfg.n_kv_heads * cfg.head_dim)
            shapes.update(k=(kv, dtype), v=(kv, dtype))
        if seg.mixer == "mla":
            shapes.update(ckv=((cache_len, cfg.mla.kv_lora_rank), dtype),
                          kr=((cache_len, cfg.mla.qk_rope_dim), dtype))
        if seg.mixer in ("ssm", "hybrid"):
            sc, d = cfg.ssm, cfg.d_model
            shapes.update(
                state=((sc.n_heads(d), sc.d_state, sc.head_dim),
                       torch.float32),
                conv=((sc.conv_kernel - 1, sc.conv_channels(d)), dtype))
        out[f"seg{i}"] = {
            name: torch.empty((seg.count, batch_size) + shape, dtype=dt,
                              device="meta")
            for name, (shape, dt) in shapes.items()}
    return out


def _run_sharded(params: TransformerLM, layout: S.Layout, x: torch.Tensor,
                 rope, caches: Optional[Caches], pos: Optional[int],
                 seq: Optional[S.ModelSplit] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_run`` on a mesh, under ``torch.no_grad``: each layer's weights
    gathered as its plan says (``layout.use``) for the layer alone. With
    ``seq`` (a prefill whose residual is split over the sequence) x is
    this rank's part of it, and each layer crosses into its blocks as a
    training step's does (``Layer``): a split block gathers the sequence
    at its entry and writes its own heads' K/V of the whole prompt, a
    block that runs whole sees the gathered sequence. A split GQA's K/V
    and a split SSM's state and conv inputs (each a ``HeadCache``) hold
    this rank's own heads and are used as they are, with no collective. A
    cache buffer whose model-axis split is not the layer's own (an
    attention or an SSM that runs whole, MLA's latents, which every head
    reads, split over its heads or not) is all-gathered over ``model`` for
    the layer and this rank's part written back after it."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    tp = layout.model_dim
    for i, seg in enumerate(params.segments):
        c = caches[f"seg{i}"] if caches is not None else None
        for j, layer in enumerate(seg):
            prefix = f"segments.{i}.{j}."
            used = {n: layout.use(prefix + n, w, None)
                    for n, w in layer.named_parameters()}
            cache, back = None, []
            if c is not None:
                cache = {}
                for name, buf in c.items():
                    local = buf.to_local()[j]
                    dim = None if tp is None or isinstance(buf, S.HeadCache) \
                        else getattr(buf.placements[tp], "dim", None)
                    if dim is None:
                        cache[name] = local
                        continue
                    full = S.all_gather(local, layout.groups[tp],
                                        layout.sizes[tp], dim - 1)
                    cache[name] = full
                    back.append((local, full, dim - 1))
            x, aux = functional_call(layer, used, (x, rope, cache, pos),
                                     {"seq": seq})
            for local, full, dim in back:
                n = local.shape[dim]
                local.copy_(full.narrow(dim, layout.coord[tp] * n, n))
            if aux is not None:
                aux_total = aux_total + aux
    return x, aux_total


def _logits(cfg: ModelConfig, params: TransformerLM,
            h: torch.Tensor) -> torch.Tensor:
    """(B, V) float32 logits of the last position's hidden states; on a
    mesh, this rank's head columns' (B, V/m) where the model axis splits
    the head's vocab (a tied model's: its embedding shard's rows)."""
    layout = layout_of(params)
    if layout is None:
        h = L.rmsnorm(h, params.final_ln, cfg.norm_eps)
        return (h @ params.head_matrix()).float()
    h = L.rmsnorm(h, layout.use("final_ln", params.final_ln, None),
                  cfg.norm_eps)
    return (h @ _sharded_head(cfg, params, layout, None)).float()


def _head_name(cfg: ModelConfig) -> str:
    return "embed" if cfg.tie_embeddings else "head"


def _sharded_head(cfg: ModelConfig, params: TransformerLM, layout: S.Layout,
                  dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The head (D, V) as this rank computes with it (``layout.use``):
    its vocab shard's columns (D, V/m) where the model axis splits the
    vocab; a tied model's embedding rows, transposed."""
    name = _head_name(cfg)
    w = layout.use(name, getattr(params, name), dtype)
    return w.T if cfg.tie_embeddings else w


def _last_position(x: torch.Tensor, seq: Optional[S.ModelSplit]
                   ) -> torch.Tensor:
    """The hidden states (B, D) of the prompt's last position: under
    ``seq``, the last row of the model rank that holds the sequence's last
    part, taken by gathering each part's last row over ``model`` (B, m,
    D), never the whole carry."""
    if seq is None:
        return x[:, -1]
    return seq.gather(x[:, -1:].contiguous())[:, -1]


def _prompt_inputs(cfg: ModelConfig, params: TransformerLM,
                   batch: Mapping[str, Any]) -> torch.Tensor:
    key = "tokens" if cfg.input_mode == "tokens" else "embeds"
    return torch.as_tensor(batch[key], device=params.device)


def _sharded_serve(cfg: ModelConfig, params: TransformerLM,
                   batch: Mapping[str, Any], caches: Caches,
                   pos: Optional[int]):
    """Prefill (``pos`` None, ``batch`` a prompt) or one decode step
    (``batch`` {"token"} at ``pos``) on a mesh: the rows of the caches'
    batch split, a prefill's residual split over the sequence where
    ``Layout.sequence`` says, the embedding and the head on this rank's
    vocab shard. DTensor logits (B, V) split as the caches' batch and,
    where the head is, over the vocab on ``model`` (the reference's head
    spec)."""
    layout = layout_of(params)
    some = next(iter(next(iter(caches.values())).values()))
    b = some.shape[1]
    axes = layout.cache_axes(b)
    batch = _local_batch(layout, batch, axes)
    if pos is None:
        inputs = _prompt_inputs(cfg, params, batch)
        rope = _prompt_rope(cfg, batch, inputs)
        seq = layout.sequence(inputs.shape[1])
    else:
        inputs = torch.as_tensor(batch["token"],
                                 device=params.device)[:, None]
        rope = _decode_rope(cfg, inputs, pos)
        seq = None
    x = _sharded_inputs(cfg, params, layout, inputs, seq)
    x, _ = _run_sharded(params, layout, x, rope, caches,
                        0 if pos is None else pos, seq)
    logits = _logits(cfg, params, _last_position(x, seq))
    vocab = ("model",) if _head_name(cfg) in layout.vocab_parallel else None
    spec = (tuple(layout.names[i] for i in axes) or None, vocab)
    return _dtensor(layout, logits, spec, (b, cfg.vocab_size)), caches


@torch.no_grad()
def prefill(cfg: ModelConfig, params: TransformerLM,
            batch: Mapping[str, Any], caches: Caches
            ) -> Tuple[torch.Tensor, Caches]:
    """Consume a prompt (``batch``: ``tokens`` (B, S), or ``embeds`` (B, S,
    D) for a model on embedding input; optional ``positions``), fill the
    caches, return last-position logits (B, V) float32. The attention of
    the prompt runs through the flash kernel, once per GQA or hybrid layer
    (an MLA layer's absorbed attention and the SSM scan are plain PyTorch,
    as the JAX package computes them outside any kernel)."""
    if layout_of(params) is not None:
        return _sharded_serve(cfg, params, batch, caches, None)
    x = _embed_inputs(cfg, params, batch)
    x, _ = _run(params, x, _prompt_rope(cfg, batch, x), caches, 0)
    return _logits(cfg, params, x[:, -1]), caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: TransformerLM, token,
                caches: Caches, pos: int) -> Tuple[torch.Tensor, Caches]:
    """One decode step. token: (B,) integer, or (B, D) embeds for a model on
    embedding input; pos: its position (every M-RoPE stream's)."""
    if layout_of(params) is not None:
        return _sharded_serve(cfg, params, {"token": token}, caches,
                              int(pos))
    x = _token_inputs(cfg, params, token)
    return _decode_from(cfg, params, x, caches, pos)


def _token_inputs(cfg: ModelConfig, params: TransformerLM, token
                  ) -> torch.Tensor:
    if cfg.input_mode == "tokens":
        return _embed(params, token)[:, None]
    return torch.as_tensor(token, device=params.device).to(
        _dtype(cfg))[:, None]


def _decode_rope(cfg: ModelConfig, x: torch.Tensor, pos: int):
    b = x.shape[0]
    positions = torch.full((b, 1), int(pos), device=x.device)
    if cfg.mrope_sections is not None:
        positions = positions[None].expand(3, b, 1)
    return _rope_for(cfg, positions)


def _decode_from(cfg: ModelConfig, params: TransformerLM, x: torch.Tensor,
                 caches: Caches, pos: int) -> Tuple[torch.Tensor, Caches]:
    x, _ = _run(params, x, _decode_rope(cfg, x, pos), caches, int(pos))
    return _logits(cfg, params, x[:, 0]), caches
