"""Sharding rules: the 2-D FSDP×TP layout of the LM on a DeviceMesh, and the
collectives that run a model in it.

The JAX package's ``repro.models.sharding``. Axes: ``pod`` (inter-pod DP),
``data`` (intra-pod DP/FSDP), ``model`` (TP). FSDP groups (pod, data); TP
is model. The rules are divisibility-aware: a preferred axis tuple drops
axes right to left, then tries the next preference, whenever a dim is not
divisible, so awkward head counts (hymba's 25 heads, mamba2's vocab of
50,280) run unmodified on a 16-way model axis.

The rules are pure functions of a mesh's axis names and sizes (a
``DeviceMesh``, or any object whose ``shape`` maps axis → size, such as a
test's stub). A spec has one entry per tensor dim: ``None`` (replicated) or
the tuple of mesh axes that split it, major to minor — the reference's
``PartitionSpec`` with a lone axis written as a 1-tuple. ``param_specs`` is
keyed by the port's parameter names; a layer's tensor has no stacked layer
dim, so its spec is its reference leaf's without the leading ``None``.
``placements`` turns a spec into DTensor placements.

Below the rules, the runtime that takes the place of the reference's
``shard_hint`` and GSPMD (``Layout``): every parameter is a DTensor with
its spec's placements; a layer casts each local shard to the compute dtype
and all-gathers it over the axes it is split on, except that an attention
whose heads (and KV heads) divide the model axis, and an MLP whose width
does, keep their model-axis shard (column-parallel wq/wk/wv/wg/wu,
row-parallel wo/wd, an all-reduce over ``model`` after the row-parallel
product). Every other weight is gathered whole. A gathered weight's
gradient is reduce-scattered back to its shard over the axes whose ranks
computed different parts of it. Every collective the port issues is
counted in ``COLLECTIVES`` (count and output bytes a rank).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

FSDP: Tuple[str, ...] = ("pod", "data")
TP: Tuple[str, ...] = ("model",)

Axes = Optional[Tuple[str, ...]]
Spec = Tuple[Axes, ...]


def mesh_sizes(mesh: Any) -> Dict[str, int]:
    """{axis: size} of a ``DeviceMesh`` or of a stub whose ``shape`` is
    that mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.mesh.shape)))
    return dict(mesh.shape)


def _present(mesh: Any, names: Sequence[str]) -> Tuple[str, ...]:
    sizes = mesh_sizes(mesh)
    return tuple(n for n in names if n in sizes)


def _size(mesh: Any, names: Sequence[str]) -> int:
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[n] for n in names) if names else 1


def pick_axes(mesh: Any, dim: int, *prefs: Sequence[str]) -> Axes:
    """Largest evenly-dividing prefix of the first workable preference."""
    for pref in prefs:
        axes = _present(mesh, pref)
        while axes:
            if dim % _size(mesh, axes) == 0:
                return axes
            axes = axes[:-1]
    return None


def _spec(dims: Sequence[Axes]) -> Spec:
    return tuple(None if not a else tuple(a) for a in dims)


def _rule_for_leaf(mesh: Any, path: Tuple[str, ...],
                   shape: Tuple[int, ...]) -> Spec:
    """Partition rule from the leaf's path (without the stacked layer dim)."""
    name = path[-1]
    nd = len(shape)
    if nd == 1:
        # norm scales, biases, per-head scalars: shard big 1-D over TP
        if shape[0] >= 1024:
            return _spec([pick_axes(mesh, shape[0], TP)])
        return ()
    if name == "embed":                      # (V, D)
        return _spec([pick_axes(mesh, shape[0], TP),
                      pick_axes(mesh, shape[1], FSDP)])
    if name == "head":                       # (D, V)
        return _spec([pick_axes(mesh, shape[0], FSDP),
                      pick_axes(mesh, shape[1], TP)])
    if name == "router":                     # (D, E): replicate experts dim
        return _spec([pick_axes(mesh, shape[0], FSDP), None])
    if name == "conv_w":                     # (K, C)
        return _spec([None, pick_axes(mesh, shape[1], TP)])
    if nd == 3:                              # MoE expert stacks (E, D, F) / (E, F, D)
        if name in ("wg", "wu"):
            return _spec([pick_axes(mesh, shape[0], TP),
                          pick_axes(mesh, shape[1], FSDP), None])
        if name == "wd":
            return _spec([pick_axes(mesh, shape[0], TP), None,
                          pick_axes(mesh, shape[2], FSDP)])
    # 2-D projections: "into heads/ffn" shard col on TP; "back to D" shard row
    if name in ("wo", "wd", "w_out", "w_uk", "w_uv"):
        return _spec([pick_axes(mesh, shape[0], TP),
                      pick_axes(mesh, shape[1], FSDP)])
    # wq, wk, wv, wg, wu, w_in, w_dkv, generic
    return _spec([pick_axes(mesh, shape[0], FSDP),
                  pick_axes(mesh, shape[1], TP)])


def _named_shapes(params: Any) -> Dict[str, Tuple[int, ...]]:
    if isinstance(params, torch.nn.Module):
        return {n: tuple(p.shape) for n, p in params.named_parameters()}
    return {n: tuple(p.shape) for n, p in params.items()}


def param_specs(cfg, mesh: Any, params: Any) -> Dict[str, Spec]:
    """{parameter name: spec} for a model's parameters (the modules, on
    ``"meta"`` for the shapes alone, or a ``{name: tensor}`` map such as
    AdamW's moments): each name takes its reference leaf's spec, less the
    stacked layer dim (``transformer.reference_paths``)."""
    from repro_torch.models import transformer as T
    shapes = _named_shapes(params)
    fsdp = FSDP + TP if cfg.dp_over_tp else FSDP
    out: Dict[str, Spec] = {}
    for path, names in T.reference_paths(shapes).items():
        for name in names:
            shape = shapes[name]
            if cfg.dp_over_tp:
                # pure-DP policy: shard the largest dim over the whole mesh
                dims: list = [None] * len(shape)
                if shape:
                    big = max(range(len(shape)), key=lambda i: shape[i])
                    dims[big] = pick_axes(mesh, shape[big], fsdp, FSDP)
                out[name] = _spec(dims)
            else:
                out[name] = _rule_for_leaf(mesh, path, shape)
    return out


def batch_specs(cfg, mesh: Any,
                batch_size: Optional[int] = None) -> Dict[str, Spec]:
    group = FSDP + TP if cfg.dp_over_tp else FSDP
    # degrade to the largest dividing prefix when the batch is smaller than
    # the DP group (e.g. prefill batch 32 on a 256-chip pure-DP policy)
    dp = (pick_axes(mesh, batch_size, group) or ()) if batch_size \
        else _present(mesh, group)
    specs: Dict[str, Spec] = {}
    if cfg.input_mode == "tokens":
        specs["tokens"] = _spec([dp, None])
    else:
        specs["embeds"] = _spec([dp, None, None])
    specs["labels"] = _spec([dp, None])
    if cfg.mrope_sections is not None:
        specs["positions"] = _spec([None, dp, None])
    return specs


def cache_specs(cfg, mesh: Any, caches: Mapping[str, Any]) -> Dict[str, Any]:
    """Decode-cache specs, the caches' nesting ({"seg<i>": {name: spec}}):
    batch over FSDP axes, channels over TP. A cache leaf keeps its stacked
    layer dim, as in the reference."""
    dp = _present(mesh, FSDP)

    def rule(name: str, shape: Tuple[int, ...]) -> Spec:
        b_axes = pick_axes(mesh, shape[1], dp)
        if name in ("k", "v", "ckv", "kr", "conv"):
            # (L, B, T, C): channels over TP
            return _spec([None, b_axes, None, pick_axes(mesh, shape[3], TP)])
        if name == "state":
            # (L, B, H, N, P): SSD heads over TP when divisible
            return _spec([None, b_axes, pick_axes(mesh, shape[2], TP),
                          None, None])
        return ()

    return {seg: {name: rule(name, tuple(buf.shape))
                  for name, buf in bufs.items()}
            for seg, bufs in caches.items()}


def placements(mesh: Any, spec: Spec) -> tuple:
    """DTensor placements of ``spec``: for each mesh dim, ``Shard(d)`` where
    that axis splits tensor dim ``d``, ``Replicate()`` otherwise. Two axes
    on one dim (``("pod", "data")``) are two ``Shard(d)``s in mesh order:
    DTensor splits the dim by the first, then each piece by the second,
    JAX's major-to-minor split."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(getattr(mesh, "mesh_dim_names", None)
                  or tuple(mesh_sizes(mesh)))
    out = []
    for name in names:
        dims = [d for d, axes in enumerate(spec) if axes and name in axes]
        out.append(Shard(dims[0]) if dims else Replicate())
    for axes in spec:
        if axes and [a for a in names if a in axes] != list(axes):
            raise ValueError(f"spec entry {axes} is not in mesh order {names}")
    return tuple(out)


def shardings(mesh: Any, spec_tree: Any) -> Any:
    """``placements`` of every spec of a (nested dict) spec tree."""
    if isinstance(spec_tree, Mapping):
        return {k: shardings(mesh, v) for k, v in spec_tree.items()}
    return placements(mesh, spec_tree)


def local_slice(full, mesh: Any, placements_: Sequence[Any],
                coord: Sequence[int]):
    """The piece of ``full`` (a tensor or numpy array) that the rank at mesh
    coordinate ``coord`` holds under ``placements_``."""
    sizes = tuple(mesh_sizes(mesh).values())
    out = full
    for i, pl in enumerate(placements_):
        dim = getattr(pl, "dim", None)
        if dim is None or sizes[i] == 1:
            continue
        n = out.shape[dim] // sizes[i]
        index = [slice(None)] * out.ndim
        index[dim] = slice(coord[i] * n, (coord[i] + 1) * n)
        out = out[tuple(index)]
    return out


def local_shape(shape: Sequence[int], mesh: Any,
                placements_: Sequence[Any]) -> Tuple[int, ...]:
    sizes = tuple(mesh_sizes(mesh).values())
    out = list(shape)
    for i, pl in enumerate(placements_):
        dim = getattr(pl, "dim", None)
        if dim is not None:
            out[dim] //= sizes[i]
    return tuple(out)


# ---------------------------------------------------------------------------
# collectives, counted where the port issues them
# ---------------------------------------------------------------------------

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
#: {kind: {"count", "bytes"}}: collectives issued by this process since the
#: last ``reset_collectives``, bytes being each call's output on this rank
#: (the reference's dry run reads the same from the HLO's result types)
COLLECTIVES: Dict[str, Dict[str, int]] = {k: {"count": 0, "bytes": 0}
                                          for k in KINDS}
_LOCK = threading.Lock()


def _count(kind: str, t: torch.Tensor) -> None:
    with _LOCK:
        COLLECTIVES[kind]["count"] += 1
        COLLECTIVES[kind]["bytes"] += t.numel() * t.element_size()


def reset_collectives() -> None:
    with _LOCK:
        for v in COLLECTIVES.values():
            v["count"] = v["bytes"] = 0


def collective_counts() -> Dict[str, Dict[str, int]]:
    with _LOCK:
        return {k: dict(v) for k, v in COLLECTIVES.items()}


def _via_host(t: torch.Tensor, group) -> bool:
    """A CUDA tensor in a gloo group (ranks sharing one card): gloo's
    all-gather and reduce-scatter move host tensors, so it goes through the
    host, as gloo stages its own CUDA collectives."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The ``n`` ranks' ``t`` concatenated along ``dim``, in group order."""
    if n == 1:
        return t
    t = t.contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    if _via_host(t, group):
        host = out.cpu()
        dist.all_gather_into_tensor(host, t.cpu(), group=group)
        out.copy_(host)
    else:
        dist.all_gather_into_tensor(out, t, group=group)
    _count("all-gather", out)
    if dim == 0:
        return out
    return out.view((n,) + tuple(t.shape)).movedim(0, dim).reshape(
        t.shape[:dim] + (n * t.shape[dim],) + t.shape[dim + 1:])


def reduce_scatter(t: torch.Tensor, group, n: int, dim: int,
                   index: int) -> torch.Tensor:
    """Σ over the ranks of ``t``, cut into ``n`` pieces along ``dim``: this
    rank's piece (``index`` is its place in the group)."""
    if n == 1:
        return t
    moved = t.movedim(dim, 0).contiguous()
    out = t.new_empty((moved.shape[0] // n,) + tuple(moved.shape[1:]))
    if _via_host(t, group):
        host = out.cpu()
        dist.reduce_scatter_tensor(host, moved.cpu(), group=group)
        out.copy_(host)
    else:
        dist.reduce_scatter_tensor(out, moved, group=group)
    _count("reduce-scatter", out)
    return out.movedim(0, dim).contiguous()


def all_reduce(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """Σ over the ranks of ``t``, in place."""
    if n > 1:
        dist.all_reduce(t, group=group)
        _count("all-reduce", t)
    return t


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor made whole on every rank by this module's all-gathers (a
    gloo group moves CUDA tensors through the host); any other tensor as
    it is. Not differentiable: for outputs, gradients and checkpoints."""
    if not hasattr(t, "to_local"):
        return t
    mesh = t.device_mesh
    sizes = tuple(mesh.mesh.shape)
    out = t.to_local().detach()
    for i in reversed(range(len(sizes))):              # minor axis first
        dim = getattr(t.placements[i], "dim", None)
        if dim is not None:
            out = all_gather(out, mesh.get_group(i), sizes[i], dim)
    return out


# ---------------------------------------------------------------------------
# the runtime layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    """How a layer uses one parameter: its placements; the (mesh dim,
    tensor dim) pairs to all-gather, minor axis first; an optional narrowing
    to this rank's heads after the gather ((dim, parts, index)); and the
    mesh dims whose ranks compute different parts of its gradient, which
    the backward sums (a reduce-scatter where the forward gathered, an
    all-reduce where the weight is replicated)."""
    placements: tuple
    gathers: Tuple[Tuple[int, int], ...]
    select: Optional[Tuple[int, int, int]]
    partial: Tuple[int, ...]


class ModelSplit:
    """Entry to and exit from a block that runs split over the model axis
    (Megatron's f and g): the input passes unchanged and its gradient is
    all-reduced over ``model``; the block's partial output is all-reduced
    and its gradient passes unchanged."""

    def __init__(self, group, n: int) -> None:
        self.group, self.n = group, n

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        return _Exit.apply(y, self)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return x

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        return all_reduce(g.contiguous(), s.group, s.n), None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, split):
        # a copy: under remat "dots" the product y is kept for the
        # recompute, which must find it unreduced
        return all_reduce(y.clone(memory_format=torch.contiguous_format),
                          split.group, split.n)

    @staticmethod
    def backward(ctx, g):
        return g, None


class BatchStats:
    """Sums of statistics over the ranks the batch is split over (the MoE
    aux loss's expert counts and router probabilities, taken by the
    reference over the global batch)."""

    def __init__(self, layout: "Layout", axes: Tuple[int, ...]) -> None:
        self.layout, self.axes = layout, axes
        self.shards = math.prod(layout.sizes[i] for i in axes)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        for i in self.axes:
            t = all_reduce(t, self.layout.groups[i], self.layout.sizes[i])
        return t


class _Use(torch.autograd.Function):
    """A parameter's local shard → the tensor a layer computes with: cast
    to the compute dtype, all-gathered over the plan's axes, narrowed to
    this rank's heads. The backward returns the float32 gradient of the
    local shard: summed over the plan's partial axes (reduce-scatter or
    all-reduce), cut to the shard elsewhere."""

    @staticmethod
    def forward(ctx, local, dtype, layout, plan):
        ctx.layout, ctx.plan = layout, plan
        ctx.local_shape, ctx.local_dtype = local.shape, local.dtype
        w = local.to(dtype) if dtype is not None else local
        for mdim, tdim in plan.gathers:
            w = all_gather(w, layout.groups[mdim], layout.sizes[mdim], tdim)
        if plan.select is not None:
            dim, parts, index = plan.select
            ctx.full_shape = w.shape
            w = w.narrow(dim, index * (w.shape[dim] // parts),
                         w.shape[dim] // parts)
        return w

    @staticmethod
    def backward(ctx, g):
        layout, plan = ctx.layout, ctx.plan
        g = g.float()
        if plan.select is not None:
            dim, parts, index = plan.select
            full = g.new_zeros(ctx.full_shape)
            full.narrow(dim, index * g.shape[dim], g.shape[dim]).copy_(g)
            g = full
        gathered = set()
        for mdim, tdim in reversed(plan.gathers):
            gathered.add(mdim)
            n = layout.sizes[mdim]
            if mdim in plan.partial:
                g = reduce_scatter(g, layout.groups[mdim], n, tdim,
                                   layout.coord[mdim])
            elif n > 1:
                size = g.shape[tdim] // n
                g = g.narrow(tdim, layout.coord[mdim] * size, size)
        for mdim in plan.partial:
            if mdim not in gathered and \
                    getattr(plan.placements[mdim], "dim", None) is None:
                g = all_reduce(g.contiguous(), layout.groups[mdim],
                               layout.sizes[mdim])
        return g.to(ctx.local_dtype).contiguous(), None, None, None


_SPLIT_DIMS = {"gqa": {"wq": 1, "wk": 1, "wv": 1, "bq": 0, "bk": 0, "bv": 0,
                        "wo": 0},
               "mlp": {"wg": 1, "wu": 1, "wd": 0}}


class Layout:
    """One model on a mesh: each parameter's spec, placements and ``Plan``;
    the mesh axes the training batch is split over (``batch_specs``); which
    attention and MLP blocks run split over the model axis; this rank's
    coordinate and the process group of each axis.

    A GQA block runs split when the model axis divides both its heads and
    its KV heads (the rule then splits wq, wk, wv by columns and wo by
    rows, each on whole heads); an MLP block when the axis divides its
    width. Every other block — MLA, the SSM, MoE experts, a GQA whose
    split would cut a head (hymba's 25 heads, 8 KV heads on a 16-way
    axis) — runs whole on every model rank, its weights gathered whole.
    Under ``dp_over_tp`` the model axis is a data axis and nothing runs
    split."""

    def __init__(self, cfg, mesh: Any, params: Any, *,
                 batch_size: Optional[int] = None) -> None:
        self.cfg, self.mesh = cfg, mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = tuple(int(s) for s in mesh.mesh.shape)
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        self.coord = tuple(coord)
        self.groups = tuple(mesh.get_group(i) for i in range(len(self.names)))
        self.specs = param_specs(cfg, mesh, params)
        bspec = batch_specs(cfg, mesh, batch_size)
        axes = next(iter(bspec.values()))[0] or ()
        self.batch_axes = tuple(self.names.index(a) for a in axes)
        self.batch_stats = BatchStats(self, self.batch_axes)
        #: the model axis's mesh dim (caches split channels over it even
        #: under dp_over_tp); tp_dim: the same when blocks run split over it
        self.model_dim = self.names.index("model") \
            if "model" in self.names else None
        tp = self.model_dim is not None and not cfg.dp_over_tp \
            and self.sizes[self.model_dim] > 1
        self.tp_dim = self.names.index("model") if tp else None
        self.split = ModelSplit(self.groups[self.tp_dim],
                                self.sizes[self.tp_dim]) if tp else None
        shapes = _named_shapes(params)
        self.split_blocks = self._split_blocks(shapes)
        self.plans = {n: self._plan(n) for n in shapes}

    # -- which blocks run split over the model axis -------------------------
    def _split_blocks(self, shapes: Mapping[str, Tuple[int, ...]]
                      ) -> Dict[str, str]:
        """{module prefix: "gqa" | "mlp"} of the blocks that run split."""
        if self.tp_dim is None:
            return {}
        cfg, m = self.cfg, self.sizes[self.tp_dim]
        out: Dict[str, str] = {}
        for name in shapes:
            prefix, leaf = name.rsplit(".", 1) if "." in name else ("", name)
            prefix += "."
            if prefix in out:
                continue
            if leaf == "wq" and prefix + "w_dkv" not in shapes:
                if cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0 and all(
                        self._on_model(prefix + w, d) for w, d in (
                            ("wq", 1), ("wk", 1), ("wv", 1), ("wo", 0))):
                    out[prefix] = "gqa"
            elif leaf == "wg" and len(shapes[name]) == 2:
                if all(self._on_model(prefix + w, d) for w, d in (
                        ("wg", 1), ("wu", 1), ("wd", 0))):
                    out[prefix] = "mlp"
        return out

    def _on_model(self, name: str, dim: int) -> bool:
        spec = self.specs[name]
        return dim < len(spec) and spec[dim] == ("model",)

    def block_of(self, name: str) -> Optional[str]:
        prefix = name.rsplit(".", 1)[0] + "." if "." in name else "."
        return prefix if prefix in self.split_blocks else None

    def _plan(self, name: str) -> Plan:
        spec = self.specs[name]
        pls = placements(self.mesh, spec)
        block = self.block_of(name)
        leaf = name.rsplit(".", 1)[-1]
        keep = None         # the tensor dim kept split over the model axis
        select = None
        if block is not None:
            # the dim that holds the heads (the FFN width): columns of the
            # projections into them, rows of the one back to D
            want = _SPLIT_DIMS[self.split_blocks[block]].get(leaf)
            if want is not None:
                if self._on_model(name, want):
                    keep = want
                elif leaf in ("bq", "bk", "bv"):
                    select = (0, self.sizes[self.tp_dim],
                              self.coord[self.tp_dim])
        gathers = []
        for i in reversed(range(len(self.names))):   # minor axis first
            dim = getattr(pls[i], "dim", None)
            if dim is None or self.sizes[i] == 1:
                continue
            if i == self.tp_dim and keep == dim:
                continue
            gathers.append((i, dim))
        partial = set(self.batch_axes)
        if block is not None:
            partial.add(self.tp_dim)
        return Plan(pls, tuple(gathers), select, tuple(sorted(partial)))

    # -- the parameters --------------------------------------------------------
    def use(self, name: str, p, dtype: Optional[torch.dtype]) -> torch.Tensor:
        """The tensor a layer computes with for parameter ``name`` (a
        DTensor, or its local shard): see ``_Use``."""
        local = p.to_local() if hasattr(p, "to_local") else p
        return _Use.apply(local, dtype, self, self.plans[name])

    def rows(self, n: int, axes: Sequence[int]) -> Tuple[int, int]:
        """(first, count) of the rows of ``n`` that this rank holds when
        they are split over mesh dims ``axes`` (major first)."""
        shards = math.prod(self.sizes[i] for i in axes)
        index = 0
        for i in axes:
            index = index * self.sizes[i] + self.coord[i]
        return index * (n // shards), n // shards

    def cache_axes(self, batch_size: int) -> Tuple[int, ...]:
        """The mesh dims a cache's batch is split over (``cache_specs``)."""
        axes = pick_axes(self.mesh, batch_size, _present(self.mesh, FSDP))
        return tuple(self.names.index(a) for a in axes or ())
