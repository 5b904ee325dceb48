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
and all-gathers it over the axes it is split on, except that a GQA
attention runs this rank's heads (``head_ranges``: whole KV heads and their
query heads, dealt evenly or not, a KV head shared where the axis is wider
than the KV heads) with the model-axis shard of each weight whose shard
holds exactly those heads and the rest gathered and cut to them, and an
MLP whose width the axis divides keeps its model-axis shard
(column-parallel wq/wk/wv/wg/wu, row-parallel wo/wd, an all-reduce over
``model`` after the row-parallel product); such an attention's K/V cache
holds the rank's own KV heads (``HeadCache``, the port's runtime layout,
where ``cache_specs`` is the reference's rule). An SSM runs the SSD heads
that ``ssm_heads`` deals it the same way, with its heads' pieces of each
weight and the B and C that every head reads, its gated norm's squares
summed over ``model``, and its state and conv cache held by its own
heads. An MLA whose heads the
axis divides keeps its wq columns and wo rows and takes its heads'
columns of the gathered w_uk and w_uv (whose shards lie on the latent
rows), and an MoE whose expert count the axis
divides keeps its experts' shard (expert parallelism, the reference's
``(DP, TP, None, None)`` dispatch buffer: each model rank runs its E/m
experts on its batch group's slots, and the routed partial output joins
the shared experts' row-parallel one in a single all-reduce over
``model``; no all-to-all, since every model rank holds the group's
tokens). Every other weight is
gathered whole. A gathered weight's gradient is reduce-scattered back to
its shard over the axes whose ranks computed different parts of it. Every
collective the port issues is counted in ``COLLECTIVES`` (count and
output bytes a rank).

A training step and a prefill also run Megatron's sequence and vocab
parallelism, the layouts GSPMD gives the reference from its ``shard_hint``
and rules: at a global sequence of ``SEQ_SPLIT_MIN`` or more that the
model axis divides (``Layout.sequence``), the residual between blocks is
split over the sequence as well as the batch, and a split block's entry
and exit become an all-gather and a reduce-scatter over the sequence
(``ModelSplit`` with ``seq``); and where the model axis splits the vocab,
the embedding and the head keep their vocab shard in training, prefill
and decode alike (``vocab_embedding``; ``VocabSplit`` for the loss, and
serving's logits come back split over the vocab on ``model``). A decode
step (one position) never splits the sequence.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

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


def head_ranges(h: int, g: int, m: int, index: int
                ) -> Tuple[int, int, int, int]:
    """(first query head, count, first KV head, count) that model rank
    ``index`` of ``m`` runs of an attention of ``h`` query heads in ``g``
    KV groups (r = h/g query heads a group), for ``m`` ≤ ``h``. Every rank
    holds whole KV heads and a whole number of query heads on each (the
    flash kernel wants its local H a multiple of its local Hkv):

      m ≤ g  the g groups dealt over the m ranks as evenly as possible,
             contiguous, the larger shares first (hymba's 5 groups on 4
             ranks: 2/1/1/1 groups, 10/5/5/5 query heads);
      m > g  the m ranks dealt over the g groups as evenly as possible,
             contiguous, then each group's r query heads over its ranks
             the same way; the ranks of a group share its one KV head,
             each holding, computing and caching it (qwen2.5-32b's 40/8
             heads on 16 ranks: 3 or 2 query heads and 1 KV head a rank).
    """
    if not 0 < m <= h or h % g or not 0 <= index < m:
        raise ValueError(f"no head split of {h}/{g} heads over {m} ranks "
                         f"(rank {index})")
    r = h // g
    if m <= g:
        base, extra = divmod(g, m)
        kv0 = index * base + min(index, extra)
        kvn = base + (index < extra)
        return kv0 * r, kvn * r, kv0, kvn
    base, extra = divmod(m, g)
    group, first = 0, 0
    while index >= first + base + (group < extra):
        first += base + (group < extra)
        group += 1
    ranks, place = base + (group < extra), index - first
    qb, qe = divmod(r, ranks)
    return (group * r + place * qb + min(place, qe), qb + (place < qe),
            group, 1)


def gqa_heads(cfg, mesh: Any) -> Optional[Tuple[Tuple[int, int, int, int],
                                                 ...]]:
    """Every model rank's ``head_ranges`` where a GQA attention (a GQA
    mixer, a hybrid's attention) runs split over the model axis: the
    reference's rule puts ``model`` on wq's columns (``_rule_for_leaf``)
    and the axis is no larger than the heads, not under ``dp_over_tp``.
    None where it runs whole on every model rank."""
    sizes = mesh_sizes(mesh)
    m = sizes.get("model", 1)
    if cfg.dp_over_tp or m == 1 or m > cfg.n_heads:
        return None
    wq = (cfg.d_model, cfg.n_heads * cfg.head_dim)
    if _rule_for_leaf(mesh, ("wq",), wq)[1] != TP:
        return None
    return tuple(head_ranges(cfg.n_heads, cfg.n_kv_heads, m, i)
                 for i in range(m))


def ssm_heads(cfg, mesh: Any) -> Optional[Tuple[Tuple[int, int], ...]]:
    """Every model rank's (first SSD head, count) where an SSM (an SSM
    mixer, a hybrid's SSM) runs split over the model axis: each SSD head a
    group of its own in ``head_ranges`` (hymba's 50 heads: 13/13/12/12 on
    4 ranks, 4/4/3/… on 16). It runs split where the reference's rule puts
    ``model`` on w_out's rows (``_rule_for_leaf``) and the axis is no
    larger than the heads, not under ``dp_over_tp``; None where it runs
    whole on every model rank."""
    m = mesh_sizes(mesh).get("model", 1)
    sc = cfg.ssm
    if sc is None or cfg.dp_over_tp or m == 1:
        return None
    nh = sc.n_heads(cfg.d_model)
    w_out = (sc.d_inner(cfg.d_model), cfg.d_model)
    if m > nh or _rule_for_leaf(mesh, ("w_out",), w_out)[0] != TP:
        return None
    return tuple(head_ranges(nh, nh, m, i)[:2] for i in range(m))


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


def all_reduce(t: torch.Tensor, group, n: int,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Σ (or ``op``) over the ranks of ``t``, in place."""
    if n > 1:
        dist.all_reduce(t, op=op, group=group)
        _count("all-reduce", t)
    return t


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor (or a ``HeadCache``) made whole on every rank by this
    module's all-gathers (a gloo group moves CUDA tensors through the
    host); any other tensor as it is. Not differentiable: for outputs,
    gradients, caches and checkpoints."""
    if isinstance(t, HeadCache):
        return t.whole()
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


class HeadCache:
    """A cache buffer of layers that run split over the model axis by
    heads, in the port's own runtime layout: each rank holds its rows of
    the batch (split over the data axes as ``cache_specs`` splits it) and
    its own heads, so a prefill and a decode step read and write it with
    no collective. A split GQA's K/V (``gqa_heads``) holds the rank's
    whole KV heads, (L, B_local, T, kvn·hd); ranks that share a KV head (a
    model axis wider than the KV heads) each hold and write it. A split
    SSM's (``ssm_heads``) ``state`` holds its SSD heads, (L, B_local, hn,
    N, P), and ``conv`` its heads' x channels followed by the B and C
    channels, which every rank convolves alike, (L, B_local, K−1, hn·P +
    2·G·N). The reference's ``cache_specs`` splits the channels (and the
    SSD heads, where the axis divides them) evenly over ``model`` instead,
    which cuts a head wherever the axis does not divide them.

    ``shape`` is the whole buffer's; ``placements`` the batch's split
    (``Replicate`` on the model axis); ``heads`` every model rank's (first
    head, count); ``head_dim`` a head's width along ``dim``, the tensor
    dim that holds the heads, where ``shared`` entries that every rank
    holds follow them."""

    def __init__(self, local: torch.Tensor, shape: Sequence[int], mesh: Any,
                 placements_: Sequence[Any], model_dim: int,
                 heads: Sequence[Tuple[int, int]], head_dim: int, *,
                 dim: int = -1, shared: int = 0) -> None:
        self.local, self.shape = local, torch.Size(shape)
        self.device_mesh, self.placements = mesh, tuple(placements_)
        self.model_dim, self.heads = model_dim, tuple(heads)
        self.head_dim, self.shared = head_dim, shared
        self.dim = dim % len(self.shape)

    def to_local(self) -> torch.Tensor:
        return self.local

    def whole(self) -> torch.Tensor:
        """The whole buffer on every rank: the batch gathered over the
        data axes, then every model rank's heads (padded to the most a rank
        holds), each head taken from the first rank that holds it, and the
        shared entries from model rank 0."""
        mesh = self.device_mesh
        sizes = tuple(mesh.mesh.shape)
        out = self.local.detach()
        for i in reversed(range(len(sizes))):
            dim = getattr(self.placements[i], "dim", None)
            if dim is not None and i != self.model_dim:
                out = all_gather(out, mesh.get_group(i), sizes[i], dim)
        hd, m, dim = self.head_dim, sizes[self.model_dim], self.dim
        most = max(n for _, n in self.heads)
        padded = out.new_zeros(out.shape[:dim] + (most * hd + self.shared,)
                               + out.shape[dim + 1:])
        padded.narrow(dim, 0, out.shape[dim]).copy_(out)
        parts = all_gather(padded[None], mesh.get_group(self.model_dim), m,
                           0)
        pieces = []
        for k in range((self.shape[dim] - self.shared) // hd):
            r = next(i for i, (k0, n) in enumerate(self.heads)
                     if k0 <= k < k0 + n)
            k0 = self.heads[r][0]
            pieces.append(parts[r].narrow(dim, (k - k0) * hd, hd))
        if self.shared:
            pieces.append(parts[0].narrow(dim, self.heads[0][1] * hd,
                                          self.shared))
        return torch.cat(pieces, dim)


# ---------------------------------------------------------------------------
# the runtime layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    """How a layer uses one parameter: its placements; the (mesh dim,
    tensor dim) pairs to all-gather, minor axis first; an optional cut to
    this rank's part after the gather, (dim, pieces): the (start, count)
    pieces along dim, concatenated in order (a range of heads; a split
    SSM's heads' columns of z, x and dt beside the B and C columns that
    every rank uses), which may be uneven over the ranks or overlap
    another rank's (a KV head that two ranks share, B and C); and the mesh
    dims whose ranks compute different parts of its gradient, which the
    backward sums (a reduce-scatter where the forward gathered, an
    all-reduce where the weight is replicated)."""
    placements: tuple
    gathers: Tuple[Tuple[int, int], ...]
    select: Optional[Tuple[int, Tuple[Tuple[int, int], ...]]]
    partial: Tuple[int, ...]


#: The shortest global sequence whose residual is split over the model
#: axis between blocks (the JAX package's ``transformer._apply_layer``).
SEQ_SPLIT_MIN = 2048


class ModelSplit:
    """Entry to and exit from a block that runs split over the model axis
    (Megatron's f and g): the input passes unchanged and its gradient is
    all-reduced over ``model``; the block's partial output is all-reduced
    and its gradient passes unchanged.

    With ``seq`` the residual between blocks is split over the sequence
    (dim 1) as well, each model rank holding part ``index`` of ``n``
    (Megatron's sequence parallelism): the entry all-gathers the sequence
    and its backward reduce-scatters the gradient; the exit
    reduce-scatters the partial output over the sequence and its backward
    all-gathers the gradient. A block that runs whole on every model rank
    crosses the same boundary by ``whole`` (the sequence all-gathered, the
    gradient cut to this rank's part) and ``own`` (this rank's part of the
    output, the gradient all-gathered), so the gradients inside it are
    whole and equal on every model rank, as without the split."""

    def __init__(self, group, n: int, index: int, *, seq: bool = False
                 ) -> None:
        self.group, self.n, self.index, self.seq = group, n, index, seq

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return (_SeqEnter if self.seq else _Enter).apply(x, self)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        return (_SeqExit if self.seq else _Exit).apply(y, self)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        return _SeqWhole.apply(x, self)

    def own(self, y: torch.Tensor) -> torch.Tensor:
        return _SeqOwn.apply(y, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' parts of the sequence, in order (not
        differentiable)."""
        return all_gather(x, self.group, self.n, 1)

    def scatter(self, y: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks of ``y``, this rank's part of the sequence (not
        differentiable)."""
        return reduce_scatter(y, self.group, self.n, 1, self.index)

    def part(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of the sequence of ``x``, a copy."""
        size = x.shape[1] // self.n
        return x.narrow(1, self.index * size, size).clone(
            memory_format=torch.contiguous_format)

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over the model ranks of ``t``, a statistic of this rank's
        channels that every rank's output then reads (a split SSM's
        squares under its gated norm): an all-reduce, whose backward is an
        all-reduce too, since each rank's gradient holds its own outputs'
        part alone."""
        return _Total.apply(t, self)

    def once(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as it is, its gradient divided by the ranks: a value that
        every model rank computes alike from inputs that entered through
        this split (an MoE's aux loss), whose gradients the entry's
        backward sums over the ranks, so the sum counts it once."""
        return _Once.apply(t, self.n)


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


class _Total(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, split):
        ctx.split = split
        return all_reduce(t.clone(memory_format=torch.contiguous_format),
                          split.group, split.n)

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          s.group, s.n), None


class _Once(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _SeqEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return split.gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.split.scatter(g), None


class _SeqExit(torch.autograd.Function):
    # the reduce-scatter writes a new tensor: a product that remat "dots"
    # keeps is not changed
    @staticmethod
    def forward(ctx, y, split):
        ctx.split = split
        return split.scatter(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.split.gather(g), None


class _SeqWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return split.gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.split.part(g), None


class _SeqOwn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, split):
        ctx.split = split
        return split.part(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.split.gather(g), None


def vocab_embedding(tokens: torch.Tensor, table: torch.Tensor,
                    split: ModelSplit) -> torch.Tensor:
    """The embedding of ``tokens`` (B, S) from this rank's rows of a
    table whose vocab is split over the model axis (``table`` (V/m, D),
    rows ``split.index``·V/m onward): each rank looks up the tokens in its
    range (``F.embedding``, whose backward sums in a fixed order), zeroes
    the others' rows, and ``split.exit`` sums the ranks' parts (an
    all-reduce, as in a decode step's (B, 1, D), or a reduce-scatter into
    this rank's part of the sequence when ``split.seq``, as in a split
    training step or prefill). One rank holds each token's row and the
    others add zeros, so the result has the bits of the whole table's
    lookup; a row gets a gradient only from the tokens it embeds."""
    v = table.shape[0]
    local = tokens - split.index * v
    mine = (local >= 0) & (local < v)
    rows = F.embedding(torch.where(mine, local, 0), table)
    return split.exit(rows.masked_fill(~mine[..., None], 0))


class VocabSplit:
    """The cross-entropy of a head whose vocab is split over the model
    axis (Megatron's vocab-parallel loss): each rank forms its columns'
    logits, and three all-reduces of one float a token give the global
    max, the sum of exponentials and the label's logit (from the rank
    whose columns hold it)."""

    def __init__(self, group, n: int, index: int) -> None:
        self.group, self.n, self.index = group, n, index

    def nll(self, hc: torch.Tensor, lc: torch.Tensor,
            head: torch.Tensor) -> torch.Tensor:
        """Σ −log p(label) over one chunk's tokens (C, D) with this rank's
        head columns ``head`` (D, V/m) → scalar float32, equal on the model
        ranks; labels < 0 count nothing. The backward is local: softmax −
        one-hot on this rank's columns, so the gradient into ``hc`` is this
        rank's part of the sum over ``model``."""
        return _VocabNLL.apply(hc, lc, head, self)

    def gold(self, logits: torch.Tensor, local: torch.Tensor,
             mine: torch.Tensor) -> torch.Tensor:
        """Each token's label logit, summed over the ranks (the one whose
        columns hold the label gives it, the others 0)."""
        v = logits.shape[1]
        own = torch.gather(logits, 1, local.clamp(0, v - 1)[:, None])[:, 0]
        return all_reduce(torch.where(mine, own, 0.0), self.group, self.n)


class _VocabNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hc, lc, head, vocab):
        logits = (hc @ head).float()                       # (C, V/m)
        v = logits.shape[1]
        peak = all_reduce(logits.amax(dim=-1), vocab.group, vocab.n,
                          op=dist.ReduceOp.MAX)
        exp = torch.exp(logits - peak[:, None])
        total = all_reduce(exp.sum(dim=-1), vocab.group, vocab.n)
        local = lc - vocab.index * v
        mine = (local >= 0) & (local < v)
        gold = vocab.gold(logits, local, mine)
        valid = (lc >= 0).float()
        ctx.save_for_backward(hc, head, exp, total, local, mine, valid)
        return ((peak + torch.log(total) - gold) * valid).sum()

    @staticmethod
    def backward(ctx, g):
        hc, head, exp, total, local, mine, valid = ctx.saved_tensors
        v = exp.shape[1]
        d = exp / total[:, None]
        d.scatter_add_(1, local.clamp(0, v - 1)[:, None],
                       -mine.float()[:, None])
        d = (d * (g * valid)[:, None]).to(hc.dtype)
        return d @ head.T, None, hc.T @ d, None


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
    to the compute dtype, all-gathered over the plan's axes, cut to this
    rank's pieces. The backward returns the float32 gradient of the
    local shard: each piece's gradient put in its place among zeros, summed
    over the plan's partial axes (reduce-scatter or all-reduce, so a head
    that two ranks use takes both ranks' gradients), cut to the shard
    elsewhere."""

    @staticmethod
    def forward(ctx, local, dtype, layout, plan):
        ctx.layout, ctx.plan = layout, plan
        ctx.local_shape, ctx.local_dtype = local.shape, local.dtype
        w = local.to(dtype) if dtype is not None else local
        for mdim, tdim in plan.gathers:
            w = all_gather(w, layout.groups[mdim], layout.sizes[mdim], tdim)
        if plan.select is not None:
            dim, pieces = plan.select
            ctx.full_shape = w.shape
            parts = [w.narrow(dim, start, count) for start, count in pieces]
            w = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
        return w

    @staticmethod
    def backward(ctx, g):
        layout, plan = ctx.layout, ctx.plan
        g = g.float()
        if plan.select is not None:
            dim, pieces = plan.select
            full = g.new_zeros(ctx.full_shape)
            at = 0
            for start, count in pieces:
                full.narrow(dim, start, count).copy_(g.narrow(dim, at, count))
                at += count
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


#: each split block's weights (named within the block) and the dim that
#: holds the heads, FFN width or experts, which the model axis keeps split
#: where its shard is exactly this rank's part (or else ``Plan.select``
#: cuts to this rank's part after the gather: a GQA's weights whose shard
#: cuts a head or whose heads are dealt unevenly, its biases, an MLA's
#: w_uk and w_uv, an SSM's weights but w_out's rows where the axis divides
#: the heads)
_SPLIT_DIMS = {"gqa": {"wq": 1, "wk": 1, "wv": 1, "bq": 0, "bk": 0, "bv": 0,
                        "wo": 0},
               "mla": {"wq": 1, "w_uk": 1, "w_uv": 1, "wo": 0},
               "mlp": {"wg": 1, "wu": 1, "wd": 0},
               "moe": {"experts.wg": 0, "experts.wu": 0, "experts.wd": 0},
               "ssm": {"w_in": 1, "conv_w": 1, "conv_b": 0, "out_ln": 0,
                       "w_out": 0, "a_log": 0, "d_skip": 0, "dt_bias": 0}}
#: a split GQA's weights that hold its KV heads (the rest, its query heads)
_KV_LEAVES = ("wk", "wv", "bk", "bv")
#: the vocab dim of the embedding (V, D) and the head (D, V)
_VOCAB_DIMS = {"embed": 0, "head": 1}


def _on_sequence_part(name: str, split_blocks: Mapping[str, str]) -> bool:
    """A parameter that a step with the residual split over the sequence
    uses on this rank's part of it: a layer's norms and the final one, and
    the output norms of a hybrid whose attention and SSM both run split
    (``split_blocks``), whose one exit lands on the part."""
    parts = name.split(".")
    if name == "final_ln" or (len(parts) == 4 and parts[0] == "segments"
                              and parts[3] in ("ln1", "ln2")):
        return True
    prefix = name.rsplit(".", 1)[0] + "."
    return parts[-1] in ("attn_out_ln", "ssm_out_ln") and all(
        prefix + b in split_blocks for b in ("attn.", "ssm."))


class Layout:
    """One model on a mesh: each parameter's spec, placements and ``Plan``;
    the mesh axes the training batch is split over (``batch_specs``); which
    attention and MLP blocks run split over the model axis; this rank's
    coordinate and the process group of each axis.

    A GQA block (a GQA mixer, a hybrid's attention) runs split when the
    rule put ``model`` on wq's columns and the axis is no larger than its
    heads (``gqa_heads``): each model rank runs the query and KV heads
    that ``head_ranges`` deals it, whole KV heads and a whole number of
    query heads on each, evenly or not (hymba's 25/5 heads on 4 ranks:
    10/5/5/5 query heads), a KV head shared by the ranks of its group
    where the axis is wider than the KV heads (qwen3-32b's 8 on 16 ranks).
    A weight keeps its model-axis shard where that shard holds exactly the
    rank's heads (wq, wk, wv by columns, wo by rows, when the axis divides
    the heads and KV heads); any other is gathered and cut to the rank's
    heads (``Plan.select``; the gradient put among zeros and
    reduce-scattered, so a shared KV head takes every sharing rank's
    gradient). q_norm and k_norm stay whole and take a gradient partial
    over ``model``. Its K/V cache holds the rank's own KV heads
    (``HeadCache``). An MLA block runs split when the axis divides its
    heads and the rule put ``model`` on wq's columns and wo's rows: each
    model rank keeps those shards (its heads; wq's columns are
    head-major), gathers w_uk and w_uv whole (the rule splits them on the
    latent rows) and takes its heads' columns of them (``Plan.select``,
    whose gradient is reduce-scattered back to the latent-row shard), and
    computes the shared latent ``ckv`` and rotary key alike, so w_dkv's
    and kv_ln's gradients are partial over ``model``; an MLP block when
    the axis divides its width; an MoE when the rule put its experts' dim
    on the model axis (the axis divides E) and its shared experts run
    split as an MLP: its expert stacks keep their model-axis shard, its
    router is whole on every rank and takes a gradient partial over
    ``model`` (each rank's gates feed only its own experts' slots). An SSM
    block (an SSM mixer, a hybrid's SSM) runs split when the rule put
    ``model`` on w_out's rows and the axis is no larger than its SSD heads
    (``ssm_heads``): each model rank scans the heads dealt it, evenly or
    not (hymba's 50 on 4 ranks: 13/13/12/12), with its heads' columns of
    w_in's z, x and dt and the whole B and C columns, its heads' x
    channels of conv_w and conv_b and the B and C channels, its heads'
    entries of out_ln, a_log, d_skip and dt_bias and rows of w_out, each
    cut from the gathered weight (``Plan.select``; w_out keeps its shard
    where the axis divides the heads); B and C, which every rank computes
    alike for its own heads, take every rank's gradient. Its gated norm
    sums its squares over ``model`` (``ModelSplit.total``) and its cache
    holds the rank's own heads (``HeadCache``). A hybrid whose attention
    and SSM both run split enters once and sums the two partial outputs
    in one collective. Every other block — an MoE whose experts the axis
    does not divide (64 experts on a 128-way axis), a GQA or an SSM whose
    heads are fewer than the axis, an MLA whose heads it does not divide —
    runs whole on every model rank, its weights gathered whole. Under
    ``dp_over_tp`` (mamba2-370m) the model axis is a data axis and nothing
    runs split.

    With blocks split over the model axis, training, prefill and decode
    keep the embedding's and the head's vocab shard where the rule splits
    their vocab over ``model`` (``vocab_parallel``), and a training step's
    norms that run on a sequence part take a gradient partial over
    ``model`` (``use(..., seq=True)``)."""

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
        self.split = self.seq_split = self.vocab = None
        if tp:
            group, n = self.groups[self.tp_dim], self.sizes[self.tp_dim]
            index = self.coord[self.tp_dim]
            self.split = ModelSplit(group, n, index)
            self.seq_split = ModelSplit(group, n, index, seq=True)
            self.vocab = VocabSplit(group, n, index)
        shapes = self.shapes = _named_shapes(params)
        #: every model rank's (first query head, count, first KV head,
        #: count) in a split GQA (``head_ranges``), None where GQA runs
        #: whole; ``heads``: this rank's
        self.gqa_heads = gqa_heads(cfg, mesh) if tp else None
        self.heads = None if self.gqa_heads is None \
            else self.gqa_heads[self.coord[self.tp_dim]]
        #: every model rank's (first SSD head, count) in a split SSM
        #: (``ssm_heads``), None where the SSM runs whole
        self.ssm_heads = ssm_heads(cfg, mesh) if tp else None
        self.split_blocks = self._split_blocks(shapes)
        #: the tables kept split over the vocab on the model axis (the
        #: embedding, the loss and serving's logits run vocab-parallel)
        self.vocab_parallel = {n for n, d in _VOCAB_DIMS.items()
                               if n in shapes and tp and self._on_model(n, d)}
        self.plans = {n: self._plan(n) for n in shapes}
        # a step whose residual is split over the sequence: the norms that
        # run on the sequence part take a gradient partial over the model
        # axis
        self.seq_plans = {n: dataclasses.replace(
            self.plans[n], partial=tuple(sorted(
                set(self.plans[n].partial) | {self.tp_dim})))
            for n in shapes if _on_sequence_part(n, self.split_blocks)} \
            if tp else {}

    # -- which blocks run split over the model axis -------------------------
    def _split_blocks(self, shapes: Mapping[str, Tuple[int, ...]]
                      ) -> Dict[str, str]:
        """{module prefix: "gqa" | "mla" | "mlp" | "moe" | "ssm"} of the
        blocks that run split (an MoE's shared experts are an "mlp" block
        inside it; a hybrid's attention a "gqa" block and its SSM an "ssm"
        one)."""
        if self.tp_dim is None:
            return {}
        cfg, m = self.cfg, self.sizes[self.tp_dim]
        out: Dict[str, str] = {}
        for name in shapes:
            prefix, leaf = name.rsplit(".", 1) if "." in name else ("", name)
            prefix += "."
            if prefix in out:
                continue
            if leaf == "wq" and prefix + "w_dkv" in shapes:
                if cfg.n_heads % m == 0 and all(
                        self._on_model(prefix + w, d)
                        for w, d in (("wq", 1), ("wo", 0))):
                    out[prefix] = "mla"
            elif leaf == "wq":
                if self.gqa_heads is not None:
                    out[prefix] = "gqa"
            elif leaf == "w_out" and prefix + "a_log" in shapes:
                if self.ssm_heads is not None:
                    out[prefix] = "ssm"
            elif leaf == "wg" and len(shapes[name]) == 2:
                if all(self._on_model(prefix + w, d) for w, d in (
                        ("wg", 1), ("wu", 1), ("wd", 0))):
                    out[prefix] = "mlp"
        for name in shapes:
            if name.endswith("router"):
                prefix = name[:-len("router")]
                if prefix + "shared." in out and all(
                        self._on_model(prefix + w, d)
                        for w, d in _SPLIT_DIMS["moe"].items()):
                    out[prefix] = "moe"
        return out

    def _on_model(self, name: str, dim: int) -> bool:
        spec = self.specs[name]
        return dim < len(spec) and spec[dim] == ("model",)

    def block_of(self, name: str) -> Optional[str]:
        """The prefix of the innermost split block that holds parameter
        ``name`` (an MoE's ``experts.wg`` lies in the MoE, its
        ``shared.wg`` in the shared experts' MLP), or None."""
        parts = name.split(".")
        for i in range(len(parts) - 1, 0, -1):
            prefix = ".".join(parts[:i]) + "."
            if prefix in self.split_blocks:
                return prefix
        return None

    def sequence(self, seq_len: int) -> Optional[ModelSplit]:
        """The split of a training step's or a prefill's residual over the
        sequence (the JAX package's ``_apply_layer``): at a global sequence
        of ``SEQ_SPLIT_MIN`` or more that the model axis divides, when
        blocks run split over it (not under ``dp_over_tp``); else None.
        GSPMD pads a sequence the axis does not divide; the port keeps
        that residual whole on the model ranks instead."""
        if self.tp_dim is None or seq_len < SEQ_SPLIT_MIN \
                or seq_len % self.sizes[self.tp_dim]:
            return None
        return self.seq_split

    def _plan(self, name: str) -> Plan:
        spec = self.specs[name]
        pls = placements(self.mesh, spec)
        block = self.block_of(name)
        keep = None         # the tensor dim kept split over the model axis
        select = None
        if name in self.vocab_parallel:
            keep = _VOCAB_DIMS[name]
        if block is not None:
            # the dim that holds the heads (the FFN width, the experts):
            # columns of the projections into them, rows of the one back
            # to D, the expert dim of an MoE's stacks; a weight whose
            # model-axis shard is not exactly this rank's part is gathered
            # and cut to it
            kind, leaf = self.split_blocks[block], name[len(block):]
            want = _SPLIT_DIMS[kind].get(leaf)
            if want is not None:
                m = self.sizes[self.tp_dim]
                size = self.shapes[name][want]
                even = [((i * (size // m), size // m),) for i in range(m)]
                cuts = self._head_cuts(leaf) if kind == "gqa" \
                    else self._ssm_cuts(leaf) if kind == "ssm" else even
                if self._on_model(name, want) and cuts == even:
                    keep = want
                else:
                    select = (want, cuts[self.coord[self.tp_dim]])
        gathers = []
        for i in reversed(range(len(self.names))):   # minor axis first
            dim = getattr(pls[i], "dim", None)
            if dim is None or self.sizes[i] == 1:
                continue
            if i == self.tp_dim and keep == dim:
                continue
            gathers.append((i, dim))
        # a split block's weights take gradients partial over the model
        # axis (summed there), except a weight that keeps its model-axis
        # shard: that shard's gradient is whole on its rank, summed over
        # the batch axes alone (_Use.backward skips the kept axis)
        partial = set(self.batch_axes)
        if block is not None:
            partial.add(self.tp_dim)
        return Plan(pls, tuple(gathers), select, tuple(sorted(partial)))

    def _head_cuts(self, leaf: str) -> list:
        """Every model rank's pieces along a split GQA weight's head dim:
        its query heads' or, for ``_KV_LEAVES``, its KV heads'
        (``head_ranges``)."""
        hd, kv = self.cfg.head_dim, leaf in _KV_LEAVES
        return [(((k0 if kv else q0) * hd, (kn if kv else qn) * hd),)
                for q0, qn, k0, kn in self.gqa_heads]

    def _ssm_cuts(self, leaf: str) -> list:
        """Every model rank's pieces along a split SSM weight's dim of
        ``_SPLIT_DIMS`` (``ssm_heads``): w_in's columns [z | x | B | C |
        dt] → its heads' z, x, the whole B and C, its heads' dt; the conv
        channels [x | B | C] → its heads' x, B and C; out_ln's entries and
        w_out's rows its heads' channels; a_log, d_skip, dt_bias its
        heads."""
        sc, d = self.cfg.ssm, self.cfg.d_model
        p, di, bc = sc.head_dim, sc.d_inner(d), 2 * sc.n_groups * sc.d_state
        out = []
        for h0, hn in self.ssm_heads:
            own = (h0 * p, hn * p)
            out.append({"w_in": (own, (di + h0 * p, hn * p), (2 * di, bc),
                                 (2 * di + bc + h0, hn)),
                        "conv_w": (own, (di, bc)), "conv_b": (own, (di, bc)),
                        "out_ln": (own,), "w_out": (own,)
                        }.get(leaf, ((h0, hn),)))
        return out

    # -- the parameters --------------------------------------------------------
    def use(self, name: str, p, dtype: Optional[torch.dtype], *,
            seq: bool = False) -> torch.Tensor:
        """The tensor a layer computes with for parameter ``name`` (a
        DTensor, or its local shard): see ``_Use``. ``seq``: on a training
        step whose residual is split over the sequence."""
        local = p.to_local() if hasattr(p, "to_local") else p
        plan = (self.seq_plans.get(name) if seq else None) \
            or self.plans[name]
        return _Use.apply(local, dtype, self, plan)

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
