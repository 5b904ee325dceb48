"""LM assembly for serving: embeddings, segments of layers, the head.

Public entry points (the JAX package's ``repro.models.transformer``, for
layers of a GQA, MLA, SSM or hybrid mixer and an MLP, MoE or no FFN, on
token or embedding input):
  - ``init_params``          weights drawn from a ``torch.Generator``
  - ``params_from_reference`` the JAX package's parameter tree (numpy) as
                             this port's modules
  - ``empty_params``         the modules, uninitialised (on ``"meta"``: the
                             shapes alone, no memory)
  - ``forward_hidden``       (B, S, D) final hidden states (+ MoE aux loss)
  - ``init_cache``           decode caches for all segments
  - ``prefill``              fill the caches from a prompt, last logits
  - ``decode_step``          one token against the caches

This is a serving port. Weights are held in ``cfg.dtype`` on the device
and carry no gradient; the trainer's float32 masters and ``lm_loss`` come
with the training slice (ROADMAP.md A10.5). A layer is an ``nn.Module``, a
segment a ``ModuleList``, and layers run in a Python loop (the JAX package
scans them). Caches are updated in place and returned.

Entry points run on the card unless given ``device="cpu"``; without a card
they raise.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.models import layers as L
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
    layer without an FFN (Mamba2's) has no ``ln2`` and ``ffn`` is None."""

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

    def forward(self, x: torch.Tensor, rope, cache=None, pos=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cos, sin = rope
        eps = self.cfg.norm_eps
        mix, _ = self.mixer(L.rmsnorm(x, self.ln1, eps), cos, sin,
                            window=self.window, cache=cache, pos=pos)
        x = x + mix
        if self.ffn is None:
            return x, None
        y = self.ffn(L.rmsnorm(x, self.ln2, eps))
        if isinstance(self.ffn, L.MoE):
            y, aux = y
            return x + y, aux
        return x + y, None


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


def empty_params(cfg: ModelConfig, *,
                 device: DeviceLike = "cuda") -> TransformerLM:
    """The modules of ``cfg`` in ``cfg.dtype`` on ``device``, their weights
    uninitialised (norms 1). ``device="meta"`` gives the shapes alone, with
    no memory: ``sum(p.numel() for p in model.parameters())`` counts a
    full-width model."""
    check_layers(cfg)
    dev = torch.device(device) if str(device) == "meta" \
        else resolve_device(device)
    dtype = _dtype(cfg)
    segments = nn.ModuleList(
        nn.ModuleList(_layer(cfg, seg, dev, dtype, None)
                      for _ in range(seg.count)) for seg in cfg.segments)
    return TransformerLM(cfg, segments, device=dev, dtype=dtype)


def init_params(cfg: ModelConfig, generator: "torch.Generator | int" = 0, *,
                device: DeviceLike = "cuda") -> TransformerLM:
    """Weights of ``cfg`` in ``cfg.dtype`` on ``device``: N(0, 0.02²) (the
    output projections scaled by 1/√(2·n_layers), a MoE router N(0,
    0.006²), an SSM's as ``layers.init_ssm``), norms 1, biases 0, as the
    JAX package's ``init_params``. ``generator`` is a
    ``torch.Generator`` on ``device`` or an int seed for one; it cannot
    replay ``jax.random``, so the two packages draw different weights from
    the same seed (the tests carry weights across with
    ``params_from_reference``)."""
    check_layers(cfg)
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, device {dev}")
    dtype = _dtype(cfg)
    segments = nn.ModuleList()
    model = TransformerLM(cfg, segments, device=dev, dtype=dtype)
    if cfg.input_mode == "tokens":
        L.normal_(model.embed, generator)
    if not cfg.tie_embeddings:
        L.normal_(model.head, generator)
    for seg in cfg.segments:
        segments.append(nn.ModuleList(
            _layer(cfg, seg, dev, dtype, generator)
            for _ in range(seg.count)))
    return model


def params_from_reference(cfg: ModelConfig, tree: Mapping[str, Any], *,
                          device: DeviceLike = "cuda") -> TransformerLM:
    """The JAX package's parameter tree as this port's modules.

    ``tree`` is ``repro.models.transformer.init_params``'s output with its
    leaves as numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``):
    ``embed`` (token input), ``head``, ``final_ln`` and
    ``segments.seg<i>.{ln1, mixer, ln2, ffn}`` (no ``ln2`` and ``ffn``
    without an FFN), each stacked along the segment's layer axis (the
    MoE's ``experts`` and ``shared`` and the hybrid's ``attn`` and ``ssm``
    are nested dicts there, submodules here).
    Leaves are rounded to ``cfg.dtype``, as the JAX package casts them at
    the forward boundary."""
    model = empty_params(cfg, device=device)

    def put(w: torch.Tensor, a) -> None:
        a = torch.tensor(np.asarray(a))
        if a.shape != w.shape:
            raise ValueError(f"reference leaf of shape {tuple(a.shape)} for "
                             f"a weight of shape {tuple(w.shape)}")
        with torch.no_grad():
            w.copy_(a)

    def leaf(sub: Mapping[str, Any], name: str):
        for part in name.split("."):        # "experts.wg" → ["experts"]["wg"]
            sub = sub[part]
        return sub

    if cfg.input_mode == "tokens":
        put(model.embed, tree["embed"])
    if not cfg.tie_embeddings:
        put(model.head, tree["head"])
    put(model.final_ln, tree["final_ln"])
    for i, layers in enumerate(model.segments):
        st = tree["segments"][f"seg{i}"]
        for j, layer in enumerate(layers):
            put(layer.ln1, st["ln1"][j])
            parts = ["mixer"]
            if layer.ffn is not None:
                put(layer.ln2, st["ln2"][j])
                parts.append("ffn")
            for part in parts:
                for name, w in getattr(layer, part).named_parameters():
                    put(w, leaf(st[part], name)[j])
    return model


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


def _rope_for(cfg: ModelConfig, positions: torch.Tensor):
    return L.rope_tables(positions, cfg.rotary_dim, cfg.rope_theta,
                         cfg.mrope_sections)


def _prompt_rope(cfg: ModelConfig, batch: Mapping[str, Any],
                 x: torch.Tensor):
    """RoPE tables of ``batch["positions"]`` ((B, S), or (3, B, S) under
    M-RoPE) where given, else of 0..S−1 (plain RoPE, M-RoPE or not)."""
    if "positions" in batch:
        return _rope_for(cfg, torch.as_tensor(batch["positions"],
                                              device=x.device).long())
    b, s, _ = x.shape
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


@torch.no_grad()
def forward_hidden(cfg: ModelConfig, params: TransformerLM,
                   batch: Mapping[str, Any]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final hidden states (B, S, D) and the summed MoE aux loss (0 for a
    model without MoE layers)."""
    x = _embed_inputs(cfg, params, batch)
    x, aux = _run(params, x, _prompt_rope(cfg, batch, x), None, None)
    return L.rmsnorm(x, params.final_ln, cfg.norm_eps), aux


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int, *,
               device: DeviceLike = "cuda") -> Caches:
    """Zeroed caches for every segment, stacked along the layer count:
    ``{"seg<i>": {"k", "v"}}`` of (count, B, cache_len, Hkv·hd) for a GQA
    segment, ``{"ckv", "kr"}`` of (count, B, cache_len, kv_lora_rank) and
    (count, B, cache_len, qk_rope_dim) for an MLA one, ``{"state",
    "conv"}`` of (count, B, H, N, P) float32 and (count, B, K−1, C) for an
    SSM one, all four for a hybrid one."""
    check_layers(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    caches: Caches = {}
    for i, seg in enumerate(cfg.segments):
        shapes = {}
        if seg.mixer in ("gqa", "hybrid"):
            kv = (cache_len, cfg.n_kv_heads * cfg.head_dim)
            shapes.update(k=(kv, dtype), v=(kv, dtype))
        if seg.mixer == "mla":
            shapes.update(ckv=((cache_len, cfg.mla.kv_lora_rank), dtype),
                          kr=((cache_len, cfg.mla.qk_rope_dim), dtype))
        if seg.mixer in ("ssm", "hybrid"):
            s, d = cfg.ssm, cfg.d_model
            shapes.update(
                state=((s.n_heads(d), s.d_state, s.head_dim), torch.float32),
                conv=((s.conv_kernel - 1, s.conv_channels(d)), dtype))
        caches[f"seg{i}"] = {
            name: torch.zeros((seg.count, batch_size) + shape, dtype=dt,
                              device=dev)
            for name, (shape, dt) in shapes.items()}
    return caches


def _logits(cfg: ModelConfig, params: TransformerLM,
            h: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(h, params.final_ln, cfg.norm_eps)
    return (h @ params.head_matrix()).float()


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
    x = _embed_inputs(cfg, params, batch)
    x, _ = _run(params, x, _prompt_rope(cfg, batch, x), caches, 0)
    return _logits(cfg, params, x[:, -1]), caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: TransformerLM, token,
                caches: Caches, pos: int) -> Tuple[torch.Tensor, Caches]:
    """One decode step. token: (B,) integer, or (B, D) embeds for a model on
    embedding input; pos: its position (every M-RoPE stream's)."""
    if cfg.input_mode == "tokens":
        x = _embed(params, token)[:, None]
    else:
        x = torch.as_tensor(token, device=params.device).to(
            _dtype(cfg))[:, None]
    b = x.shape[0]
    positions = torch.full((b, 1), int(pos), device=params.device)
    if cfg.mrope_sections is not None:
        positions = positions[None].expand(3, b, 1)
    x, _ = _run(params, x, _rope_for(cfg, positions), caches, int(pos))
    return _logits(cfg, params, x[:, 0]), caches
