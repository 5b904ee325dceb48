"""LM assembly for serving: embeddings, segments of layers, the head.

Public entry points (the JAX package's ``repro.models.transformer``, for
the dense GQA architectures):
  - ``init_params``          weights drawn from a ``torch.Generator``
  - ``params_from_reference`` the JAX package's parameter tree (numpy) as
                             this port's modules
  - ``forward_hidden``       (B, S, D) final hidden states (+ aux loss 0)
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

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, Segment
from repro_torch.utils import DeviceLike, resolve_device

Caches = Dict[str, Dict[str, torch.Tensor]]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a layer kind or input path that
    this port does not have yet."""
    kinds = {(s.mixer, s.ffn) for s in cfg.segments}
    if kinds - {("gqa", "mlp")} or cfg.input_mode != "tokens" \
            or cfg.mrope_sections is not None:
        raise NotImplementedError(
            f"{cfg.name}: layers {sorted(kinds)}, input {cfg.input_mode!r}, "
            f"M-RoPE {cfg.mrope_sections}: only dense GQA + MLP layers on "
            "token input are ported (ROADMAP.md A10)")


class Layer(nn.Module):
    """Pre-norm residual layer: x + mixer(norm(x)), then x + ffn(norm(x))."""

    def __init__(self, cfg: ModelConfig, seg: Segment, mixer: L.GQA,
                 ffn: L.MLP) -> None:
        super().__init__()
        self.cfg, self.window = cfg, seg.window
        dev, dt = mixer.wq.device, mixer.wq.dtype
        self.ln1 = L.param(cfg.d_model, device=dev, dtype=dt, fill=1.0)
        self.mixer = mixer
        self.ln2 = L.param(cfg.d_model, device=dev, dtype=dt, fill=1.0)
        self.ffn = ffn

    def forward(self, x: torch.Tensor, rope, cache=None, pos=None):
        cos, sin = rope
        eps = self.cfg.norm_eps
        mix, _ = self.mixer(L.rmsnorm(x, self.ln1, eps), cos, sin,
                            window=self.window, cache=cache, pos=pos)
        x = x + mix
        return x + self.ffn(L.rmsnorm(x, self.ln2, eps))


class TransformerLM(nn.Module):
    """The parameters of one model: ``embed`` (V, D), ``head`` (D, V) unless
    tied, ``final_ln`` (D,), and ``segments[i][j]`` the ``Layer`` j of
    segment i."""

    def __init__(self, cfg: ModelConfig, segments: nn.ModuleList, *,
                 device, dtype: torch.dtype) -> None:
        super().__init__()
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = L.param(v, d, device=device, dtype=dtype)
        if not cfg.tie_embeddings:
            self.head = L.param(d, v, device=device, dtype=dtype)
        self.final_ln = L.param(d, device=device, dtype=dtype, fill=1.0)
        self.segments = segments

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head_matrix(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.head


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: "torch.Generator | int" = 0, *,
                device: DeviceLike = "cuda") -> TransformerLM:
    """Weights of ``cfg`` in ``cfg.dtype`` on ``device``: N(0, 0.02²) (the
    output projections scaled by 1/√(2·n_layers)), norms 1, biases 0, as
    the JAX package's ``init_params``. ``generator`` is a
    ``torch.Generator`` on ``device`` or an int seed for one; it cannot
    replay ``jax.random``, so the two packages draw different weights from
    the same seed (the tests carry weights across with
    ``params_from_reference``)."""
    check_ported(cfg)
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, device {dev}")
    dtype = _dtype(cfg)
    segments = nn.ModuleList()
    model = TransformerLM(cfg, segments, device=dev, dtype=dtype)
    L.normal_(model.embed, generator)
    if not cfg.tie_embeddings:
        L.normal_(model.head, generator)
    for seg in cfg.segments:
        segments.append(nn.ModuleList(
            Layer(cfg, seg, L.init_gqa(cfg, generator, dtype=dtype),
                  L.init_mlp(cfg, generator, seg.d_ff, dtype=dtype))
            for _ in range(seg.count)))
    return model


def params_from_reference(cfg: ModelConfig, tree: Mapping[str, Any], *,
                          device: DeviceLike = "cuda") -> TransformerLM:
    """The JAX package's parameter tree as this port's modules.

    ``tree`` is ``repro.models.transformer.init_params``'s output with its
    leaves as numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``):
    ``embed``, ``head``, ``final_ln`` and ``segments.seg<i>.{ln1, mixer,
    ln2, ffn}``, each stacked along the segment's layer axis. Leaves are
    rounded to ``cfg.dtype``, as the JAX package casts them at the forward
    boundary."""
    check_ported(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)

    def put(w: torch.Tensor, a) -> None:
        a = torch.tensor(np.asarray(a))
        if a.shape != w.shape:
            raise ValueError(f"reference leaf of shape {tuple(a.shape)} for "
                             f"a weight of shape {tuple(w.shape)}")
        with torch.no_grad():
            w.copy_(a)

    segments = nn.ModuleList()
    model = TransformerLM(cfg, segments, device=dev, dtype=dtype)
    put(model.embed, tree["embed"])
    if not cfg.tie_embeddings:
        put(model.head, tree["head"])
    put(model.final_ln, tree["final_ln"])
    for i, seg in enumerate(cfg.segments):
        st = tree["segments"][f"seg{i}"]
        layers = nn.ModuleList()
        for j in range(seg.count):
            layer = Layer(cfg, seg, L.GQA(cfg, device=dev, dtype=dtype),
                          L.MLP(cfg, seg.d_ff, device=dev, dtype=dtype))
            put(layer.ln1, st["ln1"][j])
            put(layer.ln2, st["ln2"][j])
            for name, w in layer.mixer.named_parameters():
                put(w, st["mixer"][name][j])
            for name, w in layer.ffn.named_parameters():
                put(w, st["ffn"][name][j])
            layers.append(layer)
        segments.append(layers)
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed(params: TransformerLM, tokens) -> torch.Tensor:
    return params.embed[torch.as_tensor(tokens, device=params.device).long()]


def _rope_for(cfg: ModelConfig, positions: torch.Tensor):
    return L.rope_tables(positions, cfg.rotary_dim, cfg.rope_theta,
                         cfg.mrope_sections)


def _prompt_rope(cfg: ModelConfig, x: torch.Tensor):
    b, s, _ = x.shape
    return _rope_for(cfg, torch.arange(s, device=x.device)[None].expand(b, s))


def _run(params: TransformerLM, x: torch.Tensor, rope,
         caches: Optional[Caches], pos: Optional[int]) -> torch.Tensor:
    for i, seg in enumerate(params.segments):
        c = caches[f"seg{i}"] if caches is not None else None
        for j, layer in enumerate(seg):
            cache = {"k": c["k"][j], "v": c["v"][j]} if c is not None \
                else None
            x = layer(x, rope, cache, pos)   # writes into c in place
    return x


@torch.no_grad()
def forward_hidden(cfg: ModelConfig, params: TransformerLM,
                   batch: Mapping[str, Any]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final hidden states (B, S, D) and the summed MoE aux loss (0 here:
    no MoE layer is ported)."""
    x = _embed(params, batch["tokens"])
    x = _run(params, x, _prompt_rope(cfg, x), None, None)
    aux = torch.zeros((), dtype=torch.float32, device=params.device)
    return L.rmsnorm(x, params.final_ln, cfg.norm_eps), aux


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int, *,
               device: DeviceLike = "cuda") -> Caches:
    """Zeroed caches for every segment, stacked along the layer count:
    ``{"seg<i>": {"k", "v"}}`` of (count, B, cache_len, Hkv·hd)."""
    check_ported(cfg)
    dev = resolve_device(device)
    kv = cfg.n_kv_heads * cfg.head_dim
    return {f"seg{i}": {
        name: torch.zeros((seg.count, batch_size, cache_len, kv),
                          dtype=_dtype(cfg), device=dev)
        for name in ("k", "v")} for i, seg in enumerate(cfg.segments)}


def _logits(cfg: ModelConfig, params: TransformerLM,
            h: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(h, params.final_ln, cfg.norm_eps)
    return (h @ params.head_matrix()).float()


@torch.no_grad()
def prefill(cfg: ModelConfig, params: TransformerLM,
            batch: Mapping[str, Any], caches: Caches
            ) -> Tuple[torch.Tensor, Caches]:
    """Consume a prompt, fill the caches, return last-position logits
    (B, V) float32. The attention of the prompt runs through the flash
    kernel, once per layer."""
    x = _embed(params, batch["tokens"])
    x = _run(params, x, _prompt_rope(cfg, x), caches, 0)
    return _logits(cfg, params, x[:, -1]), caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: TransformerLM, token,
                caches: Caches, pos: int) -> Tuple[torch.Tensor, Caches]:
    """One decode step. token: (B,) integer; pos: its position."""
    x = _embed(params, token)[:, None]
    b = x.shape[0]
    positions = torch.full((b, 1), int(pos), device=params.device)
    x = _run(params, x, _rope_for(cfg, positions), caches, int(pos))
    return _logits(cfg, params, x[:, 0]), caches
