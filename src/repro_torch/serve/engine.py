"""Batched serving engine: prefill, then a decode loop with sampling.

The JAX package's ``repro.serve.engine``: ``Engine`` drives the host loop
over fixed slots, with greedy or temperature sampling and EOS handling.
PyTorch runs eagerly, so there is no step to ``jit``: the engine calls
``transformer.prefill`` and ``transformer.decode_step`` itself. Sampling
draws from a ``torch.Generator`` seeded with ``seed``; it cannot replay
``jax.random``, so at a temperature above 0 the two packages draw
different tokens from the same seed (greedy decoding agrees).

``make_prefill_step`` and ``make_serve_step`` are the reference's step
functions (``launch.specs.build_cell`` returns them). With weights on a
mesh (``transformer.shard_params``) they run this rank's share with the
caches of ``init_cache(..., mesh=)`` (``sharding.cache_specs``' split, a
split GQA's K/V held by this rank's own KV heads) and return DTensor
logits; ``Engine`` then gathers each step's logits, so every rank samples
the same tokens.

``Engine`` runs on the card unless given ``device="cpu"``, and raises
without a card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.utils import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    cache_len: int
    batch_size: int
    temperature: float = 0.0      # 0 → greedy
    eos_token: Optional[int] = None


def make_serve_step(cfg: ModelConfig):
    """(params, token, caches, pos) → (logits, caches): one decode step."""
    def serve_step(params, token, caches, pos):
        return T.decode_step(cfg, params, token, caches, pos)
    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """(params, batch, caches) → (last logits, caches)."""
    def prefill_step(params, batch, caches):
        return T.prefill(cfg, params, batch, caches)
    return prefill_step


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature: float) -> torch.Tensor:
    """Next tokens (B,) int64: argmax when ``temperature <= 0``, else one
    categorical draw per row from softmax(logits / temperature)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class Engine:
    """Minimal batched generation loop over fixed slots.

    After each ``generate``, ``last_stats`` holds its host-clock timings
    (every one ends where a token reaches the host, which waits for the
    device): ``prefill_s`` (prompt forward, synchronised), ``ttft_s``
    (prompt to first token on the host), ``decode_s`` and ``decode_steps``.
    """

    def __init__(self, cfg: ModelConfig, params: T.TransformerLM,
                 scfg: ServeConfig, *, device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params lie on {params.device}, the engine "
                             f"serves on {self.device}")
        self.cfg, self.params, self.scfg = cfg, params, scfg
        self.last_stats: dict = {}

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def generate(self, prompts, max_new: int, *,
                 seed: int = 0) -> np.ndarray:
        """prompts: (B, P) integer tokens, or (B, P, D) float embeds for a
        model on embedding input (an array or a tensor). Each decode step
        of an embeds model feeds zeros (B, D), as the JAX package's engine
        does (its frontend is a stub). Returns (B, max_new) int32."""
        cfg, scfg = self.cfg, self.scfg
        prompts = torch.as_tensor(prompts, device=self.device)
        b, p = prompts.shape[:2]
        if b != scfg.batch_size:
            raise ValueError(f"{b} prompts for {scfg.batch_size} slots")
        if p + max_new - 1 > scfg.cache_len:
            raise ValueError(f"{p} prompt + {max_new} new tokens do not fit "
                             f"a cache of {scfg.cache_len}")
        layout = T.layout_of(self.params)
        caches = T.init_cache(cfg, b, scfg.cache_len, device=self.device,
                              mesh=None if layout is None else layout.mesh)
        embeds = cfg.input_mode != "tokens"
        batch = {"embeds" if embeds else "tokens": prompts}
        gen = torch.Generator(device=self.device).manual_seed(seed)
        t0 = self._sync()
        logits, caches = T.prefill(cfg, self.params, batch, caches)
        logits = S.whole(logits)
        t_prefill = self._sync()
        tok = sample(logits, gen, scfg.temperature)
        tok_host = tok.cpu().numpy()
        t_first = time.perf_counter()
        out = np.zeros((b, max_new), np.int32)
        done = np.zeros((b,), bool)
        steps = 0
        for i in range(max_new):
            out[:, i] = np.where(done, scfg.eos_token or 0, tok_host)
            if scfg.eos_token is not None:
                done |= tok_host == scfg.eos_token
                if done.all():
                    break
            if i + 1 == max_new:
                break           # the JAX loop's last decode feeds no token
            feed = torch.zeros((b, cfg.d_model), device=self.device) \
                if embeds else tok
            logits, caches = T.decode_step(cfg, self.params, feed, caches,
                                           p + i)
            logits = S.whole(logits)
            tok = sample(logits, gen, scfg.temperature)
            tok_host = tok.cpu().numpy()
            steps += 1
        self.last_stats = {
            "prompt_tokens": b * p, "prefill_s": t_prefill - t0,
            "ttft_s": t_first - t0, "decode_steps": steps,
            "decode_s": time.perf_counter() - t_first}
        return out
