"""Train-step factory and host loop: gradient accumulation, remat, AdamW,
checkpoints, preemption and the straggler watchdog.

The JAX package's ``repro.train.trainer``. ``make_train_step`` returns
(params, opt_state, batch) → (params, opt_state, metrics); here the step
updates the float32 masters (a ``TransformerLM`` from
``init_params(..., masters=True)``) and AdamW's moments in place and
returns them. ``Trainer`` adds the host loop: data, checkpoints in the
JAX package's layout (either package restores the other's), SIGTERM and
SIGINT handling, and the per-step wall-time EWMA, the time taken after
``torch.cuda.synchronize`` on the card. It runs on ``"cuda"`` unless given
``device="cpu"``, and raises without a card.

On a mesh (masters from ``transformer.init_params(..., mesh=)`` or
``shard_params``) the same step trains this rank's shards: every rank
feeds the whole batch, ``lm_loss`` takes its rows, the gradients are
reduce-scattered layer by layer during the backward (no rank holds the
whole float32 gradient) and AdamW updates the local shards. The
reference's ``build_cell`` returns this step (``launch.specs``), which
``Trainer`` takes through ``step_fn=`` as the reference's does. A sharded
checkpoint is the reference's tree, gathered leaf by leaf and written by
rank 0; every rank restores its shards from it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import (OptConfig, OptState, apply_updates,
                                         init_opt_state)
from repro_torch.utils import DeviceLike, logger, resolve_device

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    accum_steps: int = 1            # microbatch gradient accumulation
    checkpoint_every: int = 100
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    straggler_slack: float = 2.0    # step slower than slack×EWMA ⇒ flagged
    log_every: int = 10


def _microbatch(batch: Mapping[str, Any], i: int, accum: int
                ) -> Dict[str, Any]:
    """Rows [i·B/A, (i+1)·B/A) of every entry, as the reference slices its
    leading axis."""
    out = {}
    for k, x in batch.items():
        n = x.shape[0] // accum
        out[k] = x[i * n:(i + 1) * n]
    return out


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig
                    ) -> Callable[[T.TransformerLM, OptState,
                                   Mapping[str, Any]],
                                  Tuple[T.TransformerLM, OptState, Metrics]]:
    """(params, opt_state, batch) → (params, opt_state, metrics): the
    gradient of ``lm_loss`` (summed in float32 over ``accum_steps``
    microbatches, then divided by their count), then ``apply_updates``.
    Metrics: ``ce``, ``aux``, ``tokens`` (both 0 under accumulation, as
    the reference reports them), ``loss``, ``grad_norm``, ``lr``."""
    accum = tcfg.accum_steps

    def train_step(params: T.TransformerLM, opt_state: OptState,
                   batch: Mapping[str, Any]):
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        if accum == 1:
            loss, metrics = T.lm_loss(cfg, params, batch)
            loss.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
            # on a mesh the loss is this rank's share, "loss" the global one
            loss = metrics.pop("loss", loss)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=params.device)
            for i in range(accum):
                part, m = T.lm_loss(cfg, params, _microbatch(batch, i, accum))
                part.backward()
                loss = loss + m.get("loss", part).detach()
            for p in named.values():
                if p.grad is not None:
                    p.grad.div_(accum)
            loss = loss / accum
            zero = torch.zeros_like(loss)
            metrics = {"ce": loss, "aux": zero, "tokens": zero}
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in named.items()}
        _, opt_state, stats = apply_updates(named, grads, opt_state,
                                            tcfg.opt)
        metrics["loss"] = loss.detach()
        metrics.update(stats)
        return params, opt_state, metrics

    return train_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Trainer:
    """Host loop: train step + checkpoint/restart + straggler watchdog."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 params: T.TransformerLM,
                 data: Iterator[Dict[str, np.ndarray]],
                 step_fn: Optional[Callable] = None, *,
                 device: DeviceLike = "cuda"):
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        if any(p.dtype != torch.float32 or not p.requires_grad
               for p in params.parameters()):
            raise ValueError("the trainer takes float32 masters that need a "
                             "gradient: init_params(..., masters=True)")
        self.sharded = T.layout_of(params) is not None
        self.params = params if self.sharded else params.to(self.device)
        self.opt_state = init_opt_state(dict(self.params.named_parameters()),
                                        tcfg.opt)
        self.data = data
        self.step = 0
        self._step_fn = step_fn or make_train_step(cfg, tcfg)
        self._ewma: Optional[float] = None
        self.stragglers: list = []
        self._preempted = False

    # -- preemption -----------------------------------------------------
    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT → finish the current step, checkpoint, stop.

        A preemption notice arrives as SIGTERM; a run that checkpoints on
        it loses at most one step on restart (restore() + resumable data
        make it exact)."""
        import signal

        def _handler(signum, frame):
            logger.warning("received signal %d — checkpoint then stop", signum)
            self._preempted = True

        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)

    # -- fault tolerance ---------------------------------------------------
    def _state_tree(self, like: bool = False) -> Dict[str, Any]:
        """{"params", "opt_state"} in the JAX package's layout: numpy
        leaves, or with ``like`` their shapes alone. On a mesh each leaf is
        a function that gathers it (``checkpoint.save`` calls them one at a
        time, on every rank)."""
        conv = T.reference_like if like else \
            (lambda t: T.params_to_reference(self.cfg, t,
                                             lazy=self.sharded))
        st = self.opt_state
        step = torch.empty((), device="meta") if like \
            else np.asarray(int(st.step), np.int32)
        return {"params": conv(self.params),
                "opt_state": OptState(step, conv(st.m), conv(st.v),
                                      None if st.err is None
                                      else conv(st.err))}

    def save(self) -> Optional[str]:
        if self.tcfg.checkpoint_dir is None:
            return None
        writer = not self.sharded or dist.get_rank() == 0
        path = ckpt_lib.save(self.tcfg.checkpoint_dir, self._state_tree(),
                             step=self.step, keep=self.tcfg.keep_checkpoints,
                             write=writer)
        if self.sharded:
            dist.barrier()          # published before any rank reads it
        return path

    def restore(self) -> bool:
        if self.tcfg.checkpoint_dir is None:
            return False
        if ckpt_lib.latest_step(self.tcfg.checkpoint_dir) is None:
            return False
        state, step = ckpt_lib.restore_latest(
            self.tcfg.checkpoint_dir, like=self._state_tree(like=True))
        T.load_reference(self.params, state["params"])
        saved = state["opt_state"]
        st = self.opt_state
        for mine, theirs in ((st.m, saved.m), (st.v, saved.v),
                             (st.err, saved.err)):
            if mine is not None:
                T.load_reference(mine, theirs)
        self.opt_state = st._replace(step=torch.tensor(
            int(saved.step), dtype=torch.int32, device=st.step.device))
        self.step = step
        logger.info("restored checkpoint at step %d", step)
        return True

    # -- loop ---------------------------------------------------------------
    def run(self, num_steps: int) -> Dict[str, float]:
        last: Dict[str, float] = {}
        for _ in range(num_steps):
            batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                     for k, v in next(self.data).items()}
            _sync(self.device)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            _sync(self.device)
            dt = time.perf_counter() - t0
            self.step += 1
            # straggler watchdog: EWMA of step time, flag big outliers
            if self._ewma is None:
                self._ewma = dt
            else:
                if dt > self.tcfg.straggler_slack * self._ewma and self.step > 3:
                    self.stragglers.append((self.step, dt, self._ewma))
                    logger.warning("straggler step %d: %.3fs vs EWMA %.3fs",
                                   self.step, dt, self._ewma)
                self._ewma = 0.9 * self._ewma + 0.1 * dt
            last = {k: float(v) for k, v in metrics.items()}
            last["step_time_s"] = dt
            if self.step % self.tcfg.log_every == 0:
                logger.info("step %d loss %.4f lr %.2e gnorm %.3f (%.2fs)",
                            self.step, last.get("loss", float("nan")),
                            last.get("lr", 0), last.get("grad_norm", 0), dt)
            if (self.tcfg.checkpoint_dir is not None
                    and self.step % self.tcfg.checkpoint_every == 0):
                self.save()
            if self._preempted:
                self.save()
                logger.warning("preempted at step %d — state saved", self.step)
                break
        return last
