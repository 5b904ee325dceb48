"""SC_RB — the paper's Algorithm 2, end to end, on one device.

  1. Z  ← RB features of X          (Alg. 1, hashed ELL)          O(NRd)
  2. D̂ ← Z(Zᵀ1); Ẑ = D̂^{-1/2} Z    (Eq. 6, two ELL mat-vecs)     O(NR)
  3. U  ← top-K left singular vecs of Ẑ (blocked LOBPCG)          O(KNRm)
  4. Û ← row-normalize(U)
  5. labels ← k-means(Û, K)                                        O(NK²t)

Both entry points are thin wrappers over ``SCRBModel.fit``:
``sc_rb(x, cfg)`` is exactly ``SCRBModel.fit(x, cfg).fit_result``. They run
on the card unless ``device="cpu"`` is passed. ``SCRBConfig(chunk_size=n)``
streams host row chunks of n rows through every stage (residency
``host_chunked``: the device holds O(n·R), whatever N is); ``x`` may then
also be a list of host row chunks.
"""
from __future__ import annotations

import torch

from repro_torch.core.executor import (  # noqa: F401
    ExecutionPlan, FitResult, SCRBConfig, SCRBResult, execute,
    plan_from_config,
)
from repro_torch.core.model import SCRBModel


def sc_rb(x, config: SCRBConfig, *, plan: "ExecutionPlan | None" = None,
          device="cuda") -> FitResult:
    """Run Algorithm 2 on ``device`` (the card unless asked for the CPU).
    ``plan`` replaces the config's plan (``plan_from_config``), e.g. to
    inject a fitted map or the eigensolver's start block."""
    return SCRBModel.fit(x, config, plan=plan, device=device).fit_result


#: Historical name for the stages-1–4 result.
SpectralEmbedding = FitResult


def spectral_embed(x, config: SCRBConfig, *, device="cuda") -> FitResult:
    """Stages 1–4 only: row-normalized embedding + singular values (as
    tensors on the CPU); unpacks as ``(embedding, singular_values)``."""
    res = SCRBModel.fit(x, config, final_stage="normalize",
                        device=device).fit_result
    res.embedding = torch.as_tensor(res.embedding)
    res.singular_values = torch.as_tensor(res.singular_values)
    return res
