"""Token data pipeline: memmap-backed shards + deterministic synthetic stream.

The JAX package's ``repro.data.tokens``, copied as it is (pure numpy): the
same ``batch_at(step)`` from (seed, step) and the same host slicing, so
both packages see the same batches.

Both sources implement the same resumable-iterator protocol: state is a bare
``step`` integer (saved with checkpoints), and ``batch_at(step)`` is a pure
function of (seed, step) — restart-safe by construction, with per-host
sharding done by slicing the global batch (host h of H takes rows
[h·B/H, (h+1)·B/H) — the standard data-parallel contract).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticTokens:
    """Markov-ish synthetic LM stream: deterministic in (seed, step).

    Produces {tokens, labels} with labels = next-token shift; enough
    structure (bigram bias) that training loss visibly decreases.
    """
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    step: int = 0
    host_index: int = 0
    host_count: int = 1

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        b = self.batch // self.host_count
        # bigram-structured stream: x_{t+1} = (a·x_t + noise) mod V
        start = rng.integers(0, self.vocab_size, size=(b, 1))
        mult = 31
        noise = rng.integers(0, 17, size=(b, self.seq_len))
        toks = np.zeros((b, self.seq_len + 1), np.int64)
        toks[:, 0] = start[:, 0]
        for t in range(self.seq_len):
            toks[:, t + 1] = (toks[:, t] * mult + noise[:, t]) % self.vocab_size
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        out = self.batch_at(self.step)
        self.step += 1
        return out


class MemmapTokens:
    """File-backed token shards (one flat int32 .bin per shard).

    Deterministic window sampling in (seed, step); hosts read only their
    slice. ``write_corpus`` builds shards from any int array (used by tests
    and the train example)."""

    def __init__(self, directory: str, batch: int, seq_len: int, *,
                 seed: int = 0, host_index: int = 0, host_count: int = 1):
        self.paths = sorted(
            os.path.join(directory, f) for f in os.listdir(directory)
            if f.endswith(".bin"))
        if not self.paths:
            raise FileNotFoundError(f"no .bin shards under {directory}")
        self.maps = [np.memmap(p, dtype=np.int32, mode="r") for p in self.paths]
        self.sizes = np.array([m.shape[0] for m in self.maps])
        self.batch, self.seq_len, self.seed = batch, seq_len, seed
        self.host_index, self.host_count = host_index, host_count
        self.step = 0

    @staticmethod
    def write_corpus(directory: str, tokens: np.ndarray, n_shards: int = 4) -> None:
        os.makedirs(directory, exist_ok=True)
        for i, chunk in enumerate(np.array_split(tokens.astype(np.int32), n_shards)):
            chunk.tofile(os.path.join(directory, f"shard_{i:04d}.bin"))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        b = self.batch // self.host_count
        shard_ids = rng.integers(0, len(self.maps), size=self.batch)
        offs = rng.integers(0, 1 << 62, size=self.batch)
        lo = self.host_index * b
        toks = np.empty((b, self.seq_len + 1), np.int32)
        for j in range(b):
            m = self.maps[shard_ids[lo + j]]
            start = int(offs[lo + j] % (m.shape[0] - self.seq_len - 1))
            toks[j] = m[start: start + self.seq_len + 1]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        out = self.batch_at(self.step)
        self.step += 1
        return out
