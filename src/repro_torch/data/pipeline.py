"""Data pipeline: deterministic synthetic streams + memmap token corpora.

The port's copy of ``repro.data.pipeline`` (numpy only, so the same code):
``batch_at(step)`` gives the reference's batches bit for bit.

Both sources are *step-addressable* (``batch_at(step)``): any host can
reproduce any global step's batch, which is what checkpoint/restart and
elastic re-sharding need — after a failure the resumed run consumes exactly
the batches it would have, with no data-loader state to persist.

Per-host sharding: a host materialises only its slice of the global batch
(``host_slice``), so the loader scales to thousands of workers.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class BatchSpec:
    global_batch: int
    seq_len: int
    vocab: int
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError("global batch must divide across hosts")
        return self.global_batch // self.n_hosts


class SyntheticLM:
    """Seeded Zipfian token stream with local n-gram structure: enough
    signal that a 100M model's loss visibly falls within a few hundred
    steps (quickstart/train examples), fully deterministic per (seed, step).
    """

    def __init__(self, spec: BatchSpec, seed: int = 0):
        self.spec = spec
        self.seed = seed
        # Zipf weights over the vocab
        ranks = np.arange(1, spec.vocab + 1, dtype=np.float64)
        self._probs = (1.0 / ranks ** 1.1)
        self._probs /= self._probs.sum()

    def batch_at(self, step: int) -> dict:
        spec = self.spec
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, spec.host_id]))
        b, s = spec.host_batch, spec.seq_len
        toks = rng.choice(spec.vocab, size=(b, s + 1), p=self._probs)
        # inject learnable bigram structure: even positions copy forward
        toks[:, 2::2] = (toks[:, 1:-1:2] * 31 + 7) % spec.vocab
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapCorpus:
    """Flat binary token file (uint16/uint32) sampled in fixed windows.

    ``batch_at(step)`` draws deterministic offsets, so the corpus reader has
    the same restartability contract as the synthetic stream.
    """

    def __init__(self, path: str, spec: BatchSpec, dtype="uint16", seed: int = 0):
        self.spec = spec
        self.seed = seed
        self.data = np.memmap(path, dtype=dtype, mode="r")
        if len(self.data) < spec.seq_len + 1:
            raise ValueError("corpus shorter than one sample")

    def batch_at(self, step: int) -> dict:
        spec = self.spec
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, spec.host_id]))
        b, s = spec.host_batch, spec.seq_len
        starts = rng.integers(0, len(self.data) - s - 1, size=b)
        toks = np.stack([self.data[st:st + s + 1] for st in starts])
        toks = toks.astype(np.int32) % spec.vocab
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batches(source, start_step: int = 0):
    """Resume-aware iterator: yields (step, batch) from ``start_step``."""
    step = start_step
    while True:
        yield step, source.batch_at(step)
        step += 1


def write_corpus(path: str, tokens: np.ndarray, dtype="uint16"):
    np.asarray(tokens, dtype=dtype).tofile(path)
