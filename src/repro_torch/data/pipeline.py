"""Deterministic synthetic LM data pipeline (a numpy-only copy of
``repro.data.pipeline``, so both packages train on identical batches).

Sequences are sampled from a fixed random bigram chain (seeded), so the task
has learnable structure (a transformer quickly beats the unigram entropy) and
every batch is a pure function of ``(seed, step)`` — which is what makes
checkpoint/restart and elastic resharding exact: resume at step k regenerates
exactly the batches a non-preempted run would have seen.

Batches are produced as numpy on host; the train step moves them to the
model's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    branching: int = 16      # out-degree of the bigram chain (entropy knob)


class SyntheticLMPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        v, b = cfg.vocab_size, min(cfg.branching, cfg.vocab_size)
        # per-token successor sets + their (unnormalized) preference weights
        self.succ = rng.randint(0, v, size=(v, b)).astype(np.int32)
        w = rng.dirichlet(np.ones(b) * 0.5, size=v).astype(np.float32)
        self.cum_w = np.cumsum(w, axis=1)

    def batch_at(self, step: int) -> dict:
        """-> {'tokens': (B, S+1) int32} ; inputs are [:, :-1], labels [:, 1:]."""
        cfg = self.cfg
        rng = np.random.RandomState((cfg.seed * 1_000_003 + step) % (2**31 - 1))
        B, S = cfg.global_batch, cfg.seq_len + 1
        toks = np.empty((B, S), dtype=np.int32)
        toks[:, 0] = rng.randint(0, cfg.vocab_size, size=B)
        u = rng.random_sample((B, S - 1)).astype(np.float32)
        for t in range(1, S):
            prev = toks[:, t - 1]
            # inverse-CDF sample from each token's successor distribution
            idx = (self.cum_w[prev] < u[:, t - 1: t]).sum(axis=1)
            idx = np.minimum(idx, self.succ.shape[1] - 1)
            toks[:, t] = self.succ[prev, idx]
        return {"tokens": toks}

    def bigram_entropy(self) -> float:
        """Per-token entropy of the chain (nats) — the loss floor."""
        w = np.diff(np.concatenate([np.zeros((self.cum_w.shape[0], 1),
                                             np.float32), self.cum_w], axis=1))
        w = np.clip(w, 1e-12, 1.0)
        return float(-(w * np.log(w)).sum(axis=1).mean())
