"""Batched serving engine with a contiguous cache (mirrors
``repro.serve.engine``): prefill + decode with a fixed-slot batch and
greedy or temperature sampling, plus the sampling helpers the paged
scheduler shares.

Sampling at temperature > 0 is Gumbel-max over the counter hash
(``kernels/common.py::hash_uniform``): the noise for vocabulary entry v of
a row is a function of (seed, stream, index, v) alone, drawn on the device.
The JAX package's ``jax.random`` streams cannot be reproduced in PyTorch, so
the two packages agree on greedy tokens only.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.kernels import common
from repro_torch.models import model as M

# Request-latency histogram edges (ms), log-spaced.  The registry's
# Histogram takes pre-binned counts, so the engine bins on the host: a
# request of latency t lands in bisect(edges, t), one overflow bin past the
# last edge.
LATENCY_BIN_EDGES_MS = (1.0, 3.0, 10.0, 30.0, 100.0, 300.0,
                        1000.0, 3000.0, 10000.0)
N_LATENCY_BINS = len(LATENCY_BIN_EDGES_MS) + 1


def _mix(a: torch.Tensor, b) -> torch.Tensor:
    """A uint32 hash of two uint32 values (int64 tensors), the counter
    hash's finalizer over ``a * 0x9E3779B1 ^ b``."""
    x = common.mul_u32(a & 0xFFFFFFFF, 0x9E3779B1) ^ (b & 0xFFFFFFFF)
    x = x ^ (x >> 16)
    x = common.mul_u32(x, 0x21F0AAAD)
    x = x ^ (x >> 15)
    x = common.mul_u32(x, 0x735A2D97)
    return x ^ (x >> 15)


def stream_keys(seed: int, stream: torch.Tensor,
                index: torch.Tensor) -> torch.Tensor:
    """(B,) uint32 keys (int64) of the sampling streams (seed, stream,
    index): for the scheduler (request id, generated-token index)."""
    s = torch.full_like(stream, int(seed) & 0xFFFFFFFF, dtype=torch.int64)
    return _mix(_mix(s, stream.long()), index.long())


def sample(logits: torch.Tensor, temperature: float,
           keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, V) f32 logits -> (B,) int64 tokens on the logits' device.

    Greedy is ``argmax`` (ties to the first index, as ``jnp.argmax``).
    Otherwise Gumbel-max: argmax(logits / T + g) with g = -log(-log(u)),
    u = hash_uniform(v, keys[b]) for vocabulary entry v."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    u = common.hash_uniform(vocab[None, :], keys[:, None])
    gumbel = -torch.log(-torch.log(u))
    return (logits / temperature + gumbel).argmax(dim=-1)


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 2048
    temperature: float = 0.0       # 0 => greedy
    seed: int = 0


class ServeEngine:
    """Prefill + decode over a contiguous cache for one equal-length
    prompt bucket; ``model`` is the port's ``Model``."""

    def __init__(self, cfg, model, serve_cfg: ServeConfig = ServeConfig(),
                 registry=None):
        M._check_model(cfg, model)
        self.cfg = cfg
        self.model = model
        self.scfg = serve_cfg
        # Optional telemetry: request / prompt-token / generated-token
        # counters, a per-request latency histogram and a generated
        # tokens/s gauge.  None = no telemetry.
        self.registry = registry
        # cumulative latency bins: observe_counts replaces the histogram
        # value, so the engine owns the running counts
        self._lat_counts = np.zeros((N_LATENCY_BINS,), np.int64)
        # per-call stream counter: every generate() call samples its own
        # stream at temperature > 0
        self._n_calls = 0

    def _observe_request(self, n_requests: int, n_tokens: int,
                         wall_s: float) -> None:
        self._lat_counts[bisect.bisect(LATENCY_BIN_EDGES_MS,
                                       wall_s * 1e3)] += n_requests
        self.registry.histogram("serve/latency_ms",
                                n_bins=N_LATENCY_BINS).observe_counts(
                                    self._lat_counts)
        if n_tokens and wall_s > 0:
            self.registry.gauge("serve/tokens_per_s").set(
                n_tokens / wall_s)

    def generate(self, prompts: np.ndarray, max_new_tokens: int):
        """prompts: (B, P) int (equal length for the batch bucket).
        Returns (B, max_new_tokens) int32."""
        B, P = prompts.shape
        if max_new_tokens < 0:
            raise ValueError(f"max_new_tokens must be >= 0, got "
                             f"{max_new_tokens}")
        if P + max_new_tokens > self.scfg.max_len:
            raise ValueError(
                f"prompt length {P} + max_new_tokens {max_new_tokens} "
                f"exceeds max_len {self.scfg.max_len}")
        if self.registry is not None:
            self.registry.counter("serve/requests").inc(B)
            self.registry.counter("serve/prompt_tokens").inc(B * P)
        t0 = time.perf_counter()
        if max_new_tokens == 0:
            # the prefill-sampled token belongs to position P; emitting it
            # would return shape (B, 1) for a 0-token request
            if self.registry is not None:
                self._observe_request(B, 0, time.perf_counter() - t0)
            return np.zeros((B, 0), np.int32)
        dev = self.model.device
        call = torch.full((B,), self._n_calls, dtype=torch.int64,
                          device=dev)
        self._n_calls += 1
        rows = torch.arange(B, device=dev)
        # one stream per (call, step), one key per batch row
        keys = lambda i: _mix(stream_keys(self.scfg.seed, call,
                                          torch.full_like(rows, i)), rows)
        tokens = device_lib.to_device(
            torch.from_numpy(np.asarray(prompts, np.int64).copy()), dev)
        logits, caches = M.prefill(self.cfg, self.model, tokens,
                                   max_len=self.scfg.max_len)
        tok = sample(logits[:, -1], self.scfg.temperature, keys(0))
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits, caches = M.decode_step(self.cfg, self.model,
                                           tok[:, None], caches, P + i)
            tok = sample(logits[:, 0], self.scfg.temperature, keys(i + 1))
            out.append(tok)
        res = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        if self.registry is not None:
            self.registry.counter("serve/generated_tokens").inc(
                B * max_new_tokens)
            self._observe_request(B, B * max_new_tokens,
                                  time.perf_counter() - t0)
        return res
