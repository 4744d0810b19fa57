"""Slot-based continuous batching over the paged quantized KV cache
(mirrors ``repro.serve.scheduler``).

One decode step advances every active slot; a slot frees the moment its
request completes, so the next waiting request admits mid-stream.

  * submit-time validation: a request that could never fit the pool
    (``ceil((P + max_new) / page_size)`` pages beyond the per-seq cap or
    the whole pool) is rejected with ``ConfigError`` up front;
  * admit = reserve a slot and the prompt's pages, prefill the prompt
    through the dense 16-bit path (batch 1, ``max_len == P``), quantize the
    rows into the reserved pages (``commit_prefill_to_paged``), and sample
    the first token from the prefill logits;
  * lazy extension: pages are allocated one page boundary at a time; when
    the pool is dry the youngest request is preempted (LIFO) — released
    and pushed back to the front of the waiting queue;
  * restart-safe sampling: generated token g of request rid is drawn from
    the stream keyed by (seed, rid, g) (``engine.sample``, Gumbel-max over
    the counter hash), independent of scheduling, so a preempted request
    regenerates the tokens it lost and eviction cannot change tokens.

Sampling and the position advance run on the device inside the step: the
scheduler needs token counts, which it knows, never token values, so the
decode steps between two scheduling events queue back to back with no
host round trip, and the token values come back in one copy per
``serve``.  The host waits once per completion (the latency observation).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.errors import ConfigError
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve import engine as engine_lib
from repro_torch.serve.kvcache import (PagedKVCache, PagedKVConfig,
                                       kv_bytes_per_token)


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    prompt: tuple                  # token ids
    max_new_tokens: int


@dataclasses.dataclass
class SchedulerConfig:
    kv: PagedKVConfig = dataclasses.field(default_factory=PagedKVConfig)
    temperature: float = 0.0       # 0 => greedy
    seed: int = 0
    impl: str = "cuda"             # gather-dequant: "cuda" (B7) | "torch"


class ContinuousBatchingEngine:
    """Continuous batching: admit/evict per decode step, paged 8/4-bit KV.
    ``model`` is the port's ``Model``; the pool lives on its device."""

    def __init__(self, cfg, model, sched_cfg: Optional[SchedulerConfig] =
                 None, registry=None):
        M._check_model(cfg, model)
        self.cfg = cfg
        self.model = model
        self.scfg = sched_cfg or SchedulerConfig()
        self.registry = registry
        self.kv = PagedKVCache(self.scfg.kv)
        kvc = self.scfg.kv
        self.device = model.device
        self.caches = M.init_paged_cache(cfg, kvc.n_slots, kvc.n_pages,
                                         kvc.page_size, kvc.kv_bits,
                                         device=self.device)
        self._cfg16 = dataclasses.replace(cfg, kv_cache_bits=16)
        self._lat_counts = np.zeros((engine_lib.N_LATENCY_BINS,), np.int64)
        self._latencies_ms: list = []
        self._last_tok = torch.zeros((kvc.n_slots,), dtype=torch.int64,
                                     device=self.device)
        self._live: dict = {}      # rid -> live-request record (see _admit)
        self._admitted: list = []  # admission tokens (device scalars)
        self.last_logits: Optional[torch.Tensor] = None   # last decode step
        self.decode_steps = 0      # decode steps run, over every serve()

    # ----------------------------------------------------------- helpers
    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device, from a private copy.  The copy
        matters: ``PagedKVCache`` writes ``page_table`` and ``positions``
        in place (admit/extend/advance/release) while decode steps that
        read the uploaded values may still be queued on the device, and a
        host-to-device copy need not have read its source when it returns
        (``torch.from_numpy`` aliases the array; ``to_device`` is
        non-blocking, and on the CPU returns its input).  The JAX
        reference uploads aliases here, and its queued steps read
        bookkeeping from later steps."""
        return device_lib.to_device(torch.from_numpy(np.array(a)),
                                    self.device)

    def _sample(self, rows: torch.Tensor, rids: torch.Tensor,
                gen_idx: torch.Tensor) -> torch.Tensor:
        """rows: (B, V) logits -> (B,) int64 tokens, on the device."""
        temp = self.scfg.temperature
        keys = None if temp <= 0.0 else \
            engine_lib.stream_keys(self.scfg.seed, rids, gen_idx)
        return engine_lib.sample(rows, temp, keys)

    def _step(self, table, pos, rids, gen_idx):
        """One decode step with every bookkeeping update on the device:
        sample, then advance the positions and generation counters of the
        active slots."""
        paged = L.PagedContext(table, pos, impl=self.scfg.impl)
        self.decode_steps += 1
        logits, self.caches = M.paged_decode_step(
            self.cfg, self.model, self._last_tok[:, None], self.caches,
            paged)
        self.last_logits = logits[:, 0]
        self._last_tok = self._sample(self.last_logits, rids, gen_idx)
        active = pos >= 0
        return (torch.where(active, pos + 1, pos),
                torch.where(active, gen_idx + 1, gen_idx))

    def _count(self, name: str, n: int = 1):
        if self.registry is not None:
            self.registry.counter(name).inc(n)

    def _gauges(self):
        if self.registry is None:
            return
        kvc = self.scfg.kv
        self.registry.gauge("serve/sched/slot_occupancy").set(
            self.kv.n_active / kvc.n_slots)
        self.registry.gauge("serve/sched/page_occupancy").set(
            self.kv.alloc.occupancy)

    def _observe_request(self, wall_ms: float):
        self._latencies_ms.append(wall_ms)
        if self.registry is None:
            return
        self._lat_counts[bisect.bisect(engine_lib.LATENCY_BIN_EDGES_MS,
                                       wall_ms)] += 1
        self.registry.histogram(
            "serve/latency_ms",
            n_bins=engine_lib.N_LATENCY_BINS).observe_counts(self._lat_counts)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # ------------------------------------------------------- transitions
    def _validate(self, req: Request):
        kvc = self.scfg.kv
        total = len(req.prompt) + req.max_new_tokens
        need = kvc.pages_needed(total)
        if need > kvc.max_pages_per_seq or need > kvc.n_pages:
            raise ConfigError(
                f"request {req.rid}: {total} tokens need {need} pages, "
                f"pool caps at min(max_pages_per_seq={kvc.max_pages_per_seq}"
                f", n_pages={kvc.n_pages})")
        if req.max_new_tokens <= 0:
            raise ConfigError(
                f"request {req.rid}: max_new_tokens must be positive")

    def _admit(self, req: Request) -> bool:
        P = len(req.prompt)
        slot = self.kv.admit(req.rid, P)
        if slot is None:
            return False
        t0 = time.perf_counter()
        tokens = self._upload(np.asarray(req.prompt, np.int64)[None])
        logits, dense = M.prefill(self._cfg16, self.model, tokens,
                                  max_len=P)
        M.commit_prefill_to_paged(self.cfg, self.caches, dense, slot,
                                  self._upload(self.kv.page_table[slot]), P,
                                  kv_bits=self.scfg.kv.kv_bits)
        tok0 = self._sample(logits[0, -1][None],
                            self._upload(np.asarray([req.rid])),
                            self._upload(np.zeros(1, np.int64)))[0]
        # out of place: earlier steps' token vectors are kept for the
        # final copy
        self._last_tok = self._last_tok.clone()
        self._last_tok[slot] = tok0
        # chain = where each generated token lives, without syncing:
        # ("a", index into the admission tokens) or ("s", decode step)
        self._admitted.append(tok0)
        self._live[req.rid] = {"req": req, "t0": t0, "n_out": 1,
                               "chain": [("a", len(self._admitted) - 1)]}
        self._count("serve/sched/admitted")
        self._count("serve/prompt_tokens", P)
        return True

    def _evict_youngest(self, waiting, protect=None) -> bool:
        """Preempt the youngest admitted request back to the queue front."""
        victims = sorted(self.kv.slots.values(), key=lambda s: -s.admit_order)
        for st in victims:
            if st.rid == protect:
                continue
            self.kv.release(st.rid)
            waiting.appendleft(self._live.pop(st.rid)["req"])
            self._count("serve/sched/evictions")
            return True
        return False

    def _complete(self, rid: int, done: dict):
        st = self._live.pop(rid)
        self.kv.release(rid)
        # wait for the request's last token: the one device sync per
        # request, and what makes the latency observation wall-clock true
        self._sync()
        done[rid] = st
        self._observe_request((time.perf_counter() - st["t0"]) * 1e3)
        self._count("serve/sched/completed")
        self._count("serve/generated_tokens", st["n_out"])

    # --------------------------------------------------------------- run
    def serve(self, requests) -> dict:
        """Run every request to completion; returns {rid: (n,) int32}."""
        for r in requests:
            self._validate(r)
        waiting = collections.deque(requests)
        done: dict = {}
        self._admitted = []
        step_toks: list = []       # per decode step: (B,) device tokens
        step_slots: list = []      # per decode step: {rid: slot} snapshot
        kvc = self.scfg.kv
        t_serve = time.perf_counter()
        while waiting or self._live:
            # 1. admit as many waiting requests as slot+page budget allows
            while waiting and self.kv.free_slot() is not None:
                if not self._admit(waiting[0]):
                    break
                waiting.popleft()
            # 2. single-token completions never reach the decode batch
            for rid in [r for r, st in self._live.items()
                        if st["n_out"] >= st["req"].max_new_tokens]:
                self._complete(rid, done)
            if not self._live:
                # everything completed this turn; retry admission next
                # iteration — unless nothing can fit an empty pool, which
                # validation should have caught
                if waiting and self.kv.alloc.n_allocated == 0 and \
                        not self._admit(waiting[0]):
                    raise ConfigError(
                        f"request {waiting[0].rid} cannot admit into an "
                        f"empty pool — capacity validation is broken")
                if waiting and self.kv.n_active > 0:
                    waiting.popleft()          # the forced admit succeeded
                continue
            # 3. make sure every active slot's write position has a page
            for rid in list(self._live):
                if rid not in self._live:      # evicted for a prior slot
                    continue
                while not self.kv.extend(rid):
                    if not self._evict_youngest(waiting, protect=rid):
                        raise ConfigError(
                            f"request {rid} cannot extend with the pool to "
                            f"itself — capacity validation is broken")
            self._gauges()
            # 4. run the next k decode steps back to back: scheduling can
            # only change at a completion or a page boundary, both known
            # ahead of time, so until then positions and counters advance
            # on the device and the host does no uploads and no syncs
            rids = np.zeros((kvc.n_slots,), np.int64)
            gen = np.zeros((kvc.n_slots,), np.int64)
            snapshot = {}
            k = None
            for rid in self._live:
                slot = self.kv.slot_of(rid)
                st = self._live[rid]
                rids[slot] = rid
                gen[slot] = st["n_out"]
                snapshot[rid] = slot
                to_done = st["req"].max_new_tokens - st["n_out"]
                to_edge = (len(self.kv.slots[slot].pages) * kvc.page_size
                           - self.kv.slots[slot].position)
                k = min(x for x in (k, to_done, to_edge) if x is not None)
            table = self._upload(self.kv.page_table)
            pos = self._upload(self.kv.positions)
            d_rids, d_gen = self._upload(rids), self._upload(gen)
            for _ in range(k):
                pos, d_gen = self._step(table, pos, d_rids, d_gen)
                step_toks.append(self._last_tok)
                step_slots.append(snapshot)
            # 5. advance host bookkeeping k steps, complete finished
            for rid, slot in snapshot.items():
                st = self._live[rid]
                for j in range(k):
                    self.kv.advance(rid)
                    st["n_out"] += 1
                    st["chain"].append(("s", len(step_toks) - k + j))
                if st["n_out"] >= st["req"].max_new_tokens:
                    self._complete(rid, done)
        # one copy for every token: the admission samples, then each
        # decode step's token vector
        n_adm = len(self._admitted)
        flat = torch.cat([torch.stack(self._admitted)] +
                         ([torch.stack(step_toks).reshape(-1)]
                          if step_toks else [])).cpu().numpy() \
            if n_adm else np.zeros((0,), np.int64)
        results: dict = {}
        n_gen = 0
        for rid, st in done.items():
            toks = [flat[e[1]] if e[0] == "a" else
                    flat[n_adm + e[1] * kvc.n_slots + step_slots[e[1]][rid]]
                    for e in st["chain"]]
            results[rid] = np.asarray(toks, np.int32)
            n_gen += len(toks)
        wall = time.perf_counter() - t_serve
        if self.registry is not None and n_gen and wall > 0:
            self.registry.gauge("serve/tokens_per_s").set(n_gen / wall)
            self.registry.gauge("serve/kv_bytes_per_token").set(
                kv_bytes_per_token(self.cfg, kvc.kv_bits))
            self._count("serve/requests", len(results))
        self._gauges()
        return results

    # ----------------------------------------------------------- metrics
    def latency_percentiles(self) -> dict:
        """p50/p99 per-request latency (ms) over everything served."""
        if not self._latencies_ms:
            return {"p50_ms": 0.0, "p99_ms": 0.0}
        arr = np.asarray(self._latencies_ms)
        return {"p50_ms": float(np.percentile(arr, 50)),
                "p99_ms": float(np.percentile(arr, 99))}
