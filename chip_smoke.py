#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py

The paper's two-line change at full width: ``make_optimizer("adamw8")`` —
and the rest of the element-wise 8-bit family, momentum8, lars8, lamb8,
adagrad8 and stochastic-rounding adamw8, the packed 4/5/6-bit states
(``state_bits``) and Muon (muon8, muon32) — trains paper-lm-209m (10
layers, d_model 1024, vocab 50264, bf16 compute, f32 masters) for a few
steps on synthetic data, through the port's hand-written CUDA kernels;
the paper LM is served from a paged quantized KV cache; and the train
launcher runs with the numerics sentinel, the qhealth probes and the
flight recorder.  The optimizer's default is the pooled single dispatch
(one fused launch for the arena of all 11 quantized leaves); the phases
that count per-leaf launches pass ``pooled=False``, and the pooled runs
are held to them bit for bit.  Phases, one line or more each:

1. device  — require CUDA (exit 2 without it).
2. build   — compile every kernel from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all in parallel).
3. kernels — first the division shortcut of the 8-bit update and B1
   (``csrc/common.cuh::div_fast``) against ``__fdiv_rn`` for every f32 x
   in its range at 50 divisors (0 mismatches); then each kernel and
   variant against its plain PyTorch version on
   the card, at the main path's largest leaf (blocks/b0_attn/mlp/w_in:
   40960 blocks of 2048): quantize, dequantize, the fused update for
   adamw8, stochastic adamw8, momentum8, lars8, lamb8 and adagrad8, and the
   lars/lamb norm prologue; then the packed update at (4, 8) (deterministic
   and stochastic), (5, 5) and (6, 6) for adam and at 4 bits for momentum,
   lamb's prologue on (4, 8) states, and quantize/dequantize at 4 bits
   (quantize also stochastic).  Exact agreement is required (p, codes,
   absmax, partials: 0 mismatches).  Then the Newton–Schulz kernels at the
   head's shape (1024 x 50264, padded to 50432): the gram A = X X^T and the
   apply X' = a X + B X (3xTF32 on the tensor cores) against their
   tile-replaying plain versions within a stated tolerance, bit-identical
   over two launches, the gram exactly symmetric; the same checks at the
   stacked norm vectors' shape (10 x 1024, padded to 16 x 1024), where
   their device time (torch.profiler) is printed beside the library
   call's.  Median times (B1 and the 8-bit and sentinel updates by raw
   launches of the C entry their wrapper calls, on its grid, with the
   wrapper's host microseconds per call beside them; the sentinel in
   turns with the sentinel-off kernel) beside the least time the card
   could take (bytes over 3.35 TB/s, f32 operations over 67 TFLOP/s: the
   H100 SXM
   data-sheet peaks; for the Newton–Schulz kernels, which take their
   products on the tensor cores, three TF32 products per f32 product at
   495 TFLOP/s, with the f32 bound beside it; the gram counts the
   m (m + 1) / 2 dot products of a symmetric result), the plain version's
   time and, where one PyTorch call computes the same
   function, that call's (torch.linalg.vector_norm for the norm prologue,
   torch.mm / torch.addmm with TF32 off for the Newton–Schulz products,
   timed in turns with the kernel on the same inputs).
4. train   — each path with the launch counters zeroed just before it and
   read just after: adamw8 for 10 steps (per-leaf dispatch), then a
   read-back of the trained 8-bit state through the kernel layer (both
   moments dequantized; the second moment requantized, which must give
   back its codes and absmax exactly), then adamw32 for 10 steps and a
   profile of one adamw8 step by kernel; then 5 steps each of momentum,
   lars, lamb and adagrad at 8 and at 32 bits, stochastic adamw8 and
   adafactor32, all from the same weights and batches.  Each 8-bit run
   must launch the fused update steps x quantized leaves times (and, for
   lamb/lars, the norm prologue as often); losses must be finite; 8-bit
   and 32-bit final losses must agree within 1%.  Then 5 steps each of the
   third slice's paths: adam8 at state_bits (4, 8), stochastic (4, 8),
   (5, 5) and (6, 6) against adam32, lamb8 at (4, 8) and momentum8 at 4
   bits, muon8, muon8 at (4, 8) and stochastic muon8 at (4, 8) against
   muon32 — one run for each packed variant and 4-bit quantizer of phase
   3, whose launches its JSON row reports.  The (5, 5) and (6, 6) runs,
   whose second moment is below 8 bits, are held to the same run through
   the torch oracle (losses within 2e-4) instead of to adam32 within 1%;
   muon8 is held to both (see ORACLE_RUNS).  Each Muon step must launch the
   Newton–Schulz
   kernels 5 x the matrix leaves times each, and muon8 the quantize and
   dequantize kernels once per quantized matrix leaf; a profile of one
   muon8 step gives the Newton–Schulz kernels' share of device time.
5. checkpoint — lamb8 for 3 steps, saved with the port's checkpoint,
   restored into a fresh state; step 4 from both must give bit-identical
   params, codes and absmax.
6. serve   — the paper LM at full width (random weights from SEED) served
   by ``ContinuousBatchingEngine`` over the paged quantized KV cache, at
   kv_bits 8 and then 4: 48 greedy requests, prompts cycling over
   64/128/256/384 tokens, max_new uniform in [1, 128]; page 16, 16 slots,
   32 pages per sequence (512 tokens), 512 pages per layer.  Every
   request must return exactly its max_new tokens, the page bookkeeping
   must hold its invariants, and the gather-dequant kernel B7 must launch
   2 x 10 layers x decode steps times (counter zeroed just before the
   run).  The same stream through the plain gather (``impl="torch"``)
   must give identical tokens and bit-identical last-step logits, and a
   tight pool (96 pages, every shape the same) must evict and still give
   identical tokens.  Printed: decode tokens/s, p50/p99 request latency,
   KV bytes per token, B7's share of device time in one profiled decode
   step with every slot at 500 tokens, and the 8- and 4-bit
   teacher-forced logit drift against the bf16 contiguous-cache
   ``decode_step``.  (The kernels phase also holds B7 against its plain
   version at the serve path's shapes, 8 and 4 bits, bf16 and f32 out, a
   scrambled table with -1 entries: 0 mismatches; and times it warm, on
   one pool, and cold, by raw launches over 6 copies of the pool and 2
   outputs in rotation, more than the L2 holds: profiler device time, and
   CUDA events around a CUDA graph of the launches.  Its JSON rows' ms is
   the cold device time of the bf16 instance, f32_ms the f32 one's.)
7. telemetry — the train launcher (``repro_torch.launch.train.main``) at
   full-width paper-lm-209m (the launcher's f32 compute), adamw8, 8 steps
   of seq 512 x batch 8 with ``--sentinel``, qhealth probes every 4 steps
   and the flight recorder (a host copy of the state after every healthy
   step), under build/ (removed after), on the default pooled dispatch.
   With the counters zeroed just before it: the fused update must launch
   8 x 1 times (one launch per step for the arena of the 11 quantized
   leaves), every launch with the sentinel output (B3(e)), and B1/B2 once
   per arena segment and probe (the round-trip sample); every step's
   sent_* nonfinite and overflow counts must be 0 and its edge-hit count
   above 0; the probes must give 2 x 11 "arena" events at steps 3 and 7,
   as the JAX package's arena branch does; the JSONL must pass the
   port's validator and the inspector must score the run clean.  Then the
   same 8 steps without the sentinel (ms/step on and off), and at lr 1e18:
   exit 2 with a flight dump of the step before the trigger, which
   restores into a fresh state, replays the trigger step to the recorded
   loss (or both nonfinite) and scores 1 under ``inspect --flight``.  Then
   5 steps with the sentinel of stochastic adamw8, momentum8, lamb8 and
   adam8 at (4, 8), per leaf (SENTINEL_RUNS: the launches of their JSON
   rows).  The
   kernels phase also holds B3(e) at the largest leaf for those five
   variants against ``health_rows`` and the sentinel-off kernel, on clean
   inputs and with NaN / +-inf / 1e31 planted in g and one block's state.
   Pooled (tenth slice; in phases 3, 4 and 5): B3 at the arena's shape
   (ARENA_BLOCKS = 127552 blocks of 2048 in the optimizer's own 11
   segments, with its per-block seeds and element offsets) for adamw8,
   stochastic adamw8, lamb8 (B4 over the arena and the 11 segments'
   trust ratios, each checked on its own blocks) and adam8 (4, 8), against
   the plain version and against the 11 per-leaf launches on the same
   rows (0 mismatches), the adamw8 launch timed in turns with the 11
   per-leaf launches; then POOLED_RUNS, each pooled and per-leaf from the
   same weights and batches (adamw8 10 steps; stochastic adamw8, lamb8,
   adam8 (4, 8) and muon8 5): bit-identical states, one B3 launch per step
   for the arena (and one of B4 for lamb) where the per-leaf run launches
   one per leaf, median step ms of both, a profiled step of each for
   adamw8 and the gradient gather timed three ways; adamw8 through the
   ``torch.optim.Optimizer`` face (``BlockOptimizer``) and the plain
   PyTorch loop for 10 steps, bit-identical to the pooled run; and a
   pooled lamb8 checkpoint restored into a pooled and a per-leaf state,
   step 4 from each bit-identical to step 4 uninterrupted.
   Partitioned (eleventh slice; in phases 3 and 4): B4 over the arena in
   turns with the two vector norms of p and g over its rows; B3 over the
   arena's 4 owned spans and 16 (span, bucket) pieces, each on its own
   absmax, seeds and offsets, byte-identical to the arena launch and
   timed in turns with it; the five POOLED_RUNS with the sentinel on,
   pooled and partitioned at PARTITION_LAYOUTS (adamw8 also at 3 spans):
   every state array and every step's loss, grad norm and health counts
   bit-identical, B3 (and lamb's B4) launched once per piece and step,
   two readings of the steps in turns; then a world of one ``nccl``
   process (``launch/mesh.py``, a FileStore under build/): adamw8 and
   lamb8 as ZeRO-1 and ZeRO-2 with 2 microbatches, bit-identical to the
   pooled run, with their peak memory and ZeRO-2's grad accounting.
   ``--phase partition`` runs phases 1-2 and these alone.
8. arch — the attention-model zoo (twelfth slice): stablelm-1.6b at its
   published widths and depth (24 layers, f32 params and masters),
   adamw8 pooled for 5 steps of seq 512 x batch 8 through the kernels and
   through their plain versions (``impl="plain"``): every state array and
   every step's metrics bit-identical, B3 launched once a step; adamw32
   beside it; 4 greedy requests through the paged engine at kv 8, B7 and
   the plain gather giving identical tokens and logits, 2 x 24 launches a
   decode step.  Then mixtral-8x22b at its published widths with
   MIXTRAL_LAYERS layer (bf16 params and bf16 masters, the dry run's
   adam8 hyperparameters): adam8 and lamb8 the same way (the bf16
   instances of B3 and B4), and one 4200-token prompt past the 4096-token
   window with 64 new tokens.  The kernels phase holds the bf16 B3 (adam)
   and B4 (lamb) against their plain versions at mixtral's expert leaf
   (393,216 blocks, exact) and times them by raw launches in turns with
   the f32 instances there and over mixtral's arena.  Peak memory and
   wall time per architecture.  ``--phase arch`` runs phases 1-2, the
   bf16 kernels and this phase alone, with their two JSON rows.
9. summary — the kernels JSON line, the card's name and power limit, and
   the last line ``{"ok": true, "device": {...}}``; printed last, after
   phase 12.
10. recurrent — the recurrent family (thirteenth slice), run after phase
   8: xlstm-350m at its published widths and depth (24 layers: 21 mLSTM,
   3 sLSTM; d_model 1024, 4 heads, vocab 50304; 0.348 B parameters, f32
   masters) and recurrentgemma-9b at its published widths with RG_LAYERS
   = 5 layers (one (rglru, rglru, attn) super-block and the 2 remainder
   rglru layers; d_model and lru_width 4096, MQA kv 1 x 256, window 2048,
   a tied head over 256,000 tokens; 2.175 B f32 parameters).  Each trains
   adamw8 pooled for RECURRENT_STEPS steps of seq 512 x batch 8 (RG_BATCH
   for recurrentgemma, whose kernel run must peak below RG_PEAK_LIMIT;
   the scans' checkpointed path: 8 chunks of 64)
   through the kernels and
   through their plain versions (every state array and step metric
   bit-identical, B3 once a step), adamw32 beside it (final losses within
   1%), and under ``--phase recurrent`` one more adamw8 step under the
   profiler (device activity only: busy time against wall, launches).  Each serves 4 greedy requests
   through the paged engine at kv 8 in 4 slots, B7 and the plain gather
   giving identical tokens and logits: xlstm (prompts 64-256, 16 new)
   launches no B7 and its tokens equal the contiguous cache's
   (``contiguous_greedy``), and so do those of one request of
   XLSTM_LONG_PROMPT = 8192 tokens served alone; recurrentgemma
   (prompts 64-2100, one past the
   2048-token window) launches B7 2 x 1 attn layer times a decode step.
   Then muon8 on bf16 masters at mixtral-8x22b's 1-layer cut (phase 8's
   configuration), per leaf, MUON_BF16_STEPS steps through the kernels
   and through ``impl="torch"``: losses within ORACLE_RTOL, B5 and B6
   launched 5 times per matrix leaf and step.  Peak memory and wall time
   per architecture.  The kernels phase also holds B7 against its plain
   version at recurrentgemma's rows (RG_GATHER_SHAPE: kv 1 x 256, 4 slots
   x 133 pages; 8 and 4 bits, exact) and times it as at the paper LM's
   shape; those numbers ride in the paged_gather rows as ``kv1x256_*``.
   ``--phase recurrent`` runs phases 1-2, that B7 check and this phase
   alone, with the 8-bit B7 row at recurrentgemma's shape.
11. dryrun — the dry run (fourteenth slice; ``launch/dryrun.py``), no
   kernel of its own: (a) DRYRUN_CELLS on the 256-device pod mesh at full
   width, each in a process of its own over a fake process group of 256
   (on the CPU: started after the build and traced while the card runs
   phases 3-10, DRYRUN_LANES processes at a time, each on one thread at
   the lowest priority, pinned to the host's last DRYRUN_LANES cores, so
   that the main path's host-bound timings keep the other cores), every
   cell ``ok`` with argument bytes equal to the
   sharding rules' arithmetic (the dry run checks them), its per-device
   total printed against the card's 80 GB with its collective bytes by
   kind and what was live at its peak by the allocating op (the
   residual sequence-sharded between blocks, the loss reduced on the
   vocab shards; recurrentgemma-9b's and xlstm-350m's train cells with
   their scans counted from a few traced steps times their trip count,
   ``models/scan_utils.counting``); (b) the calibrations: the dry
   run of paper-lm-209m at this script's train shape (SEQ_LEN x BATCH,
   adam8, ``impl="torch"``) on a mesh of one device, against the same step
   run on the card: its FLOPs equal ``FlopCounterMode``'s over the card's
   step, its peak within DRYRUN_PEAK_RTOL of ``max_memory_allocated``
   from a reset; and the same of xlstm-350m at its published widths, one
   block pattern deep (XLSTM_CAL_LAYERS), XLSTM_CAL_SEQ x XLSTM_CAL_BATCH,
   one microbatch, whose scans the dry run counts and the card runs step
   by step.  ``--phase dryrun`` runs phase 1 and this phase alone.
12. remat — activation remat (fifteenth slice; ``cfg.remat``,
   ``cfg.attn_chunk``), no kernel of its own, after phase 11: (a)
   paper-lm-209m at SEQ_LEN x BATCH, adamw8 pooled through the kernels,
   REMAT_STEPS steps at remat "none", "full" and "dots" from the same
   weights and batches: every step's loss, grad norm and health bits and
   every state array bit-identical across the three (the recomputed ops
   rerun on the same inputs), B3 once a step; each mode's
   ``max_memory_allocated`` from a reset and its step time, the three in
   turns.  (b) stablelm-1.6b at its published widths at train_4k's
   length, LONG_SEQ x LONG_BATCH (4096 x 2), remat "full" and attn_chunk
   1024 (its config's): LONG_STEPS adamw8 steps through the kernels,
   finite losses, its peak; the dry run of the same step (adam8,
   ``impl="torch"``) on a mesh of one device, traced on the host beside
   phase 11's cells and calibrated as phase 11's is (equal FLOPs, the
   peak within DRYRUN_PEAK_RTOL); and the dry run's count of that step at
   remat "none", printed beside it.  ``--phase remat`` runs phases 1-2
   and this phase alone.
13. analysis — the static-analysis package on the card
   (``repro_torch.analysis``): (a) the contract matrix
   (``runner.run_contracts``: 13 cells of the reduced paper LM, the bare
   updates, the paged decode steps, the knob pairs) through the CUDA
   route, one line a contract, and one full-width cell, paper-lm-209m
   pooled adamw8 at BATCH x SEQ_LEN, whose recorded step must hold a B3
   launch (its counters zeroed just before and read just after);
   (b) the Hopper kernel budget of every built instance
   (``kernel_budget.card_audit``): the model beside ptxas's registers,
   spill and static shared memory and the occupancy API's CTAs per SM,
   one line each; (c) the lint gate against its baseline; (d) host syncs
   per step (``torch.cuda.set_sync_debug_mode("warn")``, the warnings
   counted) of a pooled and a per-leaf adamw8 step of paper-lm-209m at
   full width, each without and with ``percentile_clipping=95``.  A
   failed contract, a budget line that disagrees with ptxas or the
   occupancy API, or a new lint violation fails the run.
   ``--phase analysis`` runs phases 1-2 and this phase alone.

Any failure raises: the script then exits non-zero without the last line.
"""
from __future__ import annotations

import ctypes
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM, f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12       # H100 SXM, dense TF32 on the tensor cores
STEPS = 10
FAMILY_STEPS = 5           # steps of each further optimizer's run
SEQ_LEN, BATCH = 512, 8
LR, WEIGHT_DECAY = 1e-3, 0.01
SEED = 0

FUSED = ("src/repro_torch/kernels/csrc/fused_update.cu",
         "src/repro/kernels/fused_update.py:642")
NORMS = ("src/repro_torch/kernels/csrc/norm_partials.cu",
         "src/repro/kernels/fused_update.py:455")
# JSON row name -> (source, replaced TPU kernel, launch-counter key)
KERNEL_META = {
    "blockwise_quant": ("src/repro_torch/kernels/csrc/blockwise_quant.cu",
                        "src/repro/kernels/blockwise_quant.py:46",
                        "blockwise_quant"),
    "blockwise_dequant": ("src/repro_torch/kernels/csrc/blockwise_dequant.cu",
                          "src/repro/kernels/blockwise_dequant.py:41",
                          "blockwise_dequant"),
    **{f"fused_update/{v}": (*FUSED, "fused_update")
       for v in ("adamw8", "adamw8_sr", "momentum8", "lars8", "lamb8",
                 "adagrad8")},
    "norm_partials/lars": (*NORMS, "norm_partials"),
    "norm_partials/lamb": (*NORMS, "norm_partials"),
}
NS = "src/repro_torch/kernels/csrc/newton_schulz.cu"
# third slice: JSON row -> (source, replaced TPU kernel, launch counter,
# the train run whose launches the row reports)
SLICE3_META = {
    **{f"fused_update/{v}": (*FUSED, "fused_update", v) for v in (
        "adam8_4_8", "adam8_4_8_sr", "adam8_5_5", "adam8_6_6",
        "momentum8_4")},
    "norm_partials/lamb_4_8": (*NORMS, "norm_partials", "lamb8_4_8"),
    "blockwise_quant/4bit": (KERNEL_META["blockwise_quant"][0],
                             KERNEL_META["blockwise_quant"][1],
                             "blockwise_quant", "muon8_4_8"),
    "blockwise_quant/4bit_sr": (KERNEL_META["blockwise_quant"][0],
                                KERNEL_META["blockwise_quant"][1],
                                "blockwise_quant", "muon8_4_8_sr"),
    "blockwise_dequant/4bit": (KERNEL_META["blockwise_dequant"][0],
                               KERNEL_META["blockwise_dequant"][1],
                               "blockwise_dequant", "muon8_4_8"),
    "ns_gram": (NS, "src/repro/kernels/newton_schulz.py:103", "ns_gram",
                "muon8"),
    "ns_apply": (NS, "src/repro/kernels/newton_schulz.py:127", "ns_apply",
                 "muon8"),
}
# packed fused-update variant -> (algo, bits_m, bits_r, stochastic)
PACKED_VARIANTS = {"adam8_4_8": ("adam", 4, 8, False),
                   "adam8_4_8_sr": ("adam", 4, 8, True),
                   "adam8_5_5": ("adam", 5, 5, False),
                   "adam8_6_6": ("adam", 6, 6, False),
                   "momentum8_4": ("momentum", 4, 8, False)}
# third slice's train runs: label -> (optimizer, kwargs, 32-bit twin)
# (each packed variant and 4-bit quantizer of phase 3 has a run that
# launches it and no other variant of its kernel: its launch count)
SLICE3_RUNS = {
    "adam8_4_8": ("adam8", dict(state_bits=(4, 8)), "adam32"),
    "adam8_4_8_sr": ("adam8", dict(state_bits=(4, 8),
                                   stochastic_rounding=True), "adam32"),
    "adam8_5_5": ("adam8", dict(state_bits=(5, 5)), "adam32"),
    "adam8_6_6": ("adam8", dict(state_bits=(6, 6)), "adam32"),
    "lamb8_4_8": ("lamb8", dict(state_bits=(4, 8)), "lamb32"),
    "momentum8_4": ("momentum8", dict(state_bits=4), "momentum32"),
    "muon8": ("muon8", {}, "muon32"),
    "muon8_4_8": ("muon8", dict(state_bits=(4, 8)), "muon32"),
    "muon8_4_8_sr": ("muon8", dict(state_bits=(4, 8),
                                   stochastic_rounding=True), "muon32"),
}
# Runs held to the same run on the torch oracle path (the plain versions,
# no kernel launch): per-step losses within the loss-trace tests' rtol.
# muon8, whose Newton–Schulz kernels take 3xTF32 products where the plain
# versions take f32 ones, is held to it and to muon32 within 1%.  The
# runs with a second moment below 8 bits (ORACLE_ONLY) are held to it
# instead of to their 32-bit twin: they are outside the paper's claim of
# equal loss (it makes it for 8-bit states; the reference's packed golden
# configuration keeps the second moment at 8 bits), and adam8 at (5, 5)
# ends 1% from adam32 after 5 steps at full width, with an update that
# agrees with the JAX package's at these widths
# (tests/test_torch_lowbit.py).
ORACLE_RUNS = ("adam8_5_5", "adam8_6_6", "muon8")
ORACLE_ONLY = ("adam8_5_5", "adam8_6_6")
ORACLE_RTOL = 2e-4
# Newton–Schulz check: relative error limit of the kernels against their
# tile-replaying plain versions (largest |difference| over the output's
# largest magnitude).  Both sum the same f32 products in other orders
# (within a 256-column tile, FMAs in column order vs the library GEMM's
# blocking): each entry carries a relative rounding error of order
# sqrt(terms) * 2^-24 ~ 1e-6 on these sums, 1e-5 leaves room for the
# spread of 1024^2 entries.
NS_RTOL = 1e-5
# fourth slice: the serve path (paged KV, kernel B7)
GATHER = ("src/repro_torch/kernels/csrc/paged_gather.cu",
          "src/repro/kernels/paged_kv.py:170")
SERVE_SLOTS, SERVE_PAGES_PER_SEQ, SERVE_PAGE = 16, 32, 16
SERVE_POOL, SERVE_TIGHT_POOL = 512, 96
SERVE_STREAMS, SERVE_PROMPT_LENS, SERVE_MAX_NEW = 48, "64,128,256,384", 128
DRIFT_PROMPT, DRIFT_STEPS = 128, 32

# fifth slice: the fused update's sentinel output (B3(e)) — variant ->
# (algo, bits_m, bits_r, stochastic); each has a train run with the
# sentinel on whose launches its JSON row reports: "adamw8" is the
# telemetry launcher's run, the others SENTINEL_RUNS (optimizer, kwargs)
SENTINEL_VARIANTS = {"adamw8": ("adamw", 8, 8, False),
                     "adamw8_sr": ("adamw", 8, 8, True),
                     "momentum8": ("momentum", 8, 8, False),
                     "lamb8": ("lamb", 8, 8, False),
                     "adam8_4_8": ("adam", 4, 8, False)}
SENTINEL_RUNS = {"adamw8_sr": ("adamw8", dict(stochastic_rounding=True)),
                 "momentum8": ("momentum8", {}), "lamb8": ("lamb8", {}),
                 "adam8_4_8": ("adam8", dict(state_bits=(4, 8)))}
TEL_STEPS, TEL_EVERY = 8, 4      # the telemetry launcher's steps and probes

# tenth slice: the pooled single dispatch (one B3 launch for the arena of
# every quantized leaf).  paper-lm-209m's arena: its 11 quantized leaves
# (wq/wk/wv/wo 5120 blocks each, w_in/w_out 40960, the four norm stacks
# 5, the head 25132), in blocks of 2048
ARENA_BLOCKS = 127552
# arena variant -> (algo, bits_m, bits_r, stochastic); each JSON row
# reports the launches of the pooled run POOLED_RUNS[variant[6:]]
ARENA_VARIANTS = {"arena_adamw8": ("adamw", 8, 8, False),
                  "arena_adamw8_sr": ("adamw", 8, 8, True),
                  "arena_lamb8": ("lamb", 8, 8, False),
                  "arena_adam8_4_8": ("adam", 4, 8, False)}
# pooled train runs, each against its per-leaf run: label -> (optimizer,
# kwargs, steps)
POOLED_RUNS = {"adamw8": ("adamw8", {}, STEPS),
               "adamw8_sr": ("adamw8", dict(stochastic_rounding=True),
                             FAMILY_STEPS),
               "lamb8": ("lamb8", {}, FAMILY_STEPS),
               "adam8_4_8": ("adam8", dict(state_bits=(4, 8)),
                             FAMILY_STEPS),
               "muon8": ("muon8", {}, FAMILY_STEPS)}

# the partitioned dispatch (eleventh slice): (shards, buckets) of the
# unrolled span runs, each held to its pooled run (adamw8 also at
# PARTITION_EXTRA: 3 shards, whose span starts are off the 4-block grid)
PARTITION_LAYOUTS = ((4, 1), (4, 4))
PARTITION_EXTRA = {"adamw8": ((3, 1),)}
# the optimizers of the process-group runs (nccl, world 1: ZeRO-1 and
# ZeRO-2, two microbatches), each held to its pooled run
GROUP_RUNS = ("adamw8", "lamb8")

# the attention-model zoo (twelfth slice, phase 9 and ``--phase arch``):
# stablelm-1.6b at its published widths and depth, mixtral-8x22b at its
# published widths with MIXTRAL_LAYERS layers (the depth cut), bf16 params
# and masters with the dry run's adam8 hyperparameters (and lamb8), each
# trained ARCH_STEPS steps through the kernels and through their plain
# versions; the bf16 instances of B3 and B4 (bf16 p, f32 g: the
# fused_update_bf16 and norm_partials_bf16 libraries of their sources)
# timed in turns with the f32 ones at mixtral's expert leaf and over its
# arena
FUSED_BF16 = ("src/repro_torch/kernels/csrc/fused_update.cu",
              "src/repro/kernels/fused_update.py:642")
BF16_META = {"fused_update/bf16_adam8": (*FUSED_BF16, "fused_update",
                                         "mixtral_adam8"),
             "norm_partials/bf16_lamb8": (*NORMS, "norm_partials",
                                          "mixtral_lamb8")}
ARCH_STEPS = 5
MIXTRAL_LAYERS = 1
MIXTRAL_OPT = dict(lr=1e-4, weight_decay=0.1)    # launch/dryrun.py's adam8
MIXTRAL_RUNS = ("adam8", "lamb8")
EXPERT_BLOCKS = 8 * 6144 * 16384 // 2048         # one (8, 6144, 16384) leaf
# stablelm's serve: page, slots, prompts, new tokens; mixtral's: one
# request whose prompt is longer than the 4096-token window
ARCH_SERVE_PAGE, ARCH_SERVE_SLOTS = 16, 4
STABLELM_PROMPTS, STABLELM_NEW = (64, 128, 192, 256), 16
MIXTRAL_PROMPT, MIXTRAL_NEW = 4200, 64

# the recurrent family (thirteenth slice, phase 10 and ``--phase
# recurrent``): xlstm-350m at its published widths and depth, and
# recurrentgemma-9b at its published widths with RG_LAYERS layers (one
# (rglru, rglru, attn) super-block and the 2 remainder rglru layers), each
# trained RECURRENT_STEPS steps (seq 512 > the scan's chunk of 64: the
# checkpointed path) through the kernels and their plain versions; served
# greedily through the paged engine at kv 8; and muon8 on bf16 masters at
# mixtral-8x22b's MIXTRAL_LAYERS-layer cut (the arch phase's
# configuration), through the kernels and through impl="torch"
RECURRENT_STEPS = 3
RG_LAYERS = 5
# recurrentgemma's train batch, the other cells': with its super-block
# under remat "full" a batch-8 adamw8 step peaks at 70.3 GB of an H100's
# 80 (without remat its first step needed ~73 GB and batch 4 was run:
# the tied head's 256,000 x 4096 table in f32 several times over, beside
# 24 GB of masters and state)
RG_BATCH = 8
XLSTM_PROMPTS, RG_PROMPTS, RECURRENT_NEW = (64, 128, 192, 256), \
    (64, 512, 1024, 2100), 16
# one long xlstm request served alone: the prefill's scans at 16x the
# train length.  Cut from the repo's prefill_32k length (32768), whose
# two prefills took 192 s on an H100 against the run's 1200 s limit, to
# 16384 (130 s), then to 8192 when remat "full" made phase 10's xlstm
# train steps 1.8x longer (its scans run a third time)
XLSTM_LONG_PROMPT, XLSTM_LONG_NEW = 8192, 4
MUON_BF16_STEPS = 3
# the kernels JSON rows that report the recurrent phase's launches beside
# their own run's ("other_runs": {run: launches})
RECURRENT_ROW_RUNS = {
    "fused_update/arena_adamw8": ("xlstm_adamw8", "recurrentgemma_adamw8"),
    "paged_gather/8bit": ("recurrentgemma_serve_kv8",),
    "blockwise_quant": ("mixtral_muon8_bf16",),
    "blockwise_dequant": ("mixtral_muon8_bf16",),
    "ns_gram": ("mixtral_muon8_bf16",),
    "ns_apply": ("mixtral_muon8_bf16",)}
# B7 at recurrentgemma's row shape: its numbers ride in the paged_gather
# rows under this prefix
RG_GATHER_KEY = "kv1x256_"

# fused-update variant -> (algo, stochastic); the optimizer name of its
# train run is the variant without "_sr" plus stochastic rounding
VARIANTS = {"adamw8": ("adamw", False), "adamw8_sr": ("adamw", True),
            "momentum8": ("momentum", False), "lars8": ("lars", False),
            "lamb8": ("lamb", False), "adagrad8": ("adagrad", False)}


# the dry run (fourteenth slice, phase 11): the pod cells, traced in
# processes of their own on the CPU (longest first: the first has a lane
# of its own, the others share the other lanes), and the calibration's
# tolerance on the peak memory
DRYRUN_CELLS = ("mixtral-8x22b:train_4k", "qwen1.5-32b:train_4k",
                "command-r-35b:train_4k", "recurrentgemma-9b:train_4k",
                "xlstm-350m:train_4k", "stablelm-1.6b:train_4k",
                "paper-lm-209m:train_4k", "qwen1.5-32b:decode_32k",
                "recurrentgemma-9b:decode_32k")
DRYRUN_LANES = 3
# the recurrent calibration (phase 11): xlstm-350m at its published widths,
# one block pattern deep (7 mLSTM + 1 sLSTM), XLSTM_CAL_SEQ x XLSTM_CAL_BATCH,
# one microbatch: the dry run's counted scans (eight chunks of 64) against
# the step run for real on the card
XLSTM_CAL_LAYERS, XLSTM_CAL_SEQ, XLSTM_CAL_BATCH = 8, 512, 2
DRYRUN_PEAK_RTOL = 0.10
CARD_BYTES = 80e9

# activation remat (fifteenth slice, phase 12 and ``--phase remat``):
# paper-lm-209m at SEQ_LEN x BATCH under each remat mode, REMAT_STEPS
# steps from the same weights and batches; stablelm-1.6b at train_4k's
# length, LONG_SEQ x LONG_BATCH, with its config's remat "full" and
# attn_chunk 1024, and the dry run's count of the same step on one device
# (at remat "full", calibrated against the card; at "none", counted only)
REMAT_MODES = ("none", "full", "dots")
REMAT_STEPS = 5
LONG_ARCH, LONG_SEQ, LONG_BATCH, LONG_STEPS = "stablelm-1.6b", 4096, 2, 3
# phase 4's per-leaf adamw8 median step on an H100 (700 W) before the port
# read cfg.remat: every layer's activations kept
PHASE4_NO_REMAT_MS = 89.7
# recurrentgemma's peak at RG_BATCH must stay below this (of the card's 80)
RG_PEAK_LIMIT = 76e9


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def bound_ms(n_bytes: float, n_ops: float,
             flop_per_s: float = F32_FLOP_PER_S) -> tuple[float, str]:
    """The least time of moving ``n_bytes`` over HBM or of ``n_ops``
    operations at ``flop_per_s``, whichever is larger, and which it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def in_turns(torch, fns: dict, reps: int, per: int, warmup: int = 1) -> dict:
    """{name: median ms per call} of ``per`` back-to-back calls by CUDA
    events (the host runs ahead, so its launch overhead is hidden), the fns
    timed in turns on the same inputs: in order, then in reverse (library,
    kernel, kernel, library, ...), so that the card's clock and neighbours
    weigh on each alike."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    times = {k: [] for k in fns}
    for r in range(reps):
        for k in (list(fns) if r % 2 == 0 else list(reversed(fns))):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per):
                fns[k]()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) / per)
    return {k: statistics.median(v) for k, v in times.items()}


def median_ms(torch, fn, reps: int, per: int = 5, warmup: int = 2) -> float:
    """Median over ``reps`` of the device time of ``per`` back-to-back
    calls of ``fn`` divided by ``per`` (:func:`in_turns` of one fn; inputs
    far exceed the 50 MB L2, so every call reads HBM)."""
    return in_turns(torch, {"fn": fn}, reps, per, warmup)["fn"]


def device_ms_split(torch, fns: dict, n: int = 20) -> dict:
    """{name: device time per call} of ``fns`` ({name: (fn, marker)}) from
    one torch.profiler session, each fn called n times in turns (in order,
    then reversed, ...): a kernel whose profiler key contains a fn's marker
    is that fn's, the kernels that match no marker belong to the fn whose
    marker is None (with no such fn, they are left out).  For a kernel of
    a few microseconds, CUDA events around
    back-to-back calls measure the host's launch rate instead (each wrapper
    call costs tens of microseconds of Python).  (One session for all the
    fns compared: a run of back-to-back profiler sessions can come back
    without device events; a session that saw none for some fn is run
    again, up to three in all.  The result's "sessions" is how many it
    took; the kernels line carries it as "profiler_sessions".)"""
    from torch.profiler import ProfilerActivity, profile
    for fn, _ in fns.values():
        fn()
    torch.cuda.synchronize()
    for sessions in range(1, 4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for r in range(n):
                for name in (list(fns) if r % 2 == 0
                             else list(reversed(fns))):
                    fns[name][0]()
            torch.cuda.synchronize()
        total = dict.fromkeys(fns, 0.0)
        for ev in prof.key_averages():
            if "CUDA" not in str(getattr(ev, "device_type", "")):
                continue
            t = getattr(ev, "self_device_time_total", None)
            t = t if t is not None else getattr(ev, "self_cuda_time_total",
                                                0.0)
            owner = next((k for k, (_, mark) in fns.items()
                          if mark is not None and mark in ev.key),
                         next((k for k, (_, mark) in fns.items()
                               if mark is None), None))
            if owner is not None:
                total[owner] += t
        if all(v > 0 for v in total.values()):
            break
        print(f"profiler: no device time for some of {list(fns)}; "
              f"profiling again")
    require(all(v > 0 for v in total.values()),
            f"the profiler saw no device time for some of {list(fns)}")
    return {**{k: v / 1e3 / n for k, v in total.items()},
            "sessions": sessions}


def host_us(torch, fn, n: int = 50) -> float:
    """Host microseconds per call of a wrapper: n calls back to back on the
    host clock, after a sync and without waiting for the device (n
    launches do not fill the launch queue, so the host never waits)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def raw_update(torch, lib, entry: str, algo: str, st, g, q1, q2, ts=None,
               *, sr: bool = False, health=None, tail=(), hyper, seeds=None,
               offsets=None) -> callable:
    """A launch of C entry ``entry`` of ``csrc/fused_update.cu`` (of
    ``lib``, this tree's or another's) on the state st = [p, codes_m,
    absmax_m, codes_r, absmax_r] (packed codes as their bytes), in place,
    with no wrapper in between: the kernel's own time.  ``tail``: the
    entry's ints after block_size (``(ctas,)`` for fused_update_grid,
    ``(bits_m, bits_r, ctas)`` for fused_update_packed_grid); ``health``
    for the entries that take it; ``seeds`` / ``offsets``: the per-block
    int32 seeds and element offsets of a pooled arena."""
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_update as fu
    nb, bsz = st[0].shape
    ptr = lambda t: None if t is None else build.ptr(t)
    ptrs = (fu.KERNEL_ALGOS[algo], ptr(st[0]), ptr(g), *map(ptr, st[1:]),
            ptr(q1), ptr(q2 if st[3] is not None else None), ptr(ts),
            ptr(seeds), ptr(offsets)) + (
                () if entry == "fused_update" else (ptr(health),))
    args = (*ptrs, int(sr), fu.to_i32(SEED), nb, bsz, *tail,
            *fu._kernel_scalars(fu.scalars(device="cpu", **hyper)),
            build.stream(st[0].device))
    fn = getattr(lib, entry)
    # the tensors behind the pointers
    keep = (st, g, q1, q2, ts, health, seeds, offsets)

    def launch():
        build.check(lib, fn(*args), entry)
        return keep
    return launch


def raw_quantize(torch, lib, x, q, codes, absmax, bits: int, seed=None,
                 ctas=None) -> callable:
    """A launch of ``blockwise_quantize_grid`` (with ``ctas``) or, without,
    ``blockwise_quantize`` (one CTA per block) of ``lib``, no wrapper in
    between."""
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_update as fu
    nb, bsz = x.shape
    entry = "blockwise_quantize" if ctas is None else \
        "blockwise_quantize_grid"
    args = (build.ptr(x), build.ptr(q), build.ptr(codes), build.ptr(absmax),
            nb, bsz, bits, int(seed is not None),
            fu.to_i32(seed) if seed is not None else 0,
            *(() if ctas is None else (ctas,)), build.stream(x.device))
    fn = getattr(lib, entry)
    keep = (x, q, codes, absmax)           # the tensors behind the pointers

    def launch():
        build.check(lib, fn(*args), entry)
        return keep
    return launch


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phase 3
def check_kernels(torch, dev, nb: int = 10 * 1024 * 8192 // 2048,
                  bsz: int = 2048) -> dict:
    """B1, B2 and the 8-bit updates B3(a)-(c) against their plain versions
    at (nb, bsz); the default is the main path's largest leaf,
    blocks/b0_attn/mlp/w_in."""
    from repro_torch.core import qmap
    from repro_torch.kernels import blockwise_dequant as bdq
    from repro_torch.kernels import blockwise_quant as bq
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import fused_update as fu

    n = nb * bsz
    gen = torch.Generator(device=dev).manual_seed(SEED)
    qs = torch.as_tensor(qmap.get_qmap("dynamic", True), device=dev)
    qu = torch.as_tensor(qmap.get_qmap("dynamic", False), device=dev)
    rows = lambda: torch.randn(nb, 1, generator=gen, device=dev)
    x = torch.randn(nb, bsz, generator=gen, device=dev) * torch.exp(rows() * 3)
    x[0] = 0.0                                       # an all-zero block
    out = {}

    # B1 quantize: exact
    ck, ak = ops.quantize_blockwise(x, qs)
    cp, ap = bq.quantize_plain(x, qs)
    err = max((ck.int() - cp.int()).abs().max().item(),
              (ak - ap).abs().max().item())
    require(torch.equal(ck, cp) and torch.equal(ak, ap),
            f"blockwise_quant disagrees with its plain version (err {err})")
    # the kernel's time: raw launches of its C entry on the wrappers' grid
    # (the wrapper's host time beside it)
    lib_q = bq._lib()
    ctas = lib_q.blockwise_quantize_ctas(nb, bsz, 8, build.sm_count(dev))
    ms = median_ms(torch, raw_quantize(torch, lib_q, x, qs, ck.clone(),
                                       ak.clone(), 8, ctas=ctas), 20, 10)
    wrap_us = host_us(torch, lambda: ops.quantize_blockwise(x, qs))
    plain = median_ms(torch, lambda: bq.quantize_plain(x, qs), 3, 2, 1)
    b, by = bound_ms(n * 5 + nb * 4 + 1024, n * 19)
    out["blockwise_quant"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                  bound_ms=b, bound_by=by, host_us=wrap_us)
    print(f"kernel blockwise_quant ({nb}x{bsz} f32): exact; {ms:.4f} ms "
          f"({ctas} CTAs), bound {b:.4f} ms ({by}, {100 * b / ms:.0f}% of "
          f"it), plain {plain:.3f} ms; wrapper {wrap_us:.1f} us of host "
          f"time per call")

    # B2 dequantize: exact, f32 and bf16
    for dt in (torch.float32, torch.bfloat16):
        vk = ops.dequantize_blockwise(ck, ak, qs, dtype=dt)
        vp = bdq.dequantize_plain(ck, ak, qs, dt)
        err = (vk.float() - vp.float()).abs().max().item()
        require(torch.equal(vk, vp), f"blockwise_dequant ({dt}) disagrees "
                f"with its plain version (err {err})")
        ms = median_ms(torch, lambda: ops.dequantize_blockwise(
            ck, ak, qs, dtype=dt), 20)
        plain = median_ms(torch, lambda: bdq.dequantize_plain(ck, ak, qs, dt),
                          3, 2, 1)
        osz = 4 if dt == torch.float32 else 2
        b, by = bound_ms(n * (1 + osz) + nb * 4 + 1024, n)
        print(f"kernel blockwise_dequant ({nb}x{bsz} -> {dt}): exact; "
              f"{ms:.4f} ms, bound {b:.4f} ms ({by}), plain {plain:.3f} ms")
        if dt == torch.float32:   # the dtype the main path's read-back uses
            out["blockwise_dequant"] = dict(max_abs_err=err, ms=ms,
                                            plain_ms=plain, bound_ms=b,
                                            bound_by=by)
    del x, ck, cp, vk, vp

    # B3 fused updates: one step from random nonzero states, each variant
    # against its plain version
    p = torch.randn(nb, bsz, generator=gen, device=dev) * 0.02
    g = torch.randn(nb, bsz, generator=gen, device=dev) * 1e-3
    codes = [torch.randint(0, 256, (nb, bsz), generator=gen, device=dev,
                           dtype=torch.uint8) for _ in range(2)]
    am = torch.rand(nb, generator=gen, device=dev) * 1e-3 + 1e-5
    ar = torch.rand(nb, generator=gen, device=dev) * 1e-6 + 1e-9
    hyper = dict(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=WEIGHT_DECAY, step=7.0, gnorm_scale=1.0)
    s = fu.scalars(device=dev, **hyper)
    # lamb/lars take the trust ratio of lamb's prologue (B4 is checked and
    # timed in check_packed_and_norm_kernels)
    partials = fu.norm_partials_plain(p, g, codes[0], am, codes[1], ar, qs,
                                      qu, s, algo="lamb")
    ts = fu.segment_scales_from_partials(fu.ALGO_SPECS["lamb"], partials,
                                         ((0, nb),), nb, WEIGHT_DECAY, 1e-3)
    del partials
    lib_fu, sms = fu._lib("fused_update"), build.sm_count(dev)

    for variant, (algo, sr) in VARIANTS.items():
        spec = fu.ALGO_SPECS[algo]
        two = spec.n_states == 2
        q1 = qs if spec.state1_signed else qu
        cr, arr = (codes[1], ar) if two else (None, None)
        ts_v = ts if spec.needs_norms else None
        uniforms = (fu.block_uniforms(nb, bsz, two=two, seed=SEED,
                                      device=dev) if sr else (None, None))
        want = fu.fused_update_plain(p, g, codes[0], am, cr, arr, q1, qu, s,
                                     algo=algo, tensor_scale=ts_v,
                                     uniforms=uniforms)
        del uniforms
        got = [None if t is None else t.clone()
               for t in (p, codes[0], am, cr, arr)]
        kw = dict(hyper, algo=algo, stochastic=sr, seed=SEED,
                  tensor_scale_blocks=ts_v)
        fu.fused_update_cuda(got[0], g, got[1], got[2], got[3], got[4], q1,
                             qu, **kw)
        err, n_bad = 0.0, 0
        for name, k_, w_ in zip(want._fields, got, want[:5]):
            if w_ is None:
                continue
            n_bad += int((k_ != w_).sum())
            err = max(err, (k_.float() - w_.float()).abs().max().item())
        require(n_bad == 0, f"fused_update/{variant}: {n_bad} values "
                f"(p, codes, absmax) disagree with the plain version "
                f"(err {err})")
        del want
        grid = lib_fu.fused_update_ctas(fu.KERNEL_ALGOS[algo], 0, nb, bsz,
                                        sms)
        ms = median_ms(torch, raw_update(
            torch, lib_fu, "fused_update_grid", algo, got, g, q1, qu, ts_v,
            sr=sr, tail=(grid,), hyper=hyper), 20, 10)
        wrap_us = host_us(torch, lambda: fu.fused_update_cuda(
            got[0], g, got[1], got[2], got[3], got[4], q1, qu, **kw))
        plain = median_ms(torch, lambda: fu.fused_update_plain(
            p, g, codes[0], am, cr, arr, q1, qu, s, algo=algo,
            tensor_scale=ts_v,
            uniforms=(fu.block_uniforms(nb, bsz, two=two, seed=SEED,
                                        device=dev)
                      if sr else (None, None))), 3, 2, 1)
        per_elem = (16 if two else 14)
        per_block = (16 if two else 8) + (4 if spec.needs_norms else 0)
        ops_ = (56 if two else 30) + (40 if sr else 0)
        b, by = bound_ms(n * per_elem + nb * per_block + 2048, n * ops_)
        out[f"fused_update/{variant}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
            library_ms=None, host_us=wrap_us)
        print(f"kernel fused_update {variant} ({nb}x{bsz}): p, codes and "
              f"absmax exact, 0 mismatches; {ms:.4f} ms ({grid} CTAs), "
              f"bound {b:.4f} ms ({by}, {100 * b / ms:.0f}% of it), plain "
              f"{plain:.3f} ms; wrapper {wrap_us:.1f} us of host time per "
              f"call")
        del got
    return out


def check_div_shortcut(torch, dev) -> dict:
    """The division shortcut of the 8-bit update and B1
    (``csrc/common.cuh::div_fast``: x / c for a divisor fixed before the
    loop, in place of ``__fdiv_rn``), against ``__fdiv_rn`` for every f32
    bit pattern x in the shortcut's range, at the main path's divisors:
    c1 and c2 of adamw's steps 1..10, 0.52 and 0.00698 at the kernels
    phase's step 7, and 24 random block scales over 2^-60 .. 2^60 with the
    range's ends, 1, a power of two and the significands next to 1 and 2;
    plus divisors outside the range (subnormal, 2^-61, 2^61, FLT_MAX),
    where no x may take it.  0 mismatches required."""
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_update as fu
    divs = []
    for step in range(1, 11):
        s = fu.scalars(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                       weight_decay=WEIGHT_DECAY, step=float(step),
                       gnorm_scale=1.0, device="cpu")
        divs += [float(s["c1"]), float(s["c2"])]
    gen = torch.Generator().manual_seed(SEED + 7)
    exps = torch.randint(-60, 60, (24,), generator=gen)
    sig = 1 + torch.rand(24, generator=gen, dtype=torch.float64)
    divs += [float(torch.tensor(float(m) * 2.0 ** int(e),
                                dtype=torch.float32))
             for m, e in zip(sig, exps)]
    divs += [2.0 ** -60, 2.0 ** 60, 1.0, 0.5, 1.0000001, 1.9999999]
    outside = [1e-40, 2.0 ** -61, 2.0 ** 61, 3.4028234663852886e38]
    d = torch.tensor(divs + outside, dtype=torch.float32, device=dev)
    bad = torch.zeros(len(d), dtype=torch.int64, device=dev)
    seen = torch.zeros(len(d), dtype=torch.int64, device=dev)
    lib = fu._lib("fused_update")
    # divisors, n, mismatches and x checked per divisor (int64), stream; a
    # card-only entry (the CPU tests' emulation lacks it)
    check = lib.fused_update_div_check
    check.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
    check.restype = ctypes.c_int
    t0 = time.perf_counter()
    build.check(lib, check(
        build.ptr(d), len(d), build.ptr(bad), build.ptr(seen),
        build.stream(dev)), "fused_update_div_check")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_bad, n_seen = int(bad.sum()), seen.tolist()
    require(n_bad == 0, f"div_fast disagrees with __fdiv_rn for {n_bad} x "
            f"(by divisor: {bad.tolist()})")
    require(all(n > 0 for n in n_seen[:len(divs)]) and
            not any(n_seen[len(divs):]),
            f"div_fast's range: x checked per divisor {n_seen}")
    print(f"kernel div_fast: every f32 x in range checked against "
          f"__fdiv_rn at {len(divs)} divisors ({sum(n_seen)} quotients, "
          f"{min(n_seen[:len(divs)])}-{max(n_seen)} per divisor), 0 "
          f"mismatches; {len(outside)} divisors outside the range take "
          f"none; {secs:.1f} s")
    return {"divisors": len(divs), "quotients": sum(n_seen),
            "mismatches": n_bad}


def _mismatches(got, want) -> tuple[int, float]:
    """(values of got that differ from want, largest |difference|) over
    pairs of tensors; a None in want skips its pair."""
    n_bad, err = 0, 0.0
    for k_, w_ in zip(got, want):
        if w_ is None:
            continue
        n_bad += int((k_ != w_).sum())
        err = max(err, (k_.float() - w_.float()).abs().max().item())
    return n_bad, err


def check_packed_and_norm_kernels(torch, dev,
                                  nb: int = 10 * 1024 * 8192 // 2048,
                                  bsz: int = 2048) -> dict:
    """The two kernels whose CTAs walk the blocks, against their plain
    versions at (nb, bsz), the main path's largest leaf: exact.  B4, the
    norm prologue, for lars, lamb and lamb on (4, 8) states, each timed in
    turns with its library call (torch.linalg.vector_norm of p and of g);
    B3(d), the packed update, at each of PACKED_VARIANTS, and at (4, 8)
    timed in turns with the 8-bit update B3(a) (adamw) on the same p and
    g.  Only the wrappers' Python interface is used, so that
    scripts/ns_bench.py can run this on another tree's kernels."""
    from repro_torch.core import qmap
    from repro_torch.core.lowbit import pack_codes
    from repro_torch.kernels import fused_update as fu

    n = nb * bsz
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    qm = lambda bits, signed=True: torch.as_tensor(
        qmap.get_qmap("dynamic", signed, bits=bits), device=dev)
    p = torch.randn(nb, bsz, generator=gen, device=dev) * 0.02
    g = torch.randn(nb, bsz, generator=gen, device=dev) * 1e-3
    hyper = dict(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=WEIGHT_DECAY, step=7.0, gnorm_scale=1.0)
    s = fu.scalars(device=dev, **hyper)
    am = torch.rand(nb, generator=gen, device=dev) * 1e-3 + 1e-5
    ar = torch.rand(nb, generator=gen, device=dev) * 1e-6 + 1e-9
    codes = lambda bits: pack_codes(torch.randint(
        0, 1 << bits, (nb, bsz), generator=gen, device=dev), bits)
    out = {}

    # B4: lars, lamb and lamb on (4, 8) states, each in turns with the two
    # vector norms (the prologue also adds ||u||^2 for lamb: the library
    # call is the same for all three)
    norm_hyper = {k: v for k, v in hyper.items() if k != "lr"}
    library_fn = lambda: (torch.linalg.vector_norm(p, dim=1),
                          torch.linalg.vector_norm(g, dim=1))
    for name, bits in (("lars", None), ("lamb", (8, 8)),
                       ("lamb_4_8", (4, 8))):
        kind = "lars" if bits is None else "lamb"
        bits_m, bits_r = bits or (8, 8)
        state = ((codes(bits_m), am, codes(bits_r), ar, qm(bits_m),
                  qm(bits_r, False)) if bits else (None,) * 6)
        kw = dict(norm_hyper, algo=kind, bits_m=bits_m, bits_r=bits_r)
        want = fu.norm_partials_plain(p, g, *state, s, algo=kind,
                                      bits_m=bits_m, bits_r=bits_r)
        got = fu.norm_partials_cuda(p, g, *state, **kw)
        n_bad, err = _mismatches([got], [want])
        require(n_bad == 0, f"norm_partials/{name}: {n_bad} partials "
                f"disagree with the plain version (err {err})")
        # 20 calls between the events: the first call's host time (~0.1 ms
        # of the wrapper's Python before its launch, against ~0.02 ms for
        # the library's) falls on the timed span once per 20 calls
        turns = in_turns(torch, {
            "library": library_fn,
            "kernel": lambda: fu.norm_partials_cuda(p, g, *state, **kw)},
            20, 20)
        ms, library = turns["kernel"], turns["library"]
        # device time alone, the two in turns in one profiler session: the
        # wrapper's host time does not enter it
        split = device_ms_split(torch, {
            "library": (library_fn, None),
            "kernel": (lambda: fu.norm_partials_cuda(p, g, *state, **kw),
                       "norm_partials_kernel")})
        plain = median_ms(torch, lambda: fu.norm_partials_plain(
            p, g, *state, s, algo=kind, bits_m=bits_m, bits_r=bits_r), 3, 2,
            1)
        per_elem = 8 + (bits_m + bits_r) / 8 if bits else 8
        b, by = bound_ms(n * per_elem + nb * (40 if bits else 32),
                         n * (26 if bits else 6))
        out[f"norm_partials/{name}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
            library_ms=library, device_ms=split["kernel"],
            library_device_ms=split["library"],
            profiler_sessions=[split["sessions"]])
        print(f"kernel norm_partials {name} ({nb}x{bsz}): exact, 0 "
              f"mismatches; {ms:.4f} ms, in turns with torch.linalg."
              f"vector_norm of p and g {library:.4f} ms ({ms / library:.3f}x "
              f"its time); device time {split['kernel']:.4f} ms against "
              f"{split['library']:.4f} ms "
              f"({split['kernel'] / split['library']:.3f}x); bound {b:.4f} "
              f"ms ({by}, {100 * b / ms:.0f}% of it), plain {plain:.3f} ms")
        del state, want, got

    # B3(d): the packed update, every variant bit-exact
    for variant, (algo, bits_m, bits_r, sr) in PACKED_VARIANTS.items():
        spec = fu.ALGO_SPECS[algo]
        two = spec.n_states == 2
        bits_r = bits_r if two else 8
        q1, q2 = qm(bits_m), qm(bits_r, False)
        cm, cr = codes(bits_m), codes(bits_r) if two else None
        arr = ar if two else None
        uniforms = (fu.block_uniforms(nb, bsz, two=two, seed=SEED,
                                      device=dev) if sr else (None, None))
        want = fu.fused_update_plain(p, g, cm, am, cr, arr, q1, q2, s,
                                     algo=algo, uniforms=uniforms,
                                     bits_m=bits_m, bits_r=bits_r)
        del uniforms
        got = [None if t is None else t.clone() for t in (p, cm, am, cr, arr)]
        kw = dict(hyper, algo=algo, stochastic=sr, seed=SEED, bits_m=bits_m,
                  bits_r=bits_r)
        fu.fused_update_cuda(got[0], g, *got[1:], q1, q2, **kw)
        n_bad, err = _mismatches(got, want[:5])
        require(n_bad == 0, f"fused_update/{variant}: {n_bad} values (p, "
                f"packed codes, absmax) disagree with the plain version "
                f"(err {err})")
        del want
        run = lambda: fu.fused_update_cuda(got[0], g, *got[1:], q1, q2, **kw)
        ms = median_ms(torch, run, 20)
        plain = median_ms(torch, lambda: fu.fused_update_plain(
            p, g, cm, am, cr, arr, q1, q2, s, algo=algo,
            uniforms=(fu.block_uniforms(nb, bsz, two=two, seed=SEED,
                                        device=dev)
                      if sr else (None, None)),
            bits_m=bits_m, bits_r=bits_r), 3, 2, 1)
        # p read and written, g read, each state's codes read and written
        per_elem = 12 + 2 * (bits_m + (bits_r if two else 0)) / 8
        ops_ = (56 if two else 30) + (40 if sr else 0)
        b, by = bound_ms(n * per_elem + nb * (16 if two else 8) + 2048,
                         n * ops_)
        out[f"fused_update/{variant}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
            library_ms=None)
        print(f"kernel fused_update {variant} ({nb}x{bsz}, bits "
              f"{bits_m}/{bits_r if two else '-'}): p, packed codes and "
              f"absmax exact, 0 mismatches; {ms:.4f} ms, bound {b:.4f} ms "
              f"({by}, {100 * b / ms:.0f}% of it), plain {plain:.3f} ms")
        if variant == "adam8_4_8":
            # in turns with the 8-bit kernel (adamw, B3(a)) on the same p, g
            st8 = [p.clone(), codes(8), am.clone(), codes(8), ar.clone()]
            q8s, q8u = qm(8), qm(8, False)
            turns = in_turns(torch, {
                "8bit": lambda: fu.fused_update_cuda(
                    st8[0], g, *st8[1:], q8s, q8u, **dict(kw, algo="adamw",
                                                          bits_m=8,
                                                          bits_r=8)),
                "packed": run}, 20, 5)
            out[f"fused_update/{variant}"]["adamw8_in_turns_ms"] = \
                turns["8bit"]
            print(f"kernel fused_update {variant} in turns with adamw8 "
                  f"(B3(a)) on the same p and g: {turns['packed']:.4f} ms vs "
                  f"{turns['8bit']:.4f} ms "
                  f"({turns['packed'] / turns['8bit']:.3f}x)")
            del st8
        del got, cm, cr, run
    del p, g
    return out


def check_slice3_kernels(torch, dev, nb: int = 10 * 1024 * 8192 // 2048,
                         bsz: int = 2048, ns_shape=(1024, 50264)) -> dict:
    """The third slice's kernels against their plain versions: quantize and
    dequantize at 4 bits (B1/B2) at (nb, bsz); the Newton–Schulz gram and
    apply (B5/B6) at ``ns_shape``, the main path's head.  (The packed
    update B3(d) and lamb's prologue on packed states are in
    :func:`check_packed_and_norm_kernels`.)"""
    from repro_torch.core import qmap
    from repro_torch.kernels import blockwise_dequant as bdq
    from repro_torch.kernels import blockwise_quant as bq
    from repro_torch.kernels import build

    n = nb * bsz
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    lib_q = bq._lib()
    out = {}

    # B1 / B2 at 4 bits; B1 also stochastic
    q4 = torch.as_tensor(qmap.get_qmap("dynamic", True, bits=4), device=dev)
    x = torch.randn(nb, bsz, generator=gen, device=dev) * torch.exp(
        torch.randn(nb, 1, generator=gen, device=dev) * 3)
    x[0] = 0.0
    for name, seed in (("blockwise_quant/4bit", None),
                       ("blockwise_quant/4bit_sr", SEED + 11)):
        ck, ak = bq.quantize_blockwise(x, q4, bits=4, seed=seed)
        cp, ap = bq.quantize_plain(x, q4, bits=4, seed=seed)
        n_bad, err = _mismatches([ck, ak], [cp, ap])
        require(n_bad == 0, f"{name}: {n_bad} packed codes or absmax "
                f"disagree with the plain version (err {err})")
        ms = median_ms(torch, raw_quantize(
            torch, lib_q, x, q4, ck.clone(), ak.clone(), 4, seed,
            lib_q.blockwise_quantize_ctas(nb, bsz, 4, build.sm_count(dev))),
            20, 10)
        wrap_us = host_us(torch, lambda: bq.quantize_blockwise(
            x, q4, bits=4, seed=seed))
        plain = median_ms(torch, lambda: bq.quantize_plain(
            x, q4, bits=4, seed=seed), 3, 2, 1)
        b, by = bound_ms(n * 4.5 + nb * 4 + 64,
                         n * (19 + (40 if seed is not None else 0)))
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                         bound_by=by, library_ms=None, host_us=wrap_us)
        print(f"kernel {name} ({nb}x{bsz} f32): exact; {ms:.4f} ms, bound "
              f"{b:.4f} ms ({by}, {100 * b / ms:.0f}% of it), plain "
              f"{plain:.3f} ms; wrapper {wrap_us:.1f} us of host time per "
              f"call")
    vk = bdq.dequantize_blockwise(ck, ak, q4, bits=4)
    vp = bdq.dequantize_plain(ck, ak, q4, bits=4)
    n_bad, err = _mismatches([vk], [vp])
    require(n_bad == 0, f"blockwise_dequant/4bit disagrees with its plain "
            f"version (err {err})")
    ms = median_ms(torch, lambda: bdq.dequantize_blockwise(ck, ak, q4,
                                                           bits=4), 20)
    plain = median_ms(torch, lambda: bdq.dequantize_plain(ck, ak, q4,
                                                          bits=4), 3, 2, 1)
    b, by = bound_ms(n * 4.5 + nb * 4 + 64, n)
    out["blockwise_dequant/4bit"] = dict(max_abs_err=err, ms=ms,
                                         plain_ms=plain, bound_ms=b,
                                         bound_by=by, library_ms=None)
    print(f"kernel blockwise_dequant/4bit ({nb}x{bsz} -> f32): exact; "
          f"{ms:.4f} ms, bound {b:.4f} ms ({by}), plain {plain:.3f} ms")
    del x, ck, ak, cp, ap, vk, vp

    out.update(check_ns_kernels(torch, dev, ns_shape))
    return out


def check_ns_kernels(torch, dev, shape=(1024, 50264),
                     small=(10, 1024)) -> dict:
    """B5 / B6 (the Newton–Schulz gram and apply) against their
    tile-replaying plain versions at the head's ``shape`` and the stacked
    norm vectors' ``small`` shape (each padded as the main path pads it):
    within NS_RTOL of the output's largest magnitude, bit-identical over
    two launches, the gram exactly symmetric.  At the head, kernel and
    library call timed in turns by CUDA events; at the small shape, where
    a call is a few microseconds of device time, by torch.profiler's device
    time, the two in turns in one session.  ``bound_ms`` is the bound of
    the design: three TF32 products per f32 product at the tensor cores'
    TF32 rate; the f32 rate outside them gives ``f32_simt_bound_ms``."""
    from repro_torch.kernels import newton_schulz as ns
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    a_, b_, c_ = ns.NS_COEFFS
    out = {}
    for (m, n_cols), head in ((shape, True), (small, False)):
        x = torch.randn(m, n_cols, generator=gen, device=dev)
        x = ns.pad_matrix(x / x.norm()).contiguous()
        m, n_pad = x.shape
        want = ns.gram_plain(x)
        b_mat = (b_ * want + c_ * (want @ want)).contiguous()
        cases = {
            # A is symmetric: m (m + 1) / 2 distinct dot products of n FMAs
            "ns_gram": (lambda: ns.gram_cuda(x), lambda: ns.gram_plain(x),
                        lambda: torch.mm(x, x.T), want,
                        (m * n_pad + m * m) * 4, float(m * (m + 1) * n_pad)),
            "ns_apply": (lambda: ns.apply_cuda(x, b_mat, a_),
                         lambda: ns.apply_plain(x, b_mat, a_),
                         lambda: torch.addmm(x, b_mat, x, beta=a_),
                         ns.apply_plain(x, b_mat, a_),
                         (2 * m * n_pad + m * m) * 4, 2.0 * m * m * n_pad)}
        for name, (fn, plain_fn, lib_fn, w, n_bytes, n_ops) in cases.items():
            k1, k2 = fn(), fn()
            at = f"{name} at {m}x{n_pad}"
            rel = ((k1 - w).abs().max() / w.abs().max()).item()
            require(rel < NS_RTOL, f"{at}: largest error {rel:.3e} of the "
                    f"output's largest magnitude (limit {NS_RTOL:g})")
            require(torch.equal(k1, k2),
                    f"{at}: two launches on the same input differ")
            require(name != "ns_gram" or torch.equal(k1, k1.T),
                    f"{at}: the result is not exactly symmetric")
            checked = (f"kernel {name} ({m}x{n_pad} f32): largest error "
                       f"{rel:.3e} of the largest magnitude (limit "
                       f"{NS_RTOL:g}), identical over two launches"
                       f"{', exactly symmetric' if name == 'ns_gram' else ''}")
            if not head:
                split = device_ms_split(torch, {"library": (lib_fn, None),
                                                "kernel": (fn, name)})
                ms, library = split["kernel"], split["library"]
                out[name].update(rel_err_small=rel, device_ms_small=ms,
                                 library_device_ms_small=library,
                                 profiler_sessions=[split["sessions"]])
                print(f"{checked}; device {ms:.4f} ms per call, library "
                      f"{library:.4f} ms")
                continue
            plain = median_ms(torch, plain_fn, 3, 1, 1)
            turns = in_turns(torch, {"library": lib_fn, "kernel": fn}, 8, 2)
            ms, library = turns["kernel"], turns["library"]
            b, by = bound_ms(n_bytes, 3 * n_ops, TF32_FLOP_PER_S)
            simt, _ = bound_ms(n_bytes, n_ops)
            out[name] = dict(max_abs_err=(k1 - w).abs().max().item(),
                             rel_err=rel, ms=ms, plain_ms=plain, bound_ms=b,
                             bound_by=by, library_ms=library,
                             f32_simt_bound_ms=simt)
            print(f"{checked}; {ms:.4f} ms, library {library:.4f} ms (in "
                  f"turns, {library / ms:.2f}x the kernel's time); 3xTF32 bound "
                  f"{b:.4f} ms ({by}, {100 * b / ms:.0f}% of it), f32-SIMT "
                  f"bound {simt:.4f} ms ({100 * simt / ms:.0f}%); "
                  f"plain {plain:.3f} ms")
            del k1, k2
    return out


# B7's shapes: (slots, pages per slot, page, kv heads, head dim, pages in
# the pool); the paper LM's serve path, and recurrentgemma-9b's (MQA, kv 1
# x 256: its 4 slots of 133 pages, prompts up to 2100 tokens + 16 new)
GATHER_SHAPE = (SERVE_SLOTS, SERVE_PAGES_PER_SEQ, SERVE_PAGE, 16, 64,
                SERVE_POOL)
RG_GATHER_SHAPE = (4, 133, 16, 1, 256, 4 * 133)


def gather_inputs(torch, dev, bits: int, shape=GATHER_SHAPE):
    """B7's inputs at ``shape`` (the serve path's by default: a pool of 512
    pages of 16 positions x 16 heads x 64, rows over many decades, two
    all-zero rows) quantized at ``bits``, and a scrambled table of slots x
    pages with -1 entries (unallocated tails, one empty slot).  Returns
    (codes, absmax, table, distinct pages read)."""
    from repro_torch.kernels import paged_kv
    B, P_, page, KV, Dh, pool = shape
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = torch.randn(pool, page, KV, Dh, generator=gen,
                       device=dev) * torch.exp(torch.randn(
                           pool, page, KV, 1, generator=gen,
                           device=dev) * 2)
    rows[1, 2] = 0.0                                   # all-zero rows
    table = torch.randperm(pool, generator=gen, device=dev)[
        :B * P_].reshape(B, P_).int()
    table[B // 4, P_ * 5 // 8:] = -1                  # unallocated tails
    table[B - 1] = -1
    pages_read = len(set(table.clamp(0, pool - 1).flatten().tolist()))
    codes, absmax = paged_kv.quantize_rows(rows, bits)
    return codes, absmax, table, pages_read


def raw_gather(lib, codes, absmax, table, out, bits: int) -> callable:
    """A launch of ``paged_gather`` (the wrapper's C entry) of ``lib``
    (this tree's or another's), no wrapper in between; the stream is read
    at each call (under a graph capture, the capture's)."""
    from repro_torch.kernels import build, paged_kv
    n_pages, page, KV, W = codes.shape
    B, P_ = table.shape
    args = (build.ptr(codes), build.ptr(absmax), build.ptr(table),
            build.ptr(paged_kv.kv_qmap(bits, codes.device)), build.ptr(out),
            int(out.element_size() == 2), n_pages, page * KV, W, bits, B,
            P_)                            # 2-byte elements: bf16, else f32
    keep = (codes, absmax, table, out)     # the tensors behind the pointers

    def launch():
        build.check(lib, lib.paged_gather(*args,
                                          build.stream(codes.device)),
                    "paged_gather")
        return keep
    return launch


# cold timing of B7: copies of the pool and outputs taken in rotation, so a
# launch finds its pages out of the 50 MB L2, as the decode step's 20 pools
# (~178 MB at 8 bits) leave them
GATHER_COPIES, GATHER_OUTS, GATHER_LAUNCHES = 6, 2, 60


def gather_rotation(torch, make, codes, absmax, table, bits: int,
                    dtype) -> tuple[list, object]:
    """GATHER_LAUNCHES launches make(codes, absmax, out) over
    GATHER_COPIES copies of the pool and GATHER_OUTS outputs in rotation
    (~87 MB at 8 bits -> bf16, more than the L2 holds), and the first
    output (written by the first launch, once it has run)."""
    n_pages, page, KV, W = codes.shape
    B, P_ = table.shape
    pools = [(codes, absmax)] + [(codes.clone(), absmax.clone())
                                 for _ in range(GATHER_COPIES - 1)]
    outs = [torch.empty((B, P_ * page, KV, W * 8 // bits), dtype=dtype,
                        device=codes.device) for _ in range(GATHER_OUTS)]
    return [make(*pools[i % GATHER_COPIES], outs[i % GATHER_OUTS])
            for i in range(GATHER_LAUNCHES)], outs[0]


def gather_cold(torch, makers: dict, codes, absmax, table, bits: int,
                dtype, reps: int = 12) -> tuple[dict, dict]:
    """({label: ms per launch}, {label: output of pool 0}): each maker's
    :func:`gather_rotation` captured in one CUDA graph; the graphs are
    replayed in turns, timed by CUDA events (so a launch's time includes
    the gap to the next launch in the graph, and no host time)."""
    graphs, first = {}, {}
    for label, make in makers.items():
        seq, out0 = gather_rotation(torch, make, codes, absmax, table, bits,
                                    dtype)
        seq[0]()
        torch.cuda.synchronize()
        first[label] = out0.clone()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for launch in seq:
                launch()
        graphs[label] = (g, seq)            # seq keeps the tensors alive
    ms = in_turns(torch, {k: v[0].replay for k, v in graphs.items()}, reps,
                  1)
    return {k: v / GATHER_LAUNCHES for k, v in ms.items()}, first


def gather_bound(codes, table, pages_read: int, bits: int, dtype) -> tuple:
    """B7's bound at these inputs: each page read once (codes and absmax),
    the table and codebook once, the output written once; one multiply a
    value."""
    n_pages, page, KV, W = codes.shape
    B, P_ = table.shape
    n_out = B * P_ * page * KV * (W * 8 // bits)
    return bound_ms(pages_read * page * KV * (W + 4) + B * P_ * 4
                    + n_out * dtype.itemsize + (1 << bits) * 4, n_out)


def check_gather_kernel(torch, dev, shape=GATHER_SHAPE) -> dict:
    """B7 against its plain version at ``shape`` (:func:`gather_inputs`;
    the serve path's by default); 8 and 4 bits, bf16 (the path's dtype)
    and f32 out.  Exact: 0 mismatches.  Timed warm (back-to-back calls on
    one pool, profiler device time beside the plain version's) and cold
    (raw launches of the wrapper's C entry over rotating pools,
    :func:`gather_rotation`: profiler device time, and CUDA events around
    a graph of them, :func:`gather_cold`)."""
    from repro_torch.kernels import paged_kv
    lib = paged_kv._lib()
    out = {}
    for bits in (8, 4):
        codes, absmax, table, pages_read = gather_inputs(torch, dev, bits,
                                                         shape)
        B, P_ = table.shape
        for dt in (torch.bfloat16, torch.float32):
            got = paged_kv.gather_cuda(codes, absmax, table, bits=bits,
                                       dtype=dt)
            want = paged_kv._gather_torch(codes, absmax, table, bits=bits,
                                          dtype=dt)
            n_bad = int((got != want).sum())
            err = (got.float() - want.float()).abs().max().item()
            require(n_bad == 0, f"paged_gather ({bits}-bit, {dt}): {n_bad} "
                    f"values disagree with the plain version (err {err})")
            call_ms = median_ms(torch, lambda: paged_kv.gather_cuda(
                codes, absmax, table, bits=bits, dtype=dt), 20, per=20)
            split = device_ms_split(torch, {
                "kernel": (lambda: paged_kv.gather_cuda(
                    codes, absmax, table, bits=bits, dtype=dt),
                    "paged_gather_kernel"),
                "plain": (lambda: paged_kv._gather_torch(
                    codes, absmax, table, bits=bits, dtype=dt), None)}, 50)
            warm, plain = split["kernel"], split["plain"]
            make = lambda c, a, o: raw_gather(lib, c, a, table, o, bits)
            graph_ms, first = gather_cold(torch, {"kernel": make}, codes,
                                          absmax, table, bits, dt)
            require(torch.equal(first["kernel"], want), f"paged_gather "
                    f"({bits}-bit, {dt}): the raw launch differs from the "
                    f"plain version")
            seq, _ = gather_rotation(torch, make, codes, absmax, table, bits,
                                     dt)
            it = iter(range(1 << 30))
            cold_split = device_ms_split(torch, {"cold": (
                lambda: seq[next(it) % len(seq)](),
                "paged_gather_kernel")}, 2 * len(seq))
            cold = cold_split["cold"]
            del seq
            b, by = gather_bound(codes, table, pages_read, bits, dt)
            print(f"kernel paged_gather ({bits}-bit -> {dt}, {B}x{P_} pages "
                  f"of {'x'.join(map(str, shape[2:5]))}, {pages_read} "
                  f"distinct): exact, 0 "
                  f"mismatches; cold {cold:.4f} ms of device time "
                  f"({100 * b / cold:.0f}% of the bound), "
                  f"{graph_ms['kernel']:.4f} ms per launch in a graph; warm "
                  f"{warm:.4f} ms of device time; bound {b:.4f} ms ({by}); "
                  f"plain {plain:.4f} ms of device time; {call_ms:.4f} ms "
                  f"per wrapper call back to back by CUDA events (the "
                  f"host's launch rate)")
            row = dict(max_abs_err=err, ms=cold, warm_ms=warm,
                       graph_ms=graph_ms["kernel"], plain_ms=plain,
                       bound_ms=b, bound_by=by, library_ms=None,
                       profiler_sessions=[split["sessions"],
                                          cold_split["sessions"]])
            if dt == torch.bfloat16:
                out[f"paged_gather/{bits}bit"] = row
            else:
                out[f"paged_gather/{bits}bit"].update(
                    {f"f32_{k}": v for k, v in row.items()
                     if k not in ("bound_by", "library_ms")})
    return out


def _poison(torch, g, am, ar):
    """NaN, +inf and -inf in block 0 of g (a NaN absmax, so x / scale
    reaches +inf: the capped encode), 1e31 in block 1 of g, and block 2's
    state absmax inf (its dequantized state inf and NaN)."""
    g, am = g.clone(), am.clone()
    g[0, 3], g[0, 7], g[0, 11] = float("nan"), float("inf"), -float("inf")
    g[1, 5] = 1e31
    am[2] = float("inf")
    if ar is not None:
        ar = ar.clone()
        ar[2] = float("inf")
    return g, am, ar


def _differ(a, b) -> int:
    """Values of a that differ from b (NaN matches NaN)."""
    if not a.is_floating_point():
        return int((a != b).sum())
    nan = a.isnan()
    return int((nan != b.isnan()).sum()) + int((a[~nan] != b[~nan]).sum())


def _sentinel_bound(n: int, nb: int, bits_m: int, bits_r, sr: bool,
                    norms: bool) -> tuple:
    """B3(e)'s bound: B3's bytes (p read and written, g read, codes read
    and written, absmax and the trust ratio) plus the (nb, 8) f32 health
    rows; bits_r None for one-state algorithms."""
    two = bits_r is not None
    per_elem = 12 + 2 * (bits_m + (bits_r if two else 0)) / 8
    ops_ = (56 if two else 30) + (40 if sr else 0) + 6
    return bound_ms(n * per_elem + nb * ((16 if two else 8) + 32 +
                                         (4 if norms else 0)) + 2048,
                    n * ops_)


def check_sentinel_kernels(torch, dev, nb: int = 10 * 1024 * 8192 // 2048,
                           bsz: int = 2048) -> dict:
    """B3(e), the fused update with the sentinel output, at the main path's
    largest leaf, for each of SENTINEL_VARIANTS on clean inputs and on
    inputs with NaN / +-inf / 1e31 planted in g and in one block's state:
    the health rows equal ``health_rows`` of the plain version exactly, p,
    codes and absmax equal the sentinel-off kernel's bit for bit (and the
    plain version's, NaN where it has NaN).  Timed on clean inputs against
    the sentinel-off kernel in turns (off, on, on, off, ...), by raw
    launches of the C entry the wrapper calls."""
    from repro_torch.core import qmap
    from repro_torch.core.lowbit import pack_codes
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_update as fu

    n = nb * bsz
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    lib_fu, sms = fu._lib("fused_update"), build.sm_count(dev)
    qm = lambda bits, signed: torch.as_tensor(
        qmap.get_qmap("dynamic", signed, bits=bits), device=dev)
    p = torch.randn(nb, bsz, generator=gen, device=dev) * 0.02
    g = torch.randn(nb, bsz, generator=gen, device=dev) * 1e-3
    am = torch.rand(nb, generator=gen, device=dev) * 1e-3 + 1e-5
    ar = torch.rand(nb, generator=gen, device=dev) * 1e-6 + 1e-9
    ts = torch.rand(nb, generator=gen, device=dev) * 0.5 + 0.75
    hyper = dict(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=WEIGHT_DECAY, step=7.0, gnorm_scale=1.0)
    s = fu.scalars(device=dev, **hyper)
    bits_of = lambda t: t.view(torch.int32) if t.dtype == torch.float32 \
        else t
    out = {}

    for variant, (algo, bits_m, bits_r, sr) in SENTINEL_VARIANTS.items():
        spec = fu.ALGO_SPECS[algo]
        two = spec.n_states == 2
        q1, q2 = qm(bits_m, spec.state1_signed), qm(bits_r, False)
        cm = pack_codes(torch.randint(0, 1 << bits_m, (nb, bsz),
                                      generator=gen, device=dev), bits_m)
        cr = (pack_codes(torch.randint(0, 1 << bits_r, (nb, bsz),
                                       generator=gen, device=dev), bits_r)
              if two else None)
        ts_v = ts if spec.needs_norms else None
        kw = dict(hyper, algo=algo, stochastic=sr, seed=SEED, bits_m=bits_m,
                  bits_r=bits_r, tensor_scale_blocks=ts_v)
        uniforms = (fu.block_uniforms(nb, bsz, two=two, seed=SEED,
                                      device=dev) if sr else (None, None))
        sums = {}
        for poisoned in (False, True):
            g_, am_, ar_ = _poison(torch, g, am, ar if two else None) \
                if poisoned else (g, am, ar if two else None)
            want = fu.fused_update_plain(p, g_, cm, am_, cr, ar_, q1, q2, s,
                                         algo=algo, tensor_scale=ts_v,
                                         uniforms=uniforms, bits_m=bits_m,
                                         bits_r=bits_r, sentinel=True)
            on = [None if t is None else t.clone()
                  for t in (p, cm, am_, cr, ar_)]
            off = [None if t is None else t.clone() for t in on]
            health = fu.fused_update_cuda(on[0], g_, *on[1:], q1, q2,
                                          sentinel=True, **kw).health
            fu.fused_update_cuda(off[0], g_, *off[1:], q1, q2, **kw)
            h_bad = int((health != want.health).sum())
            n_off = sum(int((bits_of(a) != bits_of(b)).sum())
                        for a, b in zip(on, off) if a is not None)
            n_plain = sum(_differ(a, b) for a, b in zip(on, want[:5])
                          if a is not None)
            tag = "poisoned" if poisoned else "clean"
            require(h_bad == 0, f"fused_update/sentinel_{variant} ({tag}): "
                    f"{h_bad} health counts differ from health_rows")
            require(n_off == 0, f"fused_update/sentinel_{variant} ({tag}): "
                    f"{n_off} values of p, codes or absmax differ from the "
                    f"sentinel-off kernel's")
            require(n_plain == 0, f"fused_update/sentinel_{variant} ({tag}):"
                    f" {n_plain} values of p, codes or absmax differ from "
                    f"the plain version's")
            sums[tag] = dict(zip(fu.HEALTH_SLOTS,
                                 (int(v) for v in health.sum(dim=0))))
            del want, on, off, health
        require(all(sums["clean"][k] == 0 for k in fu.HEALTH_SLOTS
                    if not k.startswith("edge_hits")),
                f"fused_update/sentinel_{variant}: clean inputs counted "
                f"{sums['clean']}")
        require(sums["poisoned"]["nonfinite_grad"] == 3 and
                sums["poisoned"]["nonfinite_absmax_m"] >= 1,
                f"fused_update/sentinel_{variant}: poisoned inputs counted "
                f"{sums['poisoned']}")
        st_on = [None if t is None else t.clone() for t in (p, cm, am, cr,
                                                            ar if two
                                                            else None)]
        st_off = [None if t is None else t.clone() for t in st_on]
        health = torch.empty(nb, fu.N_HEALTH, device=dev)
        packed = (bits_m, bits_r) != (8, 8)
        # raw launches of the wrappers' C entry and grid, in turns (off,
        # on, on, off, ...): the kernels' own times
        tails = {sent: ((bits_m, bits_r, lib_fu.fused_update_packed_ctas(
            nb, bsz, sms)) if packed else (lib_fu.fused_update_ctas(
                fu.KERNEL_ALGOS[algo], int(sent), nb, bsz, sms),))
            for sent in (False, True)}
        entry = "fused_update_packed_grid" if packed else "fused_update_grid"
        turns = in_turns(torch, {
            k: raw_update(torch, lib_fu, entry, algo, st_, g, q1, q2, ts_v,
                          sr=sr, health=h_, tail=tails[h_ is not None],
                          hyper=hyper)
            for k, st_, h_ in (("off", st_off, None),
                               ("on", st_on, health))}, 20, 10)
        ms_off, ms = turns["off"], turns["on"]
        wrap_us = host_us(torch, lambda: fu.fused_update_cuda(
            st_on[0], g, *st_on[1:], q1, q2, sentinel=True, **kw))
        plain = median_ms(torch, lambda: fu.fused_update_plain(
            p, g, cm, am, cr, ar if two else None, q1, q2, s, algo=algo,
            tensor_scale=ts_v, uniforms=uniforms, bits_m=bits_m,
            bits_r=bits_r, sentinel=True), 3, 2, 1)
        b, by = _sentinel_bound(n, nb, bits_m, bits_r if two else None, sr,
                                spec.needs_norms)
        out[f"fused_update/sentinel_{variant}"] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
            library_ms=None, off_ms=ms_off, host_us=wrap_us)
        print(f"kernel fused_update sentinel {variant} ({nb}x{bsz}, bits "
              f"{bits_m}/{bits_r if two else '-'}): health rows exact (0 "
              f"mismatches) on clean and poisoned inputs, p/codes/absmax "
              f"bit-identical to the sentinel-off kernel; poisoned counts "
              f"{sums['poisoned']}; {ms:.4f} ms vs sentinel-off "
              f"{ms_off:.4f} ms in turns ({ms / ms_off:.3f}x), bound "
              f"{b:.4f} ms ({by}, {100 * b / ms:.0f}% of it), plain "
              f"{plain:.3f} ms; wrapper {wrap_us:.1f} us of host time per "
              f"call")
        del st_on, st_off, cm, cr, uniforms
        torch.cuda.empty_cache()
    return out


def arena_layout(torch, dev):
    """The pooled arena of paper-lm-209m as ``make_optimizer("adamw8")``
    lays it out on the full-width model: (segments ((offset, n_blocks),
    ...), the per-block element offsets and seed terms, each segment's
    leaf index in leaf order, the segments' paths)."""
    from repro_torch.configs import base
    from repro_torch.core.optim import blockopt, make_optimizer
    from repro_torch.models import model as M
    model = M.init_model(base.get_config("paper-lm-209m"),
                         torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    params = model.param_dict()
    arena = make_optimizer("adamw8", device=dev).init(params).arena
    order = blockopt.leaf_order(params)
    return (tuple((s.offset, s.n_blocks) for s in arena.segments),
            arena.block_offsets.clone(), arena.leaf_seeds.clone(),
            [order.index(s.path) for s in arena.segments],
            [s.path for s in arena.segments])


def check_arena_kernels(torch, dev, bsz: int = 2048) -> dict:
    """B3 at the pooled arena's shape, as the pooled dispatch launches it:
    ARENA_BLOCKS blocks of paper-lm-209m's 11 quantized leaves, with the
    per-block seeds (a step's term plus each leaf's ``i * 7919``, int32)
    and element offsets of the optimizer's own layout, and for lamb B4 over
    the arena and the 11 segments' trust ratios.  For each of
    ARENA_VARIANTS: the arena launch (through the wrapper, as ``apply``
    makes it) against the plain version, 0 mismatches, and against the 11
    per-leaf launches on the same rows (each leaf's own seed, offsets from
    0, its own trust ratio): the rows concatenated by block must be
    byte-identical.  The seed vector must hold each leaf's per-leaf seed,
    and lamb's per-block scales each segment's own trust ratio.  adamw8's
    arena launch is timed by raw launches of its C entry in turns with the
    11 per-leaf launches on the same rows."""
    from repro_torch.core import qmap
    from repro_torch.core.lowbit import pack_codes
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_update as fu

    segs, offsets, leaf_seeds, index, paths = arena_layout(torch, dev)
    torch.cuda.empty_cache()
    nb = sum(m for _, m in segs)
    require(nb == ARENA_BLOCKS and len(segs) == 11,
            f"arena: {nb} blocks in {len(segs)} segments, expected "
            f"{ARENA_BLOCKS} in 11")
    n = nb * bsz
    base_seed = fu.to_i32(6 * 1000003)      # the seeds of the 7th step
    seeds = torch.add(leaf_seeds, base_seed)
    leaf_seed = [fu.to_i32(base_seed + i * 7919) for i in index]
    for (o, m), sd in zip(segs, leaf_seed):
        require(bool((seeds[o:o + m] == sd).all()), f"arena: the block "
                f"seeds of segment ({o}, {m}) are not its leaf's seed {sd}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    qm = lambda bits, signed=True: torch.as_tensor(
        qmap.get_qmap("dynamic", signed, bits=bits), device=dev)
    p = torch.randn(nb, bsz, generator=gen, device=dev) * 0.02
    g = torch.randn(nb, bsz, generator=gen, device=dev) * 1e-3
    am = torch.rand(nb, generator=gen, device=dev) * 1e-3 + 1e-5
    ar = torch.rand(nb, generator=gen, device=dev) * 1e-6 + 1e-9
    codes = lambda bits: pack_codes(torch.randint(
        0, 1 << bits, (nb, bsz), generator=gen, device=dev,
        dtype=torch.uint8), bits)
    hyper = dict(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=WEIGHT_DECAY, step=7.0, gnorm_scale=1.0)
    s = fu.scalars(device=dev, **hyper)
    lib_fu, sms = fu._lib("fused_update"), build.sm_count(dev)
    rows = lambda ts, o, m: [None if t is None else t[o:o + m] for t in ts]
    out = {}
    print(f"kernel arena: {nb} blocks of {bsz} ({n / 1e6:.1f} M elements) "
          f"in {len(segs)} segments ("
          + ", ".join(f"{p_} {m}" for p_, (_, m) in zip(paths, segs))
          + "); the block seed vector holds each leaf's per-leaf seed")

    for variant, (algo, bits_m, bits_r, sr) in ARENA_VARIANTS.items():
        spec = fu.ALGO_SPECS[algo]
        q1, q2 = qm(bits_m), qm(bits_r, False)
        cm, cr = codes(bits_m), codes(bits_r)
        kw = dict(hyper, algo=algo, stochastic=sr, bits_m=bits_m,
                  bits_r=bits_r)
        ts = None
        if spec.needs_norms:
            # B4 over the arena, exact; each segment's trust ratio lands
            # on its own blocks
            norm_kw = dict({k: v for k, v in hyper.items() if k != "lr"},
                           algo=algo, bits_m=bits_m, bits_r=bits_r)
            b4 = lambda: fu.norm_partials_cuda(p, g, cm, am, cr, ar, q1, q2,
                                               **norm_kw)
            partials = b4()
            want_p = fu.norm_partials_plain(p, g, cm, am, cr, ar, q1, q2, s,
                                            algo=algo, bits_m=bits_m,
                                            bits_r=bits_r)
            n_bad, err = _mismatches([partials], [want_p])
            require(n_bad == 0, f"norm_partials/{variant}: {n_bad} partials "
                    f"disagree with the plain version (err {err})")
            ts = fu.segment_scales_from_partials(spec, partials, segs, nb,
                                                 WEIGHT_DECAY, 1e-3)
            for o, m in segs:
                own = fu.segment_scales_from_partials(
                    spec, partials[o:o + m], ((0, m),), m, WEIGHT_DECAY,
                    1e-3)
                require(torch.equal(ts[o:o + m], own), f"{variant}: the "
                        f"trust ratio of segment ({o}, {m}) is not its own")
            # in turns with its library call on the same rows, as the
            # per-leaf row is timed (20 calls between the events), and by
            # device time in one profiler session
            library_fn = lambda: (torch.linalg.vector_norm(p, dim=1),
                                  torch.linalg.vector_norm(g, dim=1))
            turns = in_turns(torch, {"library": library_fn, "kernel": b4},
                             20, 20)
            ms4, library = turns["kernel"], turns["library"]
            split = device_ms_split(torch, {
                "library": (library_fn, None),
                "kernel": (b4, "norm_partials_kernel")})
            plain4 = median_ms(torch, lambda: fu.norm_partials_plain(
                p, g, cm, am, cr, ar, q1, q2, s, algo=algo, bits_m=bits_m,
                bits_r=bits_r), 3, 1, 1)
            b, by = bound_ms(n * (8 + (bits_m + bits_r) / 8) + nb * 40,
                             n * 26)
            out[f"norm_partials/{variant}"] = dict(
                max_abs_err=err, ms=ms4, plain_ms=plain4, bound_ms=b,
                bound_by=by, library_ms=library, device_ms=split["kernel"],
                library_device_ms=split["library"],
                profiler_sessions=[split["sessions"]])
            print(f"kernel norm_partials {variant} ({nb}x{bsz}): exact, 0 "
                  f"mismatches; the 11 segments' trust ratios each on its "
                  f"own blocks; {ms4:.4f} ms, in turns with torch.linalg."
                  f"vector_norm of p and g over the same rows "
                  f"{library:.4f} ms ({ms4 / library:.3f}x its time); "
                  f"device time {split['kernel']:.4f} ms against "
                  f"{split['library']:.4f} ms "
                  f"({split['kernel'] / split['library']:.3f}x); bound "
                  f"{b:.4f} ms ({by}, {100 * b / ms4:.0f}% of it), plain "
                  f"{plain4:.3f} ms")
            del partials, want_p
        uniforms = (fu.block_uniforms(nb, bsz, two=True, block_seeds=seeds,
                                      block_offsets=offsets, device=dev)
                    if sr else (None, None))
        want = fu.fused_update_plain(p, g, cm, am, cr, ar, q1, q2, s,
                                     algo=algo, tensor_scale=ts,
                                     uniforms=uniforms, bits_m=bits_m,
                                     bits_r=bits_r)
        del uniforms
        # the arena launch, as the pooled dispatch makes it (lamb: B4 and
        # the 11 segment scales inside the wrapper)
        arena = [t.clone() for t in (p, cm, am, cr, ar)]
        fu.fused_update_cuda(arena[0], g, *arena[1:], q1, q2,
                             block_seeds=seeds, block_offsets=offsets,
                             segments=segs, **kw)
        n_bad, err = _mismatches(arena, want[:5])
        require(n_bad == 0, f"fused_update/{variant}: {n_bad} values (p, "
                f"codes, absmax) of the arena launch disagree with the "
                f"plain version (err {err})")
        del want
        # the 11 per-leaf launches on copies of the same rows (each leaf
        # its own tensors, as the per-leaf layout holds them: a row slice
        # of the arena's absmax need not be 16-byte aligned)
        leaf = [rows((p, cm, am, cr, ar, g), o, m) for o, m in segs]
        leaf = [[t.clone() for t in st_] for st_ in leaf]
        for st_, sd in zip(leaf, leaf_seed):
            fu.fused_update_cuda(st_[0], st_[5], *st_[1:5], q1, q2, seed=sd,
                                 **kw)
        n_leaf = sum(_mismatches(rows(arena, o, m), st_[:5])[0]
                     for (o, m), st_ in zip(segs, leaf))
        require(n_leaf == 0, f"fused_update/{variant}: {n_leaf} values of "
                f"the arena launch differ from the 11 per-leaf launches")
        # the kernel's time: raw launches of the C entry the wrapper calls
        if (bits_m, bits_r) == (8, 8):
            entry = "fused_update_grid"
            grid = lambda m: (lib_fu.fused_update_ctas(
                fu.KERNEL_ALGOS[algo], 0, m, bsz, sms),)
        else:
            entry = "fused_update_packed_grid"
            grid = lambda m: (bits_m, bits_r,
                              lib_fu.fused_update_packed_ctas(m, bsz, sms))
        launch = raw_update(torch, lib_fu, entry, algo, arena, g, q1, q2,
                            ts, sr=sr, tail=grid(nb), hyper=hyper,
                            seeds=seeds if sr else None,
                            offsets=offsets if sr else None)
        extra = {}
        if variant == "arena_adamw8":
            per_leaf = [raw_update(torch, lib_fu, entry, algo, st_[:5],
                                   st_[5], q1, q2, tail=grid(m),
                                   hyper=hyper)
                        for (_, m), st_ in zip(segs, leaf)]
            turns = in_turns(torch, {
                "arena": launch,
                "per_leaf": lambda: [f() for f in per_leaf]}, 20, 5)
            ms = turns["arena"]
            extra = dict(per_leaf_ms=turns["per_leaf"])
        else:
            ms = median_ms(torch, launch, 20)
        plain = median_ms(torch, lambda: fu.fused_update_plain(
            p, g, cm, am, cr, ar, q1, q2, s, algo=algo, tensor_scale=ts,
            uniforms=(fu.block_uniforms(nb, bsz, two=True,
                                        block_seeds=seeds,
                                        block_offsets=offsets, device=dev)
                      if sr else (None, None)),
            bits_m=bits_m, bits_r=bits_r), 3, 1, 1)
        # p read and written, g read, both states' codes read and written;
        # per block both absmax read and written, lamb's scale, the seed
        # and offset of a stochastic launch
        per_elem = 12 + 2 * (bits_m + bits_r) / 8
        per_block = 16 + (4 if ts is not None else 0) + (8 if sr else 0)
        b, by = bound_ms(n * per_elem + nb * per_block + 2048,
                         n * (56 + (40 if sr else 0)))
        out[f"fused_update/{variant}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
            library_ms=None, **extra)
        print(f"kernel fused_update {variant} ({nb}x{bsz}, 11 segments, "
              f"bits {bits_m}/{bits_r}{', stochastic' if sr else ''}): p, "
              f"codes and absmax exact against the plain version and "
              f"byte-identical to the 11 per-leaf launches, 0 mismatches; "
              f"{ms:.4f} ms ({grid(nb)[-1]} CTAs), bound {b:.4f} ms ({by}, "
              f"{100 * b / ms:.0f}% of it), plain {plain:.3f} ms"
              + (f"; in turns with the 11 per-leaf launches on the same "
                 f"rows: {ms:.4f} ms vs {extra['per_leaf_ms']:.4f} ms "
                 f"({ms / extra['per_leaf_ms']:.3f}x)" if extra else ""))
        del arena, leaf, cm, cr, ts, launch
        torch.cuda.empty_cache()
    out["fused_update/arena_sentinel_adamw8"] = check_arena_sentinel(
        torch, p, g, am, ar, codes(8), codes(8), qm(8), qm(8, False), segs,
        offsets, hyper)
    return out


def check_arena_sentinel(torch, p, g, am, ar, cm, cr, q1, q2, segs, offsets,
                         hyper) -> dict:
    """B3(e) at the arena, as the pooled launcher launches it (adamw8, the
    sentinel on, the layout's offsets and 11 segments), on clean inputs and
    on inputs with NaN / +-inf / 1e31 planted (``_poison``): p, codes and
    absmax equal the plain version's (NaN where it has NaN) and the health
    rows ``health_rows``', 0 mismatches; the rows and the summed health
    vector equal those of the 11 per-leaf sentinel launches on the same
    rows.  Timed by raw launches of the C entry in turns with the
    sentinel-off arena launch."""
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_update as fu

    nb, bsz = p.shape
    dev = p.device
    s = fu.scalars(device=dev, **hyper)
    kw = dict(hyper, algo="adamw", stochastic=False, bits_m=8, bits_r=8)
    rows = lambda ts, o, m: [None if t is None else t[o:o + m] for t in ts]
    sums = {}
    for tag in ("clean", "poisoned"):
        g_, am_, ar_ = (_poison(torch, g, am, ar) if tag == "poisoned"
                        else (g, am, ar))
        want = fu.fused_update_plain(p, g_, cm, am_, cr, ar_, q1, q2, s,
                                     algo="adamw", bits_m=8, bits_r=8,
                                     sentinel=True)
        arena = [t.clone() for t in (p, cm, am_, cr, ar_)]
        health = fu.fused_update_cuda(arena[0], g_, *arena[1:], q1, q2,
                                      sentinel=True, block_offsets=offsets,
                                      segments=segs, **kw).health
        n_plain = sum(_differ(a, b) for a, b in zip(arena, want[:5]))
        h_bad = int((health != want.health).sum())
        require(n_plain == 0 and h_bad == 0, f"fused_update/arena_sentinel "
                f"({tag}): {n_plain} values of p, codes or absmax and "
                f"{h_bad} health counts differ from the plain version's")
        del want
        leaf = [[t.clone() for t in rows((p, cm, am_, cr, ar_, g_), o, m)]
                for o, m in segs]
        h_leaf = torch.cat([fu.fused_update_cuda(
            st_[0], st_[5], *st_[1:5], q1, q2, sentinel=True, **kw).health
            for st_ in leaf])
        n_leaf = sum(_differ(a, b) for (o, m), st_ in zip(segs, leaf)
                     for a, b in zip(rows(arena, o, m), st_[:5]))
        h_leaf_bad = int((health != h_leaf).sum())
        total = health.sum(dim=0)
        require(n_leaf == 0 and h_leaf_bad == 0 and
                torch.equal(total, h_leaf.sum(dim=0)),
                f"fused_update/arena_sentinel ({tag}): {n_leaf} values and "
                f"{h_leaf_bad} health counts differ from the 11 per-leaf "
                f"sentinel launches'")
        sums[tag] = dict(zip(fu.HEALTH_SLOTS, (int(v) for v in total)))
        del arena, leaf, health, h_leaf
    require(all(v == 0 for k, v in sums["clean"].items()
                if not k.startswith("edge_hits")) and
            sums["poisoned"]["nonfinite_grad"] == 3,
            f"fused_update/arena_sentinel: counted {sums}")
    lib_fu, sms = fu._lib("fused_update"), build.sm_count(dev)
    st_on = [t.clone() for t in (p, cm, am, cr, ar)]
    st_off = [t.clone() for t in st_on]
    health = torch.empty(nb, fu.N_HEALTH, device=dev)
    tail = lambda sent: (lib_fu.fused_update_ctas(
        fu.KERNEL_ALGOS["adamw"], int(sent), nb, bsz, sms),)
    turns = in_turns(torch, {
        k: raw_update(torch, lib_fu, "fused_update_grid", "adamw", st_, g,
                      q1, q2, health=h_, tail=tail(h_ is not None),
                      hyper=hyper)
        for k, st_, h_ in (("off", st_off, None), ("on", st_on, health))},
        20, 5)
    ms, ms_off = turns["on"], turns["off"]
    plain = median_ms(torch, lambda: fu.fused_update_plain(
        p, g, cm, am, cr, ar, q1, q2, s, algo="adamw", bits_m=8, bits_r=8,
        sentinel=True), 3, 1, 1)
    b, by = _sentinel_bound(nb * bsz, nb, 8, 8, False, False)
    print(f"kernel fused_update arena_sentinel adamw8 ({nb}x{bsz}, "
          f"{len(segs)} segments, {tail(True)[0]} CTAs): p, codes, absmax "
          f"and health rows exact against the plain version and "
          f"health_rows, and equal to the {len(segs)} per-leaf sentinel "
          f"launches' "
          f"(rows and summed health), 0 mismatches, clean and poisoned; "
          f"poisoned counts {sums['poisoned']}; {ms:.4f} ms vs "
          f"sentinel-off {ms_off:.4f} ms in turns ({ms / ms_off:.3f}x), "
          f"bound {b:.4f} ms ({by}, {100 * b / ms:.0f}% of it), plain "
          f"{plain:.3f} ms")
    del st_on, st_off, health
    torch.cuda.empty_cache()
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None, off_ms=ms_off)


def check_partition_kernels(torch, dev, bsz: int = 2048) -> dict:
    """B3 as the partitioned dispatch launches it on paper-lm-209m's arena
    (ARENA_BLOCKS blocks, the optimizer's own layout): the 4 owned spans
    of ``make_partition(ARENA_BLOCKS, 4)`` and their 16 (span, bucket)
    pieces of ``make_buckets(.., 4)``, each launch on its rows of p, g and
    the codes (views) and its own absmax, seeds and offsets (copies, as
    the arena's pieces hold them), for adamw8 and stochastic adamw8: the
    rows concatenated must be byte-identical to the single arena launch.
    The deterministic launches are timed by raw launches of the C entry,
    the 4 span launches and the 16 piece launches in turns with the arena
    launch."""
    from repro_torch.core import qmap
    from repro_torch.core.optim import base
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_update as fu

    segs, offsets, leaf_seeds, _, _ = arena_layout(torch, dev)
    torch.cuda.empty_cache()
    nb = sum(m for _, m in segs)
    require(nb == ARENA_BLOCKS, f"partition: arena of {nb} blocks")
    part = base.make_partition(nb, 4)
    plan = base.make_buckets(part, 4)
    layouts = {
        "spans": [(o, m) for o, m in part.spans if m],
        "pieces": [(o + k0, min(m, k1) - k0) for o, m in part.spans
                   for k0, k1 in plan.ranges if min(m, k1) > k0]}
    require(len(layouts["spans"]) == 4 and len(layouts["pieces"]) == 16,
            f"partition: {layouts}")
    n = nb * bsz
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    q1 = torch.as_tensor(qmap.get_qmap("dynamic", True), device=dev)
    q2 = torch.as_tensor(qmap.get_qmap("dynamic", False), device=dev)
    p = torch.randn(nb, bsz, generator=gen, device=dev) * 0.02
    g = torch.randn(nb, bsz, generator=gen, device=dev) * 1e-3
    am = torch.rand(nb, generator=gen, device=dev) * 1e-3 + 1e-5
    ar = torch.rand(nb, generator=gen, device=dev) * 1e-6 + 1e-9
    cm = torch.randint(0, 256, (nb, bsz), generator=gen, device=dev,
                       dtype=torch.uint8)
    cr = torch.randint(0, 256, (nb, bsz), generator=gen, device=dev,
                       dtype=torch.uint8)
    seeds = torch.add(leaf_seeds, fu.to_i32(6 * 1000003))
    hyper = dict(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=WEIGHT_DECAY, step=7.0, gnorm_scale=1.0)
    lib_fu, sms = fu._lib("fused_update"), build.sm_count(dev)
    print(f"kernel partition: the arena's {nb} blocks in 4 spans "
          f"{layouts['spans']} (span_pad {part.span_pad}) and 16 pieces "
          f"(bucket ranges {plan.ranges})")
    out = {}
    for sr in (False, True):
        kw = dict(hyper, algo="adamw", stochastic=sr)
        arena = [t.clone() for t in (p, cm, am, cr, ar)]
        fu.fused_update_cuda(arena[0], g, *arena[1:], q1, q2,
                             block_seeds=seeds, block_offsets=offsets, **kw)
        for name, rows in layouts.items():
            st = [t.clone() for t in (p, cm, am, cr, ar)]
            own = [(st[0][o:o + m], st[1][o:o + m], st[2][o:o + m].clone(),
                    st[3][o:o + m], st[4][o:o + m].clone(), g[o:o + m],
                    seeds[o:o + m].clone(), offsets[o:o + m].clone())
                   for o, m in rows]
            for pp, c1, a1, c2, a2, gg, sd, of in own:
                fu.fused_update_cuda(pp, gg, c1, a1, c2, a2, q1, q2,
                                     block_seeds=sd, block_offsets=of, **kw)
            got = [st[0], st[1], torch.cat([x[2] for x in own]), st[3],
                   torch.cat([x[4] for x in own])]
            n_bad, _ = _mismatches(got, arena)
            require(n_bad == 0, f"partition {name}{' sr' if sr else ''}: "
                    f"{n_bad} values differ from the arena launch")
            if sr:
                continue
            grid = lambda m: (lib_fu.fused_update_ctas(
                fu.KERNEL_ALGOS["adamw"], 0, m, bsz, sms),)
            out[name] = [raw_update(torch, lib_fu, "fused_update_grid",
                                    "adamw", [x[0], x[1], x[2], x[3], x[4]],
                                    x[5], q1, q2, tail=grid(x[0].shape[0]),
                                    hyper=hyper) for x in own]
        if not sr:
            out["arena"] = [raw_update(torch, lib_fu, "fused_update_grid",
                                       "adamw", arena, g, q1, q2,
                                       tail=grid(nb), hyper=hyper)]
    turns = in_turns(torch, {k: (lambda fs=fs: [f() for f in fs])
                             for k, fs in out.items()}, 20, 5)
    per_elem, per_block = 12 + 2 * 2, 16
    b, by = bound_ms(n * per_elem + nb * per_block + 2048, n * 56)
    span_b = max(bound_ms(m * bsz * per_elem + m * per_block, m * bsz * 56)[0]
                 for _, m in layouts["spans"])
    print(f"kernel partition adamw8: the 4 span launches and the 16 piece "
          f"launches byte-identical to the arena launch (deterministic and "
          f"stochastic, 0 mismatches); in turns: arena {turns['arena']:.4f}"
          f" ms, 4 spans {turns['spans']:.4f} ms "
          f"({turns['spans'] / turns['arena']:.3f}x), 16 pieces "
          f"{turns['pieces']:.4f} ms "
          f"({turns['pieces'] / turns['arena']:.3f}x); bound of the arena "
          f"{b:.4f} ms ({by}), of the largest span {span_b:.4f} ms")
    del out
    torch.cuda.empty_cache()
    return dict(arena_ms=turns["arena"], span_ms=turns["spans"],
                piece_ms=turns["pieces"], span_bound_ms=span_b)


# ------------------------------------------------------------------ phase 4
def train(torch, dev, cfg, name: str, steps: int, batches, label=None,
          microbatches: int = 1, **opt_kw) -> dict:
    """``steps`` train steps of optimizer ``name`` (``opt_kw`` go to
    ``make_optimizer``, a ``mesh`` among them) from SEED's weights.  The
    result's ``trace`` holds each step's loss, grad norm and sent_* health
    counts (bits of the floats, for bitwise comparisons)."""
    from repro_torch.core.optim import make_optimizer
    from repro_torch.train import loop as L

    label = label or name
    gen = torch.Generator(device=dev).manual_seed(SEED)
    opt = make_optimizer(name, lr=LR, weight_decay=WEIGHT_DECAY, device=dev,
                         **opt_kw)
    state, model = L.init_train_state(cfg, opt, gen, device=dev)
    step = L.make_train_step(cfg, model, opt,
                             L.TrainHyper(microbatches=microbatches))
    losses, ms, metrics, trace = [], [], {}, []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i])
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        trace.append(torch.stack([metrics[k].float() for k in sorted(
            metrics) if k in ("loss", "grad_norm") or k.startswith("sent_")])
            .view(torch.int32).tolist())
        print(f"train {label} step {i}: loss {losses[-1]:.6f}  "
              f"{ms[-1]:.1f} ms  grad_norm {metrics['grad_norm'].item():.4f}")
    return dict(opt=opt, state=state, step=step, losses=losses, ms=ms,
                metrics=metrics, trace=trace)


def profile_step(torch, step, state, batch, each=()):
    """Device time by kernel over one step (torch.profiler), and the
    step's wall time under the profiler; with ``each`` (kernel name
    parts), also {part: [device ms of each launch]} of the kernels whose
    name contains the part, in launch order."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue                      # host-side ops and runtime calls
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t:
            rows.append((t / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    if not each:
        return rows, wall_ms
    launches = {part: [] for part in each}
    for ev in prof.events():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        t = getattr(ev, "device_time", None)
        t = t if t is not None else getattr(ev, "cuda_time", 0.0)
        for part in each:
            if part in ev.name:
                launches[part].append(t / 1e3)
    return rows, wall_ms, launches


def readback(torch, opt, state) -> int:
    """Read the trained 8-bit state back through the kernel layer: both
    moments dequantize to finite values, and the second moment requantizes
    to exactly its codes and absmax (it is non-negative, so each block's
    absmax element sits on the codebook's +1 level and survives the round
    trip; the signed map's most negative level is -0.993, so the first
    moment need not).  Returns the number of quantized leaves."""
    from repro_torch.core.optim import Quant8Leaf
    from repro_torch.kernels import ops
    n_quant = 0
    for path, leaf in state.opt_state.leaves.items():
        require(bool(torch.isfinite(leaf.master).all()),
                f"{path}: non-finite master")
        if not isinstance(leaf, Quant8Leaf):
            continue
        n_quant += 1
        m = ops.dequantize_blockwise(leaf.codes_m, leaf.absmax_m, opt._qmap1)
        r = ops.dequantize_blockwise(leaf.codes_r, leaf.absmax_r, opt._qmap2)
        require(bool(torch.isfinite(m).all() and torch.isfinite(r).all()),
                f"{path}: non-finite 8-bit state")
        c2, a2 = ops.quantize_blockwise(r, opt._qmap2)
        require(torch.equal(c2, leaf.codes_r) and
                torch.equal(a2, leaf.absmax_r),
                f"{path}: second moment does not round-trip "
                f"({int((c2 != leaf.codes_r).sum())} codes differ)")
    return n_quant


def _kernel_share(prof, names) -> dict:
    """{kernel name: (device ms, launches)} of the kernels whose profiler
    key contains one of ``names``."""
    ours = {}
    for t, count, key in prof:
        for k in names:
            if k in key:
                ms_, n_ = ours.get(k, (0.0, 0))
                ours[k] = (ms_ + t, n_ + count)
    return ours


def train_slice3(torch, dev, cfg, batches, losses32: dict,
                 run_launches: dict, step_launches: dict,
                 run_steps: dict) -> None:
    """The third slice's paths: packed states and Muon, each run with the
    launch counters zeroed just before it and read just after, against its
    32-bit twin (run here when the family phase did not)."""
    from repro_torch.core.lowbit import PackedCodes
    from repro_torch.core.optim import Full32Leaf, Quant8Leaf
    from repro_torch.kernels import ops

    def expected(opt, state) -> dict:
        """Launches per step of each kernel for this optimizer's leaves."""
        leaves = list(state.opt_state.leaves.values())
        muon = opt.cfg.algo == "muon"
        quant = [leaf for leaf in leaves if isinstance(leaf, Quant8Leaf)]
        matrix_q = [leaf for leaf in quant
                    if muon and leaf.codes_r is None]
        matrix_32 = [leaf for leaf in leaves if muon and
                     isinstance(leaf, Full32Leaf) and leaf.r is None]
        fused = len(quant) - len(matrix_q)
        return {"fused_update": fused,
                "norm_partials": fused if opt.cfg.algo in ("lamb", "lars")
                else 0,
                "blockwise_quant": len(matrix_q),
                "blockwise_dequant": len(matrix_q),
                "ns_gram": opt.cfg.ns_steps * (len(matrix_q)
                                               + len(matrix_32)) if muon
                else 0,
                "ns_apply": opt.cfg.ns_steps * (len(matrix_q)
                                                + len(matrix_32)) if muon
                else 0}

    def counted_run(name, label, **kw):
        ops.reset_launch_counts()
        run = train(torch, dev, cfg, name, FAMILY_STEPS, batches,
                    label=label, pooled=False, **kw)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = {k: v * FAMILY_STEPS
                for k, v in expected(run["opt"], run["state"]).items()}
        require(counts == want, f"{label}: launches {counts}, expected "
                f"{want} ({FAMILY_STEPS} steps)")
        require(all(math.isfinite(x) for x in run["losses"]),
                f"non-finite {label} loss")
        run_launches[label], step_launches[label] = counts, counts
        run_steps[label] = FAMILY_STEPS
        return run, counts

    for label, (name, kw, twin) in SLICE3_RUNS.items():
        if twin not in losses32:
            run, counts = counted_run(twin, twin)
            losses32[twin] = (run["losses"][-1],
                              statistics.median(run["ms"][1:]))
            print(f"train {twin}: launches {counts}; state_bytes_per_param "
                  f"{run['metrics']['state_bytes_per_param']:.4f}")
            del run
            torch.cuda.empty_cache()
        run, counts = counted_run(name, label, **kw)
        bits = kw.get("state_bits")
        if bits is not None:
            b_m, b_r = (bits, 8) if isinstance(bits, int) else bits
            quant = [leaf for leaf in run["state"].opt_state.leaves.values()
                     if isinstance(leaf, Quant8Leaf)]
            packed = lambda c, b: (isinstance(c, PackedCodes) and c.bits == b
                                   if b < 8 else isinstance(c, torch.Tensor))
            require(quant and all(packed(leaf.codes_m, b_m) for leaf in quant)
                    and all(packed(leaf.codes_r, b_r) for leaf in quant
                            if leaf.codes_r is not None),
                    f"{label}: codes are not packed at {b_m}/{b_r} bits")
        if label == "adam8_4_8":
            prof, wall = profile_step(torch, run["step"], run["state"],
                                      batches[FAMILY_STEPS])
            total = sum(t for t, _, _ in prof)
            ours = _kernel_share(prof, ("fused_update_packed_kernel",))
            print(f"profile adam8_4_8 step: {total:.2f} ms device time over "
                  f"{wall:.2f} ms wall (device idle "
                  f"{100 * (1 - total / wall):.1f}%); port kernels: "
                  + "; ".join(f"{k} {t:.3f} ms in {n} launches "
                              f"({100 * t / total:.1f}% of device time)"
                              for k, (t, n) in ours.items()))
        if label == "muon8":
            prof, wall, each = profile_step(torch, run["step"], run["state"],
                                            batches[FAMILY_STEPS],
                                            each=("::quantize_kernel",))
            b1 = sorted(each["::quantize_kernel"], reverse=True)
            print(f"profile muon8 step: B1 (quantize_kernel) per launch, "
                  f"largest first (the head's 25132 blocks, then the norm "
                  f"stacks' 5): " + ", ".join(f"{t:.4f}" for t in b1)
                  + f" ms; {sum(b1):.4f} ms in {len(b1)} launches")
            total = sum(t for t, _, _ in prof)
            ours = _kernel_share(prof, ("ns_gram_kernel",
                                        "ns_gram_reduce_kernel",
                                        "ns_apply_kernel",
                                        "fused_update_kernel",
                                        "::quantize_kernel",
                                        "::dequantize_kernel"))
            ns_ms = sum(t for k, (t, _) in ours.items() if "ns_" in k)
            print(f"profile muon8 step: {total:.2f} ms device time over "
                  f"{wall:.2f} ms wall (device idle "
                  f"{100 * (1 - total / wall):.1f}%); Newton–Schulz kernels "
                  f"{ns_ms:.3f} ms ({100 * ns_ms / total:.1f}% of device "
                  f"time); port kernels: "
                  + "; ".join(f"{k} {t:.3f} ms in {n} launches"
                              for k, (t, n) in ours.items()))
            for t, count, key in prof[:8]:
                print(f"profile   {t:9.3f} ms  x{count:<5d} {key[:90]}")
        l8, ms_8 = run["losses"][-1], statistics.median(run["ms"][1:])
        l32, ms_32 = losses32[twin]
        rel = abs(l8 - l32) / abs(l32)
        print(f"final loss after {FAMILY_STEPS} steps: {label} {l8:.6f}  "
              f"{twin} {l32:.6f} ({100 * rel:.3f}% apart); median step ms "
              f"{ms_8:.1f} vs {ms_32:.1f}; {label} launches {counts}; "
              f"state_bytes_per_param "
              f"{run['metrics']['state_bytes_per_param']:.4f}")
        if label in ORACLE_RUNS:
            losses = run["losses"]
            del run
            torch.cuda.empty_cache()
            ops.reset_launch_counts()
            oracle = train(torch, dev, cfg, name, FAMILY_STEPS, batches,
                           label=f"{label} (torch oracle)", impl="torch",
                           pooled=False, **kw)
            require(not any(ops.launch_counts().values()),
                    f"{label}: the torch-oracle run launched kernels "
                    f"{ops.launch_counts()}")
            worst = max(abs(a - b) / abs(b)
                        for a, b in zip(losses, oracle["losses"]))
            print(f"{label}: losses of the kernel path and the torch oracle "
                  f"path at most {worst:.3e} apart over {FAMILY_STEPS} steps "
                  f"(limit {ORACLE_RTOL:g})")
            require(worst <= ORACLE_RTOL, f"{label}: kernel and torch-oracle "
                    f"losses {worst:.3e} apart (limit {ORACLE_RTOL:g})")
            del oracle
        else:
            del run
        if label not in ORACLE_ONLY:
            require(rel < 0.01, f"{label} and {twin} final losses differ by "
                    f"{100 * rel:.2f}% (limit 1%)")
        torch.cuda.empty_cache()


def _host_arrays(state) -> list:
    """The arrays of a train state (its optimizer state in the per-leaf
    canonical layout) as (key, host copy or int) pairs, which
    :func:`_same_state` takes in place of a state."""
    from repro_torch.train import checkpoint as C
    raw = lambda t: getattr(t, "packed", t)       # PackedCodes' bytes
    return [(k, v if isinstance(v, int) else raw(v).cpu())
            for k, v in C._flatten(state)]


def _same_state(torch, a, b) -> int:
    """Arrays of two train states (their optimizer states in the per-leaf
    canonical layout; ``a`` may be :func:`_host_arrays`' list) that differ
    bitwise."""
    from repro_torch.train import checkpoint as C
    fa = a if isinstance(a, list) else C._flatten(a)
    fb = C._flatten(b)
    require([k for k, _ in fa] == [k for k, _ in fb],
            "the two states hold different arrays")
    raw = lambda t: getattr(t, "packed", t)       # PackedCodes' bytes
    return sum(not (x == y if isinstance(x, int)
                    else torch.equal(raw(x), raw(y).to(raw(x).device)))
               for (_, x), (_, y) in zip(fa, fb))


def _optimizer_device_ms(prof) -> dict:
    """{kind: (device ms, launches)} of one profiled step's optimizer
    work: the fused update, the clip's multiplies (in place, or into the
    arena's gradient views) and the copies."""
    kinds = {"fused_update": ("fused_update_kernel",
                              "fused_update_packed_kernel"),
             "multiply": ("MulFunctor", "mul_kernel"),
             "copy": ("copy_kernel", "CopyKernel", "direct_copy"),
             "fill": ("FillFunctor", "fill_kernel"),
             "add": ("AddFunctor", "CUDAFunctor_add", "add_kernel")}
    out = {k: (0.0, 0) for k in kinds}
    for t, count, key in prof:
        for k, marks in kinds.items():
            if any(mk in key for mk in marks):
                ms_, n_ = out[k]
                out[k] = (ms_ + t, n_ + count)
                break
    return out


def pooled_phase(torch, dev, cfg, batches, run_launches, step_launches,
                 run_steps) -> None:
    """The tenth slice's path: each POOLED_RUNS optimizer pooled (the
    default) and per-leaf (``pooled=False``) from the same weights and
    batches, each run with the launch counters zeroed just before it and
    read just after.  The pooled run must end bit-identical to the
    per-leaf one (params, codes, absmax, 32-bit moments, through the
    checkpoint's canonical layout), launch B3 once per step for the arena
    (and B4 once for lamb) where the per-leaf run launches it once per
    quantized leaf, and launch every other kernel (Muon's) as often.
    Printed: median step ms of both, and for adamw8 one profiled step of
    each (the fused update, the clip's multiplies, copies) and the
    gradient gather by copy in turns with the clip's multiply.  Then the
    face: adamw8 through ``BlockOptimizer`` and the plain PyTorch loop for
    STEPS steps, bit-identical to the pooled ``apply`` run."""
    from repro_torch.kernels import ops

    for label, (name, kw, steps) in POOLED_RUNS.items():
        runs, counts, peak = {}, {}, {}
        for layout in ("per_leaf", "pooled"):
            ops.reset_launch_counts()
            ops.reset_fused_update_count()
            torch.cuda.reset_peak_memory_stats()
            base_b = torch.cuda.memory_allocated()
            runs[layout] = train(torch, dev, cfg, name, steps, batches,
                                 label=f"{label} {layout}",
                                 pooled=layout == "pooled", **kw)
            torch.cuda.synchronize()
            counts[layout] = ops.launch_counts()
            peak[layout] = (torch.cuda.max_memory_allocated() - base_b) / 1e9
        po, pl = runs["pooled"], runs["per_leaf"]
        arena = po["state"].opt_state.arena
        require(arena is not None and pl["state"].opt_state.arena is None,
                f"pooled {label}: layouts")
        n_bad = _same_state(torch, po["state"], pl["state"])
        require(n_bad == 0, f"pooled {label}: {n_bad} arrays differ from "
                f"the per-leaf run after {steps} steps")
        norms = name.startswith(("lamb", "lars"))
        want = dict(counts["per_leaf"], fused_update=steps,
                    norm_partials=steps if norms else 0)
        require(counts["pooled"] == want, f"pooled {label}: launches "
                f"{counts['pooled']}, expected {want} (per-leaf "
                f"{counts['per_leaf']})")
        d_po = po["metrics"]["opt_fused_dispatches"]
        d_pl = pl["metrics"]["opt_fused_dispatches"]
        ms_po = statistics.median(po["ms"][1:])
        ms_pl = statistics.median(pl["ms"][1:])
        tag = f"pooled_{label}"
        run_launches[tag] = step_launches[tag] = counts["pooled"]
        run_steps[tag] = steps
        print(f"pooled {label}: {steps} steps bit-identical to the per-leaf "
              f"run (params, codes, absmax, 32-bit moments); arena "
              f"{arena.master.shape[0]} blocks in {len(arena.segments)} "
              f"segments; launches pooled {counts['pooled']} vs per-leaf "
              f"{counts['per_leaf']}; opt_fused_dispatches {d_po:.0f} vs "
              f"{d_pl:.0f} per step; median step of the runs {ms_po:.2f} ms "
              f"vs {ms_pl:.2f} ms ({ms_po / ms_pl:.3f}x; steps "
              f"1..{steps - 1}, per-leaf run first); peak device memory of "
              f"the run {peak['pooled']:.2f} GB vs {peak['per_leaf']:.2f} GB")
        if label == "adamw8":
            face_run(torch, dev, cfg, batches, po)
            grad_view_run(torch, dev, cfg, batches, po)
            gather_turns(torch, po["opt"], po["state"].opt_state)
        if label in ("adamw8", "adam8_4_8"):
            for layout, run in (("per_leaf", pl), ("pooled", po)):
                prof, wall = profile_step(torch, run["step"], run["state"],
                                          batches[steps])
                total = sum(t for t, _, _ in prof)
                parts = _optimizer_device_ms(prof)
                print(f"profile {label} {layout} step: {total:.2f} ms "
                      f"device time over {wall:.2f} ms wall (device idle "
                      f"{100 * (1 - total / wall):.1f}%); "
                      + "; ".join(f"{k} {t:.3f} ms in {c} launches"
                                  for k, (t, c) in parts.items()))
        for reading in (1, 2):
            step_turns(torch, f"{label} (reading {reading})", runs,
                       batches[steps])
        del runs, po, pl, arena
        torch.cuda.empty_cache()


def partition_phase(torch, dev, cfg, batches, run_launches, step_launches,
                    run_steps) -> dict:
    """The eleventh slice's unrolled span dispatch: each POOLED_RUNS
    optimizer, with the sentinel on, pooled and then partitioned
    (``partition=True`` at each of PARTITION_LAYOUTS, (shards, buckets),
    and PARTITION_EXTRA), from the same weights and batches, each run with
    the counters zeroed just before it and read just after.  Each
    partitioned run must end bit-identical to the pooled one (params,
    codes, absmax, 32-bit moments) with the same per-step loss, grad norm
    and health counts, launch B3 once per piece and step (and B4 as often
    for lamb) and every other kernel as often.  Printed: the median step
    of each run, and the steps in turns, read twice.  Returns {layout:
    B3 launches per step} of adamw8."""
    from repro_torch.kernels import ops

    per_step = {}
    for label, (name, kw, steps) in POOLED_RUNS.items():
        runs, counts = {}, {}
        layouts = PARTITION_LAYOUTS + PARTITION_EXTRA.get(label, ())
        for tag, more in [("pooled", {})] + [
                (f"{s}x{b}", dict(partition=True, partition_shards=s,
                                  overlap_buckets=b)) for s, b in layouts]:
            ops.reset_launch_counts()
            ops.reset_fused_update_count()
            runs[tag] = train(torch, dev, cfg, name, steps, batches,
                              label=f"{label} {tag}", sentinel=True,
                              **kw, **more)
            torch.cuda.synchronize()
            counts[tag] = ops.launch_counts()
        po = runs["pooled"]
        norms = name.startswith(("lamb", "lars"))
        for tag, run in runs.items():
            if tag == "pooled":
                continue
            arena = run["state"].opt_state.arena
            pieces = len(arena.pieces)
            n_bad = _same_state(torch, run["state"], po["state"])
            require(n_bad == 0, f"partition {label} {tag}: {n_bad} arrays "
                    f"differ from the pooled run after {steps} steps")
            require(run["trace"] == po["trace"], f"partition {label} {tag}: "
                    f"losses, grad norms or health counts differ from the "
                    f"pooled run's")
            want = dict(counts["pooled"], fused_update=steps * pieces,
                        norm_partials=steps * pieces if norms else 0)
            require(counts[tag] == want, f"partition {label} {tag}: "
                    f"launches {counts[tag]}, expected {want}")
            if label == "adamw8":
                per_step[tag] = pieces
            sb = run["opt"].state_bytes(run["state"].opt_state)
            print(f"partition {label} {tag}: {steps} steps bit-identical to "
                  f"the pooled run (params, codes, absmax, 32-bit moments; "
                  f"loss, grad norm and health counts every step); "
                  f"{pieces} pieces ({arena.partition.spans}); launches "
                  f"{counts[tag]} vs pooled {counts['pooled']}; "
                  f"owned_blocks {sb['owned_blocks']}, owned_state_bytes "
                  f"{sb['owned_state_bytes']} of {sb['state_bytes']}; "
                  f"median step {statistics.median(run['ms'][1:]):.2f} ms "
                  f"vs pooled {statistics.median(po['ms'][1:]):.2f} ms")
        tags = ["pooled", "4x1", "4x4"]
        for reading in (1, 2):
            step_turns(torch, f"partition {label} (reading {reading})",
                       {k: runs[k] for k in tags}, batches[steps])
        del runs, po
        torch.cuda.empty_cache()
    return per_step


def group_phase(torch, dev, cfg, batches) -> None:
    """The process-group path on the card: a world of one process on
    ``nccl`` (its group from a FileStore in a temporary directory, no
    network) and a ``DeviceMesh`` over it.  For GROUP_RUNS, 5 steps of
    two microbatches each: the pooled run without a group, then ZeRO-1
    (``partition=True``) and ZeRO-2 (``shard_grads=True`` too) on the
    group, whose gradients go through the reduce-scatter, the
    all-gathers and the all-reduce on CUDA tensors.  Each must end
    bit-identical to the pooled run with the same per-step losses and
    grad norms.  Printed: peak_grad_bytes and replicated_grad_bytes (the
    ZeRO-2 accounting), the peak device memory of each run, and beside
    them the measured peak of one more step of each run above the memory
    held before it (gradients, the ZeRO-2 buffers and packs, activations:
    the run's own transient)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as ML

    (ROOT / "build").mkdir(exist_ok=True)
    store = tempfile.mkdtemp(dir=ROOT / "build", prefix="chip_smoke_pg_")
    ML.init_process_group("nccl", store_path=str(Path(store) / "store"))
    try:
        mesh = ML.make_mesh((1,), ("data",), "cuda")
        for name in GROUP_RUNS:
            runs, peak = {}, {}
            for tag, more in (("pooled", {}),
                              ("zero1", dict(mesh=mesh, partition=True)),
                              ("zero2", dict(mesh=mesh, partition=True,
                                             shard_grads=True))):
                torch.cuda.reset_peak_memory_stats()
                base_b = torch.cuda.memory_allocated()
                runs[tag] = train(torch, dev, cfg, name, FAMILY_STEPS,
                                  batches, label=f"{name} {tag}",
                                  microbatches=2, **more)
                torch.cuda.synchronize()
                peak[tag] = (torch.cuda.max_memory_allocated() - base_b) / 1e9
            for tag in ("zero1", "zero2"):
                run = runs[tag]
                n_bad = _same_state(torch, run["state"],
                                    runs["pooled"]["state"])
                require(n_bad == 0, f"group {name} {tag}: {n_bad} arrays "
                        f"differ from the pooled run")
                require(run["trace"] == runs["pooled"]["trace"],
                        f"group {name} {tag}: losses or grad norms differ "
                        f"from the pooled run's")
                m = run["metrics"]
                extra = (f"; peak_grad_bytes {m['peak_grad_bytes']:.0f}, "
                         f"replicated_grad_bytes "
                         f"{m['replicated_grad_bytes']:.0f}"
                         if "peak_grad_bytes" in m else "")
                print(f"group {name} {tag} (nccl, world 1, 2 microbatches):"
                      f" {FAMILY_STEPS} steps bit-identical to the pooled run"
                      f" (state; losses and grad norms every step){extra}; "
                      f"peak device memory of the run {peak[tag]:.2f} GB vs "
                      f"pooled {peak['pooled']:.2f} GB; median step "
                      f"{statistics.median(run['ms'][1:]):.2f} ms vs "
                      f"{statistics.median(runs['pooled']['ms'][1:]):.2f} ms")
            step_peak = {}
            for tag, run in runs.items():
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                run["state"], m = run["step"](run["state"], batches[0])
                torch.cuda.synchronize()
                step_peak[tag] = torch.cuda.max_memory_allocated() - held
            m = runs["zero2"]["metrics"]
            print(f"group {name} measured step peak above the memory held "
                  f"before the step (one more step, 2 microbatches): "
                  f"pooled {step_peak['pooled'] / 1e9:.3f} GB, zero1 "
                  f"{step_peak['zero1'] / 1e9:.3f} GB, zero2 "
                  f"{step_peak['zero2'] / 1e9:.3f} GB; zero2's "
                  f"peak_grad_bytes {m['peak_grad_bytes'] / 1e9:.3f} GB "
                  f"(span + ride), replicated_grad_bytes "
                  f"{m['replicated_grad_bytes'] / 1e9:.3f} GB")
            del runs
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def step_turns(torch, label, runs, batch, reps: int = 8,
               ref: str = "pooled") -> None:
    """Step time of the per-leaf and the pooled run in turns (per-leaf,
    pooled, pooled, per-leaf, ...), each step on the host clock ending in
    a sync, on the same batch: the two layouts under the same conditions
    (their states, compared already, move on).  Other runs are reported
    against run ``ref``."""
    times = {k: [] for k in runs}
    for r in range(reps):
        for k in (list(runs) if r % 2 == 0 else list(reversed(runs))):
            run = runs[k]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run["state"], m = run["step"](run["state"], batch)
            m["loss"].item()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in times.items()}
    if "per_leaf" in runs:
        print(f"pooled {label} in turns ({reps} steps each): median step "
              f"{med['pooled']:.2f} ms vs per-leaf {med['per_leaf']:.2f} ms"
              f" ({med['pooled'] / med['per_leaf']:.3f}x); pooled "
              + ", ".join(f"{t:.1f}" for t in times["pooled"])
              + "; per-leaf "
              + ", ".join(f"{t:.1f}" for t in times["per_leaf"]))
        return
    print(f"{label} in turns ({reps} steps each): median step "
          + ", ".join(f"{k} {med[k]:.2f} ms ({med[k] / med[ref]:.3f}x)"
                      for k in runs) + "; "
          + "; ".join(f"{k} " + ", ".join(f"{t:.1f}" for t in v)
                      for k, v in times.items()))


def gather_turns(torch, opt, opt_state) -> None:
    """The gradient gather of the pooled step, by CUDA events in turns on
    the same gradients: the clip's multiply written into the arena's
    gradient views (what the train loop does), the in-place multiply of
    the per-leaf step, a copy of each leaf's gradient into its view (what
    ``apply`` does with gradients that are not the views), and the fill
    of the buffer and an add into each view (what autograd does for a
    ``.grad`` that is the view)."""
    views = opt.grad_views(opt_state)
    gen = torch.Generator(device=views[next(iter(views))].device)
    grads = {k: torch.randn(v.shape, generator=gen.manual_seed(SEED),
                            device=v.device) for k, v in views.items()}
    one = torch.ones((), device=next(iter(grads.values())).device)
    turns = in_turns(torch, {
        "mul_into_views": lambda: [torch.mul(grads[k], one, out=views[k])
                                   for k in views],
        "mul_in_place": lambda: [grads[k].mul_(one) for k in views],
        "copy_into_views": lambda: [views[k].copy_(grads[k])
                                    for k in views],
        "zero_then_add": lambda: [opt_state.arena.grad.zero_()] + [
            views[k].add_(grads[k]) for k in views]}, 20, 5)
    n = sum(v.numel() for v in views.values())
    b, _ = bound_ms(n * 8, 0)
    print(f"gather adamw8 pooled ({len(views)} leaves, {n / 1e6:.1f} M "
          f"elements): clip's multiply into the arena's gradient views "
          f"{turns['mul_into_views']:.4f} ms, in place (per-leaf step) "
          f"{turns['mul_in_place']:.4f} ms, copy into the views "
          f"{turns['copy_into_views']:.4f} ms; bound of each {b:.4f} ms "
          f"(bytes); the zeroed buffer and autograd's add into the views "
          f"(a .grad that is the view) {turns['zero_then_add']:.4f} ms "
          f"(bound {bound_ms(n * 16, 0)[0]:.4f} ms, the buffer's fill "
          f"included)")


def grad_view_run(torch, dev, cfg, batches, ref) -> dict:
    """The alternative to a gradient buffer beside autograd's gradients:
    adamw8 pooled from the weights of ``ref`` (the pooled ``apply`` run),
    for as many steps, with each pooled parameter's ``.grad`` set once to
    its view of the arena's gradient buffer, so that autograd accumulates
    into the buffer (``model.zero_grad(set_to_none=False)`` zeroes it in
    place), the clip in place, ``apply`` with nothing to copy.  Printed:
    whether it ends bit-identical to ``ref``, its median step and peak
    device memory (above what was allocated before it), and one profiled
    step (the step's
    device time, the fills, adds, multiplies and copies).  Returns
    {"profile": (rows, wall), "identical": bool}."""
    from repro_torch.core.optim import make_optimizer
    from repro_torch.models import model as M
    from repro_torch.train import loop as L

    steps = len(ref["losses"])
    torch.cuda.reset_peak_memory_stats()
    base_b = torch.cuda.memory_allocated()
    model = M.init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    params = model.param_dict()
    opt = make_optimizer("adamw8", lr=LR, weight_decay=WEIGHT_DECAY,
                         device=dev)
    state = L.TrainState(opt_state=opt.init(params), step=0)
    for path, view in opt.grad_views(state.opt_state).items():
        params[path].grad = view

    def step(state, batch):
        model.zero_grad(set_to_none=False)
        tokens = torch.as_tensor(batch["tokens"]).to(dev, torch.long)
        logits, _ = M.forward(cfg, model, tokens[:, :-1])
        loss = L.cross_entropy(logits, tokens[:, 1:])
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        L.clip_by_global_norm(grads, 1.0)
        _, new = opt.apply(grads, state.opt_state)
        return L.TrainState(opt_state=new, step=state.step + 1), loss

    ms = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batches[i])
        loss.item()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base_b) / 1e9
    views = opt.grad_views(state.opt_state)
    kept = all(params[k].grad.data_ptr() == v.data_ptr()
               for k, v in views.items())
    n_bad = _same_state(torch, state, ref["state"])
    prof = profile_step(torch, step, state, batches[steps])
    total = sum(t for t, _, _ in prof[0])
    print(f"grad views adamw8 pooled (.grad = the arena's gradient views, "
          f"zero_grad in place, clip in place): {steps} steps "
          + ("bit-identical to" if n_bad == 0 else f"{n_bad} arrays differ "
             f"from") + f" the pooled apply run; the views kept as .grad: "
          f"{kept}; median step {statistics.median(ms[1:]):.2f} ms; peak "
          f"device memory of the run {peak:.2f} GB; profiled step "
          f"{total:.2f} ms device time over {prof[1]:.2f} ms wall; "
          + "; ".join(f"{k} {t:.3f} ms in {c} launches" for k, (t, c)
                      in _optimizer_device_ms(prof[0]).items()))
    del opt, model, params, state, views
    torch.cuda.empty_cache()
    return {"profile": prof, "identical": n_bad == 0}


def face_run(torch, dev, cfg, batches, ref) -> None:
    """adamw8 through the ``torch.optim.Optimizer`` face and the plain loop
    (backward, the repo's global-norm clip, ``step``, ``zero_grad``) from
    the weights of ``ref`` (the pooled ``apply`` run), for as many steps:
    bit-identical to it, one B3 launch per step."""
    from repro_torch.core.optim import BlockOptimizer
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.train import loop as L

    steps = len(ref["losses"])
    model = M.init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    opt = BlockOptimizer(model.named_parameters(), "adamw8", lr=LR,
                         weight_decay=WEIGHT_DECAY, device=dev)
    ops.reset_launch_counts()
    ms = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = torch.as_tensor(batches[i]["tokens"]).to(dev, torch.long)
        logits, _ = M.forward(cfg, model, tokens[:, :-1])
        L.cross_entropy(logits, tokens[:, 1:]).backward()
        L.clip_by_global_norm({k: p.grad for k, p in
                               model.named_parameters()}, 1.0)
        opt.step()
        opt.zero_grad()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    require(counts["fused_update"] == steps, f"face: launches {counts}, "
            f"expected {steps} of fused_update")
    n_bad = _same_state(torch, opt.opt_state, ref["state"].opt_state)
    require(n_bad == 0, f"face: {n_bad} arrays differ from the pooled "
            f"apply run after {steps} steps")
    print(f"face adamw8 (BlockOptimizer, loss.backward(); clip; "
          f"opt.step(); opt.zero_grad()): {steps} steps bit-identical to "
          f"the pooled apply run; launches {counts}; median step "
          f"{statistics.median(ms[1:]):.2f} ms")
    del opt, model


# ------------------------------------------------------------------ phase 5
def checkpoint_roundtrip(torch, dev, cfg, batches, pooled: bool = False,
                         into=(False,), steps: int = 3) -> None:
    """lamb8 (``pooled`` or per-leaf) for ``steps`` steps, saved with the
    port's checkpoint and restored into a fresh state of each layout in
    ``into`` (True: pooled; another model, other weights); one more step
    from the saved and from each restored state must give bit-identical
    params, codes and absmax.  The checkpoint goes to a directory under
    build/ and is removed after."""
    from repro_torch.core.optim import make_optimizer
    from repro_torch.train import checkpoint as C
    from repro_torch.train import loop as L

    def fresh(seed, pooled_):
        opt = make_optimizer("lamb8", lr=LR, weight_decay=WEIGHT_DECAY,
                             pooled=pooled_, device=dev)
        state, model = L.init_train_state(
            cfg, opt, torch.Generator(device=dev).manual_seed(seed),
            device=dev)
        return state, L.make_train_step(cfg, model, opt)

    layout = lambda p: "pooled" if p else "per-leaf"
    state, step = fresh(SEED, pooled)
    for i in range(steps):
        state, _ = step(state, batches[i])
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(dir=ROOT / "build", prefix="chip_smoke_ckpt_")
    restored = []
    try:
        t0 = time.perf_counter()
        path = C.save(ckpt, steps, state)
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(path).iterdir())
        for k, p in enumerate(into):
            t0 = time.perf_counter()
            state_b, step_b = fresh(SEED + 1 + k, p)
            state_b = C.restore(ckpt, steps, state_b)
            require((state_b.opt_state.arena is not None) == p,
                    f"checkpoint: the {layout(p)} template came back "
                    f"{layout(not p)}")
            restored.append((p, state_b, step_b,
                             time.perf_counter() - t0))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    state, _ = step(state, batches[steps])
    for p, state_b, step_b, secs in restored:
        state_b, _ = step_b(state_b, batches[steps])
        torch.cuda.synchronize()
        n_bad = _same_state(torch, state, state_b)
        n_all = len(C._flatten(state))
        require(n_bad == 0, f"checkpoint: {n_bad} of {n_all} arrays differ "
                f"after step {steps + 1} between the {layout(pooled)} "
                f"lamb8 state and the {layout(p)} state restored from it")
        print(f"checkpoint lamb8 {layout(pooled)}: saved after {steps} "
              f"steps ({size / 1e9:.2f} GB, {save_s:.1f} s), restored into "
              f"a fresh {layout(p)} state in {secs:.1f} s; step "
              f"{steps + 1} from both bit-identical ({n_all} arrays: "
              f"params, codes, absmax, 32-bit moments, step counts)")
        del state_b, step_b


# ------------------------------------------------------------------ phase 6
def serve_requests(vocab_size):
    """The serve phase's stream, as ``repro_torch.launch.serve`` builds it:
    48 greedy requests, prompts cycling over 64/128/256/384 tokens,
    max_new uniform in [1, 128], from SEED."""
    import argparse
    from repro_torch.launch import serve as launcher
    args = argparse.Namespace(seed=SEED, prompt_lens=SERVE_PROMPT_LENS,
                              streams=SERVE_STREAMS, max_new=SERVE_MAX_NEW,
                              uniform_new=False)
    return launcher.build_requests(args, vocab_size)


def serve_run(torch, cfg, model, reqs, kv_bits, n_pages, impl):
    """One ``serve`` of the stream with B7's counter zeroed just before it
    and read just after.  Returns (engine, tokens, registry, launches,
    wall seconds)."""
    from repro_torch.kernels import paged_kv
    from repro_torch.serve.kvcache import PagedKVConfig
    from repro_torch.serve.scheduler import (ContinuousBatchingEngine,
                                             SchedulerConfig)
    from repro_torch.telemetry import MetricRegistry
    kv = PagedKVConfig(page_size=SERVE_PAGE, n_pages=n_pages,
                       n_slots=SERVE_SLOTS,
                       max_pages_per_seq=SERVE_PAGES_PER_SEQ, kv_bits=kv_bits)
    reg = MetricRegistry()
    eng = ContinuousBatchingEngine(cfg, model, SchedulerConfig(
        kv=kv, impl=impl), registry=reg)
    torch.cuda.synchronize()
    paged_kv.gather_cuda.launches = 0
    t0 = time.perf_counter()
    out = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_kv.gather_cuda.launches
    require(sorted(out) == [r.rid for r in reqs], f"kv{kv_bits} {impl}: "
            f"{len(out)} of {len(reqs)} requests returned")
    short = [r.rid for r in reqs if len(out[r.rid]) != r.max_new_tokens]
    require(not short, f"kv{kv_bits} {impl}: requests {short} did not return "
            f"exactly max_new_tokens tokens")
    eng.kv.check_invariants()
    require(eng.kv.n_active == 0 and eng.kv.alloc.n_free == n_pages,
            f"kv{kv_bits} {impl}: pages or slots left allocated")
    require(bool(torch.isfinite(eng.last_logits).all()),
            f"kv{kv_bits} {impl}: non-finite logits")
    return eng, out, reg, launches, wall


def profile_decode_step(torch, cfg, model, eng):
    """One paged decode step with all 16 slots active at position 500
    under torch.profiler: (B7's device ms, launches, total device ms, wall
    ms, top kernels), and the step's median time by CUDA events."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    dev = model.device
    table = torch.arange(SERVE_SLOTS * SERVE_PAGES_PER_SEQ, dtype=torch.int32,
                         device=dev).reshape(SERVE_SLOTS, -1) % SERVE_POOL
    pos = SERVE_PAGES_PER_SEQ * SERVE_PAGE - 12            # 500 of 512
    paged = L.PagedContext(table, torch.full((SERVE_SLOTS,), pos,
                                             dtype=torch.int32, device=dev))
    token = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int64, device=dev)
    step = lambda: M.paged_decode_step(cfg, model, token, eng.caches, paged)
    step_ms = median_ms(torch, step, 5, per=4)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t:
            rows.append((t / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    ours = _kernel_share(rows, ("paged_gather_kernel",))
    b7_ms, b7_n = ours.get("paged_gather_kernel", (0.0, 0))
    require(b7_n == 2 * cfg.n_layers, f"profiled decode step: paged_gather "
            f"ran {b7_n} times, expected {2 * cfg.n_layers}")
    return b7_ms, b7_n, sum(t for t, _, _ in rows), wall, rows, step_ms


def logit_drift(torch, cfg, model, prompt):
    """Teacher-forced on the bf16 contiguous-cache greedy trajectory
    (``prefill`` + ``decode_step``): the largest |logit difference| of the
    single-slot paged path at 8 and at 4 bits, and the logits' spread (the
    form of tests/test_serve_paged.py::test_paged4_logit_drift_bounded)."""
    import dataclasses
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    dev = model.device
    P, n_new = len(prompt), DRIFT_STEPS
    tokens = torch.tensor([prompt], dtype=torch.int64, device=dev)
    logits, cache = M.prefill(cfg, model, tokens, max_len=P + n_new)
    toks, rows = [int(logits[0, -1].argmax())], [logits[0, -1]]
    for i in range(n_new - 1):
        lg, cache = M.decode_step(cfg, model, torch.tensor(
            [[toks[-1]]], device=dev), cache, P + i)
        toks.append(int(lg[0, 0].argmax()))
        rows.append(lg[0, 0])
    oracle = torch.stack(rows)
    n_pages = -(-(P + n_new) // SERVE_PAGE)
    table = torch.arange(n_pages, dtype=torch.int32, device=dev)[None]
    cfg16 = dataclasses.replace(cfg, kv_cache_bits=16)
    drift = {}
    for bits in (8, 4):
        caches = M.init_paged_cache(cfg, 1, n_pages, SERVE_PAGE, bits,
                                    device=dev)
        lg, dense = M.prefill(cfg16, model, tokens, max_len=P)
        M.commit_prefill_to_paged(cfg, caches, dense, 0, table[0], P,
                                  kv_bits=bits)
        got = [lg[0, -1]]
        for i in range(n_new - 1):
            paged = L.PagedContext(table, torch.tensor(
                [P + i], dtype=torch.int32, device=dev))
            lg, caches = M.paged_decode_step(cfg, model, torch.tensor(
                [[toks[i]]], device=dev), caches, paged)
            got.append(lg[0, 0])
        drift[bits] = (torch.stack(got) - oracle).abs().max().item()
    spread = (oracle.max() - oracle.min()).item()
    require(all(math.isfinite(v) for v in drift.values()),
            f"non-finite logit drift {drift}")
    return drift, spread


def serve_phase(torch, dev, cfg, run_launches, step_launches,
                run_steps) -> None:
    import numpy as np
    from repro_torch.models import model as M
    from repro_torch.serve.kvcache import kv_bytes_per_token
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = M.init_model(cfg, gen, device=dev)
    reqs = serve_requests(cfg.vocab_size)
    n_tok = sum(r.max_new_tokens for r in reqs)
    print(f"serve: {cfg.arch_id} at full width, {len(reqs)} requests, "
          f"{sum(len(r.prompt) for r in reqs)} prompt tokens, {n_tok} to "
          f"generate; page {SERVE_PAGE}, {SERVE_SLOTS} slots, "
          f"{SERVE_PAGES_PER_SEQ} pages per sequence, {SERVE_POOL} pages")
    for bits in (8, 4):
        eng, out, reg, launches, wall = serve_run(torch, cfg, model, reqs,
                                                  bits, SERVE_POOL, "cuda")
        steps = eng.decode_steps
        want = 2 * cfg.n_layers * steps
        require(launches == want, f"kv{bits}: paged_gather launched "
                f"{launches} times, expected 2 x {cfg.n_layers} layers x "
                f"{steps} decode steps = {want}")
        label = f"serve_kv{bits}"
        run_launches[label] = step_launches[label] = {
            "paged_gather": launches}
        run_steps[label] = steps
        lat = eng.latency_percentiles()
        m = reg.metrics()
        print(f"serve kv{bits} cuda: {steps} decode steps, paged_gather "
              f"launches {launches} (= 2 x {cfg.n_layers} x {steps}); "
              f"{m['serve/generated_tokens']} tokens in {wall:.3f} s: "
              f"{m['serve/tokens_per_s']:.1f} tokens/s; latency p50 "
              f"{lat['p50_ms']:.1f} ms, p99 {lat['p99_ms']:.1f} ms; "
              f"KV {kv_bytes_per_token(cfg, bits):.0f} B/token (fp16 "
              f"{kv_bytes_per_token(cfg, 16):.0f}); admitted "
              f"{m['serve/sched/admitted']}, evictions "
              f"{m.get('serve/sched/evictions', 0)}")
        b7_ms, b7_n, total, pwall, prof, step_ms = profile_decode_step(
            torch, cfg, model, eng)
        print(f"profile serve kv{bits} decode step (16 slots at 500 tokens):"
              f" {step_ms:.3f} ms by CUDA events; under the profiler "
              f"{total:.3f} ms device time over {pwall:.3f} ms wall (device "
              f"idle {100 * (1 - total / pwall):.1f}%); paged_gather "
              f"{b7_ms:.3f} ms in {b7_n} launches, "
              f"{100 * b7_ms / total:.1f}% of device time; top:")
        for t, count, key in prof[:8]:
            print(f"profile   {t:9.3f} ms  x{count:<5d} {key[:90]}")
        last = eng.last_logits.clone()
        del eng
        torch.cuda.empty_cache()

        eng_t, out_t, _, launches_t, wall_t = serve_run(
            torch, cfg, model, reqs, bits, SERVE_POOL, "torch")
        require(launches_t == 0, f"kv{bits} torch: paged_gather launched "
                f"{launches_t} times")
        same = all(np.array_equal(out[r.rid], out_t[r.rid]) for r in reqs)
        require(same and eng_t.decode_steps == steps,
                f"kv{bits}: the plain gather gave other tokens")
        require(torch.equal(eng_t.last_logits, last), f"kv{bits}: last-step "
                f"logits of the kernel and plain paths differ (max "
                f"{(eng_t.last_logits - last).abs().max().item()})")
        print(f"serve kv{bits} torch: identical tokens ({n_tok}) and "
              f"bit-identical last-step logits; {wall_t:.3f} s")
        del eng_t
        torch.cuda.empty_cache()

        eng_s, out_s, reg_s, launches_s, wall_s = serve_run(
            torch, cfg, model, reqs, bits, SERVE_TIGHT_POOL, "cuda")
        ev = reg_s.metrics().get("serve/sched/evictions", 0)
        require(ev > 0, f"kv{bits} tight pool: no eviction")
        require(all(np.array_equal(out[r.rid], out_s[r.rid]) for r in reqs),
                f"kv{bits} tight pool: eviction changed tokens")
        print(f"serve kv{bits} tight pool ({SERVE_TIGHT_POOL} pages): "
              f"{ev} evictions, identical tokens; {eng_s.decode_steps} "
              f"decode steps, {launches_s} launches, {wall_s:.3f} s")
        del eng_s
        torch.cuda.empty_cache()

    prompt = [int(t) for t in np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, DRIFT_PROMPT)]
    drift, spread = logit_drift(torch, cfg, model, prompt)
    print(f"serve logit drift, teacher-forced over {DRIFT_STEPS} steps after "
          f"a {DRIFT_PROMPT}-token prompt, against the bf16 contiguous "
          f"decode_step: 8-bit {drift[8]:.5f}, 4-bit {drift[4]:.5f} "
          f"(spread {spread:.3f}; 4-bit {drift[4] / spread:.4f} x spread, "
          f"8-bit {drift[8] / max(drift[4], 1e-30):.3f} x the 4-bit drift)")


# ------------------------------------------------------------------ phase 9
def mixtral_cfg():
    """mixtral-8x22b at its published widths, MIXTRAL_LAYERS layers."""
    import dataclasses
    from repro_torch.configs import base
    return dataclasses.replace(base.get_config("mixtral-8x22b"),
                               n_layers=MIXTRAL_LAYERS)


def arena_blocks(torch, cfg, name: str = "adam8", **kw) -> int:
    """Blocks of the pooled arena ``make_optimizer(name, **kw)`` lays out
    for ``cfg`` (from the shapes of a model on the meta device)."""
    from repro_torch.core.optim import base as ob
    from repro_torch.core.optim import make_optimizer
    from repro_torch.models import model as M
    opt = make_optimizer(name, device="cpu", **kw)
    params = M.Model(cfg, device="meta").param_dict()
    return sum(ob.n_blocks_for(tuple(p.shape), 2048, 1)
               for path, p in params.items()
               if opt._leaf_is_quantized(path, p))


def raw_norms(torch, lib, kind: str, p, g, state, out, hyper,
              ctas: int) -> callable:
    """A launch of B4's C entry norm_partials_grid of ``lib`` (the f32 or
    the bf16 library: the element type of p) on 8-bit states, no wrapper
    in between."""
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_update as fu
    nb, bsz = p.shape
    ptr = lambda t: None if t is None else build.ptr(t)
    args = (fu.NORM_KINDS[kind], ptr(p), ptr(g), *map(ptr, state), ptr(out),
            nb, bsz, 8, 8, ctas,
            *fu._kernel_scalars(fu.scalars(device="cpu", lr=0.0, **hyper)),
            build.stream(p.device))
    keep = (p, g, state, out)

    def launch():
        build.check(lib, lib.norm_partials_grid(*args), "norm_partials_grid")
        return keep
    return launch


# the bf16 instances of B3 held to their plain versions at mixtral's expert
# leaf: variant -> (fused_update keywords, bits of the first state)
BF16_VARIANTS = {"adam8": ({}, 8),
                 "adam8_sr": (dict(stochastic=True, seed=SEED), 8),
                 "adam8_sentinel": (dict(sentinel=True), 8),
                 "adam8_4_8": ({}, 4)}


def check_bf16_kernels(torch, dev, bsz: int = 2048) -> dict:
    """The bf16 instances of B3 and B4 (bf16 p, f32 g, random) at
    mixtral's expert leaf (EXPERT_BLOCKS blocks) against their plain
    versions (exact: p, codes, absmax, health, partials): B3's 8-bit
    kernel deterministic, stochastic and with the sentinel, its packed
    kernel at (4, 8) (BF16_VARIANTS), and B4 for lamb.  Then adam8's and
    B4's timed by raw launches of their C entries in turns with the f32
    instances on the same values (p in f32), at the expert leaf and over
    mixtral's arena (the blocks of its quantized leaves); the plain
    versions' time and, for B4, the library's two vector norms in f32.
    Byte bounds: bf16 B3 reads p (2 B), g (4 B) and both states' codes and
    writes p and the codes, 12 B/element (16 for f32 p), plus 16 B of
    absmax per block; B4 reads p, g and both codes, 8 B/element (10 for
    f32 p), plus 40 B per block."""
    from repro_torch.core import qmap
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_update as fu
    sms = build.sm_count(dev)
    lib16, lib32 = fu._lib("fused_update_bf16"), fu._lib("fused_update")
    libn16, libn32 = fu._lib("norm_partials_bf16"), fu._lib("norm_partials")
    hyper = dict(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=WEIGHT_DECAY, step=7.0, gnorm_scale=1.0)
    norm_hyper = {k: v for k, v in hyper.items() if k != "lr"}
    qm = lambda bits, signed: torch.as_tensor(
        qmap.get_qmap("dynamic", signed, bits=bits), device=dev)
    q1, q2 = qm(8, True), qm(8, False)
    n_arena = arena_blocks(torch, mixtral_cfg(), master_dtype="bfloat16")
    rows = {"fused_update/bf16_adam8": {}, "norm_partials/bf16_lamb8": {}}
    for where, nb in (("expert", EXPERT_BLOCKS), ("arena", n_arena)):
        n = nb * bsz
        gen = torch.Generator(device=dev).manual_seed(SEED + 9)
        p = torch.empty(nb, bsz, dtype=torch.bfloat16, device=dev) \
            .normal_(generator=gen).mul_(0.02)
        g = torch.empty(nb, bsz, device=dev).normal_(generator=gen) \
            .mul_(1e-3)
        code = lambda w: torch.randint(0, 256, (nb, w), generator=gen,
                                       device=dev, dtype=torch.uint8)
        cm, cr = code(bsz), code(bsz)
        am = torch.rand(nb, generator=gen, device=dev) * 1e-3 + 1e-5
        ar = torch.rand(nb, generator=gen, device=dev) * 1e-6 + 1e-9
        st16 = [p, cm, am, cr, ar]
        b3, b4 = (rows["fused_update/bf16_adam8"],
                  rows["norm_partials/bf16_lamb8"])
        if where == "expert":
            # exact against the plain versions (fused_update_cuda and
            # fused_update_chunked, each on copies)
            err = 0.0
            for variant, (kw, bits_m) in BF16_VARIANTS.items():
                st = st16 if bits_m == 8 else \
                    [p, code(bsz * bits_m // 8), am, cr, ar]
                qs = (q1 if bits_m == 8 else qm(bits_m, True), q2)
                got = [t.clone() for t in st]
                res = fu.fused_update_cuda(got[0], g, *got[1:], *qs,
                                           algo="adam", bits_m=bits_m,
                                           **kw, **hyper)
                want = [t.clone() for t in st]
                ref = fu.fused_update_chunked(want[0], g, *want[1:], *qs,
                                              algo="adam", bits_m=bits_m,
                                              **kw, **hyper)
                n_bad, e = _mismatches(got + [res.health],
                                       want + [ref.health])
                require(n_bad == 0, f"fused_update/bf16_{variant}: {n_bad} "
                        f"values (p, codes, absmax, health) disagree with "
                        f"the plain version")
                err = max(err, e)
                print(f"kernel fused_update bf16_{variant} at mixtral's "
                      f"expert ({nb}x{bsz}, bits {bits_m}/8): p, codes, "
                      f"absmax{' and health rows' if res.health is not None else ''} "
                      f"exact against the plain version, 0 mismatches")
                del got, want, res, ref
            kw = dict(norm_hyper, algo="lamb")
            part = fu.norm_partials_cuda(p, g, cm, am, cr, ar, q1, q2, **kw)
            part_p = fu.norm_partials_chunked(p, g, cm, am, cr, ar, q1, q2,
                                              **kw)
            n_bad4, err4 = _mismatches([part], [part_p])
            require(n_bad4 == 0, f"norm_partials/bf16_lamb8: {n_bad4} "
                    f"partials disagree with the plain version")
            del part, part_p
            work = [t.clone() for t in st16]
            b3["plain_ms"] = median_ms(torch, lambda: fu.fused_update_chunked(
                work[0], g, *work[1:], q1, q2, algo="adam", **hyper), 3, 1, 1)
            b4["plain_ms"] = median_ms(torch, lambda: fu.norm_partials_chunked(
                p, g, cm, am, cr, ar, q1, q2, **kw), 3, 1, 1)
            del work
            b3["max_abs_err"], b4["max_abs_err"] = err, err4
        p32 = p.float()
        st32 = [p32, cm.clone(), am.clone(), cr.clone(), ar.clone()]
        ctas = lib16.fused_update_ctas(fu.KERNEL_ALGOS["adam"], 0, nb, bsz,
                                       sms)
        t3 = in_turns(torch, {
            "bf16": raw_update(torch, lib16, "fused_update_grid", "adam",
                               st16, g, q1, q2, tail=(ctas,), hyper=hyper),
            "f32": raw_update(torch, lib32, "fused_update_grid", "adam",
                              st32, g, q1, q2, tail=(ctas,),
                              hyper=hyper)}, 10, 3)
        out = torch.empty(nb, fu.N_PARTIALS, device=dev)
        state = (cm, am, cr, ar, q1, q2)
        nctas = libn16.norm_partials_ctas(fu.NORM_KINDS["lamb"], nb, bsz,
                                          sms)
        t4 = in_turns(torch, {
            "bf16": raw_norms(torch, libn16, "lamb", p, g, state, out,
                              norm_hyper, nctas),
            "f32": raw_norms(torch, libn32, "lamb", p32, g, state, out,
                             norm_hyper, nctas),
            "library": lambda: (
                torch.linalg.vector_norm(p, dim=1, dtype=torch.float32),
                torch.linalg.vector_norm(g, dim=1))},
            10, 3)
        bb3 = bound_ms(n * 12 + nb * 16, n * 56)
        bf3 = bound_ms(n * 16 + nb * 16, n * 56)
        bb4 = bound_ms(n * 8 + nb * 40, n * 26)
        bf4 = bound_ms(n * 10 + nb * 40, n * 26)
        tag = "" if where == "expert" else "arena_"
        b3.update({f"{tag}ms": t3["bf16"], f"{tag}f32_ms": t3["f32"],
                   f"{tag}bound_ms": bb3[0], f"{tag}f32_bound_ms": bf3[0]})
        b4.update({f"{tag}ms": t4["bf16"], f"{tag}f32_ms": t4["f32"],
                   f"{tag}library_ms": t4["library"],
                   f"{tag}bound_ms": bb4[0], f"{tag}f32_bound_ms": bf4[0]})
        if where == "expert":
            b3.update(bound_by=bb3[1], library_ms=None)
            b4.update(bound_by=bb4[1])
        print(f"kernel fused_update bf16_adam8 at mixtral's {where} "
              f"({nb}x{bsz}{', exact against the plain version' if where == 'expert' else ''}): "
              f"{t3['bf16']:.4f} ms ({ctas} CTAs), in turns with the f32 "
              f"instance {t3['f32']:.4f} ms ({t3['bf16'] / t3['f32']:.3f}x); "
              f"bound {bb3[0]:.4f} ms ({bb3[1]}, {100 * bb3[0] / t3['bf16']:.0f}"
              f"% of it; f32 {bf3[0]:.4f} ms, "
              f"{100 * bf3[0] / t3['f32']:.0f}%)"
              + (f", plain {b3['plain_ms']:.3f} ms" if where == "expert"
                 else ""))
        print(f"kernel norm_partials bf16_lamb8 at mixtral's {where} "
              f"({nb}x{bsz}{', exact' if where == 'expert' else ''}): "
              f"{t4['bf16']:.4f} ms, f32 instance {t4['f32']:.4f} ms, "
              f"vector_norm of p and g (f32) {t4['library']:.4f} ms; bound "
              f"{bb4[0]:.4f} ms ({bb4[1]}, {100 * bb4[0] / t4['bf16']:.0f}% "
              f"of it; f32 {bf4[0]:.4f} ms, {100 * bf4[0] / t4['f32']:.0f}%)"
              + (f", plain {b4['plain_ms']:.3f} ms" if where == "expert"
                 else ""))
        del p, g, cm, cr, am, ar, st16, st32, p32, out, state
        torch.cuda.empty_cache()
    return rows


def arch_train(torch, dev, cfg, name: str, steps: int, batches, label: str,
               **opt_kw) -> dict:
    """``steps`` train steps of ``name`` on ``cfg`` from SEED's weights;
    the trace holds each step's metrics as bits (bitwise comparisons).
    The model's gradients are dropped after the last step."""
    from repro_torch.core.optim import make_optimizer
    from repro_torch.train import loop as L
    gen = torch.Generator(device=dev).manual_seed(SEED)
    opt = make_optimizer(name, device=dev, **opt_kw)
    state, model = L.init_train_state(cfg, opt, gen, device=dev)
    step = L.make_train_step(cfg, model, opt)
    ms, trace, losses = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        loss = m["loss"].item()
        losses.append(loss)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        trace.append(torch.stack([m[k].float().reshape(()) for k in sorted(m)
                                  if torch.is_tensor(m[k])])
                     .view(torch.int32).tolist())
        moe = "".join(f"  {k} {m[k].item():.5f}" for k in sorted(m)
                      if k.startswith("moe_"))
        print(f"train {label} step {i}: loss {loss:.6f}  {ms[-1]:.1f} ms  "
              f"grad_norm {m['grad_norm'].item():.4f}{moe}")
        require(math.isfinite(loss), f"{label}: non-finite loss")
    model.zero_grad(set_to_none=True)
    return dict(opt=opt, state=state, model=model, ms=ms, trace=trace,
                metrics=m, losses=losses)


def arch_pair(torch, dev, cfg, name, batches, label, steps=ARCH_STEPS,
              on_host=False, **opt_kw) -> tuple:
    """``name`` through the kernels and through their plain versions
    (``impl="plain"``) from the same weights and batches, ``steps`` steps
    each, with the launch counters zeroed just before it and read just
    after: every state array and every step's metrics must be
    bit-identical, the plain run must launch nothing.  ``on_host``: the
    kernel run's state is copied to host memory and freed on the card
    before the plain run (for a model whose two states do not fit the
    card together).  Returns (the kernel run's launches, its median step
    ms, the plain run's, its peak device memory in GB, its final loss)."""
    from repro_torch.kernels import ops
    runs, counts, peak = {}, {}, {}
    for impl in ("cuda", "plain"):
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        base_b = torch.cuda.memory_allocated()
        runs[impl] = arch_train(torch, dev, cfg, name, steps, batches,
                                f"{label} {impl}", impl=impl, **opt_kw)
        torch.cuda.synchronize()
        counts[impl] = ops.launch_counts()
        peak[impl] = (torch.cuda.max_memory_allocated() - base_b) / 1e9
        if impl == "cuda":
            runs[impl]["model"] = None    # the state still holds its masters
            if on_host:
                runs[impl]["state"] = _host_arrays(runs[impl]["state"])
                torch.cuda.empty_cache()
    n_bad = _same_state(torch, runs["cuda"]["state"], runs["plain"]["state"])
    require(n_bad == 0, f"{label}: {n_bad} state arrays of the kernel run "
            f"differ from the plain versions' run after {steps} steps")
    require(runs["cuda"]["trace"] == runs["plain"]["trace"],
            f"{label}: per-step metrics differ between the kernel and the "
            f"plain run")
    require(not any(counts["plain"].values()), f"{label}: the plain run "
            f"launched {counts['plain']}")
    ms = [statistics.median(runs[k]["ms"][1:]) for k in ("cuda", "plain")]
    return (counts["cuda"], ms[0], ms[1], peak["cuda"],
            runs["cuda"]["metrics"]["loss"].item())


def arch_serve(torch, cfg, model, reqs, n_slots, pages_per_seq, impl):
    """One ``serve`` of ``reqs`` through the paged engine at kv 8 with B7's
    counter zeroed just before it and read just after: (tokens, decode
    steps, launches, last-step logits, wall s)."""
    from repro_torch.kernels import paged_kv
    from repro_torch.serve.kvcache import PagedKVConfig
    from repro_torch.serve.scheduler import (ContinuousBatchingEngine,
                                             SchedulerConfig)
    kv = PagedKVConfig(page_size=ARCH_SERVE_PAGE,
                       n_pages=n_slots * pages_per_seq, n_slots=n_slots,
                       max_pages_per_seq=pages_per_seq, kv_bits=8)
    eng = ContinuousBatchingEngine(cfg, model, SchedulerConfig(
        kv=kv, impl=impl))
    torch.cuda.synchronize()
    paged_kv.gather_cuda.launches = 0
    t0 = time.perf_counter()
    out = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(all(len(out[r.rid]) == r.max_new_tokens for r in reqs),
            f"{cfg.arch_id} serve {impl}: a request came back short")
    eng.kv.check_invariants()
    require(bool(torch.isfinite(eng.last_logits).all()),
            f"{cfg.arch_id} serve {impl}: non-finite logits")
    return (out, eng.decode_steps, paged_kv.gather_cuda.launches,
            eng.last_logits.clone(), wall)


def arch_serve_pair(torch, dev, cfg, reqs, n_slots, pages_per_seq,
                    run_launches, step_launches, run_steps, label) -> None:
    """The paged engine through B7 and through its plain gather on the
    same weights (SEED) and requests: identical tokens and bit-identical
    last-step logits; B7 launched 2 x attn layers per decode step.
    Returns the model and the B7 run's tokens."""
    import numpy as np
    from repro_torch.models import model as M
    model = M.init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    torch.cuda.reset_peak_memory_stats()
    got = {impl: arch_serve(torch, cfg, model, reqs, n_slots, pages_per_seq,
                            impl) for impl in ("cuda", "torch")}
    peak = torch.cuda.max_memory_allocated() / 1e9
    (out, steps, launches, last, wall), ref = got["cuda"], got["torch"]
    n_attn = sum(cfg.block_pattern[i % len(cfg.block_pattern)] == "attn"
                 for i in range(cfg.n_layers))
    require(launches == 2 * n_attn * steps, f"{label}: B7 launched "
            f"{launches} times in {steps} decode steps, expected 2 x "
            f"{n_attn} attn layers per step")
    require(ref[2] == 0, f"{label}: the plain gather launched B7")
    require(all(np.array_equal(out[r.rid], ref[0][r.rid]) for r in reqs)
            and torch.equal(last, ref[3]), f"{label}: the kernel and the "
            f"plain gather gave other tokens or last-step logits")
    run_launches[label] = step_launches[label] = {"paged_gather": launches}
    run_steps[label] = steps
    n_tok = sum(r.max_new_tokens for r in reqs)
    print(f"serve {label}: {len(reqs)} requests (prompts "
          f"{[len(r.prompt) for r in reqs]}), {n_tok} tokens in {steps} "
          f"decode steps, {wall:.3f} s ({n_tok / wall:.1f} tokens/s); B7 "
          f"{launches} launches, {launches / steps:.0f} per decode step "
          f"(2 x {n_attn} attn layers); tokens identical and last-step "
          f"logits bit-identical to the plain gather ({ref[4]:.3f} s); "
          f"peak device memory {peak:.2f} GB")
    del got
    torch.cuda.empty_cache()
    return model, out


def arch_phase(torch, dev, run_launches, step_launches, run_steps) -> None:
    """stablelm-1.6b at its published widths and depth: adamw8 (pooled)
    ARCH_STEPS steps through the kernels and through their plain versions
    (bit-identical), adamw32 beside it, and greedy requests through the
    paged engine at kv 8; mixtral-8x22b at its published widths,
    MIXTRAL_LAYERS layer(s), bf16 params and bf16 masters: adam8 and
    lamb8 (the bf16 B3 and B4) the same way, and one request whose prompt
    and new tokens cross the 4096-token window (the ring and the paged
    window mask)."""
    import numpy as np
    from repro_torch.configs import base
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.serve.scheduler import Request
    t_phase = time.perf_counter()
    for arch in ("stablelm-1.6b", "mixtral-8x22b"):
        t_arch = time.perf_counter()
        bf16 = arch == "mixtral-8x22b"
        cfg = mixtral_cfg() if bf16 else base.get_config(arch)
        pipe = SyntheticLMPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                              seq_len=SEQ_LEN,
                                              global_batch=BATCH, seed=SEED))
        batches = [pipe.batch_at(i) for i in range(ARCH_STEPS)]
        print(f"arch {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads (kv {cfg.n_kv_heads}), d_ff "
              f"{cfg.moe_dff or cfg.d_ff}"
              + (f", {cfg.n_experts} experts top-{cfg.top_k}, window "
                 f"{cfg.window}" if bf16 else "")
              + f", vocab {cfg.vocab_size}; {cfg.param_count() / 1e9:.3f} B "
              f"parameters, {cfg.param_dtype} params, "
              f"{'bf16' if bf16 else 'f32'} masters; seq {SEQ_LEN} x batch "
              f"{BATCH}")
        names = MIXTRAL_RUNS if bf16 else ("adamw8",)
        for name in names:
            kw = dict(master_dtype="bfloat16", **MIXTRAL_OPT) if bf16 else \
                dict(lr=LR, weight_decay=WEIGHT_DECAY)
            label = f"{arch.split('-')[0]}_{name}"
            counts, ms_k, ms_p, peak, _ = arch_pair(torch, dev, cfg, name,
                                                    batches, label, **kw)
            norms = name.startswith("lamb")
            require(counts["fused_update"] == ARCH_STEPS and
                    counts["norm_partials"] == (ARCH_STEPS if norms else 0),
                    f"{label}: launches {counts}, expected B3 once per step "
                    f"(the arena){' and B4 once' if norms else ''}")
            run_launches[label] = step_launches[label] = counts
            run_steps[label] = ARCH_STEPS
            print(f"arch {label}: {ARCH_STEPS} steps, every state array and "
                  f"step metric bit-identical to the plain versions' run; "
                  f"launches {counts}; median step {ms_k:.1f} ms (plain "
                  f"versions {ms_p:.1f} ms); peak device memory "
                  f"{peak:.2f} GB")
            torch.cuda.empty_cache()
        if not bf16:
            torch.cuda.reset_peak_memory_stats()
            run32 = arch_train(torch, dev, cfg, "adamw32", ARCH_STEPS,
                               batches, f"{label.split('_')[0]} adamw32",
                               lr=LR, weight_decay=WEIGHT_DECAY)
            print(f"arch stablelm adamw32: median step "
                  f"{statistics.median(run32['ms'][1:]):.1f} ms; peak device "
                  f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            del run32
            torch.cuda.empty_cache()
            rng = np.random.RandomState(SEED)
            reqs = [Request(rid=i, prompt=tuple(rng.randint(
                0, cfg.vocab_size, P).tolist()), max_new_tokens=STABLELM_NEW)
                for i, P in enumerate(STABLELM_PROMPTS)]
            per_seq = -(-(max(STABLELM_PROMPTS) + STABLELM_NEW)
                        // ARCH_SERVE_PAGE)
            arch_serve_pair(torch, dev, cfg, reqs, ARCH_SERVE_SLOTS, per_seq,
                            run_launches, step_launches, run_steps,
                            "stablelm_serve_kv8")
        else:
            total = MIXTRAL_PROMPT + MIXTRAL_NEW
            # the prefill's ring keeps the prompt's last `window` rows, the
            # paged decode masks the rows that fall out of the window
            require(MIXTRAL_PROMPT > cfg.window, "mixtral serve: the prompt "
                    "must be longer than the window")
            reqs = [Request(rid=0, prompt=tuple(np.random.RandomState(
                SEED).randint(0, cfg.vocab_size, MIXTRAL_PROMPT).tolist()),
                max_new_tokens=MIXTRAL_NEW)]
            arch_serve_pair(torch, dev, cfg, reqs, 1,
                            -(-total // ARCH_SERVE_PAGE), run_launches,
                            step_launches, run_steps, "mixtral_serve_kv8")
        print(f"arch {arch}: {time.perf_counter() - t_arch:.1f} s")
    print(f"arch phase: {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------- phase 10
def recurrentgemma_cfg():
    """recurrentgemma-9b at its published widths, RG_LAYERS layers."""
    import dataclasses
    from repro_torch.configs import base
    return dataclasses.replace(base.get_config("recurrentgemma-9b"),
                               n_layers=RG_LAYERS)


def contiguous_greedy(torch, cfg, model, reqs) -> dict:
    """The greedy tokens of ``reqs`` (equal max_new) through the contiguous
    cache: each prompt prefilled alone (batch 1, as the paged engine
    prefills), the caches stacked on the batch axis, then ``decode_step``
    over all of them at once (as the engine's decode step runs every
    slot).  For a model without attn layers, whose cache holds no
    position."""
    from repro_torch.models import model as M
    n_new = reqs[0].max_new_tokens
    require(all(r.max_new_tokens == n_new for r in reqs) and not any(
        k == "attn" for k in cfg.block_pattern), "contiguous_greedy: equal "
        "max_new and no attn layer")
    dev = model.device
    firsts, caches = [], []
    for r in reqs:
        logits, cache = M.prefill(cfg, model, torch.tensor(
            [list(r.prompt)], device=dev), len(r.prompt))
        firsts.append(logits[0, -1].argmax())
        caches.append(cache)
    # every leaf's batch axis follows the scanned part's layer axis
    cat = lambda ts, stacked: torch.cat(ts, dim=1 if stacked else 0)
    cache = {"scan": {name: tuple(cat([c["scan"][name][j] for c in caches],
                                      True)
                                  for j in range(len(layer)))
                      if isinstance(layer, tuple) else
                      {k: cat([c["scan"][name][k] for c in caches], True)
                       for k in layer}
                      for name, layer in caches[0]["scan"].items()},
             "rem": [tuple(cat([c["rem"][i][j] for c in caches], False)
                           for j in range(len(layer)))
                     if isinstance(layer, tuple) else
                     {k: cat([c["rem"][i][k] for c in caches], False)
                      for k in layer}
                     for i, layer in enumerate(caches[0]["rem"])]}
    tok = torch.stack(firsts)
    out = [tok]
    for i in range(n_new - 1):
        logits, cache = M.decode_step(cfg, model, tok[:, None], cache, i)
        tok = logits[:, 0].argmax(dim=-1)
        out.append(tok)
    toks = torch.stack(out, dim=1).cpu().numpy().astype("int32")
    return {r.rid: toks[i] for i, r in enumerate(reqs)}


def busy_step(torch, step, state, batch) -> tuple:
    """One step under the profiler, device activity only (a recurrent
    step's ~10^6 launches make the host-side events too many to process):
    (device ms by kernel name as (ms, launches, name) largest first, the
    step's wall ms under the profiler).  The raw kineto events are read,
    not the profiler's processed tables."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        if "CUDA" not in str(ev.device_type()):
            continue
        ms_, n_ = by_name.get(ev.name(), (0.0, 0))
        by_name[ev.name()] = (ms_ + ev.duration_ns() / 1e6, n_ + 1)
    rows = sorted(((t, n, k) for k, (t, n) in by_name.items()),
                  reverse=True)
    return rows, wall_ms


def profiled_recurrent_step(torch, run, batch, label) -> None:
    """One more step of a run under the profiler: device time against the
    step's wall time and the device's launches, the starting trace of the
    scans (``run`` is an :func:`arch_train` result with its model)."""
    from repro_torch.train import loop as L
    step = L.make_train_step(run["model"].cfg, run["model"], run["opt"])
    t0 = time.perf_counter()
    prof, wall = busy_step(torch, step, run["state"], batch)
    total = sum(t for t, _, _ in prof)
    n = sum(count for _, count, _ in prof)
    print(f"profile {label} step: {total:.2f} ms device time over "
          f"{wall:.2f} ms wall under the profiler (device busy "
          f"{100 * total / wall:.1f}%), {n} device activities (kernels, "
          f"copies) in {len(prof)} names ({time.perf_counter() - t0:.1f} s "
          f"with the profiler's processing); top:")
    for t, count, key in prof[:10]:
        print(f"profile   {t:9.3f} ms  x{count:<7d} {key[:90]}")
    run["model"].zero_grad(set_to_none=True)


def recurrent_train(torch, dev, cfg, batches, label, run_launches,
                    step_launches, run_steps, on_host=False,
                    profile=False, peak_limit=None) -> None:
    """adamw8 (pooled) through the kernels and their plain versions,
    bit-identical with B3 once a step (``on_host``: see
    :func:`arch_pair`); adamw32 beside it, its final loss within 1%; with
    ``profile``, one more adamw8 step under the profiler.  Peak memory of
    each, the kernel run's below ``peak_limit`` bytes where given."""
    counts, ms_k, ms_p, peak, loss8 = arch_pair(
        torch, dev, cfg, "adamw8", batches, f"{label}_adamw8",
        steps=RECURRENT_STEPS, on_host=on_host, lr=LR,
        weight_decay=WEIGHT_DECAY)
    require(counts["fused_update"] == RECURRENT_STEPS and
            counts["norm_partials"] == 0, f"{label}_adamw8: launches "
            f"{counts}, expected B3 once per step (the arena)")
    run_launches[f"{label}_adamw8"] = step_launches[f"{label}_adamw8"] = \
        counts
    run_steps[f"{label}_adamw8"] = RECURRENT_STEPS
    print(f"recurrent {label}_adamw8: {RECURRENT_STEPS} steps, every state "
          f"array and step metric bit-identical to the plain versions' run; "
          f"launches {counts}; median step {ms_k:.1f} ms (plain versions "
          f"{ms_p:.1f} ms); peak device memory {peak:.2f} GB")
    require(peak_limit is None or peak * 1e9 < peak_limit,
            f"{label}_adamw8: peak {peak:.2f} GB")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_b = torch.cuda.memory_allocated()
    run = arch_train(torch, dev, cfg, "adamw32", RECURRENT_STEPS, batches,
                     f"{label} adamw32", lr=LR, weight_decay=WEIGHT_DECAY)
    loss32 = run["metrics"]["loss"].item()
    rel = abs(loss8 - loss32) / abs(loss32)
    print(f"recurrent {label} adamw32: median step "
          f"{statistics.median(run['ms'][1:]):.1f} ms; peak device memory "
          f"{(torch.cuda.max_memory_allocated() - base_b) / 1e9:.2f} GB; "
          f"final loss adamw8 {loss8:.6f} adamw32 {loss32:.6f} "
          f"({100 * rel:.3f}% apart)")
    require(rel < 0.01, f"{label}: adamw8 and adamw32 final losses differ "
            f"by {100 * rel:.2f}% (limit 1%)")
    del run
    torch.cuda.empty_cache()
    if profile:
        run = arch_train(torch, dev, cfg, "adamw8", 1, batches,
                         f"{label} adamw8 (profiled)", lr=LR,
                         weight_decay=WEIGHT_DECAY)
        profiled_recurrent_step(torch, run, batches[1], f"{label}_adamw8")
        del run
        torch.cuda.empty_cache()


def muon_bf16_run(torch, dev, run_launches, step_launches,
                  run_steps) -> None:
    """muon8 on bf16 masters at mixtral-8x22b's MIXTRAL_LAYERS-layer cut
    (bf16 params), MUON_BF16_STEPS steps through the kernels (B3 per
    quantized element-wise leaf, B2 -> B5/B6 -> B1 per quantized matrix
    leaf) and through impl="torch" from the same weights and batches, per
    leaf (the torch oracle over the pooled arena of 2.4 B expert elements
    would hold several f32 copies of it): losses within ORACLE_RTOL; B5
    and B6 ns_steps times per matrix leaf and step; the quantized matrix
    leaves' masters bf16."""
    from repro_torch.core.optim import Full32Leaf, Quant8Leaf
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import ops
    cfg = mixtral_cfg()
    pipe = SyntheticLMPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ_LEN, global_batch=BATCH,
                                          seed=SEED))
    batches = [pipe.batch_at(i) for i in range(MUON_BF16_STEPS)]
    losses = {}
    for impl in ("cuda", "torch"):
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        run = arch_train(torch, dev, cfg, "muon8", MUON_BF16_STEPS, batches,
                         f"mixtral muon8 bf16 masters {impl}", impl=impl,
                         master_dtype="bfloat16", pooled=False,
                         **MIXTRAL_OPT)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        leaves = list(run["state"].opt_state.leaves.values())
        quant = [leaf for leaf in leaves if isinstance(leaf, Quant8Leaf)]
        matrix_q = [leaf for leaf in quant if leaf.codes_r is None]
        matrix_32 = [leaf for leaf in leaves if isinstance(leaf, Full32Leaf)
                     and leaf.r is None]
        losses[impl] = run["losses"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        require(matrix_q and all(leaf.master.dtype == torch.bfloat16
                                 for leaf in matrix_q),
                "muon8 bf16: the quantized matrix leaves' masters are not "
                "bf16")
        if impl == "cuda":
            ns = run["opt"].cfg.ns_steps * (len(matrix_q) + len(matrix_32))
            want = {"fused_update": MUON_BF16_STEPS * (len(quant)
                                                       - len(matrix_q)),
                    "blockwise_quant": MUON_BF16_STEPS * len(matrix_q),
                    "blockwise_dequant": MUON_BF16_STEPS * len(matrix_q),
                    "ns_gram": MUON_BF16_STEPS * ns,
                    "ns_apply": MUON_BF16_STEPS * ns}
            require(all(counts[k] == v for k, v in want.items()),
                    f"muon8 bf16: launches {counts}, expected {want}")
            run_launches["mixtral_muon8_bf16"] = counts
            step_launches["mixtral_muon8_bf16"] = counts
            run_steps["mixtral_muon8_bf16"] = MUON_BF16_STEPS
        else:
            require(not any(counts.values()), f"muon8 bf16: the torch run "
                    f"launched {counts}")
        print(f"muon8 bf16 {impl}: {len(matrix_q)} quantized matrix leaves "
              f"(bf16 masters) and {len(matrix_32)} f32-momentum ones; "
              f"launches {counts}; median step "
              f"{statistics.median(run['ms'][1:]):.1f} ms; peak device "
              f"memory {peak:.2f} GB")
        del run
        torch.cuda.empty_cache()
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["torch"]))
    print(f"muon8 bf16: losses {losses['cuda']} (kernels) and "
          f"{losses['torch']} (torch) at most {worst:.3e} apart (limit "
          f"{ORACLE_RTOL:g})")
    require(worst <= ORACLE_RTOL, f"muon8 bf16: kernel and torch losses "
            f"{worst:.3e} apart (limit {ORACLE_RTOL:g})")


def xlstm_long_serve(torch, cfg, model, rng) -> None:
    """One request of XLSTM_LONG_PROMPT tokens through the paged engine
    (no B7 launch: no attn layer) and through the contiguous cache: the
    same XLSTM_LONG_NEW tokens; prints each one's wall and the peak."""
    import numpy as np
    from repro_torch.serve.scheduler import Request
    req = [Request(rid=0, prompt=tuple(rng.randint(
        0, cfg.vocab_size, XLSTM_LONG_PROMPT).tolist()),
        max_new_tokens=XLSTM_LONG_NEW)]
    torch.cuda.reset_peak_memory_stats()
    out, _, launches, _, wall = arch_serve(
        torch, cfg, model, req, 1,
        -(-(XLSTM_LONG_PROMPT + XLSTM_LONG_NEW) // ARCH_SERVE_PAGE), "cuda")
    require(launches == 0, f"xlstm long serve: B7 launched {launches} "
            f"times without an attn layer")
    t0 = time.perf_counter()
    ref = contiguous_greedy(torch, cfg, model, req)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    require(np.array_equal(out[0], ref[0]), "xlstm long serve: the paged "
            "engine's tokens differ from the contiguous cache's")
    print(f"serve xlstm long: a {XLSTM_LONG_PROMPT}-token prompt, "
          f"{XLSTM_LONG_NEW} new tokens equal to the contiguous cache's; "
          f"paged engine {wall:.3f} s, contiguous {wall_c:.3f} s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def recurrent_phase(torch, dev, run_launches, step_launches, run_steps,
                    profile=False) -> None:
    """xlstm-350m (24 layers, published widths) and recurrentgemma-9b
    (published widths, RG_LAYERS layers): trained (recurrent_train) and
    served through the paged engine at kv 8, 4 greedy requests each;
    xlstm's tokens equal the contiguous cache's (contiguous_greedy) with
    no B7 launch, recurrentgemma's B7 and plain-gather runs identical with
    2 B7 launches a decode step (one attn layer), a prompt past the
    2048-token window; then muon8 on bf16 masters (muon_bf16_run).
    ``profile``: a profiled adamw8 step of each architecture (~3 minutes
    for xlstm's ~10^6 launches; ``--phase recurrent`` runs them, the whole
    run does not)."""
    import numpy as np
    from repro_torch.configs import base
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.serve.scheduler import Request
    t_phase = time.perf_counter()
    for arch in ("xlstm-350m", "recurrentgemma-9b"):
        t_arch = time.perf_counter()
        rg = arch == "recurrentgemma-9b"
        cfg = recurrentgemma_cfg() if rg else base.get_config(arch)
        label = arch.split("-")[0]
        batch = RG_BATCH if rg else BATCH
        pipe = SyntheticLMPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                              seq_len=SEQ_LEN,
                                              global_batch=batch, seed=SEED))
        batches = [pipe.batch_at(i) for i in range(RECURRENT_STEPS)]
        print(f"recurrent {arch}: {cfg.n_layers} layers "
              f"({cfg.n_superblocks} x {'/'.join(cfg.block_pattern)}"
              f"{f' + {cfg.n_remainder_layers} remainder' if rg else ''}), "
              f"d_model {cfg.d_model}, {cfg.n_heads} heads (kv "
              f"{cfg.n_kv_heads}, head_dim {cfg.head_dim}), "
              + (f"lru_width {cfg.lru_width}, d_ff {cfg.d_ff}, window "
                 f"{cfg.window}, " if rg else "")
              + f"vocab {cfg.vocab_size}; {cfg.param_count() / 1e9:.3f} B "
              f"{cfg.param_dtype} parameters, f32 masters; seq {SEQ_LEN} x "
              f"batch {batch}")
        recurrent_train(torch, dev, cfg, batches, label, run_launches,
                        step_launches, run_steps, on_host=rg,
                        profile=profile,
                        peak_limit=RG_PEAK_LIMIT if rg else None)
        prompts = RG_PROMPTS if rg else XLSTM_PROMPTS
        rng = np.random.RandomState(SEED)
        reqs = [Request(rid=i, prompt=tuple(rng.randint(
            0, cfg.vocab_size, P).tolist()), max_new_tokens=RECURRENT_NEW)
            for i, P in enumerate(prompts)]
        if rg:
            require(max(prompts) > cfg.window, "recurrentgemma serve: a "
                    "prompt must be longer than the window")
        per_seq = -(-(max(prompts) + RECURRENT_NEW) // ARCH_SERVE_PAGE)
        model, out = arch_serve_pair(
            torch, dev, cfg, reqs, ARCH_SERVE_SLOTS, per_seq, run_launches,
            step_launches, run_steps, f"{label}_serve_kv8")
        if not rg:
            ref = contiguous_greedy(torch, cfg, model, reqs)
            require(all(np.array_equal(out[r.rid], ref[r.rid])
                        for r in reqs), f"{label} serve: the paged engine's "
                    f"tokens differ from the contiguous cache's")
            print(f"serve {label}: the paged engine's tokens equal the "
                  f"contiguous prefill + decode_step tokens")
            xlstm_long_serve(torch, cfg, model, rng)
        del model
        torch.cuda.empty_cache()
        print(f"recurrent {arch}: {time.perf_counter() - t_arch:.1f} s")
    t0 = time.perf_counter()
    muon_bf16_run(torch, dev, run_launches, step_launches, run_steps)
    print(f"recurrent muon8 bf16: {time.perf_counter() - t0:.1f} s")
    print(f"recurrent phase: {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------------ phase 7
def _metric_values(events) -> dict:
    """{(step, name): value} of a run's "metric" events."""
    return {(e["step"], e["name"]): e["value"] for e in events
            if e["kind"] == "metric"}


def _phase_walls(events, phase) -> list:
    return [e["wall_s"] for e in events
            if e["kind"] == "phase" and e["phase"] == phase]


def telemetry_phase(torch, dev, cfg, batches, n_quant, run_launches,
                    step_launches, run_steps) -> None:
    """The fifth slice's path: the train launcher with the observability
    stack, ``repro_torch.launch.train.main`` at full-width paper-lm-209m
    (its own overrides: f32 compute), adamw8, TEL_STEPS steps, qhealth
    probes every TEL_EVERY steps, the flight recorder; with the sentinel
    (kernel B3(e) on every quantized leaf of every step), then without it
    (ms/step on and off), then at lr 1e18 (exit 2, a dump that restores and
    replays the trigger step).  Then 5 sentinel steps of each other
    SENTINEL_RUNS optimizer (the launches of their JSON rows).  Everything
    is written under build/ and removed after."""
    import io
    from repro_torch import telemetry as tel
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    from repro_torch.telemetry import inspect as insp
    from repro_torch.train import loop as L

    (ROOT / "build").mkdir(exist_ok=True)
    base = Path(tempfile.mkdtemp(dir=ROOT / "build",
                                 prefix="chip_smoke_telemetry_"))
    common = ["--arch", "paper-lm-209m", "--seq-len", str(SEQ_LEN),
              "--batch", str(BATCH), "--optimizer", "adamw8", "--steps",
              str(TEL_STEPS), "--telemetry-every", str(TEL_EVERY),
              "--device", "cuda"]

    def launch(tag, *extra):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rc = launcher.main([*common, "--telemetry-dir", str(base / tag),
                            "--flight-dir", str(base / f"{tag}_flight"),
                            *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.launch_counts(),
                      fused_update_sentinel=fu.fused_update_cuda
                      .sentinel_launches)
        events, errors = tel.validate_jsonl(
            str(base / tag / "telemetry.jsonl"))
        require(errors == [], f"telemetry {tag}: the port's validator "
                f"rejects its JSONL: {errors[:3]}")
        torch.cuda.empty_cache()
        return rc, counts, events, wall

    def inspect(*argv):
        buf = io.StringIO()
        code = insp.main(list(argv), out=buf)
        for line in buf.getvalue().splitlines()[:40]:
            print(f"inspect   {line}")
        return code

    try:
        rc, counts, events, wall = launch("sentinel_on", "--sentinel")
        require(rc == 0, f"telemetry: the launcher exited {rc}")
        # the launcher runs the default, pooled dispatch: one B3(e) launch
        # per step for the arena of the n_quant quantized leaves
        want = TEL_STEPS
        require(counts["fused_update"] == want and
                counts["fused_update_sentinel"] == want,
                f"telemetry: fused_update launched {counts['fused_update']} "
                f"times ({counts['fused_update_sentinel']} with the "
                f"sentinel), expected {TEL_STEPS} steps x 1 arena = {want}, "
                f"all through B3(e)")
        probes = TEL_STEPS // TEL_EVERY
        require(counts["blockwise_quant"] == probes * n_quant and
                counts["blockwise_dequant"] == probes * n_quant,
                f"telemetry: probe round trips launched {counts}, expected "
                f"{probes} probes x {n_quant} arena segments of B1 and B2")
        m = _metric_values(events)
        for i in range(TEL_STEPS):
            for slot in fu.HEALTH_SLOTS:
                v = m.get((i, f"train/sent_{slot}"))
                require(v is not None, f"telemetry: no sent_{slot} at {i}")
                if not slot.startswith("edge_hits"):
                    require(v == 0, f"telemetry: step {i}: sent_{slot} = {v}"
                            f" on a healthy run")
            require(m[(i, "train/sent_edge_hits_m")] > 0,
                    f"telemetry: step {i}: no edge hit counted")
        q = [e for e in events if e["kind"] == "qhealth"]
        require({e["target"] for e in q} == {"arena"}, f"telemetry: qhealth "
                f"targets {sorted({e['target'] for e in q})}, expected the "
                f"arena's segments only")
        by_step = {}
        for e in q:
            by_step.setdefault(e["step"], set()).add((e["segment"],
                                                      e["slot"]))
        want_steps = list(range(TEL_EVERY - 1, TEL_STEPS, TEL_EVERY))
        got_q = [(k_, len(v)) for k_, v in sorted(by_step.items())]
        require(sorted(by_step) == want_steps and
                all(len(v) == 2 * n_quant for v in by_step.values()),
                f"telemetry: qhealth events (step, count) {got_q}, expected "
                f"{2 * n_quant} at steps {want_steps}")
        code = inspect(str(base / "sentinel_on"))
        require(code == insp.EXIT_CLEAN, f"telemetry: the inspector scores "
                f"the healthy sentinel run {code}, not clean")
        ms_on = m[(TEL_STEPS - 1, "train/steady_ms")]
        compile_on = m[(TEL_STEPS - 1, "train/compile_s")]
        probe_s = _phase_walls(events, "qhealth_probe")
        snap_s = _phase_walls(events, "flight_snapshot")
        edge = [m[(i, "train/sent_edge_hits_m")] for i in range(TEL_STEPS)]
        rms = [e["rms_error"] for e in q if "rms_error" in e]
        sat = [e["edge_code_fraction"] for e in q]
        run_launches["telemetry_adamw8"] = step_launches[
            "telemetry_adamw8"] = counts
        run_steps["telemetry_adamw8"] = TEL_STEPS
        print(f"telemetry adamw8 --sentinel: exit 0, {len(events)} events "
              f"(valid), launches {counts}; sent_* nonfinite/overflow 0 on "
              f"every step, sent_edge_hits_m {edge}; {len(q)} qhealth "
              f"events at steps {want_steps}, edge_code_fraction "
              f"{min(sat):.2e}..{max(sat):.2e}, rms_error "
              f"{min(rms):.4f}..{max(rms):.4f}; inspector: clean; "
              f"{ms_on:.1f} ms/step (steps 1..{TEL_STEPS - 1}), first step "
              f"{compile_on:.2f} s; qhealth probe "
              + ", ".join(f"{t:.3f}" for t in probe_s) + " s; flight "
              f"snapshot {statistics.median(snap_s):.3f} s (median of "
              f"{len(snap_s)}); run {wall:.1f} s")

        rc, counts_off, events_off, wall_off = launch("sentinel_off")
        require(rc == 0, f"telemetry (sentinel off): exited {rc}")
        require(counts_off["fused_update"] == want and
                counts_off["fused_update_sentinel"] == 0,
                f"telemetry (sentinel off): launches {counts_off}")
        m_off = _metric_values(events_off)
        ms_off = m_off[(TEL_STEPS - 1, "train/steady_ms")]
        print(f"telemetry adamw8 without --sentinel: exit 0, "
              f"{ms_off:.1f} ms/step; sentinel on/off {ms_on:.1f} / "
              f"{ms_off:.1f} ms/step = {ms_on / ms_off:.3f}x; run "
              f"{wall_off:.1f} s")

        rc, counts_d, events_d, _ = launch("diverge", "--sentinel", "--lr",
                                           "1e18")
        require(rc == 2, f"telemetry (lr 1e18): exited {rc}, expected 2")
        dump = base / "diverge_flight"
        manifest = tel.load_dump(str(dump))
        k = manifest["trigger_step"]
        require(manifest["snapshot_step"] == k - 1,
                f"telemetry (lr 1e18): snapshot step "
                f"{manifest['snapshot_step']}, trigger step {k}")
        dump_bytes = sum(f.stat().st_size for f in dump.rglob("*")
                         if f.is_file())
        args = launcher.build_parser().parse_args(
            [*common, "--sentinel", "--lr", "1e18"])
        cfg_d, pipe, opt, hyper = launcher.setup(args, dev)
        state, model = L.init_train_state(
            cfg_d, opt, torch.Generator(device=dev).manual_seed(SEED + 11),
            device=dev)
        t0 = time.perf_counter()
        snap, state = tel.restore_state(str(dump), state)
        restore_s = time.perf_counter() - t0
        require(snap == k - 1, f"telemetry (lr 1e18): restored step {snap}")
        _, mr = L.make_train_step(cfg_d, model, opt, hyper)(
            state, pipe.batch_at(k))
        replay = float(mr["loss"])
        recorded = [r for r in manifest["ring"] if r["step"] == k][0]["loss"]
        require(replay == recorded or not (math.isfinite(replay) or
                                           math.isfinite(recorded)),
                f"telemetry (lr 1e18): replayed loss {replay}, recorded "
                f"{recorded}")
        code = inspect("--flight", str(dump))
        require(code == insp.EXIT_ANOMALIES, f"telemetry (lr 1e18): the "
                f"inspector scores the dump {code}, not 1")
        reasons = sorted({a["reason"] for a in manifest["anomalies"]})
        print(f"telemetry adamw8 --lr 1e18: exit 2 at step {k} ({reasons}),"
              f" dump of the step-{k - 1} state {dump_bytes / 1e9:.3f} GB, "
              f"restored into a fresh state in {restore_s:.1f} s; replayed "
              f"step {k}: loss {replay} (recorded {recorded}); inspector "
              f"--flight: 1")
        del state, model, opt, mr
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(base, ignore_errors=True)

    for variant, (name, kw) in SENTINEL_RUNS.items():
        ops.reset_launch_counts()
        run = train(torch, dev, cfg, name, FAMILY_STEPS, batches,
                    label=f"{variant} --sentinel", sentinel=True,
                    pooled=False, **kw)
        torch.cuda.synchronize()
        counts = dict(ops.launch_counts(), fused_update_sentinel=fu
                      .fused_update_cuda.sentinel_launches)
        want = FAMILY_STEPS * n_quant
        require(counts["fused_update_sentinel"] == want,
                f"{variant} --sentinel: launches {counts}, expected {want} "
                f"through B3(e)")
        health = {k_: float(v) for k_, v in run["metrics"].items()
                  if k_.startswith("sent_")}
        require(all(v == 0 for k_, v in health.items()
                    if "edge_hits" not in k_),
                f"{variant} --sentinel: health {health} on a healthy run")
        label = f"sentinel_{variant}"
        run_launches[label] = step_launches[label] = counts
        run_steps[label] = FAMILY_STEPS
        print(f"train {variant} --sentinel: launches {counts}; last step's "
              f"health {health}")
        del run
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("all", "partition", "arch",
                                        "recurrent", "dryrun", "remat",
                                        "analysis"),
                    default="all",
                    help="all (the default), the partition phases alone "
                         "(device, build, the arena and partition kernels, "
                         "the span runs and the group runs), the arch "
                         "phase alone (device, build, the bf16 kernels and "
                         "the stablelm and mixtral runs, with their kernels "
                         "JSON rows) or the recurrent phase alone (device, "
                         "build, B7 at recurrentgemma's rows, the xlstm, "
                         "recurrentgemma and bf16-master muon runs) or the "
                         "dry run alone (device, the pod cells, the "
                         "calibration) or the remat phase alone (device, "
                         "build, the remat modes' runs and the long step "
                         "with its dry run) or the analysis phase alone "
                         "(device, build, phase 13), for iterating on them; "
                         "only a "
                         "run of all prints the last line")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    # ---- 1. device
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {card}")

    # the remat phase's dry-run cells trace on the CPU during the build
    dry = start_dryrun(only=("long_calibration", "long_remat_none")) \
        if args.phase == "remat" else {"lanes": [], "cells": {}}
    try:
        return _phases(args, torch, dev, t_start, card, dry)
    finally:
        finish_dryrun_quietly(dry)


def _phases(args, torch, dev, t_start, card, dry: dict) -> int:
    """Phases 2-12 of a whole run, or the phases ``--phase`` names; ``dry``:
    the remat phase's dry-run lanes."""
    from repro_torch.configs import base
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import build

    if args.phase == "dryrun":
        dryrun_phase(torch, dev, start_dryrun())
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(card)
        print("chip_smoke: the dry-run phase passed (a partial run: no "
              "kernels JSON)")
        return 0

    # ---- 2. build
    t0 = time.perf_counter()
    secs = build.build()
    print(f"build: {len(secs)} kernels compiled in "
          f"{time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())}) "
          f"into {build.build_dir().relative_to(ROOT)}")
    from repro_torch.analysis.kernel_budget import ptxas_report
    for name in build.LIBRARIES:
        for line in ptxas_report(build.build_dir() / f"{name}.log"):
            print(f"build: {name}: {line}")

    # the grids of the kernels whose CTAs walk the blocks, at the main
    # path's largest leaf (their registers and static shared memory are on
    # the build lines above)
    from repro_torch.kernels import fused_update as fu
    sms, nb_main = build.sm_count(dev), 10 * 1024 * 8192 // 2048
    lib_fu, lib_np = fu._lib("fused_update"), fu._lib("norm_partials")
    from repro_torch.kernels import blockwise_quant as bq
    for sent in (0, 1):
        ctas = lib_fu.fused_update_ctas(fu.KERNEL_ALGOS["adam"], sent,
                                        nb_main, 2048, sms)
        print(f"grid: fused_update_kernel (adam, sentinel "
              f"{'on' if sent else 'off'}) at {nb_main}x2048: {ctas} CTAs "
              f"on {sms} SMs ({nb_main / ctas:.1f} blocks each); dynamic "
              f"shared memory per CTA "
              f"{lib_fu.fused_update_smem(fu.KERNEL_ALGOS['adam'], 2048)} B "
              f"(one-state algorithms: "
              f"{lib_fu.fused_update_smem(fu.KERNEL_ALGOS['momentum'], 2048)}"
              f" B)")
    lib_q = bq._lib()
    for nb_q in (nb_main, 1024 * 50264 // 2048):   # the largest leaf, the head
        ctas = lib_q.blockwise_quantize_ctas(nb_q, 2048, 8, sms)
        print(f"grid: quantize_kernel at {nb_q}x2048: {ctas} CTAs on {sms} "
              f"SMs ({nb_q / ctas:.1f} blocks each); dynamic shared memory "
              f"per CTA {lib_q.blockwise_quantize_smem(2048)} B")
    ctas = lib_fu.fused_update_packed_ctas(nb_main, 2048, sms)
    smem = {bits: lib_fu.fused_update_packed_smem(fu.KERNEL_ALGOS["adam"],
                                                  2048, *bits)
            for bits in ((4, 8), (5, 5), (6, 6))}
    print(f"grid: fused_update_packed_kernel at {nb_main}x2048: {ctas} "
          f"CTAs on {sms} SMs ({nb_main / ctas:.1f} blocks each); dynamic "
          f"shared memory per CTA for adam "
          + ", ".join(f"{b}: {v} B" for b, v in smem.items()))
    for kind in ("lars", "lamb"):
        ctas = lib_np.norm_partials_ctas(fu.NORM_KINDS[kind], nb_main, 2048,
                                         sms)
        print(f"grid: norm_partials_kernel {kind} at {nb_main}x2048: {ctas} "
              f"CTAs on {sms} SMs ({nb_main / ctas:.1f} blocks each), "
              f"dynamic shared memory 0 B" + (
                  f" ({lib_np.norm_partials_smem(2048, 4, 8)} B on (4, 8) "
                  f"states)" if kind == "lamb" else ""))

    if args.phase == "partition":
        cfg = base.get_config("paper-lm-209m")
        pipe = SyntheticLMPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                              seq_len=SEQ_LEN,
                                              global_batch=BATCH, seed=SEED))
        batches = [pipe.batch_at(i) for i in range(STEPS + 1)]
        check_arena_kernels(torch, dev)
        torch.cuda.empty_cache()
        check_partition_kernels(torch, dev)
        partition_phase(torch, dev, cfg, batches, {}, {}, {})
        group_phase(torch, dev, cfg, batches)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(card)
        print("chip_smoke: the partition phases passed (a partial run: no "
              "kernels JSON)")
        return 0
    if args.phase == "arch":
        kernels = check_bf16_kernels(torch, dev)
        torch.cuda.empty_cache()
        run_launches, step_launches, run_steps = {}, {}, {}
        arch_phase(torch, dev, run_launches, step_launches, run_steps)
        rows = kernel_rows(kernels, [(n, *m) for n, m in BF16_META.items()],
                           run_launches, step_launches, run_steps)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": rows}))
        print(card)
        print("chip_smoke: the arch phase passed (a partial run: no last "
              "line)")
        return 0

    if args.phase == "analysis":
        analysis_phase(torch, dev)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(card)
        print("chip_smoke: the analysis phase passed (a partial run: no "
              "kernels JSON)")
        return 0
    if args.phase == "remat":
        remat_phase(torch, dev, finish_dryrun(dry), {}, {}, {})
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(card)
        print("chip_smoke: the remat phase passed (a partial run: no "
              "kernels JSON)")
        return 0
    if args.phase == "recurrent":
        kernels = check_gather_kernel(torch, dev, RG_GATHER_SHAPE)
        torch.cuda.empty_cache()
        run_launches, step_launches, run_steps = {}, {}, {}
        recurrent_phase(torch, dev, run_launches, step_launches, run_steps,
                        profile=True)
        rows = kernel_rows(kernels, [("paged_gather/8bit", *GATHER,
                                      "paged_gather",
                                      "recurrentgemma_serve_kv8")],
                           run_launches, step_launches, run_steps)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": rows}))
        print(card)
        print("chip_smoke: the recurrent phase passed (a partial run: no "
              "last line)")
        return 0

    # ---- 11 (started): the dry run traces on the CPU meanwhile
    dry_runs = start_dryrun()
    try:
        return _main_on_card(torch, dev, t_start, card, dry_runs)
    finally:
        finish_dryrun_quietly(dry_runs)


def finish_dryrun_quietly(runs: dict) -> None:
    """Stop every dry-run lane still running, and the cell it runs (its
    process group)."""
    import os
    import signal
    for proc in runs["lanes"]:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        proc.wait()


def _main_on_card(torch, dev, t_start, card, dry_runs) -> int:
    """Phases 3-11 and the summary of a whole run."""
    from repro_torch.configs import base
    from repro_torch.core.optim import Quant8Leaf
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import ops

    # ---- 3. kernels vs plain versions
    check_div_shortcut(torch, dev)
    kernels = check_kernels(torch, dev)
    torch.cuda.empty_cache()
    kernels.update(check_packed_and_norm_kernels(torch, dev))
    torch.cuda.empty_cache()
    kernels.update(check_slice3_kernels(torch, dev))
    torch.cuda.empty_cache()
    kernels.update(check_gather_kernel(torch, dev))
    torch.cuda.empty_cache()
    for name, row in check_gather_kernel(torch, dev,
                                         RG_GATHER_SHAPE).items():
        kernels[name].update({RG_GATHER_KEY + k: row[k] for k in (
            "ms", "warm_ms", "graph_ms", "plain_ms", "bound_ms",
            "max_abs_err", "f32_ms", "f32_bound_ms")})
    torch.cuda.empty_cache()
    kernels.update(check_sentinel_kernels(torch, dev))
    torch.cuda.empty_cache()
    kernels.update(check_arena_kernels(torch, dev))
    torch.cuda.empty_cache()
    parted = check_partition_kernels(torch, dev)
    kernels["fused_update/arena_adamw8"].update(
        {f"partition_{k}": v for k, v in parted.items() if k != "arena_ms"})
    # the launcher's B3(e) launches are the arena's (pooled): its row
    # reports the arena's times, the largest leaf's beside them
    leaf_e = kernels["fused_update/sentinel_adamw8"]
    kernels["fused_update/sentinel_adamw8"] = dict(
        kernels.pop("fused_update/arena_sentinel_adamw8"),
        **{f"leaf_{k}": leaf_e[k] for k in ("ms", "off_ms", "plain_ms",
                                             "bound_ms")})
    torch.cuda.empty_cache()
    kernels.update(check_bf16_kernels(torch, dev))
    torch.cuda.empty_cache()

    # ---- 4. train
    cfg = base.get_config("paper-lm-209m")
    pipe = SyntheticLMPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ_LEN,
                                          global_batch=BATCH, seed=SEED))
    batches = [pipe.batch_at(i) for i in range(STEPS + 1)]
    ops.reset_launch_counts()
    ops.reset_fused_update_count()
    run8 = train(torch, dev, cfg, "adamw8", STEPS, batches, pooled=False)
    n_quant = readback(torch, run8["opt"], run8["state"])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    m8 = run8["metrics"]
    print(f"train adamw8: {n_quant} quantized leaves; opt_fused_dispatches "
          f"{m8['opt_fused_dispatches']:.0f}/step; state_bytes_per_param "
          f"{m8['state_bytes_per_param']:.4f}; launches {launches}; "
          f"median step {statistics.median(run8['ms'][1:]):.1f} ms "
          f"(steps 1..{STEPS - 1}; remat {cfg.remat}; without remat, an "
          f"earlier run: {PHASE4_NO_REMAT_MS} ms)")
    losses = run8["losses"]
    require(all(math.isfinite(x) for x in losses), "non-finite adamw8 loss")
    require(losses[-1] < losses[0], f"adamw8 loss did not fall: {losses}")
    require(launches["fused_update"] == STEPS * n_quant,
            f"fused_update launched {launches['fused_update']} times, "
            f"expected {STEPS} steps x {n_quant} leaves")
    require(launches["blockwise_quant"] == n_quant and
            launches["blockwise_dequant"] == 2 * n_quant,
            f"read-back launches {launches}, expected {n_quant} quantize "
            f"and {2 * n_quant} dequantize")
    prof, wall = profile_step(torch, run8["step"], run8["state"],
                              batches[STEPS])
    total = sum(t for t, _, _ in prof)
    print(f"profile adamw8 step: {total:.2f} ms device time in "
          f"{len(prof)} kernel names over {wall:.2f} ms wall under the "
          f"profiler (device idle {100 * (1 - total / wall):.1f}%); top:")
    for t, count, key in prof[:12]:
        print(f"profile   {t:9.3f} ms  x{count:<5d} {key[:90]}")
    print("profile adamw8 step: port kernels: " + "; ".join(
        f"{k} {t:.3f} ms in {n} launches ({100 * t / total:.1f}% of device "
        f"time)" for k, (t, n) in _kernel_share(
            prof, ("fused_update_kernel",)).items()))
    ms8 = statistics.median(run8["ms"][1:])
    del run8
    torch.cuda.empty_cache()

    run32 = train(torch, dev, cfg, "adamw32", STEPS, batches)
    require(all(math.isfinite(x) for x in run32["losses"]),
            "non-finite adamw32 loss")
    print(f"final loss after {STEPS} steps: adamw8 {losses[-1]:.6f}  "
          f"adamw32 {run32['losses'][-1]:.6f}; median step ms: adamw8 "
          f"{ms8:.1f}, adamw32 {statistics.median(run32['ms'][1:]):.1f}")
    adamw32_at = run32["losses"][FAMILY_STEPS - 1]
    adamw32_ms = statistics.median(run32["ms"][1:])
    losses32 = {}                 # 32-bit twin -> (final loss, median ms)
    del run32
    torch.cuda.empty_cache()

    # the rest of the family: each 8-bit path with its counters zeroed
    # just before it and read just after, then its 32-bit twin
    # launches of each run, and of its train steps alone (adamw8's count
    # also holds the read-back's quantize/dequantize launches)
    run_launches = {"adamw8": launches}
    step_launches = {"adamw8": dict(launches, blockwise_quant=0,
                                    blockwise_dequant=0)}
    run_steps = {"adamw8": STEPS}
    for variant, (algo, sr) in VARIANTS.items():
        if variant == "adamw8":
            continue
        ops.reset_launch_counts()
        run = train(torch, dev, cfg, f"{algo}8", FAMILY_STEPS, batches,
                    label=variant, stochastic_rounding=sr, pooled=False)
        torch.cuda.synchronize()
        counts = run_launches[variant] = ops.launch_counts()
        step_launches[variant], run_steps[variant] = counts, FAMILY_STEPS
        nq = sum(isinstance(leaf, Quant8Leaf)
                 for leaf in run["state"].opt_state.leaves.values())
        norms = FAMILY_STEPS * nq if algo in ("lamb", "lars") else 0
        require(nq == n_quant, f"{variant}: {nq} quantized leaves")
        require(counts["fused_update"] == FAMILY_STEPS * nq and
                counts["norm_partials"] == norms,
                f"{variant}: launches {counts}, expected fused_update "
                f"{FAMILY_STEPS} steps x {nq} leaves and norm_partials "
                f"{norms}")
        require(all(math.isfinite(x) for x in run["losses"]),
                f"non-finite {variant} loss")
        # one more step under the profiler: the port's kernels per step
        prof, wall = profile_step(torch, run["step"], run["state"],
                                  batches[FAMILY_STEPS])
        total = sum(t for t, _, _ in prof)
        ours = {}
        for t, count, key in prof:
            for k in ("fused_update_kernel", "norm_partials_kernel"):
                if k in key:
                    ms_, n_ = ours.get(k, (0.0, 0))
                    ours[k] = (ms_ + t, n_ + count)
        print(f"profile {variant} step: {total:.2f} ms device time over "
              f"{wall:.2f} ms wall (device idle "
              f"{100 * (1 - total / wall):.1f}%); port kernels: "
              + "; ".join(f"{k} {t:.3f} ms in {n} launches"
                          for k, (t, n) in ours.items()))
        l8, ms_8 = run["losses"][-1], statistics.median(run["ms"][1:])
        sb = run["metrics"]["state_bytes_per_param"]
        del run
        torch.cuda.empty_cache()
        if sr:
            l32, ms_32 = adamw32_at, adamw32_ms
            twin = f"adamw32 (step {FAMILY_STEPS})"
        else:
            run = train(torch, dev, cfg, f"{algo}32", FAMILY_STEPS, batches)
            require(all(math.isfinite(x) for x in run["losses"]),
                    f"non-finite {algo}32 loss")
            l32, ms_32 = run["losses"][-1], statistics.median(run["ms"][1:])
            twin = f"{algo}32"
            losses32[twin] = (l32, ms_32)
            del run
            torch.cuda.empty_cache()
        rel = abs(l8 - l32) / abs(l32)
        print(f"final loss after {FAMILY_STEPS} steps: {variant} {l8:.6f}  "
              f"{twin} {l32:.6f} ({100 * rel:.3f}% apart); median step ms "
              f"{ms_8:.1f} vs {ms_32:.1f}; {variant} launches {counts}; "
              f"state_bytes_per_param {sb:.4f}")
        require(rel < 0.01, f"{variant} and {twin} final losses differ by "
                f"{100 * rel:.2f}% (limit 1%)")
    run = train(torch, dev, cfg, "adafactor32", FAMILY_STEPS, batches)
    require(all(math.isfinite(x) for x in run["losses"]),
            "non-finite adafactor32 loss")
    print(f"final loss after {FAMILY_STEPS} steps: adafactor32 "
          f"{run['losses'][-1]:.6f}; median step ms "
          f"{statistics.median(run['ms'][1:]):.1f}; state_bytes_per_param "
          f"{run['metrics']['state_bytes_per_param']:.4f}")
    del run
    torch.cuda.empty_cache()

    train_slice3(torch, dev, cfg, batches, losses32, run_launches,
                 step_launches, run_steps)

    # the pooled single dispatch against the per-leaf runs, and the face
    pooled_phase(torch, dev, cfg, batches, run_launches, step_launches,
                 run_steps)
    # the partitioned dispatch against the pooled runs, in one process and
    # on a process group
    per_step = partition_phase(torch, dev, cfg, batches, run_launches,
                               step_launches, run_steps)
    kernels["fused_update/arena_adamw8"]["partition_launches_per_step"] = \
        per_step
    group_phase(torch, dev, cfg, batches)

    # ---- 5. checkpoint: per-leaf, then pooled into both layouts
    checkpoint_roundtrip(torch, dev, cfg, batches)
    torch.cuda.empty_cache()
    checkpoint_roundtrip(torch, dev, cfg, batches, pooled=True,
                         into=(True, False))
    torch.cuda.empty_cache()

    # ---- 6. serve
    serve_phase(torch, dev, cfg, run_launches, step_launches, run_steps)

    # ---- 7. telemetry: the train launcher with the sentinel (B3(e))
    telemetry_phase(torch, dev, cfg, batches, n_quant, run_launches,
                    step_launches, run_steps)

    # ---- 8. the attention-model zoo: stablelm-1.6b, mixtral-8x22b
    arch_phase(torch, dev, run_launches, step_launches, run_steps)

    # ---- 10. the recurrent family: xlstm-350m, recurrentgemma-9b, and
    # muon8 on bf16 masters
    recurrent_phase(torch, dev, run_launches, step_launches, run_steps)
    torch.cuda.empty_cache()

    # ---- 11. the dry run: the pod cells, the calibration
    arts = dryrun_phase(torch, dev, dry_runs)

    # ---- 12. activation remat: the three modes, the long step
    remat_phase(torch, dev, arts, run_launches, step_launches, run_steps)
    torch.cuda.empty_cache()

    # ---- 13. the static analysis: contracts, kernel budget, lint, syncs
    analysis_phase(torch, dev)
    torch.cuda.empty_cache()

    # ---- 9. summary
    meta = [(name, source, replaces, counter,
             {"lars": "lars8", "lamb": "lamb8"}.get(
                 name.split("/")[-1], name.split("/")[-1])
             if "/" in name else "adamw8")
            for name, (source, replaces, counter) in KERNEL_META.items()]
    meta += [(name, *m) for name, m in SLICE3_META.items()]
    meta += [(f"paged_gather/{b}bit", *GATHER, "paged_gather",
              f"serve_kv{b}") for b in (8, 4)]
    meta += [(f"fused_update/sentinel_{v}", *FUSED, "fused_update_sentinel",
              "telemetry_adamw8" if v == "adamw8" else f"sentinel_{v}")
             for v in SENTINEL_VARIANTS]
    meta += [(f"fused_update/{v}", *FUSED, "fused_update", f"pooled_{v[6:]}")
             for v in ARENA_VARIANTS]
    meta += [("norm_partials/arena_lamb8", *NORMS, "norm_partials",
              "pooled_lamb8")]
    meta += [(name, *m) for name, m in BF16_META.items()]
    rows = kernel_rows(kernels, meta, run_launches, step_launches, run_steps,
                       RECURRENT_ROW_RUNS)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# a dry-run cell's process: lowest priority, one thread, on the cores
# given, then the dry run's command line
DRYRUN_MAIN = ("import os, sys, torch; os.nice(19); "
               "os.sched_setaffinity(0, {cores!r}); torch.set_num_threads(1); "
               "from repro_torch.launch import dryrun; "
               "sys.exit(dryrun.main(sys.argv[1:]))")


def _host_cell(out: Path, arch: str, seq: int, batch: int,
               remat: str | None = None, n_layers: int | None = None,
               microbatches: int | None = None) -> tuple:
    """(arguments, artifact path) of the dry run of ``arch``'s train step at
    seq x batch on a mesh of one device (its config cut to ``n_layers``,
    ``microbatches`` microbatches, where given)."""
    args = ["--arch", arch, "--shape", "train_4k", "--mesh", "host",
            "--seq-len", str(seq), "--batch", str(batch), "--out",
            str(out / "host")] + (["--remat", remat] if remat else [])
    tag = f"{arch}__train_4k__host__s{seq}b{batch}" + (
        f"__remat_{remat}" if remat else "")
    if n_layers:
        args += ["--n-layers", str(n_layers)]
        tag += f"__l{n_layers}"
    if microbatches:
        args += ["--microbatches", str(microbatches)]
        tag += f"__mb{microbatches}"
    return args, out / "host" / f"{tag}.json"


def start_dryrun(only: tuple | None = None) -> dict:
    """Start the dry run on the CPU (the card hidden from it): each pod
    cell of DRYRUN_CELLS, the calibration's one-device cell (phase 11) and
    the long step's two (phase 12), each in a process over a fake process
    group of its own (``only``: those named alone).  DRYRUN_LANES lanes (a
    shell each, in a session of its own) run the cells one after another,
    every process on one thread at the lowest priority, pinned to the
    host's last DRYRUN_LANES cores.  Returns {"lanes": [process, ...],
    "cells": {name: (artifact path, log path)}}."""
    import os
    import shlex
    out = ROOT / "build" / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    cores = set(sorted(os.sched_getaffinity(0))[-DRYRUN_LANES:])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    jobs = []
    for cell in DRYRUN_CELLS:
        arch, shape = cell.split(":")
        jobs.append((cell, ["--arch", arch, "--shape", shape, "--mesh",
                            "pod", "--out", str(out / "pod")],
                     out / "pod" / f"{arch}__{shape}__pod.json"))
    jobs.append(("calibration",
                 *_host_cell(out, "paper-lm-209m", SEQ_LEN, BATCH)))
    jobs.append(("recurrent_calibration",
                 *_host_cell(out, "xlstm-350m", XLSTM_CAL_SEQ,
                             XLSTM_CAL_BATCH, n_layers=XLSTM_CAL_LAYERS,
                             microbatches=1)))
    jobs.append(("long_calibration",
                 *_host_cell(out, LONG_ARCH, LONG_SEQ, LONG_BATCH)))
    jobs.append(("long_remat_none",
                 *_host_cell(out, LONG_ARCH, LONG_SEQ, LONG_BATCH, "none")))
    if only is not None:
        jobs = [job for job in jobs if job[0] in only]
    main = DRYRUN_MAIN.format(cores=cores)
    cells, scripts = {}, [[] for _ in range(DRYRUN_LANES)]
    for i, (name, args, artifact) in enumerate(jobs):
        log = out / f"{name.replace(':', '__')}.log"
        artifact.unlink(missing_ok=True)
        cells[name] = (artifact, log)
        # the first (longest) cell has a lane of its own, the others take
        # the other lanes in turn
        lane = 0 if i == 0 else 1 + (i - 1) % (DRYRUN_LANES - 1)
        scripts[lane].append(
            shlex.join([sys.executable, "-c", main, *args, "--force"])
            + f" > {shlex.quote(str(log))} 2>&1")
    lanes = [subprocess.Popen(["sh", "-c", "; ".join(lane)], cwd=ROOT,
                              env=env, start_new_session=True)
             for lane in scripts if lane]
    return {"lanes": lanes, "cells": cells}


def finish_dryrun(runs: dict, timeout: float = 900) -> dict:
    """Wait for the dry run's lanes (stopping any left at the end of
    ``timeout`` or on a failure) and return {name: artifact}."""
    deadline = time.perf_counter() + timeout
    try:
        for proc in runs["lanes"]:
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        finish_dryrun_quietly(runs)
    arts = {}
    for name, (artifact, log) in runs["cells"].items():
        require(artifact.exists(), f"dry run {name}: no artifact\n"
                f"{Path(log).read_text()[-3000:]}")
        arts[name] = json.loads(artifact.read_text())
    return arts


def dryrun_phase(torch, dev, runs: dict) -> dict:
    """Phase 11: the pod cells' artifacts, and the calibration against the
    same train step on the card.  Returns every dry-run artifact."""
    arts = finish_dryrun(runs)
    arts_logs = {name: log for name, (_, log) in runs["cells"].items()}
    for cell in DRYRUN_CELLS:
        art = arts[cell]
        require(art["status"] == "ok", f"dry run {cell}: {art}")
        mem, rf = art["memory"], art["roofline"]
        coll = {k: v for k, v in rf["coll_breakdown"].items()
                if not k.startswith("_")}
        print(f"dryrun {cell} pod ({art['n_chips']} devices): ok; per "
              f"device {mem['total_per_device'] / 1e9:.2f} GB against the "
              f"card's {CARD_BYTES / 1e9:.0f} GB "
              f"({'fits' if mem['total_per_device'] <= CARD_BYTES else 'does not fit'}"
              f"); arguments {mem['argument_bytes']} B (= the rules' "
              f"arithmetic), temp {mem['temp_bytes']} B; "
              f"{rf['flops_per_device']:.4e} FLOP, "
              f"{rf['bytes_per_device']:.4e} B accessed, collectives "
              + ", ".join(f"{k} {v:.4e} B" for k, v in sorted(coll.items()))
              + f"; bound by {rf['bottleneck']}; traced in "
              f"{art['compile_s']} s on the host")
        # what was live at the peak, by the op that allocated it
        log = Path(arts_logs[cell]).read_text().splitlines()
        for line in (ln.strip() for ln in log if "peak:" in ln):
            print(f"dryrun {cell} {line}")

    # (b) the calibration: the same step on the card
    from repro_torch.configs import base
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    cfg = base.get_config("paper-lm-209m")
    pipe = SyntheticLMPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ_LEN,
                                          global_batch=BATCH, seed=SEED))
    calibrate(torch, dev, arts["calibration"], cfg, pipe.batch_at(0),
              f"paper-lm-209m adam8 seq {SEQ_LEN} x batch {BATCH}")
    # the recurrent calibration: the scans counted from a few traced steps
    # on the host, run step by step on the card
    import dataclasses
    cfg = dataclasses.replace(base.get_config("xlstm-350m"),
                              n_layers=XLSTM_CAL_LAYERS)
    pipe = SyntheticLMPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=XLSTM_CAL_SEQ,
                                          global_batch=XLSTM_CAL_BATCH,
                                          seed=SEED))
    calibrate(torch, dev, arts["recurrent_calibration"], cfg,
              pipe.batch_at(0),
              f"xlstm-350m ({XLSTM_CAL_LAYERS} layers: 7 mLSTM + 1 sLSTM) "
              f"adam8 seq {XLSTM_CAL_SEQ} x batch {XLSTM_CAL_BATCH}, scans "
              f"counted")
    return arts


def calibrate(torch, dev, dry: dict, cfg, batch, label: str) -> None:
    """The dry run's one-device artifact ``dry`` of the train step of
    ``cfg`` (adam8, ``impl="torch"``, the dry run's hyperparameters)
    against the same step on the card: FLOPs equal to ``FlopCounterMode``'s,
    the peak within DRYRUN_PEAK_RTOL of ``max_memory_allocated`` from a
    reset."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.core.optim import make_optimizer
    from repro_torch.launch import dryrun
    from repro_torch.train import loop as L
    require(dry["status"] == "ok" and dry["n_chips"] == 1,
            f"dry run calibration {label}: {dry}")
    opt = make_optimizer("adam8", lr=dryrun.LR, weight_decay=0.1,
                         impl="torch", device=dev)
    state, model = L.init_train_state(
        cfg, opt, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    step = L.make_train_step(cfg, model, opt, L.TrainHyper())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    flops = fc.get_total_flops()
    loss = metrics["loss"].item()
    dry_peak = dry["memory"]["total_per_device"]
    rel = abs(dry_peak - peak) / peak
    print(f"dryrun calibration {label} (impl torch, remat {cfg.remat}, "
          f"attn_chunk {cfg.attn_chunk}), one device: FLOPs dry run "
          f"{dry['cost']['flops']:.0f}, FlopCounterMode on the card {flops}; "
          f"peak dry run {dry_peak} B, max_memory_allocated {peak} B "
          f"({100 * rel:.2f}% apart, limit {100 * DRYRUN_PEAK_RTOL:.0f}%); "
          f"loss {loss:.6f}; traced in {dry['compile_s']} s on the host; "
          f"{torch.cuda.get_device_name(0)}, {card_line()}")
    require(math.isfinite(loss), f"calibration {label}: non-finite loss")
    require(dry["cost"]["flops"] == flops,
            f"calibration {label}: dry-run FLOPs {dry['cost']['flops']} != "
            f"the card's {flops}")
    require(rel <= DRYRUN_PEAK_RTOL, f"calibration {label}: dry-run peak "
            f"{dry_peak} B vs the card's {peak} B")
    del state, model, step, opt
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 12
def remat_phase(torch, dev, arts: dict, run_launches, step_launches,
                run_steps) -> None:
    """(a) paper-lm-209m at SEQ_LEN x BATCH, adamw8 pooled through the
    kernels, REMAT_STEPS steps at each of REMAT_MODES from the same weights
    and batches: every step's metrics and every state array bit-identical
    across the modes (the recomputed ops rerun on the same inputs), B3 once
    a step; each mode's peak from a reset, and its step in turns with the
    others'.  (b) stablelm-1.6b at LONG_SEQ x LONG_BATCH with remat "full"
    and attn_chunk 1024: LONG_STEPS adamw8 steps through the kernels,
    finite losses, its peak; the dry run's one-device count of the step
    calibrated against the card (``calibrate``), and its count at remat
    "none" printed."""
    import dataclasses
    from repro_torch.configs import base
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    card = card_line()

    # (a) the three modes
    cfg0 = base.get_config("paper-lm-209m")
    pipe = SyntheticLMPipeline(DataConfig(vocab_size=cfg0.vocab_size,
                                          seq_len=SEQ_LEN,
                                          global_batch=BATCH, seed=SEED))
    batches = [pipe.batch_at(i) for i in range(REMAT_STEPS + 1)]
    runs, peaks = {}, {}
    for mode in REMAT_MODES:
        label = f"remat_{mode}"
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_b = torch.cuda.memory_allocated()
        runs[mode] = train(torch, dev, dataclasses.replace(cfg0, remat=mode),
                           "adamw8", REMAT_STEPS, batches, label=label)
        torch.cuda.synchronize()
        peaks[mode] = torch.cuda.max_memory_allocated() - base_b
        counts = ops.launch_counts()
        require(counts["fused_update"] == REMAT_STEPS,
                f"{label}: launches {counts}, expected B3 once per step")
        run_launches[label] = step_launches[label] = counts
        run_steps[label] = REMAT_STEPS
    for mode in REMAT_MODES[1:]:
        require(runs[mode]["trace"] == runs["none"]["trace"],
                f"remat {mode}: per-step loss / grad norm / health bits "
                f"differ from remat none's")
        n_bad = _same_state(torch, runs[mode]["state"], runs["none"]["state"])
        require(n_bad == 0, f"remat {mode}: {n_bad} state arrays differ "
                f"from remat none's after {REMAT_STEPS} steps")
    print(f"remat paper-lm-209m adamw8 seq {SEQ_LEN} x batch {BATCH}: "
          f"{REMAT_STEPS} steps at remat {', '.join(REMAT_MODES)}, every "
          f"step's metrics and every state array bit-identical; peak from "
          f"a reset " + ", ".join(f"{m} {peaks[m]} B ({peaks[m] / 1e9:.3f} "
                                  f"GB)" for m in REMAT_MODES)
          + f"; {torch.cuda.get_device_name(0)}, {card}")
    step_turns(torch, "remat paper-lm-209m adamw8", runs,
               batches[REMAT_STEPS], ref="none")
    del runs
    torch.cuda.empty_cache()

    # (b) the long step: stablelm-1.6b at train_4k's length
    t0 = time.perf_counter()
    cfg = base.get_config(LONG_ARCH)
    require(cfg.remat == "full" and cfg.attn_chunk == 1024,
            f"{LONG_ARCH}: remat {cfg.remat}, attn_chunk {cfg.attn_chunk}")
    pipe = SyntheticLMPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=LONG_SEQ,
                                          global_batch=LONG_BATCH, seed=SEED))
    batches = [pipe.batch_at(i) for i in range(LONG_STEPS)]
    label = "stablelm_long_adamw8"
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_b = torch.cuda.memory_allocated()
    run = arch_train(torch, dev, cfg, "adamw8", LONG_STEPS, batches,
                     label, lr=LR, weight_decay=WEIGHT_DECAY)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base_b
    counts = ops.launch_counts()
    require(counts["fused_update"] == LONG_STEPS,
            f"{label}: launches {counts}, expected B3 once per step")
    run_launches[label] = step_launches[label] = counts
    run_steps[label] = LONG_STEPS
    print(f"remat {LONG_ARCH} adamw8 seq {LONG_SEQ} x batch {LONG_BATCH} "
          f"(remat {cfg.remat}, attn_chunk {cfg.attn_chunk}): losses "
          + ", ".join(f"{x:.6f}" for x in run["losses"])
          + f"; median step {statistics.median(run['ms'][1:]):.1f} ms; "
          f"peak from a reset {peak} B ({peak / 1e9:.3f} GB); launches "
          f"{counts}; {torch.cuda.get_device_name(0)}, {card}")
    del run
    torch.cuda.empty_cache()
    calibrate(torch, dev, arts["long_calibration"], cfg, batches[0],
              f"{LONG_ARCH} adam8 seq {LONG_SEQ} x batch {LONG_BATCH}")
    none = arts["long_remat_none"]
    require(none["status"] == "ok", f"dry run remat none: {none}")
    full = arts["long_calibration"]
    print(f"dryrun {LONG_ARCH} adam8 seq {LONG_SEQ} x batch {LONG_BATCH} "
          f"one device: remat none {none['memory']['total_per_device']} B "
          f"({none['memory']['total_per_device'] / 1e9:.2f} GB, "
          f"{none['cost']['flops']:.4e} FLOP) against remat full "
          f"{full['memory']['total_per_device']} B "
          f"({full['memory']['total_per_device'] / 1e9:.2f} GB, "
          f"{full['cost']['flops']:.4e} FLOP); the card holds "
          f"{CARD_BYTES / 1e9:.0f} GB")
    print(f"remat {LONG_ARCH}: {time.perf_counter() - t0:.1f} s")
    print(f"remat phase: {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------------ phase 13
PCLIP = 95                  # the host-sync steps' percentile clipping


def analysis_phase(torch, dev) -> None:
    """Phase 13: the contract matrix and a full-width cell on the card,
    the kernel budget against ptxas and the occupancy API, the lint gate,
    host syncs per step (see the module doc)."""
    from repro_torch.analysis import contracts, kernel_budget, lint, runner
    from repro_torch.configs import base
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import build, ops

    t0 = time.perf_counter()
    failed = []         # every check runs and prints; the phase fails after
    check = lambda ok, what: None if ok else failed.append(what)
    lines = []
    ops.reset_launch_counts()
    ops.reset_fused_update_count()
    results = runner.run_contracts(device=dev, log=lines.append)
    torch.cuda.synchronize()
    launches, routes = ops.launch_counts(), ops.fused_update_routes()
    for line in lines:
        print(f"analysis: contract {line}")
    bad = runner.failures(results)
    check(not bad, f"{len(bad)} contract(s) failed on the card: "
          f"{[str(r) for r in bad]}")
    check(set(routes) == {"cuda"} and launches["fused_update"] > 0,
          f"the matrix's updates by route {routes}, launches {launches}")
    print(f"analysis: contracts {len(results)}/{len(results)} passed on "
          f"the card in {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}; dispatches by route {routes}")

    # the full-width cell: its counters zeroed just before, read just after
    cfg = base.get_config("paper-lm-209m")
    pipe = SyntheticLMPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ_LEN,
                                          global_batch=BATCH, seed=SEED))
    cell = runner.Cell("paper-lm-209m-adamw8-pooled", "adamw8", (8, 8))
    ops.reset_launch_counts()
    ops.reset_fused_update_count()
    trace = runner.trace_step(cell, device=dev, cfg=cfg,
                              batch=pipe.batch_at(0))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    routes = ops.fused_update_routes()
    b3 = sum(1 for e in trace.events
             if e.kind == "kernel" and e.name == "fused_update")
    print(f"analysis: full width {cell.name} at {BATCH}x{SEQ_LEN}: "
          f"{len(trace.events)} events, {b3} B3 launch(es) in the traced "
          f"step; launches of the two steps {launches}; dispatches by "
          f"route {routes}")
    check(b3 >= 1 and launches["fused_update"] >= 2 and
          set(routes) == {"cuda"},
          f"the full-width step's trace holds {b3} B3 launches "
          f"(counters {launches}, routes {routes})")
    runner.register_all()
    for spec in contracts.contracts_for("step"):
        r = contracts.evaluate(spec, trace, cell)
        if r is not None:
            print(f"analysis: contract {r}")
            check(r.ok, f"full-width {r}")
    del trace
    torch.cuda.empty_cache()

    # the kernel budget of every built instance
    rows = kernel_budget.card_audit(build.build_dir(), build.library)
    for r in rows:
        print(f"analysis: budget {r['library']}: {r['instance']}: "
              f"{r['threads']} threads, smem {r['static_smem']} + "
              f"{r['dynamic_smem']} B (ptxas {r['ptxas_smem']}), registers "
              f"{r['registers']} of cap {r['cap']}, spill "
              f"{r['spill_stores']} B, local {r['local']} B, CTAs/SM "
              f"assumed {r['assumed']} / model {r['model_ctas']} / API "
              f"{r['api_ctas']}: {'ok' if r['ok'] else r['problems']}")
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"{len(bad)} of {len(rows)} budget lines disagree with "
          f"ptxas or the occupancy API")
    print(f"analysis: budget {len(rows) - len(bad)}/{len(rows)} instances "
          f"agree with ptxas and the occupancy API")

    # the lint gate
    ok, lint_lines = lint.run(str(ROOT / "src" / "repro_torch"))
    for line in lint_lines:
        print(f"analysis: lint {line}")
    check(ok, "new lint violations")

    # host syncs per step, after two warm-up steps
    batches = [pipe.batch_at(i) for i in range(3)]
    for pooled in (True, False):
        for pclip in (100, PCLIP):
            label = (f"adamw8 {'pooled' if pooled else 'per-leaf'}"
                     f"{f' pclip {pclip}' if pclip < 100 else ''}")
            run = train(torch, dev, cfg, "adamw8", 2, batches,
                        label=f"sync {label}", pooled=pooled,
                        percentile_clipping=pclip)
            torch.cuda.synchronize()
            (_, m), n, sites = runner.host_syncs(
                lambda: run["step"](run["state"], batches[2]))
            torch.cuda.synchronize()
            check(math.isfinite(m["loss"].item()), f"{label}: loss")
            print(f"analysis: host syncs {label}: {n} per step ({sites})")
            del run
            torch.cuda.empty_cache()
    print(f"analysis: phase 13 {time.perf_counter() - t0:.1f} s")
    require(not failed, "; ".join(failed))


def kernel_rows(kernels, meta, run_launches, step_launches,
                run_steps, row_runs=None) -> list:
    """The kernels JSON line's rows: one per (name, source, replaced TPU
    kernel, launch counter, run) of ``meta``, its numbers from
    ``kernels[name]`` and its launches from the run's counters (and, for a
    row of ``row_runs``, {name: runs}, those runs' launches of its
    counter under "other_runs")."""
    rows = []
    for name, source, replaces, counter, run in meta:
        k = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": run_launches[run][counter],
                     "launches_per_step":
                         step_launches[run][counter] / run_steps[run],
                     "run": run,
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k.get("library_ms")})
        if "off_ms" in k:                 # B3(e): the sentinel-off kernel
            rows[-1]["sentinel_off_ms"] = k["off_ms"]
        for key in ("f32_simt_bound_ms", "device_ms_small",   # B5, B6
                    "library_device_ms_small", "device_ms",      # B4
                    "library_device_ms", "adamw8_in_turns_ms",   # B3(d)
                    "warm_ms", "graph_ms", "f32_max_abs_err",    # B7
                    "f32_ms", "f32_warm_ms", "f32_graph_ms", "f32_plain_ms",
                    "f32_bound_ms", "per_leaf_ms",                 # arena
                    "leaf_ms", "leaf_off_ms", "leaf_plain_ms",
                    "leaf_bound_ms", "partition_span_ms",        # spans
                    "partition_piece_ms", "partition_span_bound_ms",
                    "partition_launches_per_step", "profiler_sessions",
                    "f32_profiler_sessions",
                    "arena_ms", "arena_f32_ms", "arena_bound_ms",   # bf16
                    "arena_f32_bound_ms", "arena_library_ms",
                    *(RG_GATHER_KEY + key for key in (     # B7, kv 1 x 256
                        "ms", "warm_ms", "graph_ms", "plain_ms", "bound_ms",
                        "max_abs_err", "f32_ms", "f32_bound_ms"))):
            if key in k:
                rows[-1][key] = k[key]
        for other in (row_runs or {}).get(name, ()):
            if run_launches.get(other, {}).get(counter):
                rows[-1].setdefault("other_runs", {})[other] = \
                    run_launches[other][counter]
        require(rows[-1]["launches"] > 0, f"{name}: no launch in the {run} "
                f"run")
    return rows


if __name__ == "__main__":
    sys.exit(main())
