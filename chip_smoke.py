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
flight recorder.  Phases, one line or more each:

1. device  — require CUDA (exit 2 without it).
2. build   — compile every kernel from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all in parallel).
3. kernels — each kernel and variant against its plain PyTorch version on
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
   call's.  Median times beside the least time the card could take
   (bytes over 3.35 TB/s, f32 operations over 67 TFLOP/s: the H100 SXM
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
   scrambled table with -1 entries: 0 mismatches.)
7. telemetry — the train launcher (``repro_torch.launch.train.main``) at
   full-width paper-lm-209m (the launcher's f32 compute), adamw8, 8 steps
   of seq 512 x batch 8 with ``--sentinel``, qhealth probes every 4 steps
   and the flight recorder (a host copy of the state after every healthy
   step), under build/ (removed after).  With the counters zeroed just
   before it: the fused update must launch 8 x 11 quantized leaves times,
   every launch with the sentinel output (B3(e)), and B1/B2 once per leaf
   and probe (the round-trip sample); every step's sent_* nonfinite and
   overflow counts must be 0 and its edge-hit count above 0; the probes
   must give 2 x 11 events at steps 3 and 7; the JSONL must pass the
   port's validator and the inspector must score the run clean.  Then the
   same 8 steps without the sentinel (ms/step on and off), and at lr 1e18:
   exit 2 with a flight dump of the step before the trigger, which
   restores into a fresh state, replays the trigger step to the recorded
   loss (or both nonfinite) and scores 1 under ``inspect --flight``.  Then
   5 steps with the sentinel of stochastic adamw8, momentum8, lamb8 and
   adam8 at (4, 8) (SENTINEL_RUNS: the launches of their JSON rows).  The
   kernels phase also holds B3(e) at the largest leaf for those five
   variants against ``health_rows`` and the sentinel-off kernel, on clean
   inputs and with NaN / +-inf / 1e31 planted in g and one block's state.
8. summary — the kernels JSON line, the card's name and power limit, and
   the last line ``{"ok": true, "device": {...}}``.

Any failure raises: the script then exits non-zero without the last line.
"""
from __future__ import annotations

import json
import math
import re
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

# fused-update variant -> (algo, stochastic); the optimizer name of its
# train run is the variant without "_sr" plus stochastic rounding
VARIANTS = {"adamw8": ("adamw", False), "adamw8_sr": ("adamw", True),
            "momentum8": ("momentum", False), "lars8": ("lars", False),
            "lamb8": ("lamb", False), "adagrad8": ("adagrad", False)}


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
    marker is None.  For a kernel of a few microseconds, CUDA events around
    back-to-back calls measure the host's launch rate instead (each wrapper
    call costs tens of microseconds of Python).  (One session for all the
    fns compared: a run of back-to-back profiler sessions can come back
    without device events.)"""
    from torch.profiler import ProfilerActivity, profile
    for fn, _ in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for r in range(n):
            for name in (list(fns) if r % 2 == 0 else list(reversed(fns))):
                fns[name][0]()
        torch.cuda.synchronize()
    total = dict.fromkeys(fns, 0.0)
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        t = getattr(ev, "self_device_time_total", None)
        t = t if t is not None else getattr(ev, "self_cuda_time_total", 0.0)
        owner = next((k for k, (_, mark) in fns.items()
                      if mark is not None and mark in ev.key),
                     next(k for k, (_, mark) in fns.items() if mark is None))
        total[owner] += t
    require(all(v > 0 for v in total.values()),
            f"the profiler saw no device time for some of {list(fns)}")
    return {k: v / 1e3 / n for k, v in total.items()}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phase 3
def check_kernels(torch, dev, nb: int = 10 * 1024 * 8192 // 2048,
                  bsz: int = 2048) -> dict:
    """Each kernel against its plain version at (nb, bsz); the default is
    the main path's largest leaf, blocks/b0_attn/mlp/w_in."""
    from repro_torch.core import qmap
    from repro_torch.kernels import blockwise_dequant as bdq
    from repro_torch.kernels import blockwise_quant as bq
    from repro_torch.kernels import ops
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
    ms = median_ms(torch, lambda: ops.quantize_blockwise(x, qs), 20)
    plain = median_ms(torch, lambda: bq.quantize_plain(x, qs), 3, 2, 1)
    b, by = bound_ms(n * 5 + nb * 4 + 1024, n * 19)
    out["blockwise_quant"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                  bound_ms=b, bound_by=by)
    print(f"kernel blockwise_quant ({nb}x{bsz} f32): exact; {ms:.4f} ms, "
          f"bound {b:.4f} ms ({by}), plain {plain:.3f} ms")

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

    # B3 fused updates and the B4 norm prologue: one step from random
    # nonzero states, each variant against its plain version
    p = torch.randn(nb, bsz, generator=gen, device=dev) * 0.02
    g = torch.randn(nb, bsz, generator=gen, device=dev) * 1e-3
    codes = [torch.randint(0, 256, (nb, bsz), generator=gen, device=dev,
                           dtype=torch.uint8) for _ in range(2)]
    am = torch.rand(nb, generator=gen, device=dev) * 1e-3 + 1e-5
    ar = torch.rand(nb, generator=gen, device=dev) * 1e-6 + 1e-9
    hyper = dict(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=WEIGHT_DECAY, step=7.0, gnorm_scale=1.0)
    s = fu.scalars(device=dev, **hyper)
    norm_hyper = {k: v for k, v in hyper.items() if k != "lr"}
    library = median_ms(torch, lambda: (torch.linalg.vector_norm(p, dim=1),
                                        torch.linalg.vector_norm(g, dim=1)),
                        20)
    for kind in ("lars", "lamb"):
        lamb = kind == "lamb"
        state = (codes[0], am, codes[1], ar, qs, qu) if lamb \
            else (None,) * 6
        want = fu.norm_partials_plain(p, g, *state, s, algo=kind)
        got = fu.norm_partials_cuda(p, g, *state, algo=kind, **norm_hyper)
        err = (got - want).abs().max().item()
        n_bad = int((got != want).sum())
        require(n_bad == 0, f"norm_partials/{kind}: {n_bad} partials "
                f"disagree with the plain version (err {err})")
        ms = median_ms(torch, lambda: fu.norm_partials_cuda(
            p, g, *state, algo=kind, **norm_hyper), 20)
        plain = median_ms(torch, lambda: fu.norm_partials_plain(
            p, g, *state, s, algo=kind), 3, 2, 1)
        b, by = bound_ms(n * (10 if lamb else 8) + nb * (40 if lamb else 32),
                         n * (26 if lamb else 6))
        out[f"norm_partials/{kind}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
            library_ms=library)
        print(f"kernel norm_partials {kind} ({nb}x{bsz}): exact, 0 "
              f"mismatches; {ms:.4f} ms, bound {b:.4f} ms ({by}), plain "
              f"{plain:.3f} ms, torch.linalg.vector_norm of p and g "
              f"{library:.4f} ms")
        if lamb:
            partials_lamb = got
    ts = fu.segment_scales_from_partials(fu.ALGO_SPECS["lamb"],
                                         partials_lamb, ((0, nb),), nb,
                                         WEIGHT_DECAY, 1e-3)
    del want, got, partials_lamb

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
        # the update kernel alone: lamb/lars take the trust ratio computed
        # above (the prologue is checked and timed on its own)
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
        ms = median_ms(torch, lambda: fu.fused_update_cuda(
            got[0], g, got[1], got[2], got[3], got[4], q1, qu, **kw), 20)
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
            library_ms=None)
        print(f"kernel fused_update {variant} ({nb}x{bsz}): p, codes and "
              f"absmax exact, 0 mismatches; {ms:.4f} ms, bound {b:.4f} ms "
              f"({by}), plain {plain:.3f} ms")
        del got
    return out


def check_slice3_kernels(torch, dev, nb: int = 10 * 1024 * 8192 // 2048,
                         bsz: int = 2048, ns_shape=(1024, 50264)) -> dict:
    """The third slice's kernels against their plain versions: the packed
    update (B3(d)), lamb's prologue on packed states (B4), quantize and
    dequantize at 4 bits (B1/B2) at (nb, bsz); the Newton–Schulz gram and
    apply (B5/B6) at ``ns_shape``, the main path's head."""
    from repro_torch.core import qmap
    from repro_torch.core.lowbit import pack_codes
    from repro_torch.kernels import blockwise_dequant as bdq
    from repro_torch.kernels import blockwise_quant as bq
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

    def mismatches(got, want):
        n_bad, err = 0, 0.0
        for k_, w_ in zip(got, want):
            if w_ is None:
                continue
            n_bad += int((k_ != w_).sum())
            err = max(err, (k_.float() - w_.float()).abs().max().item())
        return n_bad, err

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
        n_bad, err = mismatches(got, want[:5])
        require(n_bad == 0, f"fused_update/{variant}: {n_bad} values (p, "
                f"packed codes, absmax) disagree with the plain version "
                f"(err {err})")
        del want
        ms = median_ms(torch, lambda: fu.fused_update_cuda(
            got[0], g, *got[1:], q1, q2, **kw), 20)
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
              f"({by}), plain {plain:.3f} ms")
        del got, cm, cr

    # B4: lamb's norm prologue on (4, 8) states
    q1, q2 = qm(4), qm(8, False)
    cm, cr = codes(4), codes(8)
    state = (cm, am, cr, ar, q1, q2)
    norm_hyper = {k: v for k, v in hyper.items() if k != "lr"}
    want = fu.norm_partials_plain(p, g, *state, s, algo="lamb", bits_m=4,
                                  bits_r=8)
    got = fu.norm_partials_cuda(p, g, *state, algo="lamb", bits_m=4,
                                bits_r=8, **norm_hyper)
    n_bad, err = mismatches([got], [want])
    require(n_bad == 0, f"norm_partials/lamb_4_8: {n_bad} partials disagree "
            f"with the plain version (err {err})")
    ms = median_ms(torch, lambda: fu.norm_partials_cuda(
        p, g, *state, algo="lamb", bits_m=4, bits_r=8, **norm_hyper), 20)
    plain = median_ms(torch, lambda: fu.norm_partials_plain(
        p, g, *state, s, algo="lamb", bits_m=4, bits_r=8), 3, 2, 1)
    library = median_ms(torch, lambda: (torch.linalg.vector_norm(p, dim=1),
                                        torch.linalg.vector_norm(g, dim=1)),
                        20)
    b, by = bound_ms(n * 9.5 + nb * 40, n * 26)
    out["norm_partials/lamb_4_8"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=library)
    print(f"kernel norm_partials lamb_4_8 ({nb}x{bsz}): exact, 0 mismatches; "
          f"{ms:.4f} ms, bound {b:.4f} ms ({by}), plain {plain:.3f} ms, "
          f"torch.linalg.vector_norm of p and g {library:.4f} ms")
    del want, got, state, cm, cr

    # B1 / B2 at 4 bits; B1 also stochastic
    q4 = qm(4)
    x = torch.randn(nb, bsz, generator=gen, device=dev) * torch.exp(
        torch.randn(nb, 1, generator=gen, device=dev) * 3)
    x[0] = 0.0
    for name, seed in (("blockwise_quant/4bit", None),
                       ("blockwise_quant/4bit_sr", SEED + 11)):
        ck, ak = bq.quantize_blockwise(x, q4, bits=4, seed=seed)
        cp, ap = bq.quantize_plain(x, q4, bits=4, seed=seed)
        n_bad, err = mismatches([ck, ak], [cp, ap])
        require(n_bad == 0, f"{name}: {n_bad} packed codes or absmax "
                f"disagree with the plain version (err {err})")
        ms = median_ms(torch, lambda: bq.quantize_blockwise(
            x, q4, bits=4, seed=seed), 20)
        plain = median_ms(torch, lambda: bq.quantize_plain(
            x, q4, bits=4, seed=seed), 3, 2, 1)
        b, by = bound_ms(n * 4.5 + nb * 4 + 64,
                         n * (19 + (40 if seed is not None else 0)))
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                         bound_by=by, library_ms=None)
        print(f"kernel {name} ({nb}x{bsz} f32): exact; {ms:.4f} ms, bound "
              f"{b:.4f} ms ({by}), plain {plain:.3f} ms")
    vk = bdq.dequantize_blockwise(ck, ak, q4, bits=4)
    vp = bdq.dequantize_plain(ck, ak, q4, bits=4)
    n_bad, err = mismatches([vk], [vp])
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
    del x, ck, ak, cp, ap, vk, vp, p, g

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
                                 library_device_ms_small=library)
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


def check_gather_kernel(torch, dev) -> dict:
    """B7 against its plain version at the serve path's shapes: a pool of
    512 pages, 16 slots x 32 pages of 16 positions x 16 heads x 64, a
    scrambled table with -1 entries; 8 and 4 bits, bf16 (the path's
    dtype) and f32 out.  Exact: 0 mismatches."""
    from repro_torch.kernels import paged_kv
    B, P_, page, KV, Dh = (SERVE_SLOTS, SERVE_PAGES_PER_SEQ, SERVE_PAGE, 16,
                           64)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = torch.randn(SERVE_POOL, page, KV, Dh, generator=gen,
                       device=dev) * torch.exp(torch.randn(
                           SERVE_POOL, page, KV, 1, generator=gen,
                           device=dev) * 2)
    rows[1, 2] = 0.0                                   # all-zero rows
    table = torch.randperm(SERVE_POOL, generator=gen, device=dev)[
        :B * P_].reshape(B, P_).int()
    table[B // 4, P_ * 5 // 8:] = -1                  # unallocated tails
    table[B - 1] = -1
    pages_read = len(set(table.clamp(0, SERVE_POOL - 1).flatten().tolist()))
    out = {}
    for bits in (8, 4):
        codes, absmax = paged_kv.quantize_rows(rows, bits)
        W = codes.shape[-1]
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
            ms, plain = split["kernel"], split["plain"]
            n_out = B * P_ * page * KV * Dh
            osz = 2 if dt == torch.bfloat16 else 4
            b, by = bound_ms(pages_read * page * KV * (W + 4) + B * P_ * 4
                             + n_out * osz + (1 << bits) * 4, n_out)
            print(f"kernel paged_gather ({bits}-bit -> {dt}, {B}x{P_} pages "
                  f"of {page}x{KV}x{Dh}, {pages_read} distinct): exact, 0 "
                  f"mismatches; {ms:.4f} ms of device time, bound {b:.4f} "
                  f"ms ({by}), plain {plain:.4f} ms of device time; "
                  f"{call_ms:.4f} ms per call back to back by CUDA events "
                  f"(the host's launch rate)")
            if dt == torch.bfloat16:
                out[f"paged_gather/{bits}bit"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                    bound_by=by, library_ms=None)
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


def check_sentinel_kernels(torch, dev, nb: int = 10 * 1024 * 8192 // 2048,
                           bsz: int = 2048) -> dict:
    """B3(e), the fused update with the sentinel output, at the main path's
    largest leaf, for each of SENTINEL_VARIANTS on clean inputs and on
    inputs with NaN / +-inf / 1e31 planted in g and in one block's state:
    the health rows equal ``health_rows`` of the plain version exactly, p,
    codes and absmax equal the sentinel-off kernel's bit for bit (and the
    plain version's, NaN where it has NaN).  Timed on clean inputs against
    the sentinel-off kernel in turns (off, on, on, off)."""
    from repro_torch.core import qmap
    from repro_torch.core.lowbit import pack_codes
    from repro_torch.kernels import fused_update as fu

    n = nb * bsz
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
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

    def differ(a, b) -> int:
        """Values of a that differ from b (NaN matches NaN)."""
        if not a.is_floating_point():
            return int((a != b).sum())
        nan = a.isnan()
        return int((nan != b.isnan()).sum()) + int((a[~nan] != b[~nan])
                                                   .sum())

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
            n_plain = sum(differ(a, b) for a, b in zip(on, want[:5])
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
        run_on = lambda: fu.fused_update_cuda(st_on[0], g, *st_on[1:], q1,
                                              q2, sentinel=True, **kw)
        run_off = lambda: fu.fused_update_cuda(st_off[0], g, *st_off[1:],
                                               q1, q2, **kw)
        times = [median_ms(torch, fn, 20)
                 for fn in (run_off, run_on, run_on, run_off)]
        ms_off, ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        plain = median_ms(torch, lambda: fu.fused_update_plain(
            p, g, cm, am, cr, ar if two else None, q1, q2, s, algo=algo,
            tensor_scale=ts_v, uniforms=uniforms, bits_m=bits_m,
            bits_r=bits_r, sentinel=True), 3, 2, 1)
        # B3's bytes (p read and written, g read, codes read and written,
        # absmax and the trust ratio) plus the (nb, 8) f32 health rows
        per_elem = 12 + 2 * (bits_m + (bits_r if two else 0)) / 8
        ops_ = (56 if two else 30) + (40 if sr else 0) + 6
        b, by = bound_ms(n * per_elem + nb * ((16 if two else 8) + 32 +
                                              (4 if spec.needs_norms else 0))
                         + 2048, n * ops_)
        out[f"fused_update/sentinel_{variant}"] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
            library_ms=None, off_ms=ms_off)
        print(f"kernel fused_update sentinel {variant} ({nb}x{bsz}, bits "
              f"{bits_m}/{bits_r if two else '-'}): health rows exact (0 "
              f"mismatches) on clean and poisoned inputs, p/codes/absmax "
              f"bit-identical to the sentinel-off kernel; poisoned counts "
              f"{sums['poisoned']}; {ms:.4f} ms vs sentinel-off "
              f"{ms_off:.4f} ms ({ms / ms_off:.3f}x; turns "
              + ", ".join(f"{t:.4f}" for t in times) + f"), bound {b:.4f} "
              f"ms ({by}), plain {plain:.3f} ms")
        del st_on, st_off, cm, cr, uniforms
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ phase 4
def train(torch, dev, cfg, name: str, steps: int, batches, label=None,
          **opt_kw) -> dict:
    from repro_torch.core.optim import make_optimizer
    from repro_torch.train import loop as L

    label = label or name
    gen = torch.Generator(device=dev).manual_seed(SEED)
    opt = make_optimizer(name, lr=LR, weight_decay=WEIGHT_DECAY, device=dev,
                         **opt_kw)
    state, model = L.init_train_state(cfg, opt, gen, device=dev)
    step = L.make_train_step(cfg, model, opt)
    losses, ms, metrics = [], [], {}
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i])
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        print(f"train {label} step {i}: loss {losses[-1]:.6f}  "
              f"{ms[-1]:.1f} ms  grad_norm {metrics['grad_norm'].item():.4f}")
    return dict(opt=opt, state=state, step=step, losses=losses, ms=ms,
                metrics=metrics)


def profile_step(torch, step, state, batch):
    """Device time by kernel over one step (torch.profiler), and the
    step's wall time under the profiler."""
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
    return rows, wall_ms


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
                    label=label, **kw)
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
        if label == "muon8":
            prof, wall = profile_step(torch, run["step"], run["state"],
                                      batches[FAMILY_STEPS])
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
                           **kw)
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


# ------------------------------------------------------------------ phase 5
def checkpoint_roundtrip(torch, dev, cfg, batches, steps: int = 3) -> None:
    """lamb8 for ``steps`` steps, saved with the port's checkpoint and
    restored into a fresh state (another model, other weights); one more
    step from both must give bit-identical params, codes and absmax.  The
    checkpoint goes to a directory under build/ and is removed after."""
    from repro_torch.core.optim import make_optimizer
    from repro_torch.train import checkpoint as C
    from repro_torch.train import loop as L

    def fresh(seed):
        opt = make_optimizer("lamb8", lr=LR, weight_decay=WEIGHT_DECAY,
                             device=dev)
        state, model = L.init_train_state(
            cfg, opt, torch.Generator(device=dev).manual_seed(seed),
            device=dev)
        return state, L.make_train_step(cfg, model, opt)

    state, step = fresh(SEED)
    for i in range(steps):
        state, _ = step(state, batches[i])
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(dir=ROOT / "build", prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        path = C.save(ckpt, steps, state)
        size = sum(f.stat().st_size for f in Path(path).iterdir())
        state_b, step_b = fresh(SEED + 1)
        state_b = C.restore(ckpt, steps, state_b)
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    state, _ = step(state, batches[steps])
    state_b, _ = step_b(state_b, batches[steps])
    torch.cuda.synchronize()
    pairs = list(zip(C._flatten(state), C._flatten(state_b)))
    n_bad = sum(not (a == b if isinstance(a, int) else torch.equal(a, b))
                for (_, a), (_, b) in pairs)
    require(n_bad == 0, f"checkpoint: {n_bad} of {len(pairs)} arrays differ "
            f"after step {steps + 1} from the restored lamb8 state")
    print(f"checkpoint lamb8: saved after {steps} steps ({size / 1e9:.2f} "
          f"GB), restored into a fresh state in {secs:.1f} s; step "
          f"{steps + 1} from both bit-identical ({len(pairs)} arrays: "
          f"params, codes, absmax, 32-bit moments, step counts)")


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
        want = TEL_STEPS * n_quant
        require(counts["fused_update"] == want and
                counts["fused_update_sentinel"] == want,
                f"telemetry: fused_update launched {counts['fused_update']} "
                f"times ({counts['fused_update_sentinel']} with the "
                f"sentinel), expected {TEL_STEPS} steps x {n_quant} leaves "
                f"= {want}, all through B3(e)")
        probes = TEL_STEPS // TEL_EVERY
        require(counts["blockwise_quant"] == probes * n_quant and
                counts["blockwise_dequant"] == probes * n_quant,
                f"telemetry: probe round trips launched {counts}, expected "
                f"{probes} probes x {n_quant} leaves of B1 and B2")
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
                    label=f"{variant} --sentinel", sentinel=True, **kw)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import base
    from repro_torch.core.optim import Quant8Leaf
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import build, ops

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

    # ---- 2. build
    t0 = time.perf_counter()
    secs = build.build()
    print(f"build: {len(secs)} kernels compiled in "
          f"{time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())}) "
          f"into {build.build_dir().relative_to(ROOT)}")
    for name in build.SOURCES:
        log = (build.build_dir() / f"{name}.log")
        entry, spill = "?", ""
        for line in log.read_text().splitlines() if log.exists() else ():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "spill" in line:
                spill = line.split(":", 1)[-1].strip()
            elif "registers" in line:
                # kernel<template arguments> from the mangled name
                hit = re.search(r"\d([a-z_]+_kernel)I(.+?)EEv", entry)
                plain = re.search(r"([a-z_]+_kernel)E", entry)
                short = (f"{hit.group(1)}<" + ",".join(re.findall(
                    r"L[ib](\d+)E", hit.group(2))) + ">") if hit else (
                    plain.group(1) if plain else entry)
                print(f"build: {name}: {short}: "
                      f"{line.split(':', 1)[-1].strip()}; {spill}")

    # ---- 3. kernels vs plain versions
    kernels = check_kernels(torch, dev)
    torch.cuda.empty_cache()
    kernels.update(check_slice3_kernels(torch, dev))
    torch.cuda.empty_cache()
    kernels.update(check_gather_kernel(torch, dev))
    torch.cuda.empty_cache()
    kernels.update(check_sentinel_kernels(torch, dev))
    torch.cuda.empty_cache()

    # ---- 4. train
    cfg = base.get_config("paper-lm-209m")
    pipe = SyntheticLMPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ_LEN,
                                          global_batch=BATCH, seed=SEED))
    batches = [pipe.batch_at(i) for i in range(STEPS + 1)]
    ops.reset_launch_counts()
    ops.reset_fused_update_count()
    run8 = train(torch, dev, cfg, "adamw8", STEPS, batches)
    n_quant = readback(torch, run8["opt"], run8["state"])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    m8 = run8["metrics"]
    print(f"train adamw8: {n_quant} quantized leaves; opt_fused_dispatches "
          f"{m8['opt_fused_dispatches']:.0f}/step; state_bytes_per_param "
          f"{m8['state_bytes_per_param']:.4f}; launches {launches}; "
          f"median step {statistics.median(run8['ms'][1:]):.1f} ms "
          f"(steps 1..{STEPS - 1})")
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
                    label=variant, stochastic_rounding=sr)
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

    # ---- 5. checkpoint
    checkpoint_roundtrip(torch, dev, cfg, batches)
    torch.cuda.empty_cache()

    # ---- 6. serve
    serve_phase(torch, dev, cfg, run_launches, step_launches, run_steps)

    # ---- 7. telemetry: the train launcher with the sentinel (B3(e))
    telemetry_phase(torch, dev, cfg, batches, n_quant, run_launches,
                    step_launches, run_steps)

    # ---- 8. summary
    rows = []
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
                    "library_device_ms_small"):
            if key in k:
                rows[-1][key] = k[key]
        require(rows[-1]["launches"] > 0, f"{name}: no launch in the {run} "
                f"run")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
