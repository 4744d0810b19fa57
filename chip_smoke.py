#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py

The paper's two-line change at full width: ``make_optimizer("adamw8")`` —
and the rest of the element-wise 8-bit family, momentum8, lars8, lamb8,
adagrad8 and stochastic-rounding adamw8 — trains paper-lm-209m (10
layers, d_model 1024, vocab 50264, bf16 compute, f32 masters) for a few
steps on synthetic data, through the port's hand-written CUDA kernels.
Phases, one line or more each:

1. device  — require CUDA (exit 2 without it).
2. build   — compile every kernel from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all in parallel).
3. kernels — each kernel and variant against its plain PyTorch version on
   the card, at the main path's largest leaf (blocks/b0_attn/mlp/w_in:
   40960 blocks of 2048): quantize, dequantize, the fused update for
   adamw8, stochastic adamw8, momentum8, lars8, lamb8 and adagrad8, and the
   lars/lamb norm prologue.  Exact agreement is required (p, codes, absmax,
   partials: 0 mismatches).  Median times beside the least time the card
   could take (bytes over 3.35 TB/s, f32 operations over 67 TFLOP/s: the
   H100 SXM data-sheet peaks), the plain version's time and, for the norm
   prologue, torch.linalg.vector_norm's.
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
   and 32-bit final losses must agree within 1%.
5. checkpoint — lamb8 for 3 steps, saved with the port's checkpoint,
   restored into a fresh state; step 4 from both must give bit-identical
   params, codes and absmax.
6. summary — the kernels JSON line, the card's name and power limit, and
   the last line ``{"ok": true, "device": {...}}``.

Any failure raises: the script then exits non-zero without the last line.
"""
from __future__ import annotations

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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def median_ms(torch, fn, reps: int, per: int = 5, warmup: int = 2) -> float:
    """Median over ``reps`` of the device time of ``per`` back-to-back
    calls of ``fn`` divided by ``per`` (CUDA events around each group, so
    the host runs ahead and its launch overhead is hidden; inputs far
    exceed the 50 MB L2, so every call reads HBM)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


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
        for line in log.read_text().splitlines() if log.exists() else ():
            if "registers" in line:
                print(f"build: {name}: {line.strip()}")

    # ---- 3. kernels vs plain versions
    kernels = check_kernels(torch, dev)
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

    # ---- 5. checkpoint
    checkpoint_roundtrip(torch, dev, cfg, batches)

    # ---- 6. summary
    rows = []
    for name, (source, replaces, counter) in KERNEL_META.items():
        k = kernels[name]
        run = name.split("/")[-1] if "/" in name else "adamw8"
        run = {"lars": "lars8", "lamb": "lamb8"}.get(run, run)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": run_launches[run][counter],
                     "launches_per_step":
                         step_launches[run][counter] / run_steps[run],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k.get("library_ms")})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
