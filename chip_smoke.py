#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

The paper's two-line change at full width: ``make_optimizer("adamw8")``
trains paper-lm-209m (10 layers, d_model 1024, vocab 50264, bf16 compute,
f32 masters) for a few steps on synthetic data, through the port's
hand-written CUDA kernels.  Phases, one line or more each:

1. device  — require CUDA (exit 2 without it).
2. build   — compile every kernel from ``src/repro_torch/kernels/csrc``.
3. kernels — each kernel against its plain PyTorch version on the card, at
   the main path's largest leaf (blocks/b0_attn/mlp/w_in: 40960 blocks of
   2048); exact agreement is required (fused update: code mismatches only
   within 2 f32 ULP of a codebook midpoint, counted).  Median times beside
   the least time the card could take (bytes over 3.35 TB/s, f32 operations
   over 67 TFLOP/s: the H100 SXM data-sheet peaks).
4. train   — launch counters zeroed, then the main path: adamw8 train steps
   (per-leaf dispatch), then a read-back of the trained 8-bit state through
   the kernel layer (both moments dequantized; the second moment
   requantized, which must give back its codes and absmax exactly),
   counters read.  The fused-update count must equal steps x
   quantized leaves; losses must be finite and fall.  Then the same steps
   with adamw32, both final losses on one line (reported, not gated), and a
   profile of one adamw8 step by kernel.
5. summary — the kernels JSON line, the card's name and power limit, and
   the last line ``{"ok": true, "device": {...}}``.

Any failure raises: the script then exits non-zero without the last line.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM, f32 outside the tensor cores
STEPS = 10
SEQ_LEN, BATCH = 512, 8
LR, WEIGHT_DECAY = 1e-3, 0.01
SEED = 0

KERNEL_META = {
    "blockwise_quant": ("src/repro_torch/kernels/csrc/blockwise_quant.cu",
                        "src/repro/kernels/blockwise_quant.py:46"),
    "blockwise_dequant": ("src/repro_torch/kernels/csrc/blockwise_dequant.cu",
                          "src/repro/kernels/blockwise_dequant.py:41"),
    "fused_update": ("src/repro_torch/kernels/csrc/fused_update.cu",
                     "src/repro/kernels/fused_update.py:642"),
}


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
    from repro_torch.kernels import common, ops
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

    # B3(a) fused adamw update: one step from random nonzero states
    p = torch.randn(nb, bsz, generator=gen, device=dev) * 0.02
    g = torch.randn(nb, bsz, generator=gen, device=dev) * 1e-3
    cm = torch.randint(0, 256, (nb, bsz), generator=gen, device=dev,
                       dtype=torch.uint8)
    cr = torch.randint(0, 256, (nb, bsz), generator=gen, device=dev,
                       dtype=torch.uint8)
    am = torch.rand(nb, generator=gen, device=dev) * 1e-3 + 1e-5
    ar = torch.rand(nb, generator=gen, device=dev) * 1e-6 + 1e-9
    hyper = dict(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=WEIGHT_DECAY, step=7.0, gnorm_scale=1.0)
    s = fu.scalars(device=dev, **hyper)
    want = fu.fused_update_plain(p, g, cm, am, cr, ar, qs, qu, s,
                                 algo="adamw")
    got = [t.clone() for t in (p, g, cm, am, cr, ar)]
    ops.fused_update("adamw", *got, qs, qu, **hyper)
    kp, _, kcm, kam, kcr, kar = got
    require(torch.equal(kp, want.p), "fused_update: p disagrees with the "
            f"plain version (err {(kp - want.p).abs().max().item()})")
    require(torch.equal(kam, want.absmax_m) and torch.equal(kar, want.absmax_r),
            "fused_update: absmax disagrees with the plain version")
    # code mismatches are allowed only within 2 ULP of a midpoint
    m = common.decode(cm, qs) * am[:, None]
    r = common.decode(cr, qu) * ar[:, None]
    m2, r2, _ = fu.update_math(fu.ALGO_SPECS["adamw"], g * s["gnorm_scale"],
                               p, m, r, s)
    n_mis = 0
    for x2, a2, kc, wc, q in ((m2, want.absmax_m, kcm, want.codes_m, qs),
                              (r2, want.absmax_r, kcr, want.codes_r, qu)):
        bad = kc != wc
        k = int(bad.sum())
        n_mis += k
        if k:
            xn = (x2 / torch.where(a2 > 0, a2, 1.0)[:, None])[bad]
            lo = torch.minimum(kc[bad], wc[bad]).long()
            bnd = common.padded_bounds(q)[0][lo]
            ulp = (torch.nextafter(bnd, torch.full_like(bnd, math.inf)) - bnd)
            near = ((xn - bnd).abs() <= 2 * ulp) & \
                   ((kc[bad].int() - wc[bad].int()).abs() == 1)
            require(bool(near.all()), f"fused_update: {k} code mismatches, "
                    f"{int((~near).sum())} not within 2 ULP of a midpoint")
    err = max((kp - want.p).abs().max().item(),
              (kam - want.absmax_m).abs().max().item(),
              (kar - want.absmax_r).abs().max().item(),
              (kcm.int() - want.codes_m.int()).abs().max().item(),
              (kcr.int() - want.codes_r.int()).abs().max().item())
    del want, m, r, m2, r2
    ms = median_ms(torch, lambda: ops.fused_update("adamw", *got, qs, qu,
                                                   **hyper), 20)
    plain = median_ms(torch, lambda: fu.fused_update_plain(
        p, g, cm, am, cr, ar, qs, qu, s, algo="adamw"), 3, 2, 1)
    b, by = bound_ms(n * 16 + nb * 16 + 2048, n * 56)
    out["fused_update"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                               bound_ms=b, bound_by=by)
    print(f"kernel fused_update adamw8 ({nb}x{bsz}): p and absmax exact, "
          f"{n_mis} code mismatches (all within 2 ULP of a midpoint); "
          f"{ms:.4f} ms, bound {b:.4f} ms ({by}), plain {plain:.3f} ms")
    return out


# ------------------------------------------------------------------ phase 4
def train(torch, dev, cfg, name: str, steps: int, batches) -> dict:
    from repro_torch.core.optim import make_optimizer
    from repro_torch.train import loop as L

    gen = torch.Generator(device=dev).manual_seed(SEED)
    opt = make_optimizer(name, lr=LR, weight_decay=WEIGHT_DECAY, device=dev)
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
        print(f"train {name} step {i}: loss {losses[-1]:.6f}  "
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import base
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

    # ---- 5. summary
    rows = []
    for name, (source, replaces) in KERNEL_META.items():
        k = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": None})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
