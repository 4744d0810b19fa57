#!/usr/bin/env python3
"""Time the port's train attention (``models/layers.py``) forward and
backward on one card, its forms in turns on the same inputs.

    python3 scripts/attn_turns.py [--reps N]

Shapes (bf16 q, k, v as the model's compute dtype gives them; f32 scores):

- ``paper-lm-209m`` at chip_smoke.py's train shape (batch 8, seq 512, 16
  heads of 64): one chunk of the published ``attn_chunk`` 1024 holds every
  key, so ``causal_attention`` takes the softmax (``_softmax_attention``);
  timed in turns with the online softmax over that one chunk
  (``_online_attention``), which computes the same function;
- ``stablelm-1.6b`` at train_4k's length (batch 2, seq 4096, 32 heads of
  64): the online softmax over 4 chunks of 1024, in turns with the
  softmax over one chunk of 4096 (the whole (S, S) scores).

Each form: a forward and backward with gradients to q, k and v, each
chunk under its checkpoint as in a train step (so the backward recomputes
the scores), timed by CUDA events over ``--reps`` calls after a warm-up,
in turns (a, b, b, a, ...); its peak memory from a reset; and the largest
difference of the outputs and gradients between the two forms.  Prints
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# label -> (batch, seq, heads, head_dim, chunk of the online form)
SHAPES = {"paper-lm-209m": (8, 512, 16, 64, 512),
          "stablelm-1.6b": (2, 4096, 32, 64, 1024)}


def forms(L, torch, B, S, H, D, chunk):
    """{name: f(q, k, v) -> (B, S, H, D)} of the two forms."""
    def grouped(q):
        return (q.reshape(B, S, H, 1, D) * (D ** -0.5)).to(
            torch.float32).permute(0, 2, 3, 1, 4)

    def run(attend):
        def f(q, k, v):
            q_pos = torch.arange(S, device=q.device)
            out = attend(grouped(q), k, v, q_pos)
            return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
        return f

    return {"softmax": run(lambda qh, k, v, p: L._softmax_attention(
                qh, k, v, p, 0)),
            f"online_{S // chunk}x{chunk}": run(
                lambda qh, k, v, p: L._online_attention(qh, k, v, p, 0,
                                                        chunk))}


def time_shape(torch, L, dev, label: str, shape: tuple, reps: int,
               card: str) -> None:
    """The two forms at ``shape`` (``SHAPES``' tuple): checked against each
    other, their peaks, and timed in turns."""
    B, S, H, D, chunk = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, g = (torch.randn(B, S, H, D, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    fns = forms(L, torch, B, S, H, D, chunk)
    outs, peaks = {}, {}

    def call(name):
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = fns[name](qq, kk, vv)
        out.backward(g.to(out.dtype))
        return out.detach(), qq.grad, kk.grad, vv.grad

    for name in fns:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        outs[name] = call(name)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
    a, b = outs.values()
    err = max((x.float() - y.float()).abs().max().item()
              for x, y in zip(a, b))
    del outs, a, b
    times = {name: [] for name in fns}
    order = list(fns)
    for r in range(reps):
        for name in (order if r % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(name)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    print(f"attn_turns {label} (batch {B}, seq {S}, {H} heads of {D}, bf16 "
          f"in, f32 scores), forward + backward in turns ({reps} each): "
          + "; ".join(f"{n} median {statistics.median(t):.3f} ms, peak "
                      f"{peaks[n]} B" for n, t in times.items())
          + f"; largest difference of outputs and gradients {err:.3g}; "
          f"{card}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    from repro_torch.models import layers as L
    if not torch.cuda.is_available():
        print("attn_turns: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"attn_turns: {torch.cuda.get_device_name(0)}; {card}; torch "
          f"{torch.__version__}")
    for label, shape in SHAPES.items():
        time_shape(torch, L, dev, label, shape, args.reps, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
