"""Quickstart of the PyTorch port: the paper's "two-line code change".

Train the same tiny LM twice — once with the 32-bit optimizer, once with
its quantized twin (block-wise dynamic quantization + stable embedding) —
through the ``torch.optim.Optimizer`` face and the plain PyTorch loop
(``loss.backward(); opt.step(); opt.zero_grad()``, with the repo's
global-norm clip).  Same hyperparameters, same data, same final loss, ~4x
less optimizer-state memory (more with sub-byte states).

    python examples/quickstart_torch.py                 # on the GPU
    python examples/quickstart_torch.py --device cpu    # plain PyTorch
    python examples/quickstart_torch.py --bits 4   # packed 4-bit first
                                                   # moment, 8-bit second
    python examples/quickstart_torch.py --algo muon  # quantized matrix
                          # momentum + Newton-Schulz updates on 2-D leaves
    python examples/quickstart_torch.py --no-pooled  # per-leaf dispatch
                          # (one fused launch per leaf; bit-identical)
    python examples/quickstart_torch.py --partition 4 --shard-grads \
        --overlap 4       # ZeRO-1 spans x 4 buckets, ZeRO-2 gradients
                          # (16 launches a step; bit-identical)

``--algo`` accepts any registered algorithm (adam/adamw/momentum/lamb/
lars/adagrad/muon): the script compares ``<algo>32`` against ``<algo>8``.
The quantized run is pooled by default: one fused launch updates every
quantized leaf.
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import device as device_lib  # noqa: E402
from repro_torch import telemetry as tel  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core.optim import ALGOS, BlockOptimizer  # noqa: E402
from repro_torch.data.pipeline import (DataConfig,  # noqa: E402
                                       SyntheticLMPipeline)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.telemetry import tracing  # noqa: E402
from repro_torch.train import loop as L  # noqa: E402

# Registry gauges surfaced in the final summary table, in display order:
# (metric name, row label, format)
SUMMARY_ROWS = (
    ("train/loss", "final loss", "{:.4f}"),
    ("train/state_bytes_per_param", "state bytes/param", "{:.3f}"),
    ("train/grad_buffer_bytes_per_param", "+ arena grad buffer B/param",
     "{:.3f}"),
    ("train/opt_fused_dispatches", "fused dispatches/step", "{:.0f}"),
    ("train/steady_ms", "steady ms/step", "{:.1f}"),
)


def run(opt_name: str, steps: int = 80, device="cuda", telemetry_dir=None,
        telemetry_every: int = 0, **opt_kw):
    dev = device_lib.resolve(device)
    cfg = base.reduced(base.get_config("paper-lm-209m"),
                       d_model=128, n_layers=2, vocab_size=256)
    pipe = SyntheticLMPipeline(DataConfig(vocab_size=256, seq_len=64,
                                          global_batch=8))
    model = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    if telemetry_every:
        opt_kw["telemetry_every"] = telemetry_every
    opt = BlockOptimizer(model.named_parameters(), opt_name,  # <- the swap
                         lr=5e-3, device=dev, **opt_kw)
    reg = tel.MetricRegistry()
    probe = None
    prev_tracing = tracing.phase_tracing_enabled()
    if telemetry_dir:
        reg.add_sink(tel.JsonlSink(
            os.path.join(telemetry_dir, f"{opt_name}.jsonl")))
        tracing.set_phase_tracing(True)
        tracing.reset_trace_events()
        if telemetry_every and getattr(opt.engine, "_qmap1", None) \
                is not None:
            probe = tel.QHealthProbe(opt.engine)
    timer = tracing.StepTimer()
    try:
        for i in range(steps):
            with timer.step():
                tokens = torch.as_tensor(pipe.batch_at(i)["tokens"]).to(dev)
                logits, _ = M.forward(cfg, model, tokens[:, :-1])
                loss = L.cross_entropy(logits, tokens[:, 1:])
                loss.backward()
                L.clip_by_global_norm({k: p.grad for k, p in
                                       model.named_parameters()}, 1.0)
                dispatch0 = ops.fused_update_count()
                opt.step()
                opt.zero_grad()
                m = {"loss": loss.detach(),
                     "opt_fused_dispatches":
                         ops.fused_update_count() - dispatch0}
                m = tel.registry.host_scalars(m)   # waits for the step
            reg.record_scalars(i, m, prefix="train/")
            if telemetry_dir:
                reg.emit_event({"kind": "phase", "step": i, "phase": "step",
                                "wall_s": timer.last_dt})
                if probe is not None and (i + 1) % telemetry_every == 0:
                    with tracing.host_phase("qhealth_probe", step=i):
                        for ev in probe.probe(opt.opt_state, step=i):
                            reg.emit_event(ev)
                    for ev in tracing.drain_phase_events():
                        reg.emit_event(ev)
    finally:
        tracing.set_phase_tracing(prev_tracing)
    sb = opt.engine.state_bytes(opt.opt_state)
    reg.gauge("train/state_bytes_per_param").set(sb["state_bytes"]
                                                 / sb["n_params"])
    # the pooled arena's gradient buffer (beside autograd's gradients) is
    # not optimizer state and is left out of state_bytes
    arena = getattr(opt.opt_state, "arena", None)
    grad_bytes = 0 if arena is None or arena.grad is None \
        else arena.grad.numel() * 4
    reg.gauge("train/grad_buffer_bytes_per_param").set(grad_bytes
                                                       / sb["n_params"])
    reg.gauge("train/steady_ms").set(timer.steady_ms())
    if telemetry_dir:
        reg.flush(step=steps - 1)
        reg.close()
    extra = ""
    if "owned_state_bytes" in sb:
        extra = (f"  (owned by each: {sb['owned_state_bytes'] / 1e6:.2f} MB "
                 f"over {sb['partition_shards']} owners)")
    print(f"{opt_name:8s} final loss {m['loss']:.4f}  optimizer "
          f"statistics: {sb['state_bytes'] / 1e6:.2f} MB{extra}  (not "
          f"counted: the arena's gradient buffer, {grad_bytes / 1e6:.2f} "
          f"MB)")
    return m["loss"], sb["state_bytes"], reg


def summary_table(runs) -> str:
    """One column per run, one row per SUMMARY_ROWS gauge present."""
    names = [n for n, _ in runs]
    width = max(12, *(len(n) for n in names))
    lines = [" " * 28 + "  ".join(f"{n:>{width}}" for n in names)]
    for key, label, fmt in SUMMARY_ROWS:
        vals = [reg.get(key) for _, reg in runs]
        if all(v is None for v in vals):
            continue
        cells = [fmt.format(v) if v is not None else "-" for v in vals]
        lines.append(f"{label:<28}" + "  ".join(f"{c:>{width}}"
                                                for c in cells))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="adam", choices=sorted(ALGOS),
                    help="algorithm to compare at 32 vs quantized state")
    ap.add_argument("--bits", type=int, default=8, choices=[4, 5, 6, 8],
                    help="first-moment storage bitwidth for the quantized "
                         "run (second moment stays 8-bit)")
    ap.add_argument("--no-pooled", action="store_true",
                    help="per-leaf dispatch instead of the pooled arena "
                         "(one fused launch per leaf; bit-identical)")
    ap.add_argument("--partition", type=int, default=0, metavar="N",
                    help="ZeRO-1 partition of the pooled arena over N "
                         "owners: the update runs once per owned block "
                         "span (bit-identical to the unpartitioned run)")
    ap.add_argument("--shard-grads", action="store_true",
                    help="ZeRO-2: the gradients go through the arena's "
                         "block-domain buffer (bit-identical)")
    overlap = ap.add_mutually_exclusive_group()
    overlap.add_argument("--overlap", type=int, default=1, metavar="N",
                         help="bucketed dispatch: each owned span's update "
                              "in N buckets (bit-identical)")
    overlap.add_argument("--no-overlap", action="store_true",
                         help="one update per owned span")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--telemetry-dir", default=None, metavar="DIR",
                    help="emit telemetry JSONL per run (metrics, step "
                         "phases, qhealth probes) into DIR/<run>.jsonl")
    ap.add_argument("--telemetry-every", type=int, default=0, metavar="N",
                    help="quantization-health probe every N steps "
                         "(0 = off; probes need --telemetry-dir)")
    args = ap.parse_args(argv)
    opt_kw = {} if args.bits == 8 else {"state_bits": (args.bits, 8)}
    if args.no_pooled:
        opt_kw["pooled"] = False
    if args.partition:
        if args.no_pooled:
            ap.error("--partition subdivides the pooled arena and cannot "
                     "combine with --no-pooled")
        opt_kw.update(partition=True, partition_shards=args.partition)
    if args.shard_grads:
        if args.no_pooled:
            ap.error("--shard-grads accumulates gradients in the pooled "
                     "arena's block domain and cannot combine with "
                     "--no-pooled")
        opt_kw["shard_grads"] = True
    if args.overlap > 1 and not args.no_overlap:
        if not args.partition:
            ap.error("--overlap N buckets the span-partitioned update; it "
                     "needs --partition N")
        opt_kw["overlap_buckets"] = args.overlap
    kw = dict(steps=args.steps, device=args.device,
              telemetry_dir=args.telemetry_dir,
              telemetry_every=args.telemetry_every)
    l32, b32, reg32 = run(f"{args.algo}32", **kw)
    l8, b8, reg8 = run(f"{args.algo}8", **kw, **opt_kw)
    print(f"\nloss diff: {abs(l8 - l32):.4f}   state memory: "
          f"{b32 / b8:.1f}x smaller")
    print("\n" + summary_table(((f"{args.algo}32", reg32),
                                (f"{args.algo}8", reg8))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
