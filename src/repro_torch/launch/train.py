"""End-to-end training launcher (mirrors ``repro.launch.train``):
config-driven, fault-tolerant, with the observability stack.

  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-lm-209m \
      --optimizer adamw8 --steps 300 --seq-len 512 --batch 8 \
      --sentinel --telemetry-dir artifacts/run1 --telemetry-every 50 \
      --flight-dir artifacts/run1/flight --ckpt-dir artifacts/run1/ckpt

Trains the model (f32 parameters and compute, as the JAX launcher's
overrides) on ``SyntheticLMPipeline`` batches through the port's optimizer
engine, on the card unless ``--device cpu``.  ``--partition N`` runs the
8-bit update once per owned block span of N (one process), ``--shard-grads``
accumulates the gradients in the arena's block domain (ZeRO-2) and
``--overlap-buckets N`` splits each span's update into N buckets; every
one of them leaves the run bit-identical.

Fault tolerance: resumes from the latest checkpoint in ``--ckpt-dir``
(the JAX package's checkpoint format, so a JAX run's checkpoint resumes
here too); SIGTERM/SIGINT checkpoints and exits; per-step wall times are
z-scored and stragglers logged.

Observability: ``--telemetry-dir`` writes ``telemetry.jsonl`` in the JAX
package's schema (step metrics, phase timings, the first step's dispatch
accounting, qhealth probes every ``--telemetry-every`` steps, anomalies);
``--sentinel`` turns on the fused update's health counts (kernel B3(e))
and the anomaly detectors; ``--flight-dir`` keeps a ring of step metrics
and a host copy of the last healthy state (every
``--flight-snapshot-every`` steps) and dumps both on a fatal anomaly.

Exit codes: 0 when the run completes (or is preempted and checkpointed),
2 when it diverges (nonfinite loss or a fatal anomaly).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal

import numpy as np
import torch

from repro_torch.telemetry.registry import host_scalars


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="paper-lm-209m")
    ap.add_argument("--optimizer", default="adam8")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--qmap", default="dynamic")
    ap.add_argument("--state-bits", default=None,
                    help="per-slot storage bitwidth for quantized states: "
                         "'4' or '4,8' (m,r); default 8-bit")
    ap.add_argument("--no-blockwise", action="store_true")
    ap.add_argument("--no-stable-embedding", action="store_true")
    ap.add_argument("--no-32bit-embed-override", action="store_true")
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--out", default=None, help="metrics JSONL path")
    ap.add_argument("--partition", type=int, default=0, metavar="N",
                    help="ZeRO-1 partition of the pooled arena over N "
                         "owners: the update runs once per owned block "
                         "span (bit-identical to the unpartitioned run)")
    ap.add_argument("--shard-grads", action="store_true",
                    help="ZeRO-2: accumulate the gradients in the arena's "
                         "block domain (bit-identical)")
    ap.add_argument("--overlap-buckets", type=int, default=1, metavar="N",
                    help="subdivide each owned span's update (and the "
                         "gradients' reduce-scatter) into N buckets; needs "
                         "--partition")
    ap.add_argument("--telemetry-dir", default=None,
                    help="emit telemetry JSONL (metrics, step phases, "
                         "qhealth probes) into this directory")
    ap.add_argument("--telemetry-every", type=int, default=0,
                    help="run quantization-health probes every N steps "
                         "(0 = off; requires --telemetry-dir)")
    ap.add_argument("--sentinel", action="store_true",
                    help="numerics sentinel: the fused update counts "
                         "nonfinite/overflow/saturation per block and host "
                         "detectors escalate anomalies")
    ap.add_argument("--flight-dir", default=None,
                    help="flight-recorder dump directory: on a fatal "
                         "anomaly or nonfinite loss, dump the metrics ring "
                         "and the last healthy state here")
    ap.add_argument("--flight-ring", type=int, default=64,
                    help="flight-recorder ring length (steps)")
    ap.add_argument("--flight-snapshot-every", type=int, default=1,
                    help="host copy of the state every N healthy steps "
                         "(a copy of a full-width state is ~1.5 GB)")
    return ap


def model_config(args):
    """The arch's config with the launcher's overrides (f32 params and
    compute, no remat, optional width/depth/vocab cuts)."""
    from repro_torch.configs import base as cfgs
    cfg = cfgs.get_config(args.arch)
    over = {"param_dtype": "float32", "compute_dtype": "float32",
            "remat": "none"}
    if args.d_model:
        over.update(d_model=args.d_model, head_dim=args.d_model // cfg.n_heads)
    if args.n_layers:
        over["n_layers"] = args.n_layers
    if args.vocab:
        over["vocab_size"] = args.vocab
    if args.no_stable_embedding:
        over["stable_embedding"] = False
    return dataclasses.replace(cfg, **over)


def setup(args, dev):
    """(cfg, pipe, opt, hyper) of a run: the model config, the data, the
    optimizer and the train hyperparameters the launcher builds from
    ``args`` (also used to rebuild a run around a flight dump)."""
    from repro_torch.core.optim import make_optimizer
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.train import loop as train_loop

    cfg = model_config(args)
    pipe = SyntheticLMPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch, seed=1234))

    opt_kw = {}
    if args.optimizer.endswith("8"):
        opt_kw.update(qmap_m=args.qmap, qmap_r=args.qmap,
                      blockwise_norm=not args.no_blockwise)
        if args.state_bits:
            parts = [int(b) for b in args.state_bits.split(",")]
            opt_kw["state_bits"] = parts[0] if len(parts) == 1 \
                else tuple(parts)
        if args.no_32bit_embed_override:
            opt_kw["override_32bit"] = lambda p: False
    if args.partition:
        opt_kw.update(partition=True, partition_shards=args.partition)
    if args.shard_grads:
        opt_kw["shard_grads"] = True
    if args.overlap_buckets > 1:
        opt_kw["overlap_buckets"] = args.overlap_buckets
    if args.telemetry_every:
        opt_kw["telemetry_every"] = args.telemetry_every
    if args.sentinel:
        opt_kw["sentinel"] = True
    opt = make_optimizer(args.optimizer, lr=args.lr, weight_decay=0.0,
                         device=dev, **opt_kw)
    hyper = train_loop.TrainHyper(
        microbatches=args.microbatches,
        lr_schedule=train_loop.warmup_cosine(args.lr, args.warmup,
                                             args.steps))
    return cfg, pipe, opt, hyper


def main(argv=None) -> int:
    from repro_torch import device as device_lib
    from repro_torch import telemetry as tel
    from repro_torch.telemetry import tracing
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import loop as train_loop

    ap = build_parser()
    args = ap.parse_args(argv)
    if args.overlap_buckets > 1 and not args.partition:
        ap.error("--overlap-buckets N buckets the span-partitioned update; "
                 "it needs --partition N")
    dev = device_lib.resolve(args.device)
    cfg, pipe, opt, hyper = setup(args, dev)

    # Telemetry: a typed registry over a JSONL sink, phase annotation on.
    reg = probe = None
    telemetry_jsonl = None
    if args.telemetry_dir:
        telemetry_jsonl = os.path.join(args.telemetry_dir, "telemetry.jsonl")
        reg = tel.MetricRegistry()
        reg.add_sink(tel.JsonlSink(telemetry_jsonl))
        tracing.set_phase_tracing(True)
        tracing.reset_trace_events()
        probe = tel.QHealthProbe(opt)
    detector = tel.AnomalyDetector() if (args.sentinel or args.flight_dir) \
        else None
    flight = (tel.FlightRecorder(ring=args.flight_ring,
                                 snapshot_every=args.flight_snapshot_every)
              if args.flight_dir else None)

    def emit(events):
        for ev in events:
            reg.emit_event(ev)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state, model = train_loop.init_train_state(cfg, opt, gen, device=dev)
    step_fn = train_loop.make_train_step(cfg, model, opt, hyper)

    start = 0
    if args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            state = ckpt.restore(args.ckpt_dir, latest, state)
            start = latest
            print(f"[resume] from step {latest}")

    stop = {"now": False}

    def _sig(_s, _f):   # preemption: checkpoint + clean exit
        stop["now"] = True
    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)

    out_f = open(args.out, "a") if args.out else None
    timer = tracing.StepTimer()
    loss = float("nan")
    try:
        for i in range(start, args.steps):
            with timer.step():
                state, metrics = step_fn(state, pipe.batch_at(i))
                m = host_scalars(metrics)      # waits for the whole step
            loss, dt = m["loss"], timer.last_dt
            if i == start:
                print(f"[compile] first step {dt:.2f}s (excluded from "
                      f"ms/step)")
                if reg is not None:
                    reg.emit_event(tracing.trace_event_dict(i))
            tracing.reset_trace_events()
            if timer.is_straggler:
                print(f"[straggler] step {i}: {dt:.3f}s "
                      f"z={timer.straggler_z:.1f}")
            rec = {"step": i, "loss": loss, "t": round(dt, 4),
                   "grad_norm": m["grad_norm"]}
            if i == start:
                rec["compile_s"] = round(timer.compile_s, 4)
            if out_f:
                out_f.write(json.dumps(rec) + "\n")
                out_f.flush()
            if reg is not None:
                reg.record_scalars(i, m, prefix="train/")
                reg.emit_event({"kind": "phase", "step": i, "phase": "step",
                                "wall_s": dt})
                if probe is not None and args.telemetry_every and \
                        (i + 1) % args.telemetry_every == 0:
                    with tracing.host_phase("qhealth_probe", step=i):
                        qevs = probe.probe(state.opt_state, step=i)
                    emit(qevs)
                    if detector is not None:
                        for ev in detector.observe_qhealth(qevs):
                            reg.emit_event(ev)
                            if flight is not None:
                                flight.note_anomaly(ev)
            # Escalate this step's metrics into anomaly events; a fatal
            # verdict aborts the run after the flight dump.  Only a healthy
            # step's state is snapshotted: a poisoned state must never
            # become the resume point.
            fatal_reason = None if np.isfinite(loss) else "nonfinite_loss"
            if detector is not None:
                for ev in detector.observe_step(i, m):
                    if reg is not None:
                        reg.emit_event(ev)
                    if flight is not None:
                        flight.note_anomaly(ev)
                    print(f"[anomaly] step {i} [{ev['severity']}] "
                          f"{ev['reason']} value={ev['value']:.4g}")
                    if ev["severity"] == "fatal" and fatal_reason is None:
                        fatal_reason = ev["reason"]
            if flight is not None:
                flight.record(i, m, wall_s=dt)
                if fatal_reason is None and \
                        i % flight.snapshot_every == 0:
                    with tracing.host_phase("flight_snapshot", step=i):
                        flight.snapshot(i, state)
            if reg is not None:
                emit(tracing.drain_phase_events())
            if i % 20 == 0 or i == args.steps - 1:
                print(f"step {i:5d} loss {loss:.4f} ({dt:.2f}s)", flush=True)
            if args.ckpt_dir and ((i + 1) % args.ckpt_every == 0
                                  or stop["now"]):
                ckpt.save(args.ckpt_dir, i + 1, state)
            if stop["now"]:
                print(f"[preempted] checkpointed at {i + 1}; exiting")
                return 0
            if fatal_reason is not None:
                print("[diverged]" if fatal_reason == "nonfinite_loss"
                      else f"[fatal anomaly] {fatal_reason}")
                if reg is not None:
                    reg.flush(step=i)
                if flight is not None:
                    path = flight.dump(args.flight_dir, reason=fatal_reason,
                                       trigger_step=i, config=cfg,
                                       telemetry_path=telemetry_jsonl)
                    print(f"[flight] dumped {fatal_reason} forensics to "
                          f"{path} (last healthy snapshot: step "
                          f"{flight.snapshot_step})")
                return 2
        sb = opt.state_bytes(state.opt_state) \
            if hasattr(opt, "state_bytes") else {}
        steady_ms = timer.steady_ms()
        if reg is not None:
            reg.gauge("train/steady_ms").set(steady_ms)
            reg.gauge("train/compile_s").set(timer.compile_s or 0.0)
            reg.flush(step=args.steps - 1)
        print(f"done. final loss {loss:.4f}; entropy floor "
              f"{pipe.bigram_entropy():.4f}; compile "
              f"{timer.compile_s or 0.0:.2f}s; steady {steady_ms:.1f} "
              f"ms/step; optimizer state bytes {sb}")
        return 0
    finally:
        if out_f:
            out_f.close()
        if reg is not None:
            reg.close()
            tracing.set_phase_tracing(False)


if __name__ == "__main__":
    raise SystemExit(main())
