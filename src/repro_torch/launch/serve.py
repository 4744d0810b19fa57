"""Serving launcher: paged 8/4-bit KV cache + continuous batching (mirrors
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-lm-209m \
      --serve-kv-bits 4 --serve-slots 16 --serve-pages 512 \
      --serve-max-pages-per-seq 32 --streams 48 --prompt-lens 64,128,256,384 \
      --max-new 128

Generates a synthetic mixed-length request stream (``--streams`` requests,
prompt lengths cycling over ``--prompt-lens``) for a model with random
weights from ``--seed``, serves it through ``ContinuousBatchingEngine``
(the gather-dequant kernel B7 at ``--serve-impl cuda``), and prints
per-request completions plus the tokens/s, p50/p99 latency and KV
bytes/token summary.  ``--engine static`` runs the fixed-bucket
``ServeEngine`` (16-bit contiguous cache) on the same stream.  Runs on the
card unless ``--device cpu``; ``--reduce`` shrinks the model for a CPU
smoke run.  ``--out`` writes the engine's metric registry (requests,
tokens, scheduler counters, tokens/s) as telemetry JSONL in the JAX
package's schema (``telemetry.JsonlSink``).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import base as cfgs
from repro_torch.errors import ConfigError
from repro_torch import telemetry as tel


def build_requests(args, vocab_size):
    from repro_torch.serve.scheduler import Request
    rng = np.random.RandomState(args.seed)
    plens = [int(p) for p in args.prompt_lens.split(",")]
    reqs = []
    for i in range(args.streams):
        P = plens[i % len(plens)]
        n_new = args.max_new if args.uniform_new else \
            int(rng.randint(1, args.max_new + 1))
        prompt = tuple(rng.randint(0, vocab_size, P).tolist())
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=n_new))
    return reqs


def main(argv=None):
    from repro_torch import device as device_lib
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.kvcache import PagedKVConfig, kv_bytes_per_token
    from repro_torch.serve.scheduler import (ContinuousBatchingEngine,
                                             SchedulerConfig)

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-lm-209m")
    ap.add_argument("--reduce", action="store_true",
                    help="shrink the arch to a laptop-size config")
    ap.add_argument("--engine", choices=("paged", "static"), default="paged")
    ap.add_argument("--serve-kv-bits", type=int, default=8,
                    help="paged KV quantization bitwidth (8 or 4)")
    ap.add_argument("--serve-page-size", type=int, default=16,
                    help="token positions per KV page")
    ap.add_argument("--serve-pages", type=int, default=128,
                    help="physical pages in the pool (per layer)")
    ap.add_argument("--serve-slots", type=int, default=4,
                    help="concurrent decode slots (the decode batch)")
    ap.add_argument("--serve-max-pages-per-seq", type=int, default=16)
    ap.add_argument("--serve-impl", choices=("cuda", "torch"),
                    default="cuda", help="gather-dequant implementation")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--streams", type=int, default=8,
                    help="number of requests in the stream")
    ap.add_argument("--prompt-lens", default="8,16,24",
                    help="comma list the stream's prompt lengths cycle over")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--uniform-new", action="store_true",
                    help="every request generates exactly --max-new tokens "
                         "(default: uniform random in [1, --max-new])")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="telemetry JSONL path (schema repro.telemetry.v1)")
    args = ap.parse_args(argv)

    dev = device_lib.resolve(args.device)
    cfg = cfgs.get_config(args.arch)
    if args.reduce:
        cfg = cfgs.reduced(cfg, d_model=128, n_layers=2, vocab_size=512)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = M.init_model(cfg, gen, device=dev)
    reqs = build_requests(args, cfg.vocab_size)
    reg = tel.MetricRegistry()
    if args.out:
        reg.add_sink(tel.JsonlSink(args.out))

    if args.engine == "static":
        plens = {len(r.prompt) for r in reqs}
        if len(plens) != 1:
            raise ConfigError(
                "--engine static needs equal prompt lengths (one bucket); "
                f"got {sorted(plens)} — use --prompt-lens with one value")
        eng = ServeEngine(cfg, model, ServeConfig(
            max_len=max(plens) + args.max_new,
            temperature=args.temperature, seed=args.seed), registry=reg)
        prompts = np.asarray([r.prompt for r in reqs], np.int32)
        out = eng.generate(prompts, args.max_new)
        results = {r.rid: out[i] for i, r in enumerate(reqs)}
        summary = {"engine": "static", "kv_bits": 16,
                   "kv_bytes_per_token": kv_bytes_per_token(cfg, 16),
                   "tokens_per_s": reg.get("serve/tokens_per_s")}
    else:
        kv = PagedKVConfig(page_size=args.serve_page_size,
                           n_pages=args.serve_pages,
                           n_slots=args.serve_slots,
                           max_pages_per_seq=args.serve_max_pages_per_seq,
                           kv_bits=args.serve_kv_bits)
        eng = ContinuousBatchingEngine(
            cfg, model, SchedulerConfig(kv=kv, temperature=args.temperature,
                                        seed=args.seed,
                                        impl=args.serve_impl),
            registry=reg)
        results = eng.serve(reqs)
        summary = {"engine": "paged", "kv_bits": kv.kv_bits,
                   "kv_bytes_per_token": kv_bytes_per_token(cfg, kv.kv_bits),
                   **eng.latency_percentiles(),
                   "tokens_per_s": reg.get("serve/tokens_per_s")}
    summary["device"] = str(dev)

    for r in reqs:
        toks = results[r.rid]
        print(f"request {r.rid}: P={len(r.prompt)} -> "
              f"{np.asarray(toks).tolist()[:12]}"
              f"{'...' if len(toks) > 12 else ''}")
    print(json.dumps(summary))
    reg.flush(step=0)
    reg.close()
    return summary


if __name__ == "__main__":
    main()
