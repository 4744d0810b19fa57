"""Serving example of the PyTorch port: continuous batching over the paged
8-bit KV cache.

    python examples/serve_lm_torch.py                # on the GPU
    python examples/serve_lm_torch.py --device cpu   # plain PyTorch

A mixed-length request stream runs through the slot-based scheduler:
prompts admit as slots free up, KV pages are block-wise quantized on
append (kernel B7 gathers and dequantizes them on the GPU; on the CPU its
plain version does), and sampling streams are per (request, token), so
preemption never changes the generated tokens.  ``python -m
repro_torch.launch.serve`` is the A/B command line.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import device as device_lib  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve.kvcache import PagedKVConfig  # noqa: E402
from repro_torch.serve.scheduler import (  # noqa: E402
    ContinuousBatchingEngine, Request, SchedulerConfig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    cfg = base.reduced(base.get_config("stablelm-1.6b"),
                       d_model=128, n_layers=2, vocab_size=512)
    model = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    rng = np.random.RandomState(0)
    requests = [
        Request(rid=i,
                prompt=tuple(rng.randint(0, cfg.vocab_size,
                                         [16, 8, 24, 12][i % 4]).tolist()),
                max_new_tokens=[24, 6, 12, 18][i % 4])
        for i in range(8)
    ]
    engine = ContinuousBatchingEngine(
        cfg, model,
        SchedulerConfig(kv=PagedKVConfig(page_size=8, n_pages=64,
                                         n_slots=4, max_pages_per_seq=8,
                                         kv_bits=8),
                        temperature=0.8, seed=1))
    results = engine.serve(requests)
    for r in requests:
        toks = results[r.rid]
        print(f"request {r.rid}: P={len(r.prompt):2d} "
              f"max_new={r.max_new_tokens:2d} -> {toks.tolist()}")
    print("latency:", engine.latency_percentiles())


if __name__ == "__main__":
    main()
