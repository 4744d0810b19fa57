"""Per-layer 32-bit override in the PyTorch port (the paper's
GlobalOptimManager pattern): quantize every state EXCEPT the layers you
name — here the embedding (paper §2.3 stable-embedding rule) plus the
final norm.

    python examples/finetune_override_torch.py                # on the GPU
    python examples/finetune_override_torch.py --device cpu   # plain PyTorch

Prints each leaf's state kind (``Quant8Leaf``: 8-bit block-wise,
``Full32Leaf``: 32-bit) from ``unpool_state``, the per-leaf view of the
pooled dispatch's arenas, then trains a reduced granite-3-8b with adamw8.
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import device as device_lib  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core.optim import make_optimizer, unpool_state  # noqa: E402
from repro_torch.data.pipeline import (DataConfig,  # noqa: E402
                                       SyntheticLMPipeline)
from repro_torch.train import loop as L  # noqa: E402


def my_override(path: str) -> bool:
    return "embed" in path or "final_norm" in path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    cfg = base.reduced(base.get_config("granite-3-8b"),
                       d_model=128, n_layers=2, vocab_size=256)
    pipe = SyntheticLMPipeline(DataConfig(vocab_size=256, seq_len=32,
                                          global_batch=8))
    opt = make_optimizer("adamw8", lr=3e-3, weight_decay=0.01,
                         override_32bit=my_override, device=dev)
    state, model = L.init_train_state(
        cfg, opt, torch.Generator(device=dev).manual_seed(0), device=dev)
    # unpool_state gives the per-leaf view whatever the dispatch, so the
    # kinds read the same pooled or per leaf
    for path, leaf in unpool_state(state.opt_state).leaves.items():
        print(f"state kind: {path} {type(leaf).__name__}")
    step = L.make_train_step(cfg, model, opt)
    for i in range(args.steps):
        state, m = step(state, pipe.batch_at(i))
    print(f"final loss: {m['loss'].item():.6f} after {args.steps} steps on "
          f"{dev}")


if __name__ == "__main__":
    main()
