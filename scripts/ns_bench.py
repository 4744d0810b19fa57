#!/usr/bin/env python3
"""Time the Newton–Schulz kernels B5 (gram) and B6 (apply) against the one
PyTorch call that computes the same function, on one card.

    python3 scripts/ns_bench.py [--src DIR]

Runs chip_smoke.py's Newton–Schulz phase (``check_ns_kernels``) on the
kernels of the ``repro_torch`` under ``DIR`` (default: this checkout's
``src``), so the same checks and timings apply to another tree's kernels,
such as an older commit unpacked with ``git archive``: run it for both
trees in turns (old, new, new, old) in one call to compare them on one
card.  At the head's shape (1024 x 50264, padded to 1024 x 50432) and the
stacked norm vectors' (10 x 1024, padded to 16 x 1024) each kernel is
held to its plain version (within 1e-5 of the output's largest magnitude,
bit-identical over two launches, the gram exactly symmetric) and timed in
turns with ``torch.mm(X, X.T)`` / ``torch.addmm(X, B, X, beta=a)``, TF32
off for the library.  Prints one JSON line with the card's name and power
limit.  Exits 2 without CUDA, non-zero when a check fails.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke                 # puts this checkout's src on the path
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("ns_bench: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rows = chip_smoke.check_ns_kernels(torch, dev)
    print(json.dumps({"src": args.src, "card": chip_smoke.card_line(),
                      "torch": torch.__version__, "kernels": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
