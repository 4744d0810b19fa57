#!/usr/bin/env python3
"""Check and time one phase of chip_smoke.py's kernel checks on the
kernels of a given tree, on one card.

    python3 scripts/ns_bench.py [--phase ns|update|grid] [--src DIR]

Runs a phase of chip_smoke.py on the kernels of the ``repro_torch`` under
``DIR`` (default: this checkout's ``src``), so the same checks and timings
apply to another tree's kernels, such as an older commit unpacked with
``git archive``: run it for both trees in turns (old, new, new, old) in
one call to compare them on one card.  Phases:

- ``ns`` (default; ``check_ns_kernels``): the Newton–Schulz kernels B5
  (gram) and B6 (apply) at the head's shape (1024 x 50264, padded to 1024
  x 50432) and the stacked norm vectors' (10 x 1024, padded to 16 x 1024),
  each held to its plain version (within 1e-5 of the output's largest
  magnitude, bit-identical over two launches, the gram exactly symmetric)
  and timed in turns with ``torch.mm(X, X.T)`` / ``torch.addmm(X, B, X,
  beta=a)``, TF32 off for the library.
- ``update`` (``check_packed_and_norm_kernels``): the packed update B3(d)
  at (4, 8), (4, 8) stochastic, (5, 5), (6, 6) and momentum at 4 bits, and
  the norm prologue B4 for lars, lamb and lamb at (4, 8), at the main
  path's largest leaf (40960 x 2048), each exact against its plain
  version; B4 timed in turns with the two ``torch.linalg.vector_norm``
  calls, B3(d) at (4, 8) in turns with the 8-bit update B3(a).
- ``grid`` (:func:`grid_sweep`; trees whose kernels take a grid, this
  one's): B3(d) at (4, 8) and B4 at the same shape on grids of 1, 4 and
  16 waves of the CTAs resident at once and of one CTA per block, in
  turns with B3(a) / the two vector norms, by direct calls of the C
  entries (no wrapper's host time in the span).

Prints one JSON line with the phase, the card's name and power limit and
the kernels' rows.  Exits 2 without CUDA, non-zero when a check fails.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def grid_sweep(torch, dev, nb: int = 40960, bsz: int = 2048) -> dict:
    """{kernel: {grid label: ms}} of the kernels whose CTAs walk the
    blocks, on grids of w waves (w16 is the wrappers' choice) and of one
    CTA per block (``all``), 10 back-to-back launches per timed span."""
    import chip_smoke
    from repro_torch.core import qmap
    from repro_torch.core.lowbit import pack_codes
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_update as fu

    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 3)
    p = torch.randn(nb, bsz, generator=gen, device=dev) * 0.02
    g = torch.randn(nb, bsz, generator=gen, device=dev) * 1e-3
    am = torch.rand(nb, generator=gen, device=dev) * 1e-3 + 1e-5
    ar = torch.rand(nb, generator=gen, device=dev) * 1e-6 + 1e-9
    qm = lambda b, signed=True: torch.as_tensor(
        qmap.get_qmap("dynamic", signed, bits=b), device=dev)
    codes = lambda b: pack_codes(torch.randint(
        0, 1 << b, (nb, bsz), generator=gen, device=dev), b)
    sc = fu._kernel_scalars(fu.scalars(
        lr=chip_smoke.LR, beta1=0.9, beta2=0.999, eps=1e-8,
        weight_decay=chip_smoke.WEIGHT_DECAY, step=7.0, gnorm_scale=1.0,
        device="cpu"))
    ptr = lambda t: None if t is None else build.ptr(t)
    stream, sms = build.stream(dev), build.sm_count(dev)
    lnp, lfu = fu._lib("norm_partials"), fu._lib("fused_update")
    out = torch.empty(nb, fu.N_PARTIALS, device=dev)
    res = {}

    def grids(pick):        # pick: 16 waves (or every block)
        return {**{f"w{w}": max(1, pick * w // 16) for w in (1, 4, 16)},
                "all": nb}

    for name, kind, bits in (("lars", 0, (8, 8)), ("lamb", 1, (8, 8)),
                             ("lamb_4_8", 1, (4, 8))):
        state = ((codes(bits[0]), am, codes(bits[1]), ar, qm(bits[0]),
                  qm(bits[1], False)) if kind else (None,) * 6)
        st = tuple(map(ptr, state))        # state keeps the tensors alive
        fns = {"library": lambda: (torch.linalg.vector_norm(p, dim=1),
                                   torch.linalg.vector_norm(g, dim=1))}
        for label, c in grids(lnp.norm_partials_ctas(kind, nb, bsz,
                                                     sms)).items():
            fns[label] = (lambda c=c: build.check(
                lnp, lnp.norm_partials_grid(
                    kind, ptr(p), ptr(g), *st, ptr(out), nb, bsz, *bits, c,
                    *sc, stream), "norm_partials_grid"))
        res[f"norm_partials/{name}"] = chip_smoke.in_turns(torch, fns, 12,
                                                           10)
    adam = fu.KERNEL_ALGOS["adam"]
    state8 = (p.clone(), g, codes(8), am.clone(), codes(8), ar.clone(),
              qm(8), qm(8, False))
    state48 = (p.clone(), g, codes(4), am.clone(), codes(8), ar.clone(),
               qm(4), qm(8, False))
    s8, s48 = tuple(map(ptr, state8)), tuple(map(ptr, state48))
    fns = {"adamw8": lambda: build.check(lfu, lfu.fused_update(
        adam, *s8, None, None, None, 0, 0, nb, bsz, *sc, stream),
        "fused_update")}
    for label, c in grids(lfu.fused_update_packed_ctas(nb, bsz,
                                                       sms)).items():
        fns[label] = (lambda c=c: build.check(
            lfu, lfu.fused_update_packed_grid(
                adam, *s48, None, None, None, None, 0, 0, nb, bsz, 4, 8, c,
                *sc, stream), "fused_update_packed_grid"))
    res["fused_update/adam8_4_8"] = chip_smoke.in_turns(torch, fns, 12, 10)
    for k, v in res.items():
        print(f"grid {k}: " + ", ".join(f"{g_} {t:.4f} ms"
                                        for g_, t in v.items()))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("ns", "update", "grid"),
                    default="ns")
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
    check = {"ns": chip_smoke.check_ns_kernels,
             "update": chip_smoke.check_packed_and_norm_kernels,
             "grid": grid_sweep}[args.phase]
    rows = check(torch, dev)
    print(json.dumps({"phase": args.phase, "src": args.src,
                      "card": chip_smoke.card_line(),
                      "torch": torch.__version__, "kernels": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
