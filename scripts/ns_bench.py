#!/usr/bin/env python3
"""Check and time one phase of chip_smoke.py's kernel checks on the
kernels of a given tree, on one card.

    python3 scripts/ns_bench.py [--phase ns|update|grid|turns|gather]
                                [--src DIR] [--old DIR]

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
  one's): B3(d) at (4, 8), B4, the 8-bit update (adamw, deterministic and
  stochastic, and momentum) and B1 (8 bits, 4 bits stochastic) at the same shape on
  grids of 1, 4 and 16 waves of the CTAs resident at once and of one CTA
  per block, in turns with B3(a) / the two vector norms, by direct calls
  of the C entries (no wrapper's host time in the span).
- ``turns`` (:func:`turns`, with ``--old [LABEL=]DIR ...``, the ``src``
  of other trees): this tree's 8-bit update (every variant, the
  sentinel's with and without it) and B1 in turns with the other trees',
  in one process, by raw launches of every tree's C entries (the other
  trees' libraries built beside this one's, all at once); a tree older
  than the walking kernels (the parent) also runs its packed kernel at
  (8, 8); then the paged gather B7's four instances (8 and 4 bits, bf16
  and f32 out) at the serve path's shapes in turns with the other trees',
  cold: a CUDA graph of raw launches over 6 copies of the pool and 2
  outputs in rotation, timed by CUDA events (:func:`gather_turns`).
  Outputs must agree bit for bit.
- ``gather`` (:func:`gather_phase`, with ``--old``): B7 alone — its
  instances' registers from every tree's build log and its turns,
  building only ``paged_gather.cu`` (seconds).

Prints one JSON line with the phase, the card's name and power limit and
the kernels' rows.  Exits 2 without CUDA, non-zero when a check fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def grid_sweep(torch, dev, nb: int = 40960, bsz: int = 2048) -> dict:
    """{kernel: {grid label: ms}} of the kernels whose CTAs walk the
    blocks (B4, B3(d) at (4, 8), the 8-bit update B3(a)/(b)/(c) momentum,
    B1 at 8 bits
    and 4 bits stochastic), on grids of w waves (w16 is the wrappers'
    choice) and of one CTA per block (``all``), 10 back-to-back launches
    per timed span."""
    import chip_smoke
    from repro_torch.core import qmap
    from repro_torch.core.lowbit import pack_codes
    from repro_torch.kernels import blockwise_quant as bq
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
    # the 8-bit update (adamw, deterministic and stochastic) and B1 at 8
    # bits and 4 bits stochastic on the same grids
    hyper = dict(lr=chip_smoke.LR, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=chip_smoke.WEIGHT_DECAY, step=7.0,
                 gnorm_scale=1.0)
    st = [p.clone(), codes(8), am.clone(), codes(8), ar.clone()]
    for name, algo, sr in (("adamw8", "adamw", False),
                           ("adamw8_sr", "adamw", True),
                           ("momentum8", "momentum", False)):
        two = fu.ALGO_SPECS[algo].n_states == 2
        st_ = st if two else st[:3] + [None, None]
        fns = {label: chip_smoke.raw_update(
            torch, lfu, "fused_update_grid", algo, st_, g, qm(8),
            qm(8, False), sr=sr, tail=(c,), hyper=hyper)
            for label, c in grids(lfu.fused_update_ctas(
                fu.KERNEL_ALGOS[algo], 0, nb, bsz, sms)).items()}
        res[f"fused_update/{name}"] = chip_smoke.in_turns(torch, fns, 12,
                                                          10)
    del st
    lq = bq._lib()
    for name, bits, seed in (("8bit", 8, None), ("4bit_sr", 4, 11)):
        out_c = torch.empty(nb, bsz * bits // 8, dtype=torch.uint8,
                            device=dev)
        out_a = torch.empty(nb, device=dev)
        fns = {label: chip_smoke.raw_quantize(torch, lq, p, qm(bits), out_c,
                                              out_a, bits, seed, c)
               for label, c in grids(lq.blockwise_quantize_ctas(
                   nb, bsz, bits, sms)).items()}
        res[f"blockwise_quant/{name}"] = chip_smoke.in_turns(torch, fns, 12,
                                                             10)
    for k, v in res.items():
        print(f"grid {k}: " + ", ".join(f"{g_} {t:.4f} ms"
                                        for g_, t in v.items()))
    return res


def tree_libs(src: Path, names=None) -> dict:
    """{source: ctypes library} of ``fused_update.cu``,
    ``blockwise_quant.cu`` and ``paged_gather.cu`` (or of ``names``) of the
    ``repro_torch`` under ``src`` (another tree's), built with this
    checkout's flags beside this tree's libraries; the C entries this tree
    declares get their argtypes (an older tree may lack some)."""
    import ctypes
    from repro_torch.kernels import blockwise_quant as bq
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import paged_kv
    names = names or TURNS_SOURCES
    csrc = src / "repro_torch" / "kernels" / "csrc"
    build.build(names, csrc=csrc)
    tables = {"fused_update": {k: a for k, (n, a) in fu.ARGTYPES.items()
                               if n == "fused_update"},
              "blockwise_quant": bq.ARGTYPES,
              "paged_gather": paged_kv.ARGTYPES}
    libs = {}
    for name in names:
        lib = ctypes.CDLL(str(build.build_dir(csrc) / f"{name}.so"))
        lib.rq_error_string.argtypes = [ctypes.c_int]
        lib.rq_error_string.restype = ctypes.c_char_p
        for entry, argtypes in tables[name].items():
            fn = getattr(lib, entry, None)
            if fn is not None:
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = lib
    return libs


TURNS_SOURCES = ("fused_update", "blockwise_quant", "paged_gather")


def turns(torch, dev, olds: dict, nb: int = 40960, bsz: int = 2048) -> dict:
    """This tree's 8-bit update and B1 against other trees' (``olds``:
    {label: the ``src`` of a ``git archive``}) in turns on the same
    inputs, by raw launches of their C entries at (nb, bsz), the main
    path's largest leaf: {row: {label: ms}}.  A tree whose library has
    ``fused_update_grid`` / ``blockwise_quantize_grid`` runs them on its
    own grid; an older one (the parent) runs ``fused_update`` /
    ``fused_update_sentinel`` / ``blockwise_quantize`` (one CTA per block)
    and, beside them, its packed kernel at (8, 8)
    (``fused_update_packed_grid``, run-time widths).  Rows: every 8-bit
    update variant; the sentinel variants with and without the sentinel;
    B1 at 8 bits (also at the head's 25132 blocks), 4 bits and 4 bits
    stochastic.  Every tree's outputs must equal this tree's bit for bit
    (p, codes, absmax, health)."""
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as cs
    from repro_torch.analysis import kernel_budget
    from repro_torch.core import qmap
    from repro_torch.kernels import blockwise_quant as bq
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import paged_kv

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(olds) + 1) as pool:   # every tree's nvcc
        this = pool.submit(build.build, TURNS_SOURCES)  # runs at once
        jobs = {k: pool.submit(tree_libs, d) for k, d in olds.items()}
        this.result()
        built = {k: job.result() for k, job in jobs.items()}
    print(f"turns: built {len(olds) + 1} trees in "
          f"{time.perf_counter() - t0:.1f} s")
    trees = {"new": {"fused_update": fu._lib("fused_update"),
                     "blockwise_quant": bq._lib(),
                     "paged_gather": paged_kv._lib()}}
    trees.update((k, built[k]) for k in olds)
    dirs = {"new": build.build_dir()}
    dirs.update((k, build.build_dir(d / "repro_torch" / "kernels" / "csrc"))
                for k, d in olds.items())
    for tree, d in dirs.items():
        for name in TURNS_SOURCES:
            for line in kernel_budget.ptxas_report(d / f"{name}.log"):
                if line.startswith(("fused_update_kernel<f32,0,256",
                                    "fused_update_kernel<bf16,0,256",
                                    "quantize_kernel<8,256")):
                    print(f"turns: {tree} {name}: {line}")
    sms = build.sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    qs = torch.as_tensor(qmap.get_qmap("dynamic", True), device=dev)
    qu = torch.as_tensor(qmap.get_qmap("dynamic", False), device=dev)
    p = torch.randn(nb, bsz, generator=gen, device=dev) * 0.02
    g = torch.randn(nb, bsz, generator=gen, device=dev) * 1e-3
    codes = [torch.randint(0, 256, (nb, bsz), generator=gen, device=dev,
                           dtype=torch.uint8) for _ in range(2)]
    am = torch.rand(nb, generator=gen, device=dev) * 1e-3 + 1e-5
    ar = torch.rand(nb, generator=gen, device=dev) * 1e-6 + 1e-9
    ts = torch.rand(nb, generator=gen, device=dev) * 0.5 + 0.75
    hyper = dict(lr=cs.LR, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=cs.WEIGHT_DECAY, step=7.0, gnorm_scale=1.0)
    res = {}

    def entries(lib, algo, sent):
        """(entry, ints after block_size) of a tree's 8-bit update."""
        if hasattr(lib, "fused_update_grid"):
            return "fused_update_grid", (lib.fused_update_ctas(
                fu.KERNEL_ALGOS[algo], int(sent), nb, bsz, sms),)
        return ("fused_update_sentinel" if sent else "fused_update"), ()

    def update_fns(algo, sr, labels):
        """{label: (launch, state, health)} on fresh copies of the state;
        labels: {label: (lib, entry, tail, sentinel)}."""
        spec = fu.ALGO_SPECS[algo]
        two = spec.n_states == 2
        q1 = qs if spec.state1_signed else qu
        ts_v = ts if spec.needs_norms else None
        out = {}
        for label, (lib, entry, tail, sent) in labels.items():
            st = [p.clone(), codes[0].clone(), am.clone(),
                  codes[1].clone() if two else None,
                  ar.clone() if two else None]
            h = torch.full((nb, fu.N_HEALTH), -1.0, device=dev) \
                if sent else None
            out[label] = (cs.raw_update(torch, lib, entry, algo, st, g, q1,
                                        qu, ts_v, sr=sr, health=h,
                                        tail=tail, hyper=hyper), st, h)
        return out

    def differ(fns, ref):
        """{label: values that differ from fns[ref]'s} after one launch
        each (labels that write health against a ref that does)."""
        bits_of = lambda t: t.view(torch.int32) \
            if t.dtype == torch.float32 else t
        for fn, _, _ in fns.values():
            fn()
        _, st0, h0 = fns[ref]
        bad = {}
        for label, (_, st, h) in fns.items():
            n = sum(int((bits_of(a) != bits_of(b)).sum())
                    for a, b in zip(st, st0) if a is not None)
            if h is not None and h0 is not None:
                n += int((h != h0).sum())
            bad[label] = n
        return bad

    for variant, (algo, sr) in cs.VARIANTS.items():
        labels = {}
        for tree, libs in trees.items():
            lib = libs["fused_update"]
            labels[tree] = (lib, *entries(lib, algo, False), False)
            if not hasattr(lib, "fused_update_grid"):
                labels[f"{tree}_packed_8_8"] = (
                    lib, "fused_update_packed_grid",
                    (8, 8, lib.fused_update_packed_ctas(nb, bsz, sms)),
                    False)
        fns = update_fns(algo, sr, labels)
        bad = differ(fns, "new")
        cs.require(not any(bad.values()), f"turns {variant}: values differ "
                   f"from this tree's: {bad}")
        res[f"fused_update/{variant}"] = cs.in_turns(
            torch, {k: v[0] for k, v in fns.items()}, 16, 10)
    for variant in ("adamw8", "adamw8_sr", "momentum8", "lamb8"):
        algo, _, _, sr = cs.SENTINEL_VARIANTS[variant]
        fns = update_fns(algo, sr, {
            f"{tree}_{tag}": (libs["fused_update"],
                              *entries(libs["fused_update"], algo, sent),
                              sent)
            for tree, libs in trees.items()
            for tag, sent in (("off", False), ("on", True))})
        bad = differ(fns, "new_on")
        cs.require(not any(bad.values()), f"turns sentinel_{variant}: "
                   f"values differ from this tree's: {bad}")
        res[f"fused_update/sentinel_{variant}"] = cs.in_turns(
            torch, {k: v[0] for k, v in fns.items()}, 16, 10)
    del p, g, codes
    torch.cuda.empty_cache()

    x = torch.randn(nb, bsz, generator=gen, device=dev) * torch.exp(
        torch.randn(nb, 1, generator=gen, device=dev) * 3)
    x[0] = 0.0
    for name, rows, bits, seed in (("8bit", nb, 8, None),
                                   ("8bit_head", min(nb, 25132), 8, None),
                                   ("4bit", nb, 4, None),
                                   ("4bit_sr", nb, 4, cs.SEED + 11)):
        xr = x[:rows]
        q = torch.as_tensor(qmap.get_qmap("dynamic", True, bits=bits),
                            device=dev)
        outs, fns = {}, {}
        for tree, libs in trees.items():
            lib = libs["blockwise_quant"]
            outs[tree] = (torch.empty(rows, bsz * bits // 8,
                                      dtype=torch.uint8, device=dev),
                          torch.empty(rows, device=dev))
            ctas = (lib.blockwise_quantize_ctas(rows, bsz, bits, sms)
                    if hasattr(lib, "blockwise_quantize_grid") else None)
            fns[tree] = cs.raw_quantize(torch, lib, xr, q, *outs[tree], bits,
                                        seed, ctas)
            fns[tree]()
            cs.require(torch.equal(outs[tree][0], outs["new"][0]) and
                       torch.equal(outs[tree][1], outs["new"][1]),
                       f"turns blockwise_quant/{name}: {tree}'s codes or "
                       f"absmax differ from this tree's")
        res[f"blockwise_quant/{name}"] = cs.in_turns(torch, fns, 16, 10)
    del x
    torch.cuda.empty_cache()
    res.update(gather_turns(torch, dev, {k: libs["paged_gather"]
                                         for k, libs in trees.items()
                                         if k != "new"}))
    for k, v in res.items():
        ref = v.get("new", v.get("new_off"))
        print(f"turns {k}: " + ", ".join(
            f"{label} {t:.4f} ms ({t / ref:.3f}x)" for label, t in v.items()))
    return res


GATHER_CASES = [(bits, dt) for bits in (8, 4)
                for dt in ("bfloat16", "float32")]


def gather_turns(torch, dev, trees: dict) -> dict:
    """{B7 instance: {tree: ms per launch}}: this tree's B7 (the C entry
    its wrapper calls) against other trees' ``paged_gather`` (``trees``:
    {label: library}) at the serve path's shapes, cold and in turns
    (``chip_smoke.gather_cold``); every tree's output must equal this
    tree's and the plain version's bit for bit."""
    import chip_smoke as cs
    from repro_torch.kernels import paged_kv
    libs = {"new": paged_kv._lib(), **trees}
    res = {}
    for bits, dt_name in GATHER_CASES:
        dt = getattr(torch, dt_name)
        codes, absmax, table, _ = cs.gather_inputs(torch, dev, bits)
        want = paged_kv._gather_torch(codes, absmax, table, bits=bits,
                                      dtype=dt)
        makers = {label: (lambda c, a, o, lib=lib:
                          cs.raw_gather(lib, c, a, table, o, bits))
                  for label, lib in libs.items()}
        ms, first = cs.gather_cold(torch, makers, codes, absmax, table, bits,
                                   dt, reps=16)
        bad = [k for k, v in first.items() if not torch.equal(v, want)]
        cs.require(not bad, f"turns paged_gather/{bits}bit_{dt_name}: "
                   f"{bad} differ from the plain version")
        res[f"paged_gather/{bits}bit_{dt_name}"] = ms
    return res


def gather_phase(torch, dev, olds: dict) -> dict:
    """B7 alone: the build logs' registers of every tree's instances, then
    :func:`gather_turns` against ``olds`` ({label: the ``src`` of a ``git
    archive``}), all trees' nvcc at once."""
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as cs
    from repro_torch.analysis import kernel_budget
    from repro_torch.kernels import build
    names = ("paged_gather",)
    with ThreadPoolExecutor(len(olds) + 1) as pool:
        this = pool.submit(build.build, names)
        jobs = {k: pool.submit(tree_libs, d, names) for k, d in olds.items()}
        this.result()
        trees = {k: job.result()["paged_gather"] for k, job in jobs.items()}
    dirs = {"new": build.build_dir(), **{
        k: build.build_dir(d / "repro_torch" / "kernels" / "csrc")
        for k, d in olds.items()}}
    for tree, d in dirs.items():
        for line in kernel_budget.ptxas_report(d / "paged_gather.log"):
            print(f"gather: {tree}: {line}")
    res = gather_turns(torch, dev, trees)
    for k, v in res.items():
        print(f"turns {k}: " + ", ".join(
            f"{label} {t:.4f} ms ({t / v['new']:.3f}x)"
            for label, t in v.items()))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("ns", "update", "grid", "turns",
                                        "gather"), default="ns")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--old", nargs="+", default=[],
                    metavar="[LABEL=]DIR", help="the turns and gather phases: the src "
                    "directories of the trees to compare with (git "
                    "archives), each under its label (default old, old1, "
                    "...)")
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
    if args.phase in ("turns", "gather"):
        if not args.old:
            ap.error(f"--phase {args.phase} needs --old")
        olds = {}
        for i, item in enumerate(args.old):
            label, _, d = item.rpartition("=")
            olds[label or ("old" if i == 0 else f"old{i}")] = \
                Path(d).resolve()
        if args.phase == "turns":
            rows = turns(torch, dev, olds)
        else:
            rows = gather_phase(torch, dev, olds)
    else:
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
