#!/usr/bin/env python3
"""Static SASS instruction counts of the port's CUDA kernels.

    python3 scripts/kernel_sass.py [SOURCE ...] [--filter REGEX] [--dump FILE]
        [--against CSRC]

Builds the named sources of ``src/repro_torch/kernels/csrc`` (default:
fused_update and norm_partials) with the port's own flags (``repro_torch.kernels.build``),
disassembles each library with ``cuobjdump -sass`` and prints, for every
kernel instance whose name matches ``--filter``, its static instruction
count and the counts of a few opcode families (barriers, shuffles,
compares, selects, float adds and FMAs, tensor-core products (HMMA),
shared and global loads, cp.async copies (LDGSTS)).  The names read
``kernel<template arguments>`` (``repro_torch.analysis.kernel_budget.
demangle``, the element type first where the first argument is one),
e.g. ``fused_update_kernel<f32,0,256,0,1>`` = f32 p, adam, 256 threads,
not stochastic, with the sentinel; ``norm_partials_kernel<f32,1,2,1>`` =
lamb, 2 vectors per thread, packed rows.  ``--dump FILE`` writes the
matching kernels' SASS to FILE.  ``--against CSRC`` also builds the same
libraries from another tree's ``csrc`` directory (e.g. a ``git archive``
of the parent commit) and compares every kernel's counts with this
tree's: it prints each instance that differs, or that only one tree has,
and exits 1 if any does.  Needs the CUDA toolkit (nvcc, cuobjdump): it
runs on the machine with the card.
"""
from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.analysis.kernel_budget import demangle  # noqa: E402

FAMILIES = ("BAR", "SHFL", "ISETP", "FSETP", "IADD3", "LOP3", "SEL", "FMUL",
            "FADD", "FFMA", "HMMA", "LDS", "LDG", "LDGSTS", "STG", "BRA")
ADDR = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+(.*?);")


def sass_counts(lib: Path) -> tuple[dict, dict]:
    """({kernel name: Counter of opcodes}, {kernel name: SASS lines}) of one
    shared library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    counts, text, name = {}, {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = demangle(line.split("Function :", 1)[1].strip())
            counts[name] = collections.Counter()
            text[name] = []
            continue
        hit = ADDR.match(line)
        if hit and name is not None:
            ins = re.sub(r"^@!?U?P[T0-9]+\s+", "", hit.group(1).strip())
            op = ins.split()[0].split(".")[0] if ins else "?"
            counts[name][op] += 1
            text[name].append(hit.group(1).strip())
    return counts, text


def main(argv=None) -> int:
    from repro_torch.kernels import build
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*",
                    default=["fused_update", "norm_partials"])
    ap.add_argument("--filter", default=".")
    ap.add_argument("--dump")
    ap.add_argument("--against", help="another tree's csrc directory to "
                    "compare every kernel's counts with")
    args = ap.parse_args(argv)
    if args.against:
        return compare(args.sources, Path(args.against))
    build.build(tuple(args.sources))
    dump = []
    for src in args.sources:
        counts, text = sass_counts(build.build_dir() / f"{src}.so")
        for name in sorted(counts):
            if not re.search(args.filter, name):
                continue
            c = counts[name]
            fam = " ".join(f"{f} {c[f]}" for f in FAMILIES if c[f])
            print(f"{src}: {name}: {sum(c.values())} instructions; {fam}")
            dump += [f"// {src}: {name}", *text[name], ""]
    if args.dump:
        Path(args.dump).write_text("\n".join(dump))
    return 0


def compare(sources, other: Path) -> int:
    """Every kernel's opcode counts of this tree's libraries against those
    built from ``other`` (a csrc directory); 1 if any differ."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    with ThreadPoolExecutor(2) as pool:     # both trees' nvcc at once
        builds = [pool.submit(build.build, tuple(sources), csrc)
                  for csrc in (build.CSRC, other)]
        for b in builds:
            b.result()
    n, bad = 0, 0
    for src in sources:
        mine, _ = sass_counts(build.build_dir() / f"{src}.so")
        theirs, _ = sass_counts(build.build_dir(other) / f"{src}.so")
        for name in sorted(set(mine) | set(theirs)):
            n += 1
            a, b = mine.get(name), theirs.get(name)
            if a != b:
                bad += 1
                print(f"{src}: {name}: "
                      f"{'missing' if a is None else sum(a.values())} "
                      f"instructions here, "
                      f"{'missing' if b is None else sum(b.values())} in "
                      f"{other}")
    print(f"sass: {n - bad}/{n} kernel instances with identical opcode "
          f"counts to {other}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
