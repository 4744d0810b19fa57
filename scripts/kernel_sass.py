#!/usr/bin/env python3
"""Static SASS instruction counts of the port's CUDA kernels.

    python3 scripts/kernel_sass.py [SOURCE ...] [--filter REGEX] [--dump FILE]

Builds the named sources of ``src/repro_torch/kernels/csrc`` (default:
fused_update) with the port's own flags (``repro_torch.kernels.build``),
disassembles each library with ``cuobjdump -sass`` and prints, for every
kernel instance whose name matches ``--filter``, its static instruction
count and the counts of a few opcode families (barriers, shuffles,
compares, selects, float adds and FMAs, tensor-core products (HMMA),
shared and global loads, cp.async copies (LDGSTS)).  The names read
``kernel<template arguments>``, e.g.
``fused_update_kernel<0,2,0,1>`` = adam, 2 vectors per thread, not
stochastic, with the sentinel.  ``--dump FILE`` writes the matching
kernels' SASS to FILE.  Needs the CUDA toolkit (nvcc, cuobjdump):
it runs on the machine with the card.
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

FAMILIES = ("BAR", "SHFL", "ISETP", "FSETP", "IADD3", "LOP3", "SEL", "FMUL",
            "FADD", "FFMA", "HMMA", "LDS", "LDG", "LDGSTS", "STG", "BRA")
ADDR = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+(.*?);")


def short_name(mangled: str) -> str:
    hit = re.search(r"\d([a-z_]+_kernel)I(.+?)EEv", mangled)
    if not hit:
        plain = re.search(r"([a-z_]+_kernel)E", mangled)
        return plain.group(1) if plain else mangled
    args = re.findall(r"L[ib](\d+)E", hit.group(2))
    return f"{hit.group(1)}<{','.join(args)}>"


def sass_counts(lib: Path) -> tuple[dict, dict]:
    """({kernel name: Counter of opcodes}, {kernel name: SASS lines}) of one
    shared library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    counts, text, name = {}, {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = short_name(line.split("Function :", 1)[1].strip())
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
    ap.add_argument("sources", nargs="*", default=["fused_update"])
    ap.add_argument("--filter", default=".")
    ap.add_argument("--dump")
    args = ap.parse_args(argv)
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


if __name__ == "__main__":
    raise SystemExit(main())
