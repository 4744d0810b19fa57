"""CLI of the port's static-analysis gate: ``python -m repro_torch.analysis``.

    python -m repro_torch.analysis [contracts|kernels|lint|all]
        [--device cuda|cpu] [--write-baseline] [--root DIR]

  contracts   run the config matrix on ``--device`` and evaluate every
              registered contract on the recorded traces
  kernels     the Hopper kernel budget and the grid-alignment audit; on
              the card (``--device cuda``) also every built instance held
              to ptxas's report and the occupancy API
  lint        the AST lint gate against the committed baseline
              (``--write-baseline`` rewrites it)

Exits 0 when every leg passes, 1 on any failure.  ``--device`` defaults to
``cuda`` and does not fall back to the CPU: without a card, pass
``--device cpu`` (the contracts then run the kernels' plain versions).
"""
from __future__ import annotations

import argparse
import os
import sys


def _run_contracts(args) -> int:
    from repro_torch.analysis import runner
    results = runner.run_contracts(device=args.device)
    bad = runner.failures(results)
    print(f"contracts: {len(results) - len(bad)}/{len(results)} passed")
    return 1 if bad else 0


def _run_kernels(args) -> int:
    from repro_torch.analysis import kernel_budget
    results = kernel_budget.audit()
    if args.device.startswith("cuda"):
        from repro_torch.kernels import build
        build.build()
        for row in kernel_budget.card_audit(build.build_dir(),
                                            build.library):
            results.append((f"card:{row['library']}:{row['instance']}",
                            row["ok"], "; ".join(row["problems"]) or
                            f"{row['registers']} registers, "
                            f"{row['api_ctas']} CTAs/SM"))
    bad = [r for r in results if not r[1]]
    for name, ok, detail in results:
        print(f"[{'PASS' if ok else 'FAIL'}] {name} — {detail}")
    print(f"kernels: {len(results) - len(bad)}/{len(results)} passed")
    return 1 if bad else 0


def _run_lint(args) -> int:
    from repro_torch.analysis import lint
    root = args.root or os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    ok, lines = lint.run(root, update_baseline=args.write_baseline)
    for ln in lines:
        print(ln)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="contracts + kernel budget + repo lint")
    ap.add_argument("what", nargs="?", default="all",
                    choices=("all", "contracts", "kernels", "lint"))
    ap.add_argument("--device", default="cuda",
                    help="where the contracts run and whether the kernel "
                         "budget is held to the card (cuda, the default, "
                         "or cpu)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="lint: rewrite the baseline instead of checking")
    ap.add_argument("--root", default=None,
                    help="lint: tree to lint (default: the repro_torch "
                         "package)")
    args = ap.parse_args(argv)

    legs = {"contracts": _run_contracts, "kernels": _run_kernels,
            "lint": _run_lint}
    picked = legs.items() if args.what == "all" else \
        [(args.what, legs[args.what])]
    rc = 0
    for name, fn in picked:
        print(f"=== {name} ===")
        rc |= fn(args)
    print("ANALYSIS " + ("PASS" if rc == 0 else "FAIL"))
    return rc


if __name__ == "__main__":
    sys.exit(main())
