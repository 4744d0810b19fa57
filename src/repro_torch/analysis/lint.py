"""Repo lint gate over the port: AST rules encoding its conventions
(mirrors ``repro.analysis.lint``).

Four rules, each encoding a convention the repo learned the hard way:

  * ``bare-assert`` — ``assert`` statements in library code.  Asserts
    vanish under ``python -O``, so user-reachable validation must raise
    typed exceptions (:mod:`repro_torch.errors`).
  * ``host-sync-in-step`` — ``.item()``, ``.cpu()``, ``.tolist()``,
    ``.numpy()`` or ``torch.cuda.synchronize`` in a function body of one
    of the step's modules: on a CUDA tensor each waits for the device and
    serializes the host with the step.  The port has no ``jit`` (the JAX
    rule is ``host-sync-in-jit``), so the rule is scoped by module; the
    step's modules are those the train step and the decode step run:
    ``core/optim/``, ``kernels/`` apart from ``build.py`` (which loads
    libraries and reads no tensor), ``train/loop.py``, ``models/`` and
    ``serve/kvcache.py``.  A call on a CPU tensor does not wait, but the
    rule cannot see devices: such sites are baselined and named.
  * ``env-read-at-trace`` — ``os.environ`` / ``os.getenv`` inside a
    function body: config must be read at import or passed explicitly.
  * ``duplicate-import`` — the same module imported twice in one file.

Violations are compared against a committed baseline
(``lint_baseline.json``: per (file, rule) counts).  New violations fail;
existing ones burn down — shrinking a count below baseline auto-shrinks
the baseline on the next ``--write-baseline``.  Stdlib-only on purpose.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os

BASELINE_FILE = os.path.join(os.path.dirname(__file__),
                             "lint_baseline.json")
RULES = ("bare-assert", "host-sync-in-step", "env-read-at-trace",
         "duplicate-import")
# lint-root-relative path prefixes of the step's modules, and exceptions
STEP_MODULES = ("core/optim/", "kernels/", "train/loop.py", "models/",
                "serve/kvcache.py")
STEP_EXCLUDED = ("kernels/build.py",)
SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
SYNC_CALLS = ("torch.cuda.synchronize",)


@dataclasses.dataclass(frozen=True)
class Violation:
    file: str
    line: int
    rule: str
    msg: str

    def __str__(self):
        return f"{self.file}:{self.line}: [{self.rule}] {self.msg}"


def in_step_module(rel: str) -> bool:
    """Whether lint-root-relative path ``rel`` is one of the step's
    modules (:data:`STEP_MODULES`)."""
    return rel.startswith(STEP_MODULES) and rel not in STEP_EXCLUDED


def _dotted(node: ast.AST) -> str:
    """'jax.device_get' for an Attribute/Name chain, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _check_file(path: str, rel: str) -> list:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    tree = ast.parse(src, filename=path)
    out = []

    # bare-assert: every assert statement in library code
    for node in ast.walk(tree):
        if isinstance(node, ast.Assert):
            out.append(Violation(rel, node.lineno, "bare-assert",
                                 "assert vanishes under -O; raise a typed "
                                 "exception (repro_torch.errors) instead"))

    # host-sync-in-step: .item() / .cpu() / .tolist() / .numpy() /
    # torch.cuda.synchronize() in a function body of a step module (each
    # call site once, however deep its functions nest)
    if in_step_module(rel):
        seen_sync: set = set()
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or id(node) in seen_sync:
                    continue
                dn = _dotted(node.func)
                # a method on any expression (x.cpu(), x.sum().item()):
                # _dotted cannot name a chain rooted in a call, so match
                # the attribute itself
                meth = (node.func.attr if isinstance(node.func, ast.Attribute)
                        and node.func.attr in SYNC_METHODS else None)
                if meth or dn in SYNC_CALLS:
                    seen_sync.add(id(node))
                    what = f".{meth}()" if meth else f"{dn}()"
                    out.append(Violation(
                        rel, node.lineno, "host-sync-in-step",
                        f"{what} in a function of a step module waits for "
                        f"the device on a CUDA tensor"))

    # env-read-at-trace: os.environ/os.getenv inside any function body
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            dn = ""
            if isinstance(node, ast.Call):
                dn = _dotted(node.func)
            elif isinstance(node, ast.Attribute):
                dn = _dotted(node)
            if dn in ("os.getenv", "os.environ"):
                out.append(Violation(
                    rel, node.lineno, "env-read-at-trace",
                    f"{dn} read inside {fn.name}(): read config at import "
                    f"(module-level flag) or pass it explicitly"))

    # duplicate-import: same module bound twice at module level
    seen: dict = {}
    for node in tree.body:
        names = []
        if isinstance(node, ast.Import):
            names = [(a.name, a.asname or a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mod = "." * node.level + (node.module or "")
            names = [(f"{mod}:{a.name}", a.asname or a.name)
                     for a in node.names]
        for key, _ in names:
            if key in seen:
                out.append(Violation(
                    rel, node.lineno, "duplicate-import",
                    f"{key} already imported at line {seen[key]}"))
            else:
                seen[key] = node.lineno
    return out


def lint_paths(root: str) -> list:
    """Lint every .py file under ``root`` (the src/repro_torch tree)."""
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__",))
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            out.extend(_check_file(path, rel))
    return sorted(out, key=lambda v: (v.file, v.line, v.rule))


def counts(violations: list) -> dict:
    """Per ``"file::rule"`` violation counts (the baseline unit)."""
    out: dict = {}
    for v in violations:
        key = f"{v.file}::{v.rule}"
        out[key] = out.get(key, 0) + 1
    return out


def load_baseline(path: str = BASELINE_FILE) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def write_baseline(violations: list, path: str = BASELINE_FILE) -> dict:
    c = counts(violations)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(c, f, indent=2, sort_keys=True)
        f.write("\n")
    return c


def compare(violations: list, baseline: dict) -> tuple:
    """(new, fixed): violations beyond the per-(file, rule) baseline
    count, and baseline entries whose count shrank (candidates for a
    ``--write-baseline`` refresh)."""
    cur = counts(violations)
    new = {k: (n, baseline.get(k, 0)) for k, n in cur.items()
           if n > baseline.get(k, 0)}
    fixed = {k: (cur.get(k, 0), n) for k, n in baseline.items()
             if cur.get(k, 0) < n}
    return new, fixed


def run(root: str, *, baseline_path: str = BASELINE_FILE,
        update_baseline: bool = False) -> tuple:
    """Full lint gate: returns (ok, report_lines)."""
    violations = lint_paths(root)
    if update_baseline:
        c = write_baseline(violations, baseline_path)
        return True, [f"baseline rewritten: {sum(c.values())} violation(s) "
                      f"across {len(c)} (file, rule) pair(s)"]
    baseline = load_baseline(baseline_path)
    new, fixed = compare(violations, baseline)
    lines = []
    if new:
        by_key = {}
        for v in violations:
            by_key.setdefault(f"{v.file}::{v.rule}", []).append(v)
        for k, (n, base) in sorted(new.items()):
            lines.append(f"NEW {k}: {n} violation(s), baseline {base}")
            for v in by_key[k]:
                lines.append(f"  {v}")
    if fixed:
        for k, (n, base) in sorted(fixed.items()):
            lines.append(f"improved {k}: {n} (baseline {base}) — run "
                         f"--write-baseline to ratchet down")
    lines.append(f"{len(violations)} violation(s) total, baseline "
                 f"{sum(baseline.values())}, {len(new)} regressing "
                 f"(file, rule) pair(s)")
    return not new, lines
