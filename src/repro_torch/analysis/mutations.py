"""Test-only mutation toggles for the contract auditors (mirrors
``repro.analysis.mutations``).

An auditor that cannot fail is decoration, so the tests seed one
deliberate violation per contract class and require the matching
auditor to fire.  The violations live *in the production code paths*
behind these toggles — ``kernels/ops.py::fused_update`` turns the
gradient into float64 under ``promote_f64``, ``sharding/rules.py::
replicate_for_scales`` hands back only the caller's own span's rows under
``drop_replication_pin`` — because a violation grafted into test-only
code would not prove that the auditors watch the real dispatch.

Every toggle is read at call time; with every toggle off (the only
production state) the guarded branches are dead code.

    with mutations.seeded("promote_f64"):
        trace = runner.trace_update("adamw", 8, device="cpu")
"""
from __future__ import annotations

import contextlib

KNOWN = (
    "promote_f64",           # ops.fused_update: g through float64
    "drop_replication_pin",  # rules.replicate_for_scales: own span only
)

_ACTIVE: set = set()


def active(name: str) -> bool:
    """Whether mutation ``name`` is currently seeded."""
    return name in _ACTIVE


@contextlib.contextmanager
def seeded(name: str):
    """Seed mutation ``name`` for the duration of the block (tests only)."""
    if name not in KNOWN:
        raise ValueError(f"unknown mutation {name!r}; known: {KNOWN}")
    _ACTIVE.add(name)
    try:
        yield
    finally:
        _ACTIVE.discard(name)
