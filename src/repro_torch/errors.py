"""Typed exceptions for user-reachable validation (mirrors ``repro.errors``).

Both derive from ValueError so ``except ValueError`` callers keep working.
"""
from __future__ import annotations


class ConfigError(ValueError):
    """An invalid optimizer / training configuration value — wrong knob
    combination, unsupported bit-width, out-of-range hyperparameter."""


class FormatError(ValueError):
    """Malformed quantized-state data — shape/dtype/packing mismatches in
    codes, absmax, codebooks, or serialized state containers."""
