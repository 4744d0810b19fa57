"""8-bit block-wise optimizers and their 32-bit twins (mirrors
``repro.core.optim``).

Factory usage (the "two-line change" of the paper):

    opt = make_optimizer("adamw8", lr=1e-3)      # instead of "adamw32"
    state = opt.init(dict(model.named_parameters()))   # path-keyed
    params, state = opt.apply(grads, state)             # in place

The port has adam and adamw (ROADMAP A7 and A10 add the rest).  Its
``make_optimizer`` defaults to ``pooled=False``: the pooled single dispatch
(the JAX package's default) is ROADMAP A9, and per-leaf and pooled updates
are bit-identical by the reference's own contract.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

from repro_torch.core.optim.base import (ALGOS, Full32Leaf, OptimConfig,
                                         Quant8Leaf, default_override_32bit)
from repro_torch.core.optim.blockopt import Block8bitOptimizer, OptState
from repro_torch.errors import ConfigError
from repro_torch.kernels.fused_update import ALGO_SPECS

# name: (algo, bits) for every ported algorithm.
_NAMES = {f"{algo}{bits}": (algo, bits) for algo in ALGO_SPECS
          for bits in (8, 32)}


def optimizer_names() -> list:
    """Every constructible optimizer name."""
    return sorted(_NAMES)


def make_optimizer(name_or_config: Union[str, OptimConfig],
                   override_32bit: Optional[Callable[[str], bool]] = None,
                   *, device="cuda", **kwargs) -> Block8bitOptimizer:
    """Build an optimizer from a name (``adam8``, ``adamw32``, ...) or an
    ``OptimConfig`` (``**kwargs`` then apply as ``dataclasses.replace``).

    ``override_32bit``: path predicate forcing 32-bit state for matching
    leaves (defaults to the paper's stable-embedding rule for 8-bit state;
    pass ``lambda p: False`` to disable).  By name, ``pooled`` defaults to
    False (ROADMAP A9)."""
    if isinstance(name_or_config, OptimConfig):
        cfg = name_or_config
        if kwargs:
            cfg = dataclasses.replace(cfg, **kwargs)
        if override_32bit is None and cfg.bits == 8:
            override_32bit = default_override_32bit
        return Block8bitOptimizer(cfg, override_32bit, device=device)
    name = name_or_config
    if name not in _NAMES:
        raise ConfigError(f"unknown optimizer '{name}'; have "
                          f"{optimizer_names()}")
    algo, bits = _NAMES[name]
    kwargs.setdefault("pooled", False)
    return make_optimizer(OptimConfig(algo=algo, bits=bits, **kwargs),
                          override_32bit=override_32bit, device=device)


__all__ = [
    "ALGOS", "Block8bitOptimizer", "Full32Leaf", "OptimConfig", "OptState",
    "Quant8Leaf", "default_override_32bit", "make_optimizer",
    "optimizer_names",
]
