"""8-bit block-wise optimizers, their 32-bit twins and the Adafactor
baseline (mirrors ``repro.core.optim``).

Factory usage (the "two-line change" of the paper):

    opt = make_optimizer("adamw8", lr=1e-3)      # instead of "adamw32"
    state = opt.init(dict(model.named_parameters()))   # path-keyed
    params, state = opt.apply(grads, state)             # in place

Names: ``<algo>8`` and ``<algo>32`` for adam, adamw, momentum, lamb, lars
and adagrad, and ``adafactor32`` (muon is ROADMAP A10).  The port's
``make_optimizer`` defaults to ``pooled=False``: the pooled single dispatch
(the JAX package's default) is ROADMAP A9, and per-leaf and pooled updates
are bit-identical by the reference's own contract.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

from repro_torch.core.optim.adafactor import Adafactor, AdafactorConfig
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
    return sorted(_NAMES) + ["adafactor32"]


def make_optimizer(name_or_config: Union[str, OptimConfig, AdafactorConfig],
                   override_32bit: Optional[Callable[[str], bool]] = None,
                   *, device="cuda", **kwargs):
    """Build an optimizer from a name (``adam8``, ``lars32``,
    ``adafactor32``, ...) or a config object (``OptimConfig`` /
    ``AdafactorConfig``; ``**kwargs`` then apply as
    ``dataclasses.replace``).

    ``override_32bit``: path predicate forcing 32-bit state for matching
    leaves (defaults to the paper's stable-embedding rule for 8-bit state;
    pass ``lambda p: False`` to disable).  By name, ``pooled`` defaults to
    False (ROADMAP A9); ``adafactor32`` takes the ``AdafactorConfig``
    fields among ``**kwargs`` and ignores the rest, as in the JAX
    package."""
    if isinstance(name_or_config, AdafactorConfig):
        cfg = name_or_config
        if kwargs:
            cfg = dataclasses.replace(cfg, **kwargs)
        return Adafactor(cfg, device=device)
    if isinstance(name_or_config, OptimConfig):
        cfg = name_or_config
        if kwargs:
            cfg = dataclasses.replace(cfg, **kwargs)
        if override_32bit is None and cfg.bits == 8:
            override_32bit = default_override_32bit
        return Block8bitOptimizer(cfg, override_32bit, device=device)
    name = name_or_config
    if name == "adafactor32":
        fields = {f.name for f in dataclasses.fields(AdafactorConfig)}
        return make_optimizer(AdafactorConfig(
            **{k: v for k, v in kwargs.items() if k in fields}),
            device=device)
    if name not in _NAMES:
        raise ConfigError(f"unknown optimizer '{name}'; have "
                          f"{optimizer_names()}")
    algo, bits = _NAMES[name]
    kwargs.setdefault("pooled", False)
    return make_optimizer(OptimConfig(algo=algo, bits=bits, **kwargs),
                          override_32bit=override_32bit, device=device)


__all__ = [
    "ALGOS", "Adafactor", "AdafactorConfig", "Block8bitOptimizer",
    "Full32Leaf", "OptimConfig", "OptState",
    "Quant8Leaf", "default_override_32bit", "make_optimizer",
    "optimizer_names",
]
