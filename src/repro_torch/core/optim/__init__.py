"""8-bit block-wise optimizers, their 32-bit twins, Muon and the Adafactor
baseline (mirrors ``repro.core.optim``).

Factory usage (the "two-line change" of the paper):

    opt = make_optimizer("adamw8", lr=1e-3)      # instead of "adamw32"
    state = opt.init(dict(model.named_parameters()))   # path-keyed
    params, state = opt.apply(grads, state)             # in place

Names: ``<algo>8`` and ``<algo>32`` for adam, adamw, momentum, lamb, lars,
adagrad and muon, and ``adafactor32``.  Sub-byte states are a config field:
``make_optimizer("adam8", state_bits=(4, 8))`` stores a packed 4-bit first
moment and an 8-bit second moment; the same knob packs Muon's matrix
momentum.  As in the JAX package, ``pooled=True`` (one fused dispatch for
all quantized leaves) is the default and ``pooled=False`` the per-leaf
dispatch; the two are bit-identical.  The same engine as a
``torch.optim.Optimizer``::

    opt = BlockOptimizer(model.named_parameters(), "adamw8", lr=1e-3)
    loss.backward(); opt.step(); opt.zero_grad()
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

from repro_torch.core.optim.adafactor import Adafactor, AdafactorConfig
from repro_torch.core.optim.base import (ALGOS, ArenaPartition, BucketPlan,
                                         Full32Leaf, OptimConfig,
                                         Pool32Arena, Pool32Leaf,
                                         PooledQuantLeaf, Quant8Leaf,
                                         QuantArena, default_override_32bit,
                                         make_buckets, make_partition)
from repro_torch.core.optim.blockopt import (Block8bitOptimizer, GradBuffer,
                                             OptState, repool_like,
                                             unpool_state)
from repro_torch.core.optim.muon import MuonOptimizer
from repro_torch.core.optim.torch_optim import BlockOptimizer
from repro_torch.errors import ConfigError
from repro_torch.sharding.rules import data_parallel_degree

# name: (algo, bits) — every algorithm gets an "<algo>8" and an "<algo>32".
_NAMES = {f"{algo}{bits}": (algo, bits) for algo in ALGOS
          for bits in (8, 32)}


def optimizer_names() -> list:
    """Every constructible optimizer name."""
    return sorted(_NAMES) + ["adafactor32"]


def make_optimizer(name_or_config: Union[str, OptimConfig, AdafactorConfig],
                   override_32bit: Optional[Callable[[str], bool]] = None,
                   *, device="cuda", mesh=None, **kwargs):
    """Build an optimizer from a name (``adam8``, ``lars32``,
    ``adafactor32``, ...) or a config object (``OptimConfig`` /
    ``AdafactorConfig``; ``**kwargs`` then apply as
    ``dataclasses.replace``).

    ``override_32bit``: path predicate forcing 32-bit state for matching
    leaves (defaults to the paper's stable-embedding rule for 8-bit state,
    and for muon at any width; pass ``lambda p: False`` to disable).  For
    muon the override also routes matched 2-D leaves to the element-wise
    adamw fallback, so muon32 and muon8 route alike, as in the JAX
    package.  ``adafactor32`` takes the ``AdafactorConfig`` fields among
    ``**kwargs`` and ignores the rest, as in the JAX package.

    ``mesh``: a ``torch.distributed.DeviceMesh`` (``launch.mesh.make_mesh``)
    whose ``partition_axes`` dims ("data"; "pod,data") form the
    data-parallel process group: the gradients are reduced over it and the
    partitioned arena owns one span per rank.  As in the JAX package, when
    ``partition_shards`` was left at 1 it is derived from the mesh (the
    product of those dims' sizes), so partitioning turns on by itself on a
    group of more than one rank, and ``partition=False`` opts out."""
    if isinstance(name_or_config, AdafactorConfig):
        cfg = name_or_config
        if kwargs:
            cfg = dataclasses.replace(cfg, **kwargs)
        return Adafactor(cfg, device=device)
    if isinstance(name_or_config, OptimConfig):
        cfg = name_or_config
        if kwargs:
            cfg = dataclasses.replace(cfg, **kwargs)
        if mesh is not None and cfg.partition_shards == 1:
            names = mesh.mesh_dim_names or ()
            if cfg.partition_axes and all(a in names
                                          for a in cfg.partition_axes):
                cfg = dataclasses.replace(
                    cfg, partition_shards=data_parallel_degree(
                        mesh, cfg.partition_axes))
        if override_32bit is None and (cfg.bits == 8 or cfg.algo == "muon"):
            override_32bit = default_override_32bit
        engine = MuonOptimizer if cfg.algo == "muon" else Block8bitOptimizer
        return engine(cfg, override_32bit, device=device, mesh=mesh)
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
    return make_optimizer(OptimConfig(algo=algo, bits=bits, **kwargs),
                          override_32bit=override_32bit, device=device,
                          mesh=mesh)


__all__ = [
    "ALGOS", "Adafactor", "AdafactorConfig", "ArenaPartition",
    "Block8bitOptimizer", "BlockOptimizer", "BucketPlan", "Full32Leaf",
    "GradBuffer", "MuonOptimizer", "OptimConfig", "OptState", "Pool32Arena",
    "Pool32Leaf", "PooledQuantLeaf", "Quant8Leaf", "QuantArena",
    "default_override_32bit", "make_buckets", "make_optimizer",
    "make_partition", "optimizer_names", "repool_like", "unpool_state",
]
