"""The engine of ``make_optimizer`` as a ``torch.optim.Optimizer`` (the
bitsandbytes idiom of the paper's two-line change):

    opt = BlockOptimizer(model.named_parameters(), "adamw8", lr=1e-3)
    for batch in data:
        loss_fn(model, batch).backward()
        opt.step()
        opt.zero_grad()

It adds no hyperparameter and no algorithm: ``optimizer`` is a name or a
config of :func:`~repro_torch.core.optim.make_optimizer` and every other
keyword argument is that function's, so the dispatch (pooled by default),
the formats and the seeds are the engine's.  Parameter names are read as
the engine's path strings ('.' -> '/'), so the leaf order, the
stochastic-rounding seeds and the checkpoint keys are those of
``make_optimizer(...).init(model.param_dict())``, and ``step()`` is the
engine's ``apply`` on every parameter's ``.grad`` with the param group's
``lr`` (which ``torch.optim.lr_scheduler`` may change).  The engine updates
the parameters in place.  One param group: a second raises ConfigError.
With ``shard_grads`` (ZeRO-2), or an engine on a mesh (``mesh=``), the
gradients go through the engine's ``GradBuffer`` first (on a mesh they
are averaged over its data-parallel group there), as the train loop
sends them.

``state_dict()`` holds the optimizer state as the checkpoint holds it
(``train/checkpoint.state_dict``: ``{key: tensor or int}`` in the per-leaf
canonical layout, whatever the dispatch, with the packed codes'
annotations), so a state dict restores into a pooled or a per-leaf face,
and ``load_state_dict(checkpoint.read(dir, step))`` restores a checkpoint
of the engine's state, of either package.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch

from repro_torch.core.optim.base import path_str
from repro_torch.errors import ConfigError


class BlockOptimizer(torch.optim.Optimizer):
    """``torch.optim.Optimizer`` over ``make_optimizer(optimizer, ...)``;
    ``engine`` and ``opt_state`` are the engine and its state."""

    def __init__(self, named_params: Iterable, optimizer="adamw8", *,
                 override_32bit=None, device="cuda", **kwargs):
        from repro_torch.core.optim import make_optimizer
        named = list(named_params)
        if any(isinstance(x, dict) for x in named):
            raise ConfigError("BlockOptimizer takes model.named_parameters(),"
                              " one param group; the engine's "
                              "hyperparameters are keyword arguments")
        self.paths = [path_str(name) for name, _ in named]
        if len(set(self.paths)) != len(self.paths):
            raise ValueError("parameter names must be distinct")
        self.engine = make_optimizer(optimizer, override_32bit,
                                     device=device, **kwargs)
        super().__init__([p for _, p in named],
                         {"lr": float(self.engine.cfg.lr)})
        self.opt_state = self.engine.init(
            dict(zip(self.paths, self.param_groups[0]["params"])))

    def add_param_group(self, param_group: dict) -> None:
        if getattr(self, "param_groups", None):
            raise ConfigError("BlockOptimizer has one param group")
        super().add_param_group(param_group)

    @torch.no_grad()
    def step(self, closure=None) -> Optional[torch.Tensor]:
        """One engine ``apply`` on every parameter's ``.grad``; returns the
        closure's loss, if given one."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        grads = {}
        for path, p in zip(self.paths, self.param_groups[0]["params"]):
            if p.grad is None:
                raise ValueError(f"{path} has no gradient: the engine "
                                 f"updates every parameter in each step")
            grads[path] = p.grad
        eng = self.engine
        if getattr(eng.cfg, "shard_grads_active", False) or \
                getattr(eng, "data_parallel", None) is not None:
            buf = eng.finish_grads(eng.accumulate_grads(
                eng.init_grad_buffer(self.opt_state), grads))
            grads = buf if eng.cfg.shard_grads_active else \
                eng.gather_grads(buf, self.opt_state)
        self.opt_state = eng.apply(grads, self.opt_state,
                                   lr=self.param_groups[0]["lr"])[1]
        return loss

    def state_dict(self) -> dict:
        """The checkpoint's keys and tensors (the state's own, no copy),
        their packing, and the param group's ``lr``."""
        from repro_torch.train import checkpoint
        sd = checkpoint.state_dict(self.opt_state)
        sd["param_groups"] = [{"lr": self.param_groups[0]["lr"]}]
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore :meth:`state_dict`'s or ``checkpoint.read``'s content
        in place (the parameters included)."""
        from repro_torch.train import checkpoint
        self.opt_state = checkpoint.load_state_dict(self.opt_state,
                                                    state_dict)
        for group in state_dict.get("param_groups", ())[:1]:
            self.param_groups[0]["lr"] = group["lr"]
