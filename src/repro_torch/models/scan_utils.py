"""Checkpointed (sqrt-N) time scan for the recurrent layers (mirrors
``repro.models.scan_utils``).

A plain loop over T timesteps keeps every step's saved tensors for the
backward: for mLSTM's matrix memory that is T x (B, H, D, D) f32 (at
xlstm-350m's train shape, B 8, H 4, D 512, one step's C is 33.5 MB; 512
steps over 21 layers would be ~360 GB).  ``checkpointed_scan`` runs the
loop in chunks of ``chunk`` steps, each under
``torch.utils.checkpoint.checkpoint`` (non-reentrant): the forward keeps
one carry per chunk, and the backward recomputes a chunk's steps when it
reaches them.  Memory drops from O(T) to O(T / chunk + chunk) steps.

The inputs are split into the chunks' pieces and each piece unbound into
its steps once (not indexed per step: a per-step index's backward would
write a zero-filled copy of the whole input for every step), and the
chunks run exactly the plain loop's ops on them; the non-reentrant
checkpoint keeps the forward's autograd graph and only recomputes its
saved tensors.  So the chunked scan's values and gradients are
bit-identical to the plain loop's.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint


def _steps(f: Callable, carry, pieces: tuple) -> tuple:
    """The steps of one piece of each input: (carry, [y_t, ...])."""
    ys = []
    for x_t in zip(*(p.unbind(0) for p in pieces)):
        carry, y = f(carry, x_t)
        ys.append(y)
    return carry, ys


def _stack(ys: list):
    """[y_t] -> ys stacked on a leading T (each component of tuple y_t)."""
    if isinstance(ys[0], tuple):
        return tuple(torch.stack(c) for c in zip(*ys))
    return torch.stack(ys)


def checkpointed_scan(f: Callable, init, xs, *, chunk: int = 64):
    """The semantics of ``jax.lax.scan(f, init, xs)``: ``f(carry, x_t) ->
    (carry, y_t)``; ``xs`` a tensor or a tuple of tensors sharing the
    leading dim T (``x_t`` is then a tensor or a tuple); ``carry`` a tensor
    or a tuple of tensors; ``y_t`` a tensor or a tuple of tensors.
    Returns (final carry, ys stacked on a leading T).

    As in the JAX package, T <= chunk or T % chunk != 0 runs the plain loop;
    otherwise the chunks run under activation checkpointing.  With
    gradients off (prefill) nothing is saved, and the plain loop runs."""
    single = isinstance(xs, torch.Tensor)
    xs = (xs,) if single else tuple(xs)
    g = (lambda c, x: f(c, x[0])) if single else f
    T = xs[0].shape[0]
    if T <= chunk or T % chunk != 0 or not torch.is_grad_enabled():
        carry, ys = _steps(g, init, tuple(x.split(T)[0] for x in xs))
        return carry, _stack(ys)
    tuple_carry = isinstance(init, tuple)
    n = len(init) if tuple_carry else 1

    def run(*args):
        carry = tuple(args[:n]) if tuple_carry else args[0]
        carry, ys = _steps(g, carry, args[n:])
        return (*(carry if tuple_carry else (carry,)), *ys)

    carry, ys = init, []
    for pieces in zip(*(x.split(chunk) for x in xs)):
        out = checkpoint(run, *(carry if tuple_carry else (carry,)),
                         *pieces, use_reentrant=False)
        carry = tuple(out[:n]) if tuple_carry else out[0]
        ys.extend(out[n:])
    return carry, _stack(ys)
