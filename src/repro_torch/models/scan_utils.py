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

**Counting mode** (the dry run only: ``counting(counter)`` around a step
traced on fake tensors, ``launch/dryrun.py``).  On fake tensors every time
step of a scan has the same shapes and runs the same ops, so the mode
traces a few steps of it and counts each of them, through the
``DeviceCounter``'s multiplier, as many times as the real loop runs it,
in the forward, the chunk's recompute and the backward: the trip count,
as the JAX package's cost model multiplies a while body by its trip count
(``repro/roofline/hlo_cost.py``).  With gradients off (prefill) that is
one step, T times.  Under the chunked checkpoint it is the first and the
last chunk, each traced at steps 0, 1 and chunk-1, with multipliers that
sum, at every step position, to the number of chunks, so the steps that
differ (the first, whose carry has no gradient; the last, whose carry
gets none) count once and the ops at a step boundary count right on
either side of it:

    first chunk   1,  (K-1)(chunk-2),  K-1
    last chunk  K-1,       chunk-2,      1

A custom autograd marker before each traced step sets the multiplier of
the nodes that run next in the backward (autograd runs the nodes of one
graph in the reverse order of their creation).  What the steps not
traced hold in the real loop is allocated at its real size
(``DeviceCounter.phantom``) and held as long as the real loop holds it:
the per-step outputs until the stack, the chunks' carries by the last
chunk's checkpoint (as the real chunks' checkpoints hold theirs), what a
step saves for the backward in a chunk's recompute, and the gradients of
the steps' inputs until they are stacked and concatenated.  What a step
allocates, saves and outputs is read once per scan from two steps run
uncounted (``DeviceCounter.probing``).  The stacks and the concatenation
that gather the steps are counted with their real bytes
(``DeviceCounter.account``).  So FLOPs, bytes and collectives equal the
step-by-step trace's, and its peak too, except inside a middle chunk's
backward, which is not traced: there the real loop holds one chunk's
input gradients more than the first or last chunk does (or one carry
less), which the count does not see.  The mode refuses a tensor that is
not a ``FakeTensor``: on the card and on the CPU the scan is the loop
above.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

_COUNTERS: list = []


@contextlib.contextmanager
def counting(counter):
    """Scans in the context count a few traced steps times their trip
    count on ``counter`` (a ``roofline.analysis.DeviceCounter``); every
    scan input must be a ``FakeTensor``."""
    _COUNTERS.append(counter)
    try:
        yield
    finally:
        _COUNTERS.pop()


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
    gradients off (prefill) nothing is saved, and the plain loop runs.
    Under :func:`counting` (the dry run) both are counted from a few
    traced steps (module docstring)."""
    single = isinstance(xs, torch.Tensor)
    xs = (xs,) if single else tuple(xs)
    g = (lambda c, x: f(c, x[0])) if single else f
    T = xs[0].shape[0]
    counter = _COUNTERS[-1] if _COUNTERS else None
    if counter is not None:
        _require_fake(init, xs)
    if T <= chunk or T % chunk != 0 or not torch.is_grad_enabled():
        if counter is not None and T > 1 and not torch.is_grad_enabled():
            return _counted_loop(counter, g, init, xs)
        carry, ys = _steps(g, init, tuple(x.split(T)[0] for x in xs))
        return carry, _stack(ys)
    if counter is not None and chunk >= 3:
        return _counted_chunks(counter, g, init, xs, chunk)
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


# ------------------------------------------------------------ counting mode

def _flat(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for e in tree for t in _flat(e)]


def _require_fake(*trees) -> None:
    from torch._subclasses.fake_tensor import FakeTensor
    for t in _flat(trees):
        if not isinstance(t, FakeTensor):
            raise RuntimeError(
                "scan counting mode: an input is a real tensor; the mode "
                "only counts a step traced on fake tensors (the dry run)")


def _sid(t) -> int:
    return id(t.untyped_storage())


def _dt(t) -> str:
    return str(t.dtype).replace("torch.", "")


class _Probe:
    """What one time step in the middle of a scan allocates, saves for the
    backward and outputs, from steps 0 and 1 run uncounted on a carry that
    requires a gradient (as every carry after the first step does):

    * ``out``: {origin: bytes} of the storages the step makes that its
      output ``y`` holds (what the real loop keeps until the stack);
    * ``saved`` / ``listed``: of the storages the step makes, those that it
      or the next step saves for the backward (held in a chunk's recompute
      until the step's backward), and the outputs among the rest;
    * ``carry``: [(bytes, origin, is an output)] of the carry it returns;
    * ``grads``: {input index: (bytes of one step, origin)} of the inputs
      that require a gradient."""

    def __init__(self, counter, g, init, xs, grad: bool):
        saved = [set(), set()]
        k = [0]

        def pack(t):           # no backward runs: keep the storage's id only
            saved[k[0]].add(_sid(t))
            return None

        leaf = lambda t: t.detach().requires_grad_(t.is_floating_point()) \
            if grad else t
        with counter.probing() as made, torch.set_grad_enabled(grad), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda n: n):
            tup = isinstance(init, tuple)
            carry = tuple(leaf(t) for t in init) if tup else leaf(init)
            before = set(made)
            carry, y = g(carry, tuple(x[0] for x in xs))
            first = {i: made[i][:2] for i in set(made) - before}
            k[0] = 1
            g(carry, tuple(x[1] for x in xs))
        ys = {_sid(t) for t in _flat(y)}
        del made

        def group(ids) -> dict:
            out = {}
            for i in ids:
                n, origin = first[i]
                out[origin] = out.get(origin, 0) + n
            return out

        keep = set(first) & (saved[0] | saved[1])
        self.out = group(set(first) & ys)
        self.saved = group(keep)
        self.listed = group((set(first) & ys) - keep)
        self.carry = []
        for t in _flat(carry):
            n, origin = first.get(_sid(t), (t.untyped_storage().nbytes(), (
                "carry", tuple(t.shape), _dt(t))))
            self.carry.append((n, origin, _sid(t) in ys))
        self.grads = {i: (x.numel() // x.shape[0] * x.element_size(),
                          ("grad", tuple(x.shape[1:]), _dt(x)))
                      for i, x in enumerate(xs) if x.requires_grad}


def _phantoms(counter, groups: dict, times: int, device) -> list:
    return [counter.phantom(times * n, origin, device)
            for origin, n in groups.items() if times * n > 0]


def _meta(t) -> tuple:
    """(shape, dtype, device) of ``t``: what a backward needs of an input
    without holding it."""
    return tuple(t.shape), t.dtype, t.device


def _gathered(counter, name: str, meta: tuple):
    """The output of a stack or a concatenation of time steps, of ``meta``
    (shape, dtype, device), which reads as many bytes as it writes:
    allocated uncounted, then counted as the op ``name``."""
    shape, dtype, device = meta
    counter._muted += 1
    try:
        out = torch.empty(shape, dtype=dtype, device=device)
    finally:
        counter._muted -= 1
    counter._add_storage(out, origin=(name, shape, _dt(out)))
    counter.account(name, out.numel() * out.element_size(), out)
    return out


class _Stack(torch.autograd.Function):
    """``torch.stack`` of T time steps' outputs of which the traced ones
    are given (at ``positions``), the others held by phantoms until it
    runs.  Its backward (views of the gradient) first sets the multiplier
    of the last traced step."""

    @staticmethod
    def forward(ctx, counter, T: int, positions, last: int, *ys):
        ctx.counter, ctx.positions, ctx.last = counter, positions, last
        y = ys[0]
        return _gathered(counter, "stack",
                         ((T,) + tuple(y.shape), y.dtype, y.device))

    @staticmethod
    def backward(ctx, g):
        ctx.counter.scale = ctx.last
        return (None, None, None, None, *(g[p] for p in ctx.positions))


def _counted_stack(counter, ys: list, T: int, positions, last: int):
    """``_stack`` of the traced outputs ``ys`` (at ``positions`` of T)."""
    if isinstance(ys[0], tuple):
        return tuple(_Stack.apply(counter, T, positions, last, *c)
                     for c in zip(*ys))
    return _Stack.apply(counter, T, positions, last, *ys)


def _counted_loop(counter, g, init, xs):
    """The loop with gradients off: one step traced on ``init``, counted T
    times, with the other steps' outputs, and the carry the last step
    reads where it is not one of them, held beside it."""
    T = xs[0].shape[0]
    dev = xs[0].device
    probe = _Probe(counter, g, init, xs, grad=False)
    held = _phantoms(counter, probe.out, T - 1, dev)
    prev = [counter.phantom(n, origin, dev)
            for n, origin, is_out in probe.carry if not is_out]
    with counter.scaled(T):
        carry, y = g(init, tuple(x[0] for x in xs))
    del prev
    return carry, _counted_stack(counter, [y], T, (T - 1,), 1)


def _marked(fn, st, *carry):
    """``carry`` (a flat tuple) with the components that require a
    gradient passed through the marker ``fn`` (views)."""
    idx = [i for i, t in enumerate(carry) if t.requires_grad]
    if not idx:
        return carry
    out = list(carry)
    for i, t in zip(idx, fn(st, *(carry[i] for i in idx))):
        out[i] = t
    return tuple(out)


class _Mark(torch.autograd.Function):
    """On the carry into traced step ``slot`` of a chunk.  Its backward runs
    after that step's nodes and before the previous step's: it sets the
    multiplier of the previous step (of the chunk's stack of input
    gradients, before step 0), and at the step that stands for the chunk's
    middle steps it trades what those steps saved for their input
    gradients."""

    @staticmethod
    def forward(ctx, st, slot: int, *carry):
        ctx.st, ctx.slot = st, slot
        return tuple(t.view_as(t) for t in carry)

    @staticmethod
    def backward(ctx, *grads):
        st, slot = ctx.st, ctx.slot
        if slot == st.rep + 1 and st.trade_early or slot == st.rep:
            st.trade()
        st.counter.scale = st.mults[slot - 1] if slot else st.stack_mult
        return (None, None, *grads)


class _StepViews(torch.autograd.Function):
    """A chunk's pieces unbound into the traced steps' inputs (views).  Its
    backward is the unbind's: the stack of the chunk's step gradients,
    the traced ones and the phantoms of the others, counted with the
    chunk's multiplier of it."""

    @staticmethod
    def forward(ctx, st, *pieces):
        ctx.st = st
        ctx.metas = [_meta(p) for p in pieces]
        return tuple(p[t] for t in st.slots for p in pieces)

    @staticmethod
    def backward(ctx, *grads):
        st = ctx.st
        st.counter.scale = st.stack_mult
        nx = len(ctx.metas)
        out = []
        for i, meta in enumerate(ctx.metas):
            if all(grads[s * nx + i] is None for s in range(len(st.slots))):
                out.append(None)
                continue
            out.append(_gathered(st.counter, "stack", meta))
        st.done()
        return (None, *out)


class _Chunk:
    """One traced chunk: its steps ``slots`` and their multipliers, the
    multiplier of its stack of input gradients, and the phantoms of its
    middle steps (``skip`` of them not traced)."""

    def __init__(self, counter, g, probe, n_carry, tup, nx, chunk, mults,
                 stack_mult, device):
        self.counter, self.g, self.probe = counter, g, probe
        self.n, self.tup, self.nx, self.device = n_carry, tup, nx, device
        self.slots = (0, 1, chunk - 1)
        self.rep = 1
        self.skip = chunk - len(self.slots)
        self.mults, self.stack_mult = mults, stack_mult
        saved = sum(probe.saved.values())
        self.trade_early = sum(n for n, _ in probe.grads.values()) > saved
        self.calls = 0
        self.saved = self.grads = None

    def done(self):
        """The chunk's backward has run: drop what the autograd nodes would
        otherwise keep alive through this state (the step function and
        what it captures, the phantoms) for as long as the graph lives."""
        self.g = self.probe = self.saved = self.grads = None

    def trade(self):
        """The middle steps' backward, untraced: what they saved is freed,
        their input gradients are made (held until the chunk's stack)."""
        if self.grads is not None or not self.skip:
            return
        self.saved = None
        self.grads = [self.counter.phantom(self.skip * n, origin, self.device)
                      for n, origin in self.probe.grads.values()]

    def run(self, *args):
        """The checkpointed function: the traced steps (the carries, the
        pieces, then extra arguments held for the checkpoint); returns the
        carry, the traced outputs and the middle steps' outputs."""
        self.calls += 1
        recompute = self.calls > 1
        carry = tuple(args[:self.n])
        nx = self.nx
        views = _StepViews.apply(self, *args[self.n:self.n + nx])
        ys, held = [], []
        for i in range(len(self.slots)):
            if torch.is_grad_enabled():
                carry = _marked(lambda st, *c: _Mark.apply(st, i, *c), self,
                                *carry)
            x_t = tuple(views[i * nx:(i + 1) * nx])
            with self.counter.scaled(self.mults[i]):
                c, y = self.g(carry if self.tup else carry[0], x_t)
            carry = tuple(c) if self.tup else (c,)
            ys.append(y)
            if i == self.rep and self.skip:
                if recompute:
                    self.saved = _phantoms(self.counter, self.probe.saved,
                                           self.skip, self.device)
                    held += _phantoms(self.counter, self.probe.listed,
                                      self.skip, self.device)
                else:
                    held += _phantoms(self.counter, self.probe.out,
                                      self.skip, self.device)
        self.ny = len(_flat(ys[0]))
        self.y_tuple = isinstance(ys[0], tuple)
        return (*carry, *(t for y in ys for t in _flat(y)), *held)

    def split(self, out):
        """(carry, [y of each slot], held) of ``run``'s outputs."""
        n, ny = self.n, self.ny
        ys = []
        for i in range(len(self.slots)):
            comps = tuple(out[n + i * ny:n + (i + 1) * ny])
            ys.append(comps if self.y_tuple else comps[0])
        return tuple(out[:n]), ys, list(out[n + len(self.slots) * ny:])


class _Scan:
    """The state shared by a counted chunked scan's markers: the middle
    chunks' input gradients, made when the backward passes from the last
    chunk to the first."""

    def __init__(self, counter, probe, chunk, K, device):
        self.counter, self.probe = counter, probe
        self.chunk, self.K, self.device = chunk, K, device
        self.grads = None


class _Boundary(torch.autograd.Function):
    """On the carry from the first traced chunk into the last.  Its
    backward stands for the middle chunks' backward: it makes their
    stacked input gradients (held until the concatenation) and sets the
    multiplier of the first chunk's last step."""

    @staticmethod
    def forward(ctx, scan, mult: int, *carry):
        ctx.scan, ctx.mult = scan, mult
        return tuple(t.view_as(t) for t in carry)

    @staticmethod
    def backward(ctx, *grads):
        scan = ctx.scan
        mid = (scan.K - 2) * scan.chunk
        scan.grads = [scan.counter.phantom(
            mid * n, ("stack", (scan.chunk,) + origin[1], origin[2]),
            scan.device) for n, origin in scan.probe.grads.values()
            if mid]
        scan.counter.scale = ctx.mult
        return (None, None, *grads)


class _Pieces(torch.autograd.Function):
    """The first and the last chunk of each input (views of ``split``'s
    first and last pieces).  Its backward is the split's: the
    concatenation of every chunk's stacked input gradients, counted once
    (the middle chunks' are the phantoms made by ``_Boundary``)."""

    @staticmethod
    def forward(ctx, scan, *xs):
        ctx.scan, ctx.metas = scan, [_meta(x) for x in xs]
        c, T = scan.chunk, xs[0].shape[0]
        return (*(x[:c] for x in xs), *(x[T - c:] for x in xs))

    @staticmethod
    def backward(ctx, *grads):
        scan = ctx.scan
        scan.counter.scale = 1
        nx = len(ctx.metas)
        out = []
        for i, meta in enumerate(ctx.metas):
            if grads[i] is None and grads[nx + i] is None:
                out.append(None)
                continue
            out.append(_gathered(scan.counter, "cat", meta))
        scan.grads = None
        return (None, *out)


def _counted_chunks(counter, g, init, xs, chunk: int):
    """The chunked scan (T = K chunks) counted from its first and last
    chunk, each traced at steps 0, 1 and chunk-1 (module docstring)."""
    T = xs[0].shape[0]
    K = T // chunk
    dev = xs[0].device
    tup = isinstance(init, tuple)
    carry = tuple(init) if tup else (init,)
    probe = _Probe(counter, g, init, xs, grad=True)
    scan = _Scan(counter, probe, chunk, K, dev)
    pieces = _Pieces.apply(scan, *xs)
    nx = len(xs)
    mid = chunk - 2
    first = _Chunk(counter, g, probe, len(carry), tup, nx, chunk,
                   (1, (K - 1) * mid, K - 1), 1, dev)
    last = _Chunk(counter, g, probe, len(carry), tup, nx, chunk,
                  (K - 1, mid, 1), K - 1, dev)
    carry, ys_a, held_a = first.split(checkpoint(
        first.run, *carry, *pieces[:nx], use_reentrant=False))
    # the middle chunks' outputs (their carries apart) until the stack,
    # and their carries, held by the last chunk's checkpoint as each real
    # chunk's checkpoint holds the carry it starts from
    held = {}
    for origin, n in probe.out.items():
        held[origin] = held.get(origin, 0) + chunk * n
    frames = []
    for n, origin, is_out in probe.carry:
        if is_out:
            held[origin] -= n
        frames += _phantoms(counter, {origin: n}, K - 2, dev)
    held_mid = _phantoms(counter, held, K - 2, dev)
    carry = _marked(lambda st, *c: _Boundary.apply(st, first.mults[-1], *c),
                    scan, *carry)
    carry, ys_b, held_b = last.split(checkpoint(
        last.run, *carry, *pieces[nx:], *frames, use_reentrant=False))
    del frames
    off = (K - 1) * chunk
    positions = tuple(first.slots) + tuple(off + t for t in last.slots)
    ys = _counted_stack(counter, ys_a + ys_b, T, positions, last.mults[-1])
    del held_a, held_mid, held_b
    return (carry if tup else carry[0]), ys
