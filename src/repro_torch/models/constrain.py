"""Activation sharding constraints (mirrors ``repro.models.constrain``):
divisibility-safe and context-driven.

The launcher configures the mesh axis groups once
(``set_activation_axes(dp_axes, tp_axis, dp_size, tp_size)``);
model code then calls ``constrain(x, "dp", None, "tp")`` at the JAX
package's sites.  Where the JAX package pins an XLA sharding, the port
redistributes a ``DTensor`` activation to the placements the same spec
names (``sharding.rules.placements``), so the move is a collective the
caller can count.  Every axis is dropped if it does not divide the
corresponding dim, which is what lets one model code serve every
architecture on a fixed (pod, data, model) mesh.

Sequence parallelism (Megatron-LM's, Korthikanti et al. 2022; the JAX
package pins the same layout and leaves the moves to GSPMD): between
blocks the residual stream is (batch on dp, sequence on tp), so norms and
residual adds run on a device's sequence shard.  Two explicit moves bound
each tensor-parallel region, so that no product sees the sharded
sequence:

  * :func:`seq_gather`, before a branch's first product: the sequence
    gathered whole on the tp axis (an all-gather; its backward a
    reduce-scatter of the gradient, which the products leave partial);
  * :func:`seq_scatter`, on a branch's output before the residual add:
    the residual layout (a reduce-scatter from a partial sum on the tp
    axis, a local slice from a replicated value; its backward an
    all-gather).

Without configured axes (every single-device run) each call returns its
input, and so does a call on a plain tensor: only a ``DTensor`` has a
placement to change.
"""
from __future__ import annotations

import torch

_CTX = {"dp": None, "tp": None, "dp_size": 1, "tp_size": 1,
        "block_specs": None}


def set_activation_axes(dp_axes=None, tp_axis=None, dp_size=1, tp_size=1):
    """``dp_axes``: the data-parallel mesh dim names (a tuple), ``tp_axis``
    the tensor-parallel one (the mesh is each DTensor's own)."""
    _CTX.update(dp=dp_axes, tp=tp_axis, dp_size=dp_size, tp_size=tp_size)
    if active():
        _register_sharding_rules()


_RULES_REGISTERED = []


def _register_sharding_rules():
    """Sharding rules DTensor lacks for ops of the model (once per
    process): the backward of ``logsigmoid`` (xLSTM's gates) is
    element-wise, sharded as its input is, and so is its forward's buffer
    where it has the input's shape (the CPU kernel's; CUDA's is empty)."""
    if _RULES_REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten

    @register_sharding(aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad_output, x, buffer):
        out = [([Replicate()], [Replicate(), Replicate(), Replicate()])]
        full = getattr(buffer, "ndim", 0) == x.ndim
        for d in range(x.ndim):
            out.append(([Shard(d)], [Shard(d), Shard(d),
                                     Shard(d) if full else Replicate()]))
        return out

    _RULES_REGISTERED.append(True)


def clear_activation_axes():
    set_activation_axes(None, None, 1, 1)
    _CTX["block_specs"] = None


def active() -> bool:
    return _CTX["dp"] is not None or _CTX["tp"] is not None


def _axes_and_size(kind):
    if kind == "all":
        dp, tp = _CTX["dp"], _CTX["tp"]
        axes = tuple(dp or ()) + ((tp,) if tp else ())
        return (axes or None), _CTX["dp_size"] * _CTX["tp_size"]
    return _CTX[kind], _CTX[f"{kind}_size"]


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _redistribute(x, spec: tuple):
    from repro_torch.sharding.rules import placements
    mesh = x.device_mesh
    target = placements(spec, mesh)
    if tuple(x.placements) == tuple(target):
        return x
    return x.redistribute(mesh, target)


def constrain(x: torch.Tensor, *dims):
    """dims: one of None | 'dp' | 'tp' | 'all' per tensor dim (trailing
    dims may be omitted).  Axes that don't divide the dim are dropped; a
    dim left without axes is replicated, as the JAX package's
    ``with_sharding_constraint`` of a spec with None there."""
    if not active() or not is_dtensor(x):
        return x
    spec = _spec(x, dims)
    if all(s is None for s in spec):
        return x
    return _redistribute(x, spec)


def place(x: torch.Tensor, *dims):
    """:func:`constrain` to exactly that layout: where every axis drops
    out, ``x`` is replicated (``constrain`` leaves it as it is)."""
    if not active() or not is_dtensor(x):
        return x
    return _redistribute(x, _spec(x, dims))


def _spec(x, dims) -> tuple:
    spec = []
    used = set()
    for i in range(x.ndim):
        want = dims[i] if i < len(dims) else None
        if want is None or want in used:
            spec.append(None)
            continue
        axes, size = _axes_and_size(want)
        if axes is None or size <= 1 or x.shape[i] % size != 0:
            spec.append(None)
            continue
        spec.append(axes)
        used.add(want)
    return tuple(spec)


def seq_scatter(x: torch.Tensor):
    """A (B, S, d) branch output (or the embedding) moved to the residual
    layout, ``constrain(x, "dp", "tp", None)``: the tp axis is dropped
    where it does not divide S (decode's S = 1, a frontend prefix that
    breaks divisibility) and the stream keeps batch on dp alone."""
    return constrain(x, "dp", "tp", None)


def seq_gather(x: torch.Tensor):
    """The residual ``x`` (B, S, ...) with its sequence gathered whole on
    the tp axis, its other placements kept: the input of a branch's
    products.  A tensor whose sequence is not on the tp axis is returned
    as it is."""
    if not active() or not is_dtensor(x) or _CTX["tp"] is None:
        return x
    from torch.distributed.tensor import Replicate, Shard
    i = x.device_mesh.mesh_dim_names.index(_CTX["tp"])
    p = x.placements[i]
    if not (isinstance(p, Shard) and p.dim == 1):
        return x
    whole = list(x.placements)
    whole[i] = Replicate()
    return x.redistribute(x.device_mesh, whole)


def replicated(x):
    """``x`` replicated on every mesh axis: the move GSPMD makes in front
    of an op with no sharded form (the MoE's sort-and-scatter dispatch),
    made explicit so that it is counted as a collective."""
    if not active() or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    target = [Replicate()] * x.device_mesh.ndim
    if tuple(x.placements) == tuple(target):
        return x
    return x.redistribute(x.device_mesh, target)


def attn_score_dims(KV: int, G: int, S: int):
    """Constraint dims for (B, KV, G, S, C) attention tensors: prefer kv-head
    TP, then q-group TP, then sequence TP (always divides for 4k+ seqs)."""
    tp_size = _CTX["tp_size"]
    if tp_size > 1 and KV % tp_size == 0:
        return ("dp", "tp", None, None, None)
    if tp_size > 1 and G % tp_size == 0:
        return ("dp", None, "tp", None, None)
    if tp_size > 1 and S % tp_size == 0:
        return ("dp", None, None, "tp", None)
    return ("dp", None, None, None, None)


def _unshard(x, dim: int):
    """``x`` with tensor dim ``dim`` gathered whole (its other placements
    kept)."""
    from torch.distributed.tensor import Replicate, Shard
    whole = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
             for p in x.placements]
    if whole == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, whole)


def head_split(t, n_heads: int):
    """A (B, S, n_heads * Dh) projection ready for its split into heads:
    the tp axis stays on the feature dim where it divides the head count,
    else moves to the sequence (qwen's 40 heads on a 16-way axis), as the
    JAX package's score dims fall back to sequence TP, else the features
    are gathered whole; DTensor cannot split a dim sharded mid-head."""
    if not active() or not is_dtensor(t):
        return t
    tp_size = _CTX["tp_size"]
    if tp_size > 1 and n_heads % tp_size == 0:
        return constrain(t, "dp", None, "tp")
    if tp_size > 1 and t.shape[1] % tp_size == 0:
        return constrain(t, "dp", "tp", None)
    return _unshard(t, 2)


def attention_dims(KV: int, G: int, S: int):
    """(query dims, key/value dims) for the port's (B, S, heads, D)
    attention inputs, by :func:`attn_score_dims`'s preference: the heads
    on the tp axis when it divides the kv heads; else the queries' sequence
    on it, every key gathered (the JAX package's q-group choice takes this
    path too: a device's query heads would not be contiguous); else
    neither."""
    d = attn_score_dims(KV, G, S)
    if d[1] == "tp":
        return ("dp", None, "tp", None), ("dp", None, "tp", None)
    tp_size = _CTX["tp_size"]
    if tp_size > 1 and S % tp_size == 0:
        return ("dp", "tp", None, None), ("dp", None, None, None)
    return ("dp", None, None, None), ("dp", None, None, None)


def tp_shard_dim(x, dim: int):
    """The mesh dim of the tp axis if it, and no other mesh dim, splits
    ``dim`` of the DTensor ``x`` (under configured axes) and ``x`` holds no
    partial sum: a reduction over ``dim`` is then one on the local shard
    and one across that mesh dim's group.  Else None."""
    if not active() or not is_dtensor(x) or _CTX["tp"] is None:
        return None
    from torch.distributed.tensor import Replicate, Shard
    i = x.device_mesh.mesh_dim_names.index(_CTX["tp"])
    on = [k for k, p in enumerate(x.placements)
          if type(p) is Shard and p.dim == dim]
    whole = all(type(p) in (Replicate, Shard) for p in x.placements)
    return i if on == [i] and whole else None


def shard_offset(x, dim: int) -> int:
    """Index along ``dim`` of this device's first element of the DTensor
    ``x`` (mesh dims sharding ``dim`` split it major to minor)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    n, idx = x.shape[dim], 0
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n //= mesh.size(i)
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx * n


def write_rows(buf, start: int, new) -> None:
    """``buf[:, start:start + n] = new`` in place (``n`` = ``new.shape[1]``;
    a cache's rows).  On a DTensor ``buf`` each device writes the rows it
    holds, from ``new`` made whole on dim 1: DTensor's slice of a dim
    sharded on the tp axis (a cache's sequence) gathers it into a copy, so
    an indexed write there would be lost."""
    n = new.shape[1]
    if not is_dtensor(buf):
        buf[:, start:start + n] = new
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = buf.device_mesh
    want = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in buf.placements]
    if not is_dtensor(new):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    if list(new.placements) != want:
        new = new.redistribute(mesh, want)
    local, off = buf.to_local(), shard_offset(buf, 1)
    lo, hi = max(start, off), min(start + n, off + local.shape[1])
    if lo < hi:
        local[:, lo - off:hi - off] = new.to_local()[:, lo - start:hi - start]


def kv_groups_local(KV: int) -> bool:
    """Whether the tp axis divides the kv heads (and so every head
    dim)."""
    return _CTX["tp_size"] > 1 and KV % _CTX["tp_size"] == 0


def kv_groups(q, KV: int):
    """(B, S, H, D) queries ready for their split into (KV, G) groups: the
    head dim keeps the tp axis only where it divides the kv heads, else it
    is gathered whole."""
    if not active() or not is_dtensor(q):
        return q
    tp_size = _CTX["tp_size"]
    if tp_size > 1 and KV % tp_size == 0:
        return constrain(q, "dp", None, "tp", None)
    return _unshard(q, 2)


def _tree(fn, x):
    if isinstance(x, dict):
        return {k: _tree(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(fn, v) for v in x)
    return x if x is None else fn(x)


def batch_local(fn, params, x, state):
    """``fn(params, x, state) -> (out, new_state)`` (a recurrent block)
    run on this device's batch rows under activation sharding: the
    parameters gathered whole (FSDP's gather; their gradient a partial sum
    over the data-parallel devices), ``x`` (B, S, d) and the state
    (batch-first tensors) with the batch on dp and the rest whole.  The
    blocks' scans are sequential in time and element-wise or per head, so
    each device runs its rows alone, as plain tensors (the scans' steps
    then do not each pass through DTensor).  Without axes set, or on plain
    tensors, ``fn`` runs as is."""
    if not active() or not is_dtensor(x):
        return fn(params, x, state)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    dp = set(_CTX["dp"] or ())
    names = mesh.mesh_dim_names
    on_dp = x.shape[0] % _CTX["dp_size"] == 0
    place = [Shard(0) if n in dp and on_dp else Replicate() for n in names]
    pgrad = [Partial() if n in dp and on_dp else Replicate() for n in names]

    def local(t, layout, grad):
        if list(t.placements) != layout:
            t = t.redistribute(mesh, layout)
        return t.to_local(grad_placements=grad)

    out, new = fn(
        _tree(lambda t: local(t, [Replicate()] * mesh.ndim, pgrad), params),
        local(x, place, place), _tree(lambda t: local(t, place, place), state))
    wrap = lambda t: DTensor.from_local(t, mesh, place, run_check=False)
    return wrap(out), _tree(wrap, new)


def set_block_param_specs(specs):
    """Per-leaf specs of the stacked block params, keyed by their path
    within ``blocks`` ('b0_attn/attn/wq'; the leading 'layers' dim
    included).  Each per-layer slice is constrained to spec[1:]."""
    _CTX["block_specs"] = specs


def constrain_block_params(bp: dict) -> dict:
    """One super-block's per-layer params (nested dicts keyed like the JAX
    tree) with each DTensor slice redistributed to its spec without the
    layer dim."""
    specs = _CTX["block_specs"]
    if specs is None:
        return bp

    def walk(node, prefix):
        out = {}
        for k, v in node.items():
            path = f"{prefix}{k}"
            if isinstance(v, dict):
                out[k] = walk(v, path + "/")
            elif is_dtensor(v) and path in specs:
                spec = tuple(specs[path])[1:]
                spec = spec + (None,) * (v.ndim - len(spec))
                out[k] = _redistribute(v, spec)
            else:
                out[k] = v
        return out

    return walk(bp, "")
