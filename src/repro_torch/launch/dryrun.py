"""Multi-pod dry run (mirrors ``repro.launch.dryrun``): trace every (arch x
input-shape) cell on the production meshes without a device, and record
per-device memory, FLOPs, bytes and collective bytes.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-32b \\
      --shape train_4k --mesh pod            # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multipod

The process plays rank 0 of a **fake** process group of the mesh's size
(256, 512, or 8 for "smoke"; ``launch.mesh.make_fake_mesh``).  Per cell,
under ``FakeTensorMode`` (shapes, no data): the model is built on "meta";
each parameter becomes a DTensor placed by ``sharding.rules
.param_shardings``; the activation axes are set as the JAX dry run sets
them; then one step runs at full width:

  * train: forward, backward and the update of ``adam8`` with the JAX dry
    run's settings (``impl="torch"``, weight decay 0.1, ``shard_multiple``
    = devices, ``partition_shards`` = the data-parallel degree, masters in
    ``cfg.param_dtype``), ``MICROBATCHES`` microbatches.  The gradients are
    reduced to their parameters' placements, clipped by their global norm,
    and the optimizer's own launches (``Block8bitOptimizer._launch``,
    ``_apply_full32``) update this device's local share of the state as
    ``opt_state_shardings`` lays it out: the quantized statistics' blocks
    over every mesh axis, so the gradients and masters of those blocks
    move into the block layout and back by an all-to-all over the world
    each way (the JAX package leaves that move to GSPMD); Full32 and
    small leaves update their own shards;
  * prefill / decode: ``prefill`` / ``decode_step`` with the caches placed
    by ``cache_shardings``.

The model runs as the card runs it: a train forward under the config's
``remat`` (every published config: "full"; ``--remat`` replaces it), so
the count holds the recomputed forward, its redistributions and the
checkpoints' frees, and train and prefill attention in KV chunks of
``attn_chunk``.  The recurrent scans are the one exception: in the dry
run they are counted (``models/scan_utils.counting``: a few time steps
traced, each counted as many times as the loop runs it, what the others
hold allocated at its real size), as the JAX package's cost model
multiplies a loop body by its trip count (``lower_cell(...,
count_scans=False)`` traces every step: what the tests hold the counting
to).

A :class:`~repro_torch.roofline.analysis.DeviceCounter` beneath DTensor
counts what this device runs.  The artifact
``<out>/<arch>__<shape>__<mesh>.json`` has the JAX artifact's keys:
``memory.argument_bytes`` (the placed parameters, state, batch and caches:
the sum over the local shapes the rules give), ``temp_bytes`` (the peak of
live allocations above the arguments), ``alias_bytes`` (arguments updated
in place: the train state, the caches), ``total_per_device``, ``cost``,
``roofline``; ``lower_s`` is the seconds to build and place, ``compile_s``
the seconds of the traced step.  The command line also prints what was
live at the peak above the arguments, by the op that allocated it
(``DeviceCounter.peak_breakdown``: "peak:" lines).  A cell that fails
records ``"status": "FAILED"`` with the error and the run exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import time
import traceback

import torch
from torch import nn

from repro_torch.analysis.dtypes import nbytes
from repro_torch.configs import base as cfgs
from repro_torch.core.optim import blockopt, make_optimizer
from repro_torch.core.optim.base import (Full32Leaf, Pool32Leaf,
                                         PooledQuantLeaf)
from repro_torch.kernels import fused_update as kfu
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.shapes import SHAPES, cell_supported, input_specs
from repro_torch.models import constrain as constrain_lib
from repro_torch.models import model as M
from repro_torch.models import scan_utils
from repro_torch.roofline import analysis as roofline
from repro_torch.sharding import rules
from repro_torch.train import loop as L

# per-arch microbatch count for train_4k (activation-memory knob)
MICROBATCHES = {
    "xlstm-350m": 4,
    "kimi-k2-1t-a32b": 8, "mixtral-8x22b": 8, "command-r-35b": 4,
    "qwen1.5-32b": 4, "llava-next-34b": 4, "recurrentgemma-9b": 2,
    "granite-3-8b": 2,
}

# per-cell overrides: (arch, shape) -> dict(remat=..., microbatches=...)
PERF_OVERRIDES: dict = {}

MESHES = {"pod": mesh_lib.POD, "multipod": mesh_lib.MULTI_POD,
          "smoke": ((2, 2, 2), ("pod", "data", "model")),
          "host": ((1, 1), ("data", "model"))}

LR = 1e-4


def build_mesh(kind: str):
    """The mesh of ``kind`` over a fake process group of its size."""
    if kind not in MESHES:
        raise ValueError(kind)
    return mesh_lib.make_fake_mesh(*MESHES[kind])


@contextlib.contextmanager
def _dtensor_on_fake_group():
    """Two adjustments of DTensor for a trace on the fake group:

    * its Shard -> Shard move is the card's all-to-all: on a "cpu" mesh
      DTensor stands in an all-gather and a chunk for it (gloo has no
      all-to-all), which would count the move as an all-gather of the
      whole dim;
    * a strided shard (a batch-sharded dim merged with a sequence-sharded
      one by a reshape) computes its shard sizes from small index tensors,
      which under the fake mode have no values: they are computed outside
      it."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor import placement_types as pt
    orig = cu.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        name = mesh.get_group(mesh_dim).group_name
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim,
                                                     shard_dim, name)

    mods = [m for m in (cu, pt) if getattr(m, "shard_dim_alltoall",
                                           None) is orig]
    strided = getattr(pt, "_StridedShard", None)
    sizes = vars(strided).get("local_shard_size_and_offset") \
        if strided is not None else None
    if sizes is None:
        raise RuntimeError("dry run: DTensor has no _StridedShard."
                           "local_shard_size_and_offset to run outside the "
                           "fake mode")
    for m in mods:
        m.shard_dim_alltoall = alltoall

    def outside_fake(*args, **kwargs):
        with unset_fake_temporarily():
            return sizes(*args, **kwargs)

    strided.local_shard_size_and_offset = outside_fake
    try:
        yield
    finally:
        for m in mods:
            m.shard_dim_alltoall = orig
        strided.local_shard_size_and_offset = sizes


def _local(meta: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """A fake tensor of this device's share of ``meta`` under ``spec``."""
    return torch.empty(rules.local_shape(tuple(meta.shape), spec, mesh),
                       dtype=meta.dtype)


def _place(meta: torch.Tensor, spec: tuple, mesh):
    """``meta`` as a DTensor of fake local shards placed by ``spec``."""
    from torch.distributed.tensor import DTensor
    stride = [1] * meta.dim()
    for i in range(meta.dim() - 2, -1, -1):
        stride[i] = stride[i + 1] * meta.shape[i + 1]
    return DTensor.from_local(_local(meta, spec, mesh), mesh,
                              rules.placements(spec, mesh), run_check=False,
                              shape=meta.shape, stride=tuple(stride))


def _set_param(model: nn.Module, path: str, value) -> None:
    *parents, leaf = path.split("/")
    mod = model
    for name in parents:
        mod = getattr(mod, name)
    setattr(mod, leaf, value)


def _tree_map(tree, fn, prefix=""):
    """``fn(path, tensor)`` over a cache tree (dicts, lists, tuples),
    paths as ``convert.flatten_tree`` names them."""
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(v, fn, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def _dp_axes(sizes: dict) -> tuple:
    return tuple(a for a in ("pod", "data") if a in sizes)


def _all_to_all(flat: torch.Tensor, out_numel: int, group) -> torch.Tensor:
    """``flat`` (this device's elements in one layout) exchanged over
    ``group`` for ``out_numel`` elements of another: an all-to-all with
    even splits on each side."""
    from torch.distributed import _functional_collectives as funcol
    n = group.size()
    split = lambda total: [total // n + (1 if i < total % n else 0)
                           for i in range(n)]
    return funcol.wait_tensor(funcol.all_to_all_single(
        flat, split(out_numel), split(flat.numel()), group))


class _Cell:
    """The traced step of one cell: its placed arguments and their
    expected bytes (the rules' arithmetic)."""

    def __init__(self, cfg, case, mesh, policy):
        self.cfg, self.case, self.mesh, self.policy = cfg, case, mesh, policy
        self.sizes = rules.mesh_sizes(mesh)
        self.n_chips = math.prod(self.sizes.values())
        self.expected = 0        # the rules' bytes of the arguments
        self.aliased = 0         # the arguments updated in place

    def arg(self, meta, spec, *, dtensor=True, aliased=False):
        t = _place(meta, spec, self.mesh) if dtensor and self.n_chips > 1 \
            else _local(meta, spec, self.mesh)
        b = rules.local_bytes(meta, spec, self.mesh)
        self.expected += b
        self.aliased += b if aliased else 0
        return t

    def batch(self, meta):
        spec = rules.batch_sharding(self.mesh, self.policy, meta.dim(),
                                    meta.shape[0])
        return self.arg(meta, spec), spec


def _place_model(cell: _Cell, model: M.Model, pspec: dict, train: bool):
    """Replace every parameter of the meta ``model`` by a DTensor of fake
    shards placed by its spec (by a fake tensor on a mesh of one device);
    returns {path: parameter}."""
    params = {}
    for path, p in list(model.param_dict().items()):
        dt = cell.arg(p, pspec[path], aliased=train)
        params[path] = nn.Parameter(dt, requires_grad=train)
        _set_param(model, path, params[path])
    return params


def _train_step(cell: _Cell, model, params, pspec, opt, state, batch_meta,
                micro: int):
    """Places the train step's batch and optimizer state; returns the step
    (forward, backward and the local-share update) to trace."""
    tokens, tspec = cell.batch(batch_meta["tokens"])
    embeds = espec = None
    if "embeds" in batch_meta:
        embeds, espec = cell.batch(batch_meta["embeds"])
    state_args = _place_state(cell, opt, state, pspec, params)
    return lambda: _run_train(cell, model, params, opt, state, state_args,
                              tokens, tspec, embeds, espec, micro)


def _run_train(cell, model, params, opt, state, state_args, tokens, tspec,
               embeds, espec, micro: int) -> int:
    from torch.distributed.tensor import DTensor
    cfg, mesh = cell.cfg, cell.mesh
    hyper = L.TrainHyper(microbatches=micro)

    def chunk(t, spec, i):
        local = t.to_local().chunk(micro, dim=0)[i]
        return DTensor.from_local(local, mesh, rules.placements(spec, mesh),
                                  run_check=False)

    for i in range(micro):
        emb = None if embeds is None else chunk(embeds, espec, i)
        loss, _ = L.microbatch_loss(cfg, model, hyper,
                                    chunk(tokens, tspec, i), emb)
        loss.backward()
        del loss
    # the data-parallel reduction: each gradient to its parameter's
    # layout, a small leaf's to the replicated pool's
    from torch.distributed.tensor import Replicate
    whole = [Replicate()] * mesh.ndim
    grads = {}
    for path, p in params.items():
        g = p.grad
        p.grad = None
        g = g.redistribute(mesh, whole if isinstance(
            state.leaves[path], Pool32Leaf) else p.placements)
        grads[path] = g / micro if micro > 1 else g
    norm = torch.sqrt(torch.stack([g.to(torch.float32).square().sum()
                                   for g in grads.values()]).sum())
    scale = L.clip_scale(norm.full_tensor(), hyper.grad_clip)
    local = {k: g.to_local().to(torch.float32) * scale
             for k, g in grads.items()}
    del grads
    _local_update(cell, opt, state, state_args, params, local)
    return 0                  # the state is updated in place: no output


def _whole_train_step(cell: _Cell, model, params, opt_kw: dict, batch_meta,
                      micro: int):
    """On a mesh of one device the local share is the whole state: places
    the batch and the port's own optimizer state over ``params`` (its
    masters alias them); returns the port's own train step
    (``make_train_step``) to trace."""
    tokens = cell.arg(batch_meta["tokens"], (), dtensor=False)
    batch = {"tokens": tokens}
    if "embeds" in batch_meta:
        batch["embeds"] = cell.arg(batch_meta["embeds"], (), dtensor=False)
    opt = make_optimizer("adam8", device="cpu", **opt_kw)
    state = L.TrainState(opt_state=opt.init(params), step=0)
    step = L.make_train_step(cell.cfg, model, opt,
                             L.TrainHyper(microbatches=micro))
    return lambda: (step(state, batch), 0)[1]


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages of ``tensors`` (meta ones too)."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _place_state(cell: _Cell, opt, state, pspec, params) -> dict:
    """This device's share of the optimizer state, as fake tensors: the
    quantized statistics' blocks over every mesh axis (a partitioned
    arena piece by piece) with the block offsets (and seed terms, under
    stochastic rounding) that the update reads beside them, the Full32
    moments and masters by their parameter's spec, the small-leaf pool and
    the codebooks replicated.  A master of its parameter's dtype is the
    parameter itself (the port's aliasing)."""
    out = {}
    specs = rules.opt_state_shardings(state, pspec, cell.mesh, cell.policy)
    read = ("block_offsets",) + (("leaf_seeds",) if
                                 opt.cfg.stochastic_rounding else ())
    for name, (t, spec) in specs.items():
        if name.endswith("/master") or (rules.port_only_state(name) and
                                        name.rsplit("/", 1)[1] not in read):
            continue
        out[name] = cell.arg(t, spec, dtensor=False,
                             aliased=not rules.port_only_state(name))
    for path, leaf in state.leaves.items():
        if isinstance(leaf, (PooledQuantLeaf, Full32Leaf)) and \
                leaf.master.dtype != params[path].dtype:
            out[f"leaves/{path}/master"] = cell.arg(
                leaf.master, pspec[path], dtensor=False, aliased=True)
    if state.pool32 is not None:
        # the small leaves' pool is replicated, their parameters sharded
        # by their specs: the pool holds the masters beside them
        out["pool32/master"] = cell.arg(state.pool32.master, (),
                                        dtensor=False, aliased=True)
    opt._qmap1, opt._qmap2 = (cell.arg(q, (), dtensor=False)
                              for q in (opt._qmap1, opt._qmap2))
    return out


@torch.no_grad()
def _local_update(cell: _Cell, opt, state, sargs: dict, params: dict,
                  grads: dict) -> None:
    """The optimizer's update (``Block8bitOptimizer.apply``) on this
    device's local share of the state, rank 0's: the first rows of each
    arena piece, through the optimizer's own launch per piece
    (``_launch``, the tails zeroed by ``zero_block_tails``) and its 32-bit
    update of every other leaf (``_apply_full32``)."""
    import torch.distributed as dist
    if kfu.ALGO_SPECS[opt._ew_algo].needs_norms:
        raise NotImplementedError(
            f"dry run: {opt.cfg.algo}'s trust ratios need norms over the "
            f"whole arena, which a local share does not hold")
    step_t = torch.tensor(float(state.step + 1))
    lr_t = torch.tensor(LR)
    gnorm_scale, _ = opt.percentile_clip(grads, state)
    kw = opt._kernel_kw(lr_t, step_t, gnorm_scale)
    base_seed = kfu.to_i32(state.step * 1000003)
    local = {k: p.to_local().detach() for k, p in params.items()}
    master = lambda path: sargs.get(f"leaves/{path}/master", local[path])
    arena = state.arena
    if arena is not None:
        bs = arena.master.shape[1]
        pieces = arena.pieces or (arena,)
        names = ([f"arena/pieces/{k}/" for k in range(len(arena.pieces))]
                 if arena.pieces else ["arena/"])
        rows = [-(-_piece_rows(p, arena) // cell.n_chips) for p in pieces]
        paths = [seg.path for seg in arena.segments]
        world = dist.group.WORLD
        gflat = torch.cat([grads[p].reshape(-1) for p in paths])
        g_blk = _all_to_all(gflat, sum(rows) * bs, world).view(-1, bs)
        mflat = torch.cat([master(p).reshape(-1) for p in paths])
        p_blk = _all_to_all(mflat, sum(rows) * bs, world).view(-1, bs)
        r0 = 0
        for pre, pc, n in zip(names, pieces, rows):
            fields = blockopt.STAT_FIELDS + ("block_offsets", "leaf_seeds")
            stats = dataclasses.replace(
                pc, **{f: sargs.get(pre + f) for f in fields})
            opt._launch(stats, p_blk[r0:r0 + n], g_blk[r0:r0 + n],
                        base_seed, kw)
            blockopt.zero_block_tails(
                p_blk[r0:r0 + n], arena.segments,
                row0=0 if pc is arena else pc.start)
            r0 += n
        back = _all_to_all(p_blk.reshape(-1), mflat.numel(), world)
        off = 0
        for p in paths:
            m = master(p)
            m.copy_(back[off:off + m.numel()].view(m.shape))
            off += m.numel()
    pool = None if state.pool32 is None else dataclasses.replace(
        state.pool32, **{f: sargs.get(f"pool32/{f}")
                         for f in ("master", "m", "r")})
    for path, leaf in state.leaves.items():
        pre = f"leaves/{path}/"
        if isinstance(leaf, PooledQuantLeaf):
            continue
        if isinstance(leaf, Pool32Leaf):
            leaf = blockopt._pool32_view(pool, leaf)
        elif isinstance(leaf, Full32Leaf):
            leaf = Full32Leaf(master=master(path), m=sargs[pre + "m"],
                              r=sargs.get(pre + "r"))
        else:
            raise TypeError(f"{path}: {type(leaf).__name__} has no dry-run "
                            f"update")
        opt._apply_full32(leaf, grads[path], lr_t, step_t, gnorm_scale)
    for path, p in local.items():           # the bf16 parameters' casts
        key = f"leaves/{path}/master"
        if key in sargs:
            p.copy_(sargs[key])
    if pool is not None:                    # each small parameter's shard
        from torch.distributed.tensor import DTensor, Replicate
        mesh = cell.mesh
        for path, leaf in state.leaves.items():
            if isinstance(leaf, Pool32Leaf):
                full = blockopt._pool32_view(pool, leaf).master
                shard = DTensor.from_local(
                    full, mesh, [Replicate()] * mesh.ndim,
                    run_check=False).redistribute(
                    mesh, params[path].placements).to_local()
                local[path].copy_(shard)


def _piece_rows(piece, arena) -> int:
    """Rows of an arena piece (the whole arena when unpartitioned)."""
    return piece.n if piece is not arena else arena.total


def lower_cell(arch: str, shape_name: str, mesh_kind: str,
               overrides: dict | None = None, cfg=None, case=None,
               counter: roofline.DeviceCounter | None = None,
               count_scans: bool = True) -> dict:
    """Trace one cell; returns the artifact dict.  ``cfg`` / ``case``: the
    model config / ``ShapeCase`` in place of the registry's and
    ``SHAPES[shape_name]`` (reduced ones, a calibration's shape).
    ``counter``: the ``DeviceCounter`` to count with (a new one by
    default), whose ``peak_breakdown`` the caller may read after.
    ``count_scans``: the recurrent scans traced in the counting mode of
    ``models/scan_utils`` (a few steps, counted times their trip count);
    False traces every time step (the reference the mode is held to).

    On a mesh of one device nothing is sharded: the step traced is the
    port's own (``make_train_step``, ``prefill``, ``decode_step``) on fake
    tensors, without DTensor or activation axes, the same code a run on
    the card executes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = cfg or cfgs.get_config(arch)
    case = case or SHAPES[shape_name]
    ok, why = cell_supported(cfg, case)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": why}
    overrides = dict(overrides or {})
    overrides.update(PERF_OVERRIDES.get((arch, shape_name), {}))
    cfg_keys = ("remat", "attn_chunk", "scan_layers", "kv_cache_bits")
    if any(k in overrides for k in cfg_keys):
        cfg = dataclasses.replace(
            cfg, **{k: v for k, v in overrides.items() if k in cfg_keys})

    mesh = build_mesh(mesh_kind)
    policy = rules.ShardingPolicy()
    cell = _Cell(cfg, case, mesh, policy)
    sizes = cell.sizes
    t0 = time.time()
    dp_axes = _dp_axes(sizes)
    dp_size = math.prod(sizes[a] for a in dp_axes)
    tp_size = sizes.get("model", 1)
    whole = cell.n_chips == 1
    if not whole:
        constrain_lib.set_activation_axes(
            dp_axes=dp_axes, tp_axis="model" if tp_size > 1 else None,
            dp_size=dp_size, tp_size=tp_size)
    counter = counter or roofline.DeviceCounter()
    train = case.kind == "train"
    micro = overrides.get("microbatches", MICROBATCHES.get(arch, 1))
    try:
        model = M.Model(cfg, device="meta")
        pspec = rules.param_shardings(M.logical_axes(cfg, model),
                                      model.param_dict(), mesh, policy)
        constrain_lib.set_block_param_specs(
            {k[len("blocks/"):]: v for k, v in pspec.items()
             if k.startswith("blocks/")} or None)
        opt = state = None
        ins = input_specs(cfg, case)
        if train:
            opt_kw = dict(
                lr=LR, master_dtype=("bfloat16" if cfg.param_dtype ==
                                     "bfloat16" else "float32"),
                shard_multiple=cell.n_chips, weight_decay=0.1, impl="torch",
                partition_shards=mesh_lib.data_parallel_degree(mesh))
            opt = make_optimizer("adam8", device="meta", **opt_kw)
            state = opt.init(model.param_dict())
            if whole:       # the rules' arithmetic on one device: every
                cell.expected = _storage_bytes(    # buffer the port holds
                    list(model.param_dict().values())
                    + [opt._qmap1, opt._qmap2]     # the codebooks
                    + [t for t, _ in rules.opt_state_shardings(
                        state, pspec, mesh, policy).values()])
        with FakeTensorMode(), implicit_replication(), \
                _dtensor_on_fake_group(), counter:
            with counter.arguments():
                if train and whole:
                    model = M.Model(cfg, device="cpu")
                    step = _whole_train_step(cell, model, model.param_dict(),
                                             opt_kw, ins, micro)
                elif train:
                    params = _place_model(cell, model, pspec, train)
                    step = _train_step(cell, model, params, pspec, opt,
                                       state, ins, micro)
                else:
                    _place_model(cell, model, pspec, train)
                    step = _serve_step(cell, model, ins)
            t_build = time.time() - t0
            with (scan_utils.counting(counter) if count_scans
                  else contextlib.nullcontext()):
                out_bytes = step()
            gc.collect()
        t_trace = time.time() - t0 - t_build
    finally:
        constrain_lib.clear_activation_axes()
    argument = counter.tracked_bytes
    if argument != cell.expected:
        raise AssertionError(f"argument bytes {argument} != the rules' "
                             f"{cell.expected}")
    rf = roofline.analyze(counter, n_chips=cell.n_chips,
                          model_flops_global=roofline.model_flops(cfg, case))
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok", "n_chips": cell.n_chips,
        "lower_s": round(t_build, 1), "compile_s": round(t_trace, 1),
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "memory": {
            "argument_bytes": argument,
            "output_bytes": out_bytes,
            "temp_bytes": counter.peak_bytes - argument,
            "alias_bytes": cell.aliased,
            "total_per_device": counter.peak_bytes,
        },
        "cost": {"flops": float(counter.flops),
                 "bytes accessed": float(counter.bytes_accessed)},
        "roofline": rf.to_dict(),
    }


def _serve_step(cell: _Cell, model, ins: dict):
    """Places the caches (by ``cache_shardings``) and the tokens; returns
    the step to trace, ``prefill`` or ``decode_step``, which returns its
    logits' bytes on this device."""
    cfg, case = cell.cfg, cell.case
    if case.kind == "prefill":
        caches_meta = M.init_cache(cfg, case.global_batch, case.seq_len,
                                   device="meta")
    else:
        caches_meta = ins["caches"]
    cspec = rules.cache_shardings(caches_meta, cfg, cell.mesh, cell.policy)
    caches = _tree_map(caches_meta, lambda path, t: cell.arg(
        t, cspec[path], aliased=True))
    if case.kind == "prefill":
        tokens, _ = cell.batch(ins["tokens"])
        embeds = cell.batch(ins["embeds"])[0] if "embeds" in ins else None
        run = lambda: M.prefill(cfg, model, tokens, case.seq_len,
                                embeds=embeds, caches=caches)[0]
    else:
        token, _ = cell.batch(ins["token"])
        run = lambda: M.decode_step(cfg, model, token, caches,
                                    case.seq_len - 1)[0]
    return lambda: nbytes(_local_of(run()))


def _local_of(t):
    return t.to_local() if constrain_lib.is_dtensor(t) else t


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", type=str, default="pod",
                    choices=list(MESHES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="artifacts/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--kv8", action="store_true",
                    help="int8 block-quantized KV cache (extension)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="the shape's sequence length replaced (a "
                         "calibration against a run on the card)")
    ap.add_argument("--batch", type=int, default=None,
                    help="the shape's global batch replaced")
    ap.add_argument("--remat", type=str, default=None,
                    choices=("none", "full", "dots"),
                    help="the config's activation remat replaced")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="the config cut to this many layers (a "
                         "calibration's depth)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="the train cell's microbatch count replaced")
    args = ap.parse_args(argv)

    archs = cfgs.list_archs() if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    cells = [(a, s) for a in archs for s in shapes]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape_name in cells:
        tag = f"{arch}__{shape_name}__{args.mesh}".replace("/", "_")
        case = SHAPES[shape_name]
        if args.seq_len or args.batch:
            case = dataclasses.replace(
                case, seq_len=args.seq_len or case.seq_len,
                global_batch=args.batch or case.global_batch)
            tag += f"__s{case.seq_len}b{case.global_batch}"
        if args.kv8:
            tag += "__kv8"
        overrides = {"kv_cache_bits": 8} if args.kv8 else {}
        if args.remat:
            tag += f"__remat_{args.remat}"
            overrides["remat"] = args.remat
        cfg = cfgs.get_config(arch)
        if args.n_layers:
            tag += f"__l{args.n_layers}"
            cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
        if args.microbatches:
            tag += f"__mb{args.microbatches}"
            overrides["microbatches"] = args.microbatches
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[skip cached] {tag}")
            continue
        print(f"[dryrun] {tag} ...", flush=True)
        counter = roofline.DeviceCounter()
        try:
            art = lower_cell(arch, shape_name, args.mesh,
                             overrides=overrides, cfg=cfg, case=case,
                             counter=counter)
        except Exception as e:  # a failure here is a framework bug
            failures += 1
            art = {"arch": arch, "shape": shape_name, "mesh": args.mesh,
                   "status": "FAILED", "error": repr(e),
                   "trace": traceback.format_exc()[-2000:]}
            print(f"  FAILED: {e!r}")
        with open(path, "w") as f:
            json.dump(art, f, indent=1)
        if art["status"] == "ok":
            r, mem = art["roofline"], art["memory"]
            print(f"  ok: {mem['total_per_device'] / 1e9:.2f} GB/device "
                  f"compute={r['compute_s']:.3e}s "
                  f"memory={r['memory_s']:.3e}s "
                  f"coll={r['collective_s']:.3e}s "
                  f"bottleneck={r['bottleneck']} "
                  f"useful={r['useful_flops_ratio']:.2f} "
                  f"(trace {art['compile_s']}s)", flush=True)
            for b, op, shape, dt in counter.peak_breakdown():
                print(f"  peak: {b / 1e9:.3f} GB live from {op} "
                      f"{list(shape)} {dt}", flush=True)
    print(f"done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
