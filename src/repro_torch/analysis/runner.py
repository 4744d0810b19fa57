"""Trace recorder, config matrix and contract evaluator (mirrors
``repro.analysis.runner``).

The JAX package lowers every subject with ``jax.jit(...).lower(...)`` and
reads the StableHLO text.  The port runs eagerly, so it *runs* each
subject once and records what ran (:class:`Recorder`, a
``TorchDispatchMode``): every aten op with the dtypes of its tensor
inputs and outputs and the storages its write-aliased arguments name;
every collective, as the mode sees the ``c10d`` ops (gloo's and nccl's
eager collectives go through the dispatcher); every CUDA kernel launch —
the kernels are called through ``ctypes`` and invisible to a dispatch
mode, so the recorder reads the kernel layer's own launch counters
(``kernels.ops.launch_counts`` and B7's ``paged_kv.gather_cuda``) before
each op and records one ``kernel`` event per launch since the last op;
every fused-update dispatch (``ops.fused_update_count``) as the
``fused_update_dispatch`` marker; and every ``contracts.mark``.  Around
the call it records the storage of every tensor of the named state, so
``check_donates`` sees whether the state stayed in place.

The subjects, all on the harness below (the JAX package's ``_harness``):

  * ``trace_step`` — one train step of a matrix cell (after one untraced
    warm-up step, so lazily made buffers are not counted as moved);
  * ``trace_update`` — one bare fused update per (algo, bits): adamw and
    muon at 8 and 4 bits, through the plain route on the CPU (adamw:
    ``impl="plain"``, the kernels' plain versions; muon: ``"torch"``, its
    only plain route) and the CUDA route on the card;
  * ``trace_serve`` — one ``models.model.paged_decode_step`` at kv 8 and 4.

The matrix (:func:`default_cells`) keeps the JAX package's 12 cells —
adamw8 and muon8 x (8, 8) and (4, 8) x pooled, ``part4`` (ZeRO-1 over 4
spans) and ``part4-zero2`` (ZeRO-2, 2 buckets) — all in **one process**
through the unrolled span dispatch (``blockopt.apply`` with no process
group), and adds ``lamb8-b88-part4``: the port's replication contract
(``partitioned_step.replicated_scales``, ``.partition_pins``) is about
the lamb/lars trust ratios, finalized from per-block partials gathered
whole (``blockopt._partition_scales``), so only a partitioned lamb/lars
cell carries it; adamw and muon have no trust ratio to gather.
``train_step.collective_order`` needs a process group and is evaluated
by ``tests/test_torch_dist.py`` (worlds of 2 and 4, gloo); in one process
the step runs no collective and the contract does not apply.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import traceback
import warnings
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import contracts as C
from repro_torch.analysis import dtypes


@dataclasses.dataclass(frozen=True)
class Cell:
    """One config-matrix point (static description; contracts read it)."""
    name: str
    algo: str                  # optimizer name for make_optimizer
    state_bits: tuple          # (bits_m, bits_r)
    partition: int = 1         # partition_shards (1 = pooled, unsharded)
    shard_grads: bool = False  # ZeRO-2 grad accumulation
    overlap_buckets: int = 1
    world: int = 1             # ranks of the process group (1: none)


def default_cells() -> list:
    """The audited matrix: one pooled and two partitioned cells per (algo,
    bits) point, plus the partitioned lamb8 cell of the trust-ratio
    contract.  adamw exercises the two-state element-wise family, muon the
    matrix-class path; (4, 8) rides the sub-byte packing."""
    cells = []
    for algo in ("adamw8", "muon8"):
        for bits in ((8, 8), (4, 8)):
            tag = f"{algo}-b{bits[0]}{bits[1]}"
            cells.append(Cell(f"{tag}-pooled", algo, bits))
            cells.append(Cell(f"{tag}-part4", algo, bits, partition=4))
            cells.append(Cell(f"{tag}-part4-zero2", algo, bits,
                              partition=4, shard_grads=True,
                              overlap_buckets=2))
    cells.append(Cell("lamb8-b88-part4", "lamb8", (8, 8), partition=4))
    return cells


# ---------------------------------------------------------------- recorder
# c10d op name -> the collective it runs
_COLLECTIVES = {
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "all_reduce": "all_reduce", "_allgather_base_": "all_gather",
    "allgather_": "all_gather", "allgather_into_tensor_coalesced_":
    "all_gather", "all_gather_into_tensor": "all_gather",
    "_reduce_scatter_base_": "reduce_scatter", "reduce_scatter_":
    "reduce_scatter", "reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "reduce_scatter_tensor": "reduce_scatter", "broadcast_": "broadcast",
    "gather_": "gather", "scatter_": "scatter", "alltoall_base_":
    "all_to_all", "all_to_all_single": "all_to_all", "barrier": "barrier",
}
DISPATCH_MARK = "fused_update_dispatch"


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


def _dtype(t: torch.Tensor) -> str:
    try:
        return dtypes.dtype_name(t.dtype)
    except KeyError:
        return str(t.dtype)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _counters() -> tuple:
    """(kernel launch counts by name, fused-update dispatches)."""
    from repro_torch.kernels import ops, paged_kv
    counts = dict(ops.launch_counts())
    counts["paged_gather"] = paged_kv.gather_cuda.launches
    return counts, ops.fused_update_count()


class Recorder(TorchDispatchMode):
    """Records the events of what runs under it (see the module doc)."""

    def __init__(self):
        super().__init__()
        self.events: list = []

    def __enter__(self):
        self._last = _counters()
        self._listen = C.listening(self._mark)
        self._listen.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        self.poll()
        self._listen.__exit__(*exc)
        return super().__exit__(*exc)

    def poll(self) -> None:
        """Record the kernel launches and dispatches since the last poll."""
        counts, dispatches = _counters()
        last_counts, last_dispatches = self._last
        for _ in range(dispatches - last_dispatches):
            self.events.append(C.Event("marker", DISPATCH_MARK))
        for name, n in counts.items():
            for _ in range(n - last_counts.get(name, 0)):
                self.events.append(C.Event("kernel", name))
        self._last = (counts, dispatches)

    def _mark(self, name: str, attrs: dict) -> None:
        self.poll()
        self.events.append(C.Event("marker", name,
                                   attrs=tuple(sorted(attrs.items()))))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.poll()
        out = func(*args, **kwargs)
        ns, op = func.namespace, func.__name__.split(".")[0]
        writes = []
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            v = kwargs.get(a.name, args[i] if i < len(args) else None)
            writes += [_storage(t) for t in _tensors(v)]
        if ns in ("c10d", "_c10d_functional") and op in _COLLECTIVES:
            kind, name = "collective", _COLLECTIVES[op]
        else:
            kind, name = "op", str(func)
        self.events.append(C.Event(
            kind, name,
            ins=tuple(_dtype(t) for t in _tensors((args, kwargs))),
            outs=tuple(_dtype(t) for t in _tensors(out)),
            writes=tuple(writes),
            exempt=tuple(sorted({d for d, _ in C.exemptions()}))))
        return out


def state_storages(tree, prefix: str = "") -> dict:
    """{path: (storage address, dtype name, bytes)} of every tensor of a
    state tree (dataclasses, named tuples, dicts, lists)."""
    out: dict = {}

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            out[path] = (_storage(x), _dtype(x), dtypes.nbytes(x))
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{path}/{f.name}")
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for k, v in zip(x._fields, x):
                walk(v, f"{path}/{k}")
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}/{i}")

    walk(tree, prefix)
    return out


def _opt_state_pieces(opt_state) -> dict:
    """The optimizer state the step must keep in place: the leaves, the
    arenas and the casts — not the percentile-clipping history, which the
    step replaces by design (a 16-entry vector)."""
    return {"leaves": opt_state.leaves, "arena": opt_state.arena,
            "pool32": opt_state.pool32, "casts": opt_state.casts}


def record(name: str, fn, states: dict) -> tuple:
    """Run ``fn()`` under a :class:`Recorder`; ``states``: {name:
    callable(result or None) -> tree} giving each named state before (with
    None) and after the call.  Returns (Trace, fn's result)."""
    before = {k: state_storages(get(None)) for k, get in states.items()}
    with Recorder() as rec:
        result = fn()
    after = {k: state_storages(get(result)) for k, get in states.items()}
    return C.Trace(name, tuple(rec.events), before, after), result


# ------------------------------------------------------------- subjects
@functools.lru_cache(maxsize=1)
def harness():
    """(cfg, batch) the matrix traces: reduced paper-lm-209m at d_model
    64, 2 layers, vocab 128; 8 sequences of 32 tokens."""
    from repro_torch.configs import base
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    cfg = base.reduced(base.get_config("paper-lm-209m"), d_model=64,
                       n_layers=2, vocab_size=128)
    pipe = SyntheticLMPipeline(DataConfig(vocab_size=128, seq_len=32,
                                          global_batch=8))
    return cfg, pipe.batch_at(0)


def make_opt(cell: Cell, device, mesh=None, **overrides):
    from repro_torch.core.optim import make_optimizer
    kw = dict(lr=5e-3, min_8bit_size=1024, state_bits=cell.state_bits)
    if cell.partition > 1:
        kw.update(partition_shards=cell.partition,
                  shard_grads=cell.shard_grads,
                  overlap_buckets=cell.overlap_buckets)
    kw.update(overrides)
    return make_optimizer(cell.algo, device=device, mesh=mesh, **kw)


def trace_step(cell: Cell, *, device, cfg=None, batch=None, mesh=None,
               **overrides) -> C.Trace:
    """The trace of one train step of ``cell`` (the harness's model and
    batch unless ``cfg`` / ``batch`` are given; ``overrides`` replace
    optimizer options), after one untraced warm-up step."""
    from repro_torch.train import loop as L
    if cfg is None:
        cfg, batch = harness()
    opt = make_opt(cell, device, mesh, **overrides)
    state, model = L.init_train_state(cfg, opt,
                                      torch.Generator().manual_seed(0),
                                      device=device)
    step = L.make_train_step(cfg, model, opt)
    state, _ = step(state, batch)
    pieces = lambda out: _opt_state_pieces((state if out is None
                                            else out[0]).opt_state)
    tag = "".join(f"-{k}{v}" for k, v in sorted(overrides.items()))
    trace, _ = record(f"step:{cell.name}{tag}", lambda: step(state, batch),
                      {"opt_state": pieces})
    return trace


def update_impl(algo: str, device) -> str:
    """The update scope's route: "cuda" on the card; on the CPU the plain
    versions ("plain" for the element-wise algorithms, "torch" for
    muon)."""
    if torch.device(device).type == "cuda":
        return "cuda"
    return "torch" if algo == "muon" else "plain"


def trace_update(algo: str, bits_m: int = 8, *, device) -> C.Trace:
    """The trace of one bare fused update of ``algo`` with ``bits_m``-bit
    momentum (8 blocks of 256; muon a (32, 64) leaf), the state from a
    seed."""
    from repro_torch.core import qmap as qmap_lib
    from repro_torch.core.lowbit.packing import PackedCodes, packed_width
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ops
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(0)
    nb, bsz = 8, 256
    two = fu.ALGO_SPECS[algo].n_states == 2
    shape = (32, 64) if algo == "muon" else (nb, bsz)
    p = torch.randn(shape, generator=gen).to(dev)
    g = (1e-2 * torch.randn(shape, generator=gen)).to(dev)
    qm = torch.as_tensor(qmap_lib.dynamic_map(signed=True, bits=bits_m),
                         device=dev)
    qr = torch.as_tensor(qmap_lib.dynamic_map(signed=False), device=dev)
    cm = torch.randint(0, 256, (nb, packed_width(bsz, bits_m)),
                       generator=gen, dtype=torch.uint8).to(dev)
    if bits_m != 8:
        cm = PackedCodes(cm, bits_m, bsz)
    am = torch.rand(nb, generator=gen).to(dev)
    cr = torch.randint(0, 256, (nb, bsz), generator=gen,
                       dtype=torch.uint8).to(dev) if two else None
    ar = torch.rand(nb, generator=gen).to(dev) if two else None
    impl = update_impl(algo, dev)
    run = lambda: ops.fused_update(algo, p, g, cm, am, cr, ar, qm,
                                   qr if two else None, lr=1e-3, impl=impl)
    trace, _ = record(f"update:{algo}-b{bits_m}", run, {})
    return trace


def trace_serve(kv_bits: int = 8, *, device) -> C.Trace:
    """The trace of one paged decode step of the harness's model (4 slots,
    16 pages of 8 positions) at ``kv_bits``; the caches are the named
    state."""
    from repro_torch.models import layers, model as M
    cfg, _ = harness()
    dev = torch.device(device)
    model = M.init_model(cfg, torch.Generator().manual_seed(0), device=dev)
    n_slots = 4
    caches = M.init_paged_cache(cfg, n_slots, 16, 8, kv_bits, device=dev)
    paged = layers.PagedContext(
        torch.zeros((n_slots, 4), dtype=torch.int32, device=dev),
        torch.zeros((n_slots,), dtype=torch.int32, device=dev),
        impl="cuda" if dev.type == "cuda" else "torch")
    tok = torch.zeros((n_slots, 1), dtype=torch.long, device=dev)
    trace, _ = record(
        f"serve:decode-b{kv_bits}",
        lambda: M.paged_decode_step(cfg, model, tok, caches, paged),
        {"caches": lambda out: caches if out is None else out[1]})
    return trace


def _pair_cells(cells: list) -> dict:
    """The matrix cells the knob-pair contracts run on."""
    by_name = {c.name: c for c in cells}
    return {
        "pair:telemetry": by_name.get("adamw8-b88-pooled"),
        "pair:overlap": by_name.get("adamw8-b88-part4-zero2"),
        "pair:partition": by_name.get("lamb8-b88-part4"),
        "pair:sentinel": by_name.get("adamw8-b88-pooled"),
    }


def pair_traces(scope: str, cell: Cell, *, device) -> dict:
    """The traces of one knob pair of ``scope`` on ``cell``."""
    step = functools.partial(trace_step, device=device)
    if scope == "pair:telemetry":
        return {n: step(cell, telemetry_every=n) for n in (0, 2)}
    if scope == "pair:overlap":
        return {n: step(cell, overlap_buckets=n) for n in (1, 2)}
    if scope == "pair:sentinel":
        return {"off": step(cell), "off_explicit": step(cell, sentinel=False),
                "on": step(cell, sentinel=True)}
    off = dataclasses.replace(cell, name=cell.name + "-off", partition=1,
                              shard_grads=False, overlap_buckets=1)
    return {"on": step(cell), "off": step(off)}


def _evaluate(scope: str, subject, cell, results: list, log) -> None:
    for spec in C.contracts_for(scope):
        r = C.evaluate(spec, subject, cell)
        if r is not None:
            results.append(r)
            log(str(r))


def register_all() -> None:
    """Import the modules that register contracts."""
    import repro_torch.kernels.ops  # noqa: F401
    import repro_torch.serve.kvcache  # noqa: F401
    import repro_torch.sharding.rules  # noqa: F401
    import repro_torch.train.loop  # noqa: F401


def run_contracts(cells: Optional[list] = None, *, device, log=print
                  ) -> list:
    """Evaluate every registered contract over the matrix on ``device``
    ("cuda" raises without a card: there is no fallback to the CPU).
    Returns the ContractResult list."""
    from repro_torch import device as device_lib
    dev = device_lib.resolve(device)
    register_all()
    cells = default_cells() if cells is None else cells
    results: list = []
    for cell in cells:
        _evaluate("step", trace_step(cell, device=dev), cell, results, log)
    for algo in ("adamw", "muon"):
        for bits_m in (8, 4):
            trace = trace_update(algo, bits_m, device=dev)
            _evaluate("update", trace, Cell(trace.name, algo, (bits_m, 8)),
                      results, log)
    for kv_bits in (8, 4):
        trace = trace_serve(kv_bits, device=dev)
        _evaluate("serve", trace, Cell(trace.name, "serve", (kv_bits,)),
                  results, log)
    for scope, cell in _pair_cells(cells).items():
        if cell is not None and C.contracts_for(scope):
            _evaluate(scope, pair_traces(scope, cell, device=dev), cell,
                      results, log)
    return results


def failures(results: list) -> list:
    return [r for r in results if not r.ok]


def host_syncs(fn) -> tuple:
    """(fn's result, host syncs it made, {"file:line": count}): the CUDA
    synchronizing calls ``torch.cuda.set_sync_debug_mode("warn")`` reports
    while ``fn`` runs, each counted at the innermost line of the port that
    led to it; without one on the stack (a sync in another thread, such as
    the autograd engine's), at the thread's name and its innermost frames
    (card only)."""
    sites: dict = {}

    def count(message, category, filename, lineno, file=None, line=None):
        # the mode's own one-time notice on being enabled is no sync
        if "called a synchronizing" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if not f.filename.endswith("warnings.py")]
        ours = [f for f in stack if "/repro_torch/" in f.filename
                and "/repro_torch/analysis/" not in f.filename]
        if ours:
            key = f"{ours[-1].filename.rsplit('/src/', 1)[-1]}:" \
                  f"{ours[-1].lineno}"
        else:
            frames = " <- ".join(f"{f.filename.rsplit('/', 1)[-1]}:"
                                 f"{f.lineno} {f.name}"
                                 for f in reversed(stack[-4:]))
            key = (f"{filename.rsplit('/', 1)[-1]}:{lineno} in thread "
                   f"{threading.current_thread().name} ({frames})")
        sites[key] = sites.get(key, 0) + 1

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = count
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, sum(sites.values()), sites
