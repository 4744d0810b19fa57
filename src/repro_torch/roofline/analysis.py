"""Roofline terms of a dry-run cell (mirrors ``repro.roofline.analysis``),
per device:

  compute term    = FLOPs_per_device / peak FLOP/s of one card
  memory term     = bytes_per_device / HBM bandwidth
  collective term = collective_bytes_per_device / link bandwidth

Where the JAX package parses the compiled SPMD module's HLO, the port
counts what one device runs: :class:`DeviceCounter` is a
``TorchDispatchMode`` that sits beneath DTensor — it hands every DTensor
op back to DTensor and sees the local ops DTensor issues on this device's
shards — and counts their FLOPs (``torch.utils.flop_counter``'s formulas
on the local shapes), the bytes every op reads and writes, the bytes of
each ``_c10d_functional`` collective by kind (its result, as the JAX
package counts an HLO collective's result shape), and the peak of the live
allocations.  Counted above DTensor, the same formulas would give the
global FLOPs.

The peaks are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense rates at
the 700 W power limit): 989 TFLOP/s in bf16, 3.35 TB/s of HBM3, and 450
GB/s per direction of NVLink 4 (900 GB/s bidirectional).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.dtypes import nbytes

PEAK_FLOPS = 989e12        # bf16 FLOP/s per card (dense)
HBM_BW = 3.35e12           # bytes/s per card
LINK_BW = 450e9            # NVLink bytes/s per direction per card

# _c10d_functional op name -> the JAX package's collective kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


class DeviceCounter(TorchDispatchMode):
    """Per-device FLOPs, bytes, collective bytes and live-allocation peak of
    what runs under it, beneath DTensor.

    Enter it inside the ``FakeTensorMode`` (and over the DTensors) of the
    traced step.  Tensors made under :meth:`arguments` are the step's
    arguments (``tracked_bytes``), live from then on; ``peak_bytes`` is the
    largest sum of live storages seen, arguments included, and
    ``peak_by_op`` what was live then above the arguments, by the op that
    allocated it: {(op, shape, dtype): bytes}.  DTensor's planning (its
    shape inference on global-shape stand-ins, its redistribution costs)
    is not counted.

    For the dry run's scans (``models/scan_utils.counting``) the counter
    has a multiplier, ``scale``: every op counted while it is k counts k
    times (its FLOPs, bytes and collective bytes, and k ops), so one traced
    time step stands for k identical ones; :meth:`scaled` sets it around
    a forward, the scans' autograd markers set it in the backward.
    :meth:`phantom` allocates bytes that are live but not work (the steps
    not traced hold them in the real loop), :meth:`account` counts an op
    whose output is such an allocation, and :meth:`probing` records what
    a step allocates without counting or holding it."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes_read = 0
        self.bytes_written = 0
        self.collectives: dict = {}
        self.n_collectives = 0
        self.n_ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.tracked_bytes = 0
        self.peak_by_op: dict = {}
        self._live_by_op: dict = {}
        self._op = None               # the name of the op being counted
        self._storages: dict = {}
        self._muted = 0
        self._placing = False
        self._patched = None
        self.scale = 1
        self._probe = None

    # ------------------------------------------------------- live storages
    def _add_storage(self, t: torch.Tensor, origin=False) -> int:
        """Count ``t``'s storage as live (once); returns its new bytes.
        A "meta" tensor (a shape the trace reads) allocates nothing.
        ``origin``: its (op, shape, dtype) key in ``peak_by_op`` (by
        default the op being counted and ``t``'s own shape and dtype)."""
        if t.is_meta:
            return 0
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return 0
        n = st.nbytes()
        if origin is False:
            origin = None if self._placing else (
                self._op, tuple(t.shape), str(t.dtype).replace("torch.", ""))
        self._storages[key] = (n, origin)
        self.live_bytes += n
        if origin is not None:
            self._live_by_op[origin] = self._live_by_op.get(origin, 0) + n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self.peak_by_op = dict(self._live_by_op)
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key) -> None:
        n, origin = self._storages.pop(key, (0, None))
        self.live_bytes -= n
        if origin is not None:         # (storages of 0 bytes share keys)
            left = self._live_by_op.get(origin, 0) - n
            if left:
                self._live_by_op[origin] = left
            else:
                self._live_by_op.pop(origin, None)

    def peak_breakdown(self, top: int = 8) -> list:
        """The ``top`` largest entries of ``peak_by_op``: [(bytes, op,
        shape, dtype)], largest first."""
        rows = sorted(((b, *k) for k, b in self.peak_by_op.items()),
                      key=lambda r: -r[0])
        return rows[:top]

    @contextlib.contextmanager
    def scaled(self, k: int):
        """Every op counted in the context counts ``k`` times."""
        before, self.scale = self.scale, k
        try:
            yield
        finally:
            self.scale = before

    def phantom(self, nbytes: int, origin, device=None) -> torch.Tensor:
        """A tensor of ``nbytes`` bytes, live as long as it is referenced,
        under the ``peak_by_op`` key ``origin``: memory that the real run
        holds (the tensors of time steps not traced), not work."""
        self._muted += 1
        try:
            t = torch.empty(int(nbytes), dtype=torch.uint8, device=device)
        finally:
            self._muted -= 1
        self._add_storage(t, origin=origin)
        return t

    def account(self, op: str, bytes_read: int, out: torch.Tensor) -> None:
        """Count one op named ``op`` that reads ``bytes_read`` bytes and
        writes ``out`` (times ``scale``), ``out`` allocated by
        :meth:`phantom` or by a muted op."""
        self.n_ops += self.scale
        self.bytes_read += self.scale * int(bytes_read)
        self.bytes_written += self.scale * nbytes(out)

    @contextlib.contextmanager
    def probing(self):
        """Ops in the context are not counted and their outputs not held
        as live; yields {storage id: (bytes, (op, shape, dtype), tensor)}
        of every storage they create (the tensor kept until the dict is
        dropped, so that no id is reused meanwhile)."""
        seen, self._probe = self._probe, {}
        try:
            yield self._probe
        finally:
            self._probe = seen

    @contextlib.contextmanager
    def arguments(self):
        """Tensors made under this context and alive at its end are the
        step's arguments (``tracked_bytes``); its ops are not counted, and
        the peak starts from them."""
        self._placing = True
        try:
            yield
        finally:
            self._placing = False
            self.tracked_bytes = self.live_bytes
            self.peak_bytes = self.live_bytes
            self.peak_by_op = {}

    # ------------------------------------------------------------ dispatch
    def _planning(self, fn):
        """``fn`` (a DTensor planning method) run muted and outside the
        fake mode: its ops are DTensor's bookkeeping (small index tensors,
        shape inference on global-shape stand-ins), not this device's
        work, and outside the fake mode its results are cached."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        counter = self

        def planned(*args, **kwargs):
            counter._muted += 1
            try:
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            finally:
                counter._muted -= 1

        return planned

    def __enter__(self):
        from torch.distributed.tensor import _dispatch, _sharding_prop
        targets = [(_dispatch.OpDispatcher,
                    "_propagate_op_sharding_dispatch_slow_path"),
                   (_sharding_prop.ShardingPropagator, "propagate")]
        for cls, name in targets:
            if name not in vars(cls):
                raise RuntimeError(
                    f"DeviceCounter: DTensor has no {cls.__name__}.{name}; "
                    f"per-device counts would include its planning")
        self._patched = []
        for cls, name in targets:
            orig = vars(cls)[name]
            self._patched.append((cls, name, orig))
            setattr(cls, name, self._planning(orig))
        return super().__enter__()

    def __exit__(self, *exc):
        for cls, name, orig in self._patched:
            setattr(cls, name, orig)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._muted:
            return out
        self._op = func._schema.name.split("::")[-1]
        outs = _tensors(out)
        if self._probe is not None:
            for t in outs:
                if not t.is_meta and id(t.untyped_storage()) not in \
                        self._storages:
                    st = t.untyped_storage()    # ``t`` held: ids stay unique
                    self._probe.setdefault(id(st), (st.nbytes(), (
                        self._op, tuple(t.shape),
                        str(t.dtype).replace("torch.", "")), t))
            return out
        if self._placing:
            for t in outs:
                self._add_storage(t)
            return out
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "prim":
            pass              # a metadata query (``prim::device``): no bytes
        elif ns in ("_c10d_functional", "_dtensor", "c10d"):
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                b = sum(nbytes(t) for t in outs)
                self.collectives[kind] = self.collectives.get(kind, 0) + \
                    self.scale * b
                self.n_collectives += self.scale
        elif not func.is_view:
            k = self.scale
            self.n_ops += k
            pk = func._overloadpacket
            if pk in self._flop_registry:
                self.flops += k * int(self._flop_registry[pk](
                    *args, **kwargs, out_val=out))
            self.bytes_read += k * sum(nbytes(t) for t in
                                       _tensors((args, kwargs)))
            self.bytes_written += k * sum(nbytes(t) for t in outs)
        for t in outs:
            self._add_storage(t)
        return out

    @property
    def bytes_accessed(self) -> int:
        return self.bytes_read + self.bytes_written

    @property
    def collective_bytes(self) -> int:
        return sum(self.collectives.values())


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: dict
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float            # 6*N*D (or 6*N_active*D) global
    useful_flops_ratio: float     # model_flops / (flops_per_device * chips)

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(counter: DeviceCounter, *, n_chips: int,
            model_flops_global: float) -> Roofline:
    """The roofline of one device from a :class:`DeviceCounter`'s counts
    of the traced step."""
    flops = float(counter.flops)
    byts = float(counter.bytes_accessed)
    coll = {k: float(v) for k, v in counter.collectives.items()}
    coll["_n_ops"] = counter.n_collectives
    cb = float(counter.collective_bytes)
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = cb / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    total = flops * n_chips
    ratio = (model_flops_global / total) if total > 0 else 0.0
    return Roofline(flops_per_device=flops, bytes_per_device=byts,
                    coll_bytes_per_device=cb, coll_breakdown=coll,
                    compute_s=compute_s, memory_s=memory_s,
                    collective_s=collective_s, bottleneck=bottleneck,
                    model_flops=model_flops_global, useful_flops_ratio=ratio)


def newton_schulz_flops(rows: int, cols: int, steps: int = 5) -> float:
    """FLOPs of the tiled NS(steps) orthogonalization on an (rows, cols)
    matrix (kernels/newton_schulz.py; DESIGN.md §11): per iteration one
    gram (2·m²·n), one m×m finalize (2·m³) and one apply (2·m²·n), with
    m = min dim.  The repo's first compute-bound optimizer kernel."""
    m, n = sorted((rows, cols))
    return float(steps) * (4.0 * m * m * n + 2.0 * m ** 3)


def muon_update_roofline(shape: tuple, *, bits: int = 8,
                         block_size: int = 2048, steps: int = 5) -> dict:
    """Roofline position of one quantized-Muon matrix-leaf update.

    Unlike the element-wise family (~11 B/param streamed, ~O(100) ops/param
    → bandwidth-bound, §3 napkin math), Muon adds the NS matmul chain whose
    FLOPs/param grow with min(m, n): ~4·steps·min_dim, vs ~14 bytes/param
    streamed.  The update flips compute-bound once
    min_dim ≳ bytes_per_param·(peak/bw)/(4·steps) ≈ 14·295/20 ≈ 210 on
    the H100 — i.e. essentially every real weight matrix; the per-block
    dequant/requant stays bandwidth-bound but no longer dominates.  Used
    by ``bench_speed``'s muon sweep to derive the analytic position."""
    rows, cols = shape
    n = rows * cols
    # p read+write (4+4), g read (4), momentum codes read+write
    # (2 · bits/8), absmax amortized (8/block_size per state).
    bytes_per_param = 12.0 + 2.0 * bits / 8.0 + 8.0 / block_size
    flops = newton_schulz_flops(rows, cols, steps) + 8.0 * n  # + EMA/step
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_per_param * n / HBM_BW
    return {
        "flops": flops,
        "bytes": bytes_per_param * n,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "bottleneck": "compute" if compute_s > memory_s else "memory",
    }


def model_flops(cfg, case) -> float:
    """MODEL_FLOPS: 6*N*D for training (N = active params), 2*N*D for
    inference forward (D = tokens processed by the step)."""
    n_active = cfg.active_param_count()
    if case.kind == "train":
        tokens = case.global_batch * case.seq_len
        return 6.0 * n_active * tokens
    if case.kind == "prefill":
        tokens = case.global_batch * case.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * case.global_batch
