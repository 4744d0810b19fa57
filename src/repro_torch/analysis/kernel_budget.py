"""Hopper resource budget of every kernel instance the port builds, and
grid alignment (mirrors ``repro.analysis.kernel_budget``).

The JAX package models each Pallas kernel's per-tile VMEM bytes against a
16 MiB budget.  On an H100 the scarce resources are per SM: 2048 threads,
65,536 registers, 228 KB of shared memory (1 KB of it reserved per CTA,
at most 227 KB to one CTA) and 32 CTAs.  Each CUDA kernel instance the
port builds (``csrc/*.cu``, every library of ``kernels.build.LIBRARIES``)
is modelled here from its source: threads per CTA
(``rq_walk_threads``, ``common.cuh``), static shared memory (its
``__shared__`` arrays), dynamic shared memory (``quant_smem_bytes``,
``update8_smem_bytes``, ``packed_smem_bytes``, the norm prologue's ring,
``gram_smem`` / ``apply_smem``) at the largest block size the instance
serves, the register cap of its ``__launch_bounds__`` (65,536 / (threads
x minimum CTAs), rounded down to 8, at most 255), and from these the CTAs
resident per SM.  The checks (:func:`audit`):

  * every instance fits (threads, registers, shared memory, >= 1 CTA);
  * the CTAs per SM that a grid assumes are resident at the register cap:
    ``walk_ctas_per_sm`` / ``update8_ctas_per_sm`` (``fused_update.cu``),
    ``quant_ctas_per_sm`` (``blockwise_quant.cu``), ``norm_ctas_per_sm``
    (``norm_partials.cu``) and the gram's one CTA per SM
    (``ns_gram_splits``);
  * the Newton–Schulz kernels tile the m x m result, so no shared-memory
    envelope bounds m (the JAX ``ns_max_m``): what replaces it is the set
    of matrix-leaf shapes the launches accept (``valid_shape``: m a
    multiple of 4, n of 64, m <= n), checked for every matrix leaf of the
    configs up to the head's 1024 x 50432;
  * ``check_partition_plan`` / ``check_grid_alignment`` on
    ``core.optim.base.make_partition`` / ``make_buckets``, with the JAX
    audit's cases.

On the card (:func:`card_audit`) the model is held to two sources: the
report ``ptxas -v`` writes into each library's build log
(``build/kernels/<key>/<name>.log``; registers within the cap, spill as
:data:`RECORDED_SPILL` records it, static shared memory as modelled), and
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` through each library's
``*_occupancy`` C entry (host code only), whose CTAs per SM must equal the
model's at ptxas's registers and cover the grid's assumption.

:func:`demangle` names an instance ``kernel<type,int,...>`` for ptxas's
report here and for ``scripts/kernel_sass.py``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import re
from pathlib import Path
from typing import Optional

from repro_torch.analysis.contracts import AnalysisError

# ------------------------------------------------- H100 (sm_90) per SM
SM_THREADS = 2048
SM_REGISTERS = 65536
SM_CTAS = 32
SM_SMEM = 228 * 1024           # shared memory of an SM
CTA_SMEM_RESERVED = 1024       # the runtime's reserve per CTA
CTA_SMEM_MAX = 227 * 1024      # the most one CTA may have (232,448 B)
SMEM_UNIT = 128                # shared memory allocation unit
REG_UNIT = 256                 # registers are allocated per warp in 256s
MAX_REGISTERS = 255
CTA_THREADS_MAX = 1024

SMEM_DEFAULT = 48 * 1024       # static + dynamic without the attribute
SMEM_ATTRIBUTE_FROM = 40 * 1024  # rq_allow_smem raises it past this

CODEBOOK = 256                 # rq::kCodebookSize
MAX_BLOCK = 8192               # rq::kMaxBlock
THREADS = 256                  # rq::kThreads
ALGOS = {"adam": 0, "lamb": 1, "momentum": 2, "lars": 3, "adagrad": 4}
TWO_STATES = (0, 1)            # AlgoTraits::kTwoStates: adam, lamb
ELEM = {"f32": 4, "bf16": 2}   # bytes of p (PElem) by library


def reg_cap(threads: int, min_ctas: int) -> int:
    """Registers a thread under ``__launch_bounds__(threads, min_ctas)``
    (min_ctas 0: none given, as 1)."""
    cap = SM_REGISTERS // (threads * max(min_ctas, 1)) // 8 * 8
    return min(cap, MAX_REGISTERS)


def resident_limits(threads: int, regs: int, smem: int) -> dict:
    """CTAs per SM each resource allows, for CTAs of ``threads`` threads
    with ``regs`` registers each and ``smem`` bytes of shared memory
    (static + dynamic)."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // REG_UNIT) * REG_UNIT
    cta_smem = -(-(smem + CTA_SMEM_RESERVED) // SMEM_UNIT) * SMEM_UNIT
    return {"threads": SM_THREADS // threads,
            "registers": (SM_REGISTERS // per_warp) // warps if regs else
            SM_CTAS,
            "shared": SM_SMEM // cta_smem,
            "ctas": SM_CTAS}


def static_smem(*arrays: int) -> int:
    """Static shared memory of a kernel's ``__shared__`` arrays (bytes
    each), as ptxas lays them out: a one-element placeholder array (the
    ``X ? N : 1`` of a feature that is off) is never used and dropped, and
    the total is rounded up to 16 bytes."""
    return -(-sum(a for a in arrays if a > 4) // 16) * 16


def staged_row_bytes(w: int) -> int:
    """rq::staged_row_bytes: a packed row of w bytes staged, rounded to
    16, plus the 16 bytes unpack may read past its end."""
    return (w + 15) // 16 * 16 + 16


# rq_walk_threads: CTA threads -> the largest block size they serve
THREADS_BLOCK = {256: 2048, 512: 4096, 1024: 8192}


@dataclasses.dataclass(frozen=True)
class KernelInstance:
    """One kernel instance of one library, as the port launches it."""
    kernel: str                # e.g. "fused_update_kernel"
    args: tuple                # template arguments, as :func:`demangle`
    library: str               # key of build.LIBRARIES
    threads: int
    min_ctas: int              # __launch_bounds__ minimum (0: none)
    static_smem: int
    dynamic_smem: int          # at block_size
    block_size: Optional[int]  # the largest block size it serves
    assumed: Optional[int]     # CTAs per SM its grid assumes resident
    query: tuple               # (C entry, its int arguments before out)

    @property
    def name(self) -> str:
        return f"{self.kernel}<{','.join(str(a) for a in self.args)}>" \
            if self.args else self.kernel

    @property
    def cap(self) -> int:
        return reg_cap(self.threads, self.min_ctas)

    @property
    def smem(self) -> int:
        return self.static_smem + self.dynamic_smem

    def limits(self, regs: Optional[int] = None) -> dict:
        return resident_limits(self.threads, self.cap if regs is None
                               else regs, self.smem)

    def resident(self, regs: Optional[int] = None) -> int:
        """CTAs per SM, at ``regs`` registers (default: the cap)."""
        return min(self.limits(regs).values())


def _update_static(two: bool, sent: bool) -> int:
    """fused_update.cu's __shared__ arrays (both kernels): lut_m, tree_m,
    lut_r and tree_r (one float each for one-state algorithms), red[66],
    hred (64 ints with the sentinel, else 1)."""
    r = CODEBOOK if two else 1
    return static_smem(4 * CODEBOOK, 4 * CODEBOOK, 4 * r, 4 * r, 4 * 66,
                       4 * (64 if sent else 1))


def fused_update_instances(library: str = "fused_update") -> list:
    """The 8-bit and packed update kernels of one library: algorithm x
    threads x stochastic x sentinel.  The packed kernel's ring is taken at
    the widest widths it is launched with ((8, 6) for two states, 6 for
    one: 8-bit states run the 8-bit kernel)."""
    t = "bf16" if library.endswith("_bf16") else "f32"
    elem, out = ELEM[t], []
    for algo, a in ALGOS.items():
        two = a in TWO_STATES
        for threads, bsz in THREADS_BLOCK.items():
            walk = 5 if threads == 256 else 1024 // threads
            lean = threads == 256 and two
            for stoch in (0, 1):
                for sent in (0, 1):
                    static = _update_static(two, bool(sent))
                    per_sm = 4 if lean and (sent or elem == 2) else walk
                    dyn = 2 * (elem + 4) * bsz if two else 0
                    out.append(KernelInstance(
                        "fused_update_kernel", (t, a, threads, stoch, sent),
                        library, threads, per_sm, static, dyn, bsz, per_sm,
                        ("fused_update_occupancy", 0, a, threads, stoch,
                         sent, dyn)))
                    wm, wr = ((bsz, bsz * 6 // 8) if two
                              else (bsz * 6 // 8, 0))
                    dyn = 2 * ((elem + 4) * bsz + staged_row_bytes(wm)
                               + (staged_row_bytes(wr) if wr else 0))
                    out.append(KernelInstance(
                        "fused_update_packed_kernel",
                        (t, a, threads, stoch, sent), library, threads,
                        walk, static, dyn, bsz, walk,
                        ("fused_update_occupancy", 1, a, threads, stoch,
                         sent, dyn)))
    return out


def norm_partials_instances(library: str = "norm_partials") -> list:
    """The norm prologue: lars (8-bit, never packed) and lamb (8-bit and
    packed rows, the ring at the widest packed pair (8, 6)) x vectors per
    thread 1/2/4/8 (B up to 1024/2048/4096/8192), 256 threads."""
    t = "bf16" if library.endswith("_bf16") else "f32"
    out = []
    for kind, name in ((0, "lars"), (1, "lamb")):
        for vpt in (1, 2, 4, 8):
            bsz = 1024 * vpt
            per_sm = (8 if kind == 0 else 4) // (1 if vpt <= 2 else vpt // 2)
            lut = 4 * (CODEBOOK if kind else 1)
            static = static_smem(lut, lut, 4 * 99)
            for packed in ((0, 1) if kind else (0,)):
                dyn = (2 * (staged_row_bytes(bsz) +
                            staged_row_bytes(bsz * 6 // 8)) if packed else 0)
                out.append(KernelInstance(
                    "norm_partials_kernel", (t, kind, vpt, packed), library,
                    THREADS, per_sm, static, dyn, bsz, per_sm,
                    ("norm_partials_occupancy", kind, vpt, packed, dyn)))
    return out


def quantize_instances() -> list:
    """B1: bits x threads x stochastic; its ring of two x rows."""
    out = []
    for bits in (4, 5, 6, 8):
        for threads, bsz in THREADS_BLOCK.items():
            per_sm = {256: 6, 512: 3, 1024: 1}[threads]
            for stoch in (0, 1):
                dyn = 2 * 4 * bsz
                out.append(KernelInstance(
                    "quantize_kernel", (bits, threads, stoch),
                    "blockwise_quant", threads, per_sm,
                    static_smem(4 * CODEBOOK, 4 * CODEBOOK, 4 * 66), dyn,
                    bsz, per_sm,
                    ("blockwise_quantize_occupancy", bits, threads, stoch,
                     dyn)))
    return out


def dequantize_instances() -> list:
    """B2: f32 or bf16 output x packed; one CTA per block, no grid
    assumption; packed rows staged in shared memory."""
    out = []
    for i, t in enumerate(("f32", "bf16")):
        for packed in (0, 1):
            static = static_smem(4 * CODEBOOK,
                                 MAX_BLOCK + 16 if packed else 1)
            out.append(KernelInstance(
                "dequantize_kernel", (t, packed), "blockwise_dequant",
                THREADS, 0, static, 0, None, None,
                ("blockwise_dequantize_occupancy", i, packed)))
    return out


def ns_gram_smem(kmi: int) -> int:
    """gram_smem<kMi>: 4 stages of a K-major (2 kMi 16 x 32) tile and the
    (128 x 32) B tile, f32."""
    return 4 * (2 * kmi * 16 * 32 + 128 * 32) * 4


def ns_apply_smem(kmi: int) -> int:
    """apply_smem<kMi>: 4 stages of a K-major tile and an N-major (32 x
    132) one, f32."""
    return 4 * (2 * kmi * 16 * 32 + 32 * 132) * 4


def newton_schulz_instances() -> list:
    """B5 (the gram, one CTA per SM: ``ns_gram_splits`` fills waves of
    ``sms`` CTAs), its chunk reduction, and B6 (the apply), at 32-row
    (kMi 1) and 128-row (kMi 4) tiles."""
    out = []
    for kmi in (1, 4):
        out.append(KernelInstance(
            "ns_gram_kernel", (kmi,), "newton_schulz", THREADS, 1, 0,
            ns_gram_smem(kmi), None, 1, ("ns_occupancy", 0, kmi)))
        out.append(KernelInstance(
            "ns_apply_kernel", (kmi,), "newton_schulz", THREADS, 1, 0,
            ns_apply_smem(kmi), None, None, ("ns_occupancy", 1, kmi)))
    out.append(KernelInstance(
        "ns_gram_reduce_kernel", (), "newton_schulz", THREADS, 0,
        static_smem(4 * 32 * 33), 0, None, None, ("ns_occupancy", 2, 0)))
    return out


def paged_gather_instances() -> list:
    """B7: f32 or bf16 output x 8 or 4 bits, the vector kernel (capped at
    4 CTAs: 64 registers) and the any-width one; one CTA per page."""
    out = []
    for i, t in enumerate(("f32", "bf16")):
        for bits in (8, 4):
            for kernel, any_, per in (("paged_gather_kernel", 0, 4),
                                      ("paged_gather_any_kernel", 1, 0)):
                out.append(KernelInstance(
                    kernel, (t, bits), "paged_gather", THREADS, per,
                    static_smem(4 * (1 << bits)), 0, None, None,
                    ("paged_gather_occupancy", any_, i, bits)))
    return out


def instances() -> list:
    """Every kernel instance of every library the port builds."""
    return (quantize_instances() + dequantize_instances()
            + fused_update_instances("fused_update")
            + fused_update_instances("fused_update_bf16")
            + norm_partials_instances("norm_partials")
            + norm_partials_instances("norm_partials_bf16")
            + newton_schulz_instances() + paged_gather_instances())


def check_instance(inst: KernelInstance, regs: Optional[int] = None
                   ) -> tuple:
    """(ok, detail): ``inst`` fits an H100 SM, and the CTAs its grid
    assumes are resident, at ``regs`` registers (default: the cap)."""
    problems = []
    if inst.threads > CTA_THREADS_MAX:
        problems.append(f"{inst.threads} threads > {CTA_THREADS_MAX}")
    if inst.smem > CTA_SMEM_MAX:
        problems.append(f"{inst.smem} B of shared memory > {CTA_SMEM_MAX}")
    if inst.smem > SMEM_DEFAULT and inst.dynamic_smem <= SMEM_ATTRIBUTE_FROM:
        problems.append(f"{inst.smem} B of shared memory past the "
                        f"{SMEM_DEFAULT} B default, with too little of it "
                        f"dynamic ({inst.dynamic_smem} B) for rq_allow_smem "
                        f"to raise the limit")
    r = inst.cap if regs is None else regs
    if r > inst.cap:
        problems.append(f"{r} registers > the cap {inst.cap}")
    lim = inst.limits(regs)
    ctas = min(lim.values())
    if ctas < 1:
        problems.append(f"no CTA resident ({lim})")
    if inst.assumed is not None and ctas < inst.assumed:
        problems.append(f"{ctas} CTAs resident, the grid assumes "
                        f"{inst.assumed} ({lim})")
    detail = (f"{inst.threads} threads, smem {inst.static_smem} + "
              f"{inst.dynamic_smem} B, {r} registers (cap {inst.cap}), "
              f"{ctas} CTAs/SM (assumed {inst.assumed})")
    return not problems, detail + ("" if not problems else
                                   "; " + "; ".join(problems))


# ------------------------------------------------ Newton–Schulz shapes
def ns_accepts(m: int, n: int) -> bool:
    """newton_schulz.cu's valid_shape, on the padded (m, n) (m the small
    dimension)."""
    return m > 0 and n > 0 and m % 4 == 0 and n % 64 == 0 and m <= n


def ns_padded(shape: tuple) -> tuple:
    """newton_schulz.pad_matrix's shape of a matrix leaf: the small
    dimension first, rows to a multiple of 8, columns of 256."""
    m, n = sorted(shape[-2:])
    return -(-m // 8) * 8, -(-n // 256) * 256


def ns_leaf_shapes(arch: str = "paper-lm-209m") -> list:
    """The shapes of the leaves Muon orthogonalizes in ``arch`` at its
    published widths (its 2-D parameters apart from the 32-bit
    embedding; built on the "meta" device): the head's 1024 x 50264 is
    the largest of paper-lm-209m."""
    from repro_torch.configs import base
    from repro_torch.core.optim.base import default_override_32bit
    from repro_torch.models import model as M
    model = M.Model(base.get_config(arch), device="meta")
    return sorted({tuple(p.shape) for k, p in model.param_dict().items()
                   if p.dim() == 2 and not default_override_32bit(k)})


# ------------------------------------------------------- grid alignment
def check_partition_plan(part, plan, grid: int) -> tuple:
    """Validate an (ArenaPartition, BucketPlan) pair against the block
    ``grid`` the dispatch was built on (``cfg.shard_multiple``): span
    starts and span_pad stay grid-aligned, spans cover exactly [0, total),
    and bucket ranges tile [0, span_pad) exactly with grid-aligned
    boundaries (the overlap schedule launches one update per range).
    Takes the *built objects* so a regression in make_partition /
    make_buckets — or a hand-constructed bad plan — is caught."""
    problems = []
    if part.span_pad % grid != 0:
        problems.append(f"span_pad {part.span_pad} not a multiple of "
                        f"grid={grid}")
    for start, length in part.spans:
        if start % grid != 0:
            problems.append(f"span start {start} misaligned to grid={grid}")
    lengths = sum(length for _, length in part.spans)
    if lengths != part.total:
        problems.append(f"spans cover {lengths} rows, total is {part.total}")
    if plan is not None:
        if plan.span_pad != part.span_pad:
            problems.append(f"plan span_pad {plan.span_pad} != partition "
                            f"span_pad {part.span_pad}")
        prev = 0
        for k0, k1 in plan.ranges:
            if k0 != prev:
                problems.append(f"bucket ranges not contiguous at {k0} "
                                f"(expected {prev})")
            if k1 <= k0:
                problems.append(f"empty/negative bucket range ({k0}, {k1})")
            if k0 % grid != 0:
                problems.append(f"bucket start {k0} misaligned to "
                                f"grid={grid}")
            if k1 % grid != 0 and k1 != part.span_pad:
                problems.append(f"bucket end {k1} misaligned to grid={grid}"
                                f" (span_pad={part.span_pad})")
            prev = k1
        if plan.ranges and prev != part.span_pad:
            problems.append(f"bucket ranges end at {prev}, span_pad is "
                            f"{part.span_pad}")
    ok = not problems
    return ok, ("grid-aligned" if ok else "; ".join(problems))


def check_grid_alignment(total: int, n_shards: int, n_buckets: int,
                         grid: int) -> tuple:
    """Build the partition/bucket plan as the partitioned dispatch does
    (``make_partition`` / ``make_buckets`` on ``cfg.shard_multiple``) and
    validate it with :func:`check_partition_plan`."""
    from repro_torch.core.optim import base as _base
    part = _base.make_partition(total, n_shards, grid=grid)
    plan = _base.make_buckets(part, n_buckets, grid=grid)
    ok, detail = check_partition_plan(part, plan, grid)
    return ok, (f"partition(total={total}, shards={n_shards}, "
                f"buckets={n_buckets}, grid={grid}): {detail}")


# (total, shards, buckets, grid): the JAX audit's cases, its kernel rows
# (8) written out
GRID_CASES = ((1000, 4, 1, 4), (12345, 4, 2, 4), (8192, 8, 4, 8),
              (7, 4, 2, 4), (1000, 4, 2, 8))


def audit() -> list:
    """The model's audit (no card needed): every instance fits and holds
    its grid's assumption at the register cap, every matrix leaf of
    paper-lm-209m is a shape the Newton–Schulz launches accept, and the
    partition plans stay grid-aligned.  (name, ok, detail) tuples."""
    results = [(f"budget:{inst.library}:{inst.name}", *check_instance(inst))
               for inst in instances()]
    shapes = ns_leaf_shapes()
    bad = [s for s in shapes if not ns_accepts(*ns_padded(s))]
    big = max(shapes, key=lambda s: s[0] * s[1])
    results.append((
        "ns_shapes:paper-lm-209m", not bad,
        f"{len(shapes)} matrix-leaf shapes, the largest {big} padded to "
        f"{ns_padded(big)}; smem per CTA gram {ns_gram_smem(4)} B, apply "
        f"{ns_apply_smem(4)} B whatever m" + (f"; refused: {bad}" if bad
                                              else "")))
    for total, shards, buckets, grid in GRID_CASES:
        ok, detail = check_grid_alignment(total, shards, buckets, grid)
        results.append((f"grid:total={total},shards={shards},"
                        f"buckets={buckets},grid={grid}", ok, detail))
    return results


# ---------------------------------------------------------- on the card
def demangle(mangled: str) -> str:
    """``kernel<type,int,...>`` of a mangled kernel name (its element type
    first, f32 or bf16, where the first template argument is one), or the
    plain kernel name."""
    hit = re.search(r"\d([a-z_]+_kernel)I(.+?)EEv", mangled)
    if not hit:
        plain = re.search(r"([a-z_]+_kernel)E", mangled)
        return plain.group(1) if plain else mangled
    types = {"f": ["f32"], "1": ["bf16"]}.get(hit.group(2)[:1], [])
    args = types + re.findall(r"L[ib](\d+)", hit.group(2))
    return f"{hit.group(1)}<{','.join(args)}>"


def ptxas_entries(log: Path) -> dict:
    """{instance name: {"registers", "spill_stores", "spill_loads",
    "stack", "smem"}} of every kernel in an nvcc build log (``-Xptxas
    -v``)."""
    out: dict = {}
    entry, props = None, {}
    for line in log.read_text().splitlines() if log.exists() else ():
        if "Compiling entry function" in line:
            entry = demangle(line.split("'")[1] if "'" in line else line)
            props = {}
        elif "Function properties for" in line:
            props = {}
        elif "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            props.update(stack=nums[0], spill_stores=nums[1],
                         spill_loads=nums[2])
        elif "Used" in line and "registers" in line and entry is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            out[entry] = dict(
                registers=int(re.search(r"Used (\d+) registers",
                                        line).group(1)),
                smem=int(smem.group(1)) if smem else 0,
                **{k: props.get(k, 0) for k in ("stack", "spill_stores",
                                                "spill_loads")})
            entry = None
    return out


def ptxas_report(log: Path) -> list:
    """``kernel<args>: registers, spill, smem`` lines of a build log."""
    return [f"{name}: {p['registers']} registers, {p['smem']} bytes smem; "
            f"{p['stack']} bytes stack frame, {p['spill_stores']} bytes "
            f"spill stores, {p['spill_loads']} bytes spill loads"
            for name, p in ptxas_entries(log).items()]


# Spill stores (bytes) per instance, as PERF.md §6's budget table records
# them (ptxas, sm_90a; the 256-thread update instances capped at 48
# registers and B1's stochastic ones at 40 spill a little); every other
# instance spills nothing.  Keys: (library, instance name).
RECORDED_SPILL: dict = {
    ("blockwise_quant", "quantize_kernel<5,256,1>"): 4,
    ("blockwise_quant", "quantize_kernel<5,512,1>"): 4,
    ("blockwise_quant", "quantize_kernel<6,256,1>"): 4,
    ("blockwise_quant", "quantize_kernel<6,512,1>"): 4,
    ("blockwise_quant", "quantize_kernel<8,256,1>"): 12,
    ("blockwise_quant", "quantize_kernel<8,512,1>"): 12,
    ("fused_update", "fused_update_packed_kernel<f32,0,256,0,0>"): 4,
    ("fused_update", "fused_update_packed_kernel<f32,0,256,0,1>"): 16,
    ("fused_update", "fused_update_kernel<f32,0,256,1,0>"): 12,
    ("fused_update", "fused_update_packed_kernel<f32,0,256,1,0>"): 12,
    ("fused_update", "fused_update_kernel<f32,0,256,1,1>"): 20,
    ("fused_update", "fused_update_packed_kernel<f32,0,256,1,1>"): 24,
    ("fused_update", "fused_update_kernel<f32,0,512,1,1>"): 20,
    ("fused_update", "fused_update_kernel<f32,0,1024,1,1>"): 20,
    ("fused_update", "fused_update_packed_kernel<f32,1,256,0,0>"): 4,
    ("fused_update", "fused_update_packed_kernel<f32,1,256,0,1>"): 20,
    ("fused_update", "fused_update_kernel<f32,1,256,1,0>"): 12,
    ("fused_update", "fused_update_packed_kernel<f32,1,256,1,0>"): 12,
    ("fused_update", "fused_update_kernel<f32,1,256,1,1>"): 32,
    ("fused_update", "fused_update_packed_kernel<f32,1,256,1,1>"): 24,
    ("fused_update", "fused_update_kernel<f32,1,512,1,1>"): 32,
    ("fused_update", "fused_update_kernel<f32,1,1024,1,1>"): 32,
    ("fused_update", "fused_update_kernel<f32,2,256,1,1>"): 8,
    ("fused_update", "fused_update_kernel<f32,3,256,1,1>"): 16,
    ("fused_update", "fused_update_kernel<f32,4,256,0,1>"): 36,
    ("fused_update", "fused_update_kernel<f32,4,256,1,1>"): 72,
    ("fused_update_bf16", "fused_update_packed_kernel<bf16,0,256,0,1>"): 32,
    ("fused_update_bf16", "fused_update_kernel<bf16,0,256,1,1>"): 32,
    ("fused_update_bf16", "fused_update_packed_kernel<bf16,0,256,1,1>"): 36,
    ("fused_update_bf16", "fused_update_kernel<bf16,0,512,1,1>"): 32,
    ("fused_update_bf16", "fused_update_kernel<bf16,0,1024,1,1>"): 32,
    ("fused_update_bf16", "fused_update_packed_kernel<bf16,1,256,0,1>"): 36,
    ("fused_update_bf16", "fused_update_kernel<bf16,1,256,1,1>"): 48,
    ("fused_update_bf16", "fused_update_packed_kernel<bf16,1,256,1,1>"): 44,
    ("fused_update_bf16", "fused_update_kernel<bf16,1,512,1,1>"): 48,
    ("fused_update_bf16", "fused_update_kernel<bf16,1,1024,1,1>"): 48,
    ("fused_update_bf16", "fused_update_kernel<bf16,2,256,1,1>"): 8,
    ("fused_update_bf16", "fused_update_kernel<bf16,3,256,1,1>"): 8,
    ("fused_update_bf16", "fused_update_kernel<bf16,4,256,0,1>"): 44,
    ("fused_update_bf16", "fused_update_kernel<bf16,4,256,1,1>"): 72,
    ("fused_update_bf16", "fused_update_packed_kernel<bf16,4,256,1,1>"): 24,
}


def occupancy(lib, inst: KernelInstance) -> list:
    """The library's ``*_occupancy`` C entry for ``inst``: [CTAs per SM,
    registers, static shared memory, local bytes, max threads]."""
    fn = getattr(lib, inst.query[0])
    fn.argtypes = [ctypes.c_int] * (len(inst.query) - 1) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    rc = fn(*inst.query[1:], ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise AnalysisError(f"{inst.library}:{inst.name}: {inst.query[0]} "
                            f"returned CUDA error {rc}")
    return list(out)


def card_audit(build_dir: Path, load) -> list:
    """Every instance's model held to ptxas's report in ``build_dir`` and
    to the occupancy API of its library (``load(name)`` -> ctypes CDLL).
    Returns dicts: the instance, the model, ptxas's and the API's numbers,
    ok and the problems."""
    logs: dict = {}
    rows = []
    for inst in instances():
        if inst.library not in logs:
            logs[inst.library] = ptxas_entries(build_dir /
                                               f"{inst.library}.log")
        px = logs[inst.library].get(inst.name)
        problems = []
        try:
            occ = occupancy(load(inst.library), inst)
        except AnalysisError as e:
            problems.append(str(e))
            occ = [0, -1, -1, -1, 0]
        if px is None:
            problems.append("not in ptxas's report")
            px = {"registers": occ[1], "smem": occ[2], "stack": 0,
                  "spill_stores": 0, "spill_loads": 0}
        regs = px["registers"]
        ok, detail = check_instance(inst, regs)
        if not ok:
            problems.append(detail)
        spill = RECORDED_SPILL.get((inst.library, inst.name), 0)
        if px["spill_stores"] != spill:
            problems.append(f"spill {px['spill_stores']} B, recorded "
                            f"{spill} B")
        if px["smem"] != inst.static_smem:
            problems.append(f"ptxas static smem {px['smem']} B, model "
                            f"{inst.static_smem} B")
        if (occ[1], occ[2]) != (regs, px["smem"]):
            problems.append(f"runtime attributes {occ[1]} registers, "
                            f"{occ[2]} B static smem differ from ptxas")
        model = inst.resident(regs)
        if occ[0] != model:
            problems.append(f"occupancy API {occ[0]} CTAs/SM, model "
                            f"{model}")
        if inst.assumed is not None and occ[0] < inst.assumed:
            problems.append(f"occupancy API {occ[0]} CTAs/SM < assumed "
                            f"{inst.assumed}")
        rows.append(dict(
            library=inst.library, instance=inst.name, threads=inst.threads,
            static_smem=inst.static_smem, dynamic_smem=inst.dynamic_smem,
            block_size=inst.block_size, cap=inst.cap, registers=regs,
            spill_stores=px["spill_stores"], ptxas_smem=px["smem"],
            local=occ[3], assumed=inst.assumed,
            model_ctas=model, api_ctas=occ[0], ok=not problems,
            problems=problems))
    return rows
