"""The port's static-analysis package (``repro_torch.analysis``), mirroring
``tests/test_analysis.py`` test for test, and held to the JAX package on
the CPU where the JAX side passes here.

Four families, as there:

  * primitives — the trace checks against synthetic events;
  * trace contracts — the telemetry guard, overlap_buckets 1 vs K,
    partition on/off, a ZeRO-2 matrix cell through every step contract;
  * kernel budget — the Hopper model against the sources' own numbers,
    the Newton–Schulz shapes, grid alignment, an oversized instance;
  * mutation self-tests — every auditor must fire on its seeded violation
    (promote_f64 -> no_dtype, drop_replication_pin -> replicated, a
    synthetic ``.item()`` in a step module -> lint), and no_f64 without
    its named exempt scope.

The four tests of ``tests/test_analysis.py`` that fail on this toolchain
(ROADMAP C1: the 4-device mesh) are mirrored on the port's own contracts.
Against the JAX package: the dtype table, the three shared lint rules on
one set of synthetic sources, ``check_grid_alignment`` on the JAX audit's
cases, and the verdicts, contract by contract, on the pooled adamw8 (8, 8)
step with its telemetry and sentinel pairs, the adamw and muon 8-bit
updates and the kv-8 decode step (seven JAX lowerings).  One intra-op
thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.analysis import (contracts, dtypes, kernel_budget, lint,
                                  mutations, runner)
from repro_torch.analysis import __main__ as cli
from repro_torch.core.optim import base as optim_base
from repro_torch.core.optim import make_optimizer
from repro_torch.errors import ConfigError, FormatError

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
CELLS = {c.name: c for c in runner.default_cells()}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ev(kind="op", name="aten.add.Tensor", ins=("f32",), outs=("f32",),
        **kw):
    return contracts.Event(kind, name, tuple(ins), tuple(outs), **kw)


def _trace(events, before=None, after=None, name="t"):
    return contracts.Trace(name, tuple(events), before or {}, after or {})


# ------------------------------------------------------------- primitives
def test_donates_checks_storage_and_writes():
    before = {"s": {"/a": (1, "f32", 16), "/b": (2, "u8", 4)}}
    wrote = _ev(name="aten.copy_.default", writes=(1,))
    ok, detail = contracts.check_donates(_trace([wrote], before, before),
                                         "s")
    assert ok and "1 written" in detail, detail
    # nothing written: the state was not updated in place
    ok, _ = contracts.check_donates(_trace([_ev()], before, before), "s")
    assert not ok
    # a piece reallocated
    moved = {"s": {"/a": (1, "f32", 16), "/b": (3, "u8", 4)}}
    ok, detail = contracts.check_donates(_trace([wrote], before, moved), "s")
    assert not ok and "/b" in detail
    ok, _ = contracts.check_donates(_trace([wrote], before, before), "s",
                                    min_written=2)
    assert not ok


def test_no_dtype_finds_f64_not_f16_and_honours_exempt_scope():
    good = _trace([_ev(ins=("f32", "f32")), _ev(ins=("f16",), outs=("f16",))])
    assert contracts.check_no_dtype(good, "f64")[0]
    bad = _trace([_ev(), _ev(name="aten._to_copy.default", outs=("f64",))])
    ok, detail = contracts.check_no_dtype(bad, "f64")
    assert not ok and "_to_copy" in detail
    scoped = _trace([_ev(name="aten.sqrt.default", ins=("f64",),
                         outs=("f64",), exempt=("f64",))])
    assert contracts.check_no_dtype(scoped, "f64")[0]
    # the scope tags events with the dtypes it allows, innermost last
    with contracts.exempt("f64", "outer"), contracts.exempt("bf16", "inner"):
        assert contracts.exemptions() == (("f64", "outer"),
                                          ("bf16", "inner"))
    assert contracts.exemptions() == ()


def test_accumulation_sites_and_check():
    events = [_ev(name="aten.mm.default", ins=("f32", "f32")),
              _ev(name="aten.sum.dim_IntList"),
              _ev(name="aten.sum.default", ins=("pred",), outs=("s64",)),
              _ev(name="aten.add.Tensor")]
    sites = contracts.accumulation_sites(_trace(events))
    assert [op for op, _, _ in sites] == ["mm", "sum", "sum"]
    ok, detail = contracts.check_accumulates_in(_trace(events), "f32")
    assert ok, detail              # the integer count is exempt
    events[0] = _ev(name="aten.mm.default", ins=("bf16", "bf16"),
                    outs=("bf16",))
    ok, detail = contracts.check_accumulates_in(_trace(events), "f32")
    assert not ok and "bf16" in detail


def test_collective_order_checks_the_chain():
    t = _trace([_ev(), _ev("collective", "reduce_scatter"), _ev(),
                _ev("marker", "update"), _ev("collective", "all_gather")])
    ok, _ = contracts.check_collective_order(t, "reduce_scatter", "update",
                                             "all_gather")
    assert ok
    ok, detail = contracts.check_collective_order(t, "all_gather",
                                                  "reduce_scatter")
    assert not ok and "VIOLATED" in detail
    ok, _ = contracts.check_collective_order(t, "reduce_scatter", "missing")
    assert not ok
    ok, _ = contracts.check_collective_order(t, "reduce_scatter", "missing",
                                             require_all=False)
    assert ok
    # an aten op of the same name is no collective
    t2 = _trace([_ev(name="all_gather"), _ev("collective", "reduce_scatter")])
    assert not contracts.check_collective_order(t2, "all_gather",
                                                "reduce_scatter")[0]


def test_lowering_invariant_modes():
    a = [_ev(), _ev(name="aten.mul.Tensor")]
    st = {"opt_state": {"/x": (1, "f32", 64)}}
    ok, _ = contracts.lowering_invariant({0: _trace(a, st, st),
                                          2: _trace(a, st, st)})
    assert ok
    b = [_ev(), _ev(name="aten.div.Tensor")]
    ok, detail = contracts.lowering_invariant({0: _trace(a), 2: _trace(b)})
    assert not ok and "event 1" in detail
    # in-place sets: equal bytes per dtype, whatever the op sequences
    st2 = {"opt_state": {"/y": (7, "f32", 32), "/z": (8, "f32", 32)}}
    ok, _ = contracts.lowering_invariant(
        {1: _trace(a, st, st), 4: _trace(b, st2, st2)},
        compare_aliases_only=True)
    assert ok
    moved = {"opt_state": {"/x": (2, "f32", 64)}}
    ok, _ = contracts.lowering_invariant(
        {1: _trace(a, st, st), 4: _trace(a, st, moved)},
        compare_aliases_only=True)
    assert not ok
    with pytest.raises(contracts.AnalysisError):
        contracts.lowering_invariant({1: _trace(a)})


def test_registry_register_evaluate_not_applicable():
    contracts.register("tmp.test_contract", "step",
                       lambda t, cell: None if cell is None
                       else (True, "ok"), doc="test")
    try:
        spec = dict((s.name, s) for s in contracts.contracts_for("step"))[
            "tmp.test_contract"]
        t = _trace([], name="x")
        assert contracts.evaluate(spec, t, None) is None
        r = contracts.evaluate(spec, t, runner.Cell("c", "adamw8", (8, 8)))
        assert r.ok and r.target == "c"
    finally:
        contracts._REGISTRY.pop("tmp.test_contract", None)


# ----------------------------------------------------------- dtype table
def test_dtype_tables_are_shared_and_complete():
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis as roof
    assert roof.nbytes is dtypes.nbytes and dryrun.nbytes is dtypes.nbytes
    for name, expect in (("f32", 4), ("bf16", 2), ("s4", 1), ("u8", 1),
                         ("f8e4m3fn", 1), ("c128", 16), ("pred", 1)):
        assert dtypes.dtype_bytes(name) == expect
    with pytest.raises(KeyError):
        dtypes.dtype_bytes("f128")
    assert dtypes.nbytes(torch.zeros(3, 5, dtype=torch.bfloat16)) == 30


def test_dtype_bytes_match_jax():
    """Every torch dtype with a JAX name: the same bytes in both tables
    and as torch stores it."""
    from repro.analysis import dtypes as jdtypes
    n = 0
    for tname, name in dtypes.TORCH_NAMES.items():
        dt = getattr(torch, tname.split(".", 1)[1], None)
        if dt is None:
            continue
        assert dtypes.dtype_name(dt) == name
        assert dtypes.DTYPE_BYTES[name] == jdtypes.DTYPE_BYTES[name] \
            == torch.empty((), dtype=dt).element_size(), tname
        n += 1
    assert n >= 15
    assert set(dtypes.DTYPE_BYTES) == set(jdtypes.DTYPE_BYTES)


# ------------------------------------------------------ typed exceptions
def test_config_validation_raises_typed_errors():
    with pytest.raises(ConfigError):
        make_optimizer("adamw8", lr=1e-3, overlap_buckets=0, device="cpu")
    with pytest.raises(ConfigError):
        make_optimizer("adamw8", lr=1e-3, state_bits=3, device="cpu")
    with pytest.raises(FormatError):
        from repro_torch.core.lowbit import packed_width
        packed_width(3, 4)
    assert issubclass(ConfigError, ValueError)
    assert issubclass(FormatError, ValueError)


# ------------------------------------------------------ trace contracts
def test_telemetry_guard_on_contract_api():
    traces = runner.pair_traces("pair:telemetry", CELLS["adamw8-b88-pooled"],
                                device="cpu")
    ok, detail = contracts.lowering_invariant(traces)
    assert ok, detail
    assert len(traces[0].events) > 100


def test_overlap_buckets_donation_invariant():
    """overlap_buckets 1 vs K launches more updates but keeps the same
    state in place (the pair:overlap contract)."""
    traces = runner.pair_traces("pair:overlap",
                                CELLS["adamw8-b88-part4-zero2"], device="cpu")
    ok, detail = contracts.lowering_invariant(traces,
                                              compare_aliases_only=True)
    assert ok, detail
    dispatches = {k: sum(e.name == runner.DISPATCH_MARK for e in t.events)
                  for k, t in traces.items()}
    assert dispatches[2] > dispatches[1], dispatches


def test_partition_toggles_replication_pins():
    """Partition on -> the partials of every span gathered whole before
    the trust ratios; off -> none (the pair:partition contract, on
    lamb8: the port's pins are the trust ratios')."""
    traces = runner.pair_traces("pair:partition", CELLS["lamb8-b88-part4"],
                                device="cpu")
    pins = {k: contracts.replicated_pins(t) for k, t in traces.items()}
    assert pins["on"] >= 1 and pins["off"] == 0, pins
    ok, detail = contracts.check_replicated(traces["on"])
    assert ok, detail


def test_runner_matrix_cell_passes_all_step_contracts():
    """One ZeRO-2 matrix cell through every registered step contract."""
    runner.register_all()
    cell = CELLS["adamw8-b88-part4-zero2"]
    trace = runner.trace_step(cell, device="cpu")
    results = [contracts.evaluate(s, trace, cell)
               for s in contracts.contracts_for("step")]
    results = [r for r in results if r is not None]
    assert {r.contract for r in results} >= {"train_step.donates",
                                             "train_step.no_f64"}
    assert all(r.ok for r in results), [str(r) for r in results
                                        if not r.ok]
    # in one process the step runs no collective: collective_order is the
    # group's (tests/test_torch_dist.py)
    assert not any(e.kind == "collective" for e in trace.events)


def test_recorder_sees_kernel_counters_and_markers():
    """Kernel launches come from the kernel layer's counters, markers from
    contracts.mark, in order with the ops."""
    from repro_torch.kernels import ops
    with runner.Recorder() as rec:
        torch.zeros(2).add_(1)
        ops.KERNELS["fused_update"].launches += 1
        contracts.mark("m", rows=3, total=3)
        torch.ones(1)
    ops.KERNELS["fused_update"].launches -= 1
    kinds = [(e.kind, e.name) for e in rec.events if e.kind != "op"]
    assert kinds == [("kernel", "fused_update"), ("marker", "m")]
    assert rec.events[-1].kind == "op"
    assert contracts.replicated_pins(_trace(rec.events), "m") == 1


def test_host_syncs_counted_by_site(monkeypatch):
    """Each synchronizing-call warning of the sync debug mode counts once,
    at the innermost line of the port below the caller, or (none on the
    stack, as here) at the warning's line, its thread and frames."""
    import warnings
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    from repro_torch.kernels import fused_update as fu

    def step():
        warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("something else")
        return fu.to_i32(2 ** 31)

    out, n, sites = runner.host_syncs(step)
    assert out == -2 ** 31 and n == 1
    (site,) = sites
    line = step.__code__.co_firstlineno + 1
    assert site.startswith(f"test_torch_analysis.py:{line} in thread "
                           f"MainThread (test_torch_analysis.py:{line} "
                           f"step"), sites


# ------------------------------------------------------- kernel budget
def test_update_instance_matches_launch_smem():
    """The model's shared memory against the numbers the sources give:
    the 8-bit two-state ring 2 x (4 + 4) x B, the packed ring 38,976 B for
    adam at B = 2048, (4, 8) (fused_update.cu), B1's ring 2 x 4 x B, the
    gram's 128 KB; static arrays as declared."""
    by = {(i.library, i.name): i for i in kernel_budget.instances()}
    adam = by[("fused_update", "fused_update_kernel<f32,0,256,0,1>")]
    assert adam.dynamic_smem == 2 * 8 * 2048 and adam.threads == 256
    # every array used, rounded to 16 B: 4616 -> 4624 (ptxas's report);
    # the one-state kernel's one-float placeholders are dropped
    assert adam.static_smem == 4624
    assert by[("fused_update",
               "fused_update_kernel<f32,2,256,0,0>")].static_smem == 2320
    assert adam.min_ctas == adam.assumed == 4 and adam.cap == 64
    mom = by[("fused_update", "fused_update_kernel<f32,2,256,0,0>")]
    assert mom.dynamic_smem == 0 and mom.assumed == 5 and mom.cap == 48
    bf = by[("fused_update_bf16", "fused_update_kernel<bf16,0,256,0,0>")]
    assert bf.dynamic_smem == 2 * 6 * 2048 and bf.assumed == 4
    st = kernel_budget.staged_row_bytes
    assert 2 * (8 * 2048 + st(1024) + st(2048)) == 38976
    q = by[("blockwise_quant", "quantize_kernel<8,256,1>")]
    assert q.dynamic_smem == 2 * 4 * 2048 and q.assumed == 6 and q.cap == 40
    assert by[("newton_schulz", "ns_gram_kernel<4>")].dynamic_smem == 131072
    libs = {i.library for i in kernel_budget.instances()}
    from repro_torch.kernels import build
    assert libs == set(build.LIBRARIES)


def test_budget_audit_clean_and_oversized_detected():
    results = kernel_budget.audit()
    bad = [r for r in results if not r[1]]
    assert not bad, bad
    # the expected residencies: the two-state 8-bit instances with the
    # sentinel or bf16 p at 4 CTAs of 256, the other 256-thread updates at 5
    per = {(i.library, i.name): i.resident()
           for i in kernel_budget.fused_update_instances("fused_update")}
    assert per[("fused_update", "fused_update_kernel<f32,1,256,1,1>")] == 4
    assert per[("fused_update", "fused_update_kernel<f32,0,256,0,0>")] == 5
    assert per[("fused_update",
                "fused_update_packed_kernel<f32,0,256,0,1>")] == 5
    # mutation: an instance past the card's shared memory, and one whose
    # grid assumes more CTAs than fit
    inst = kernel_budget.fused_update_instances()[0]
    big = dataclasses.replace(inst, dynamic_smem=240 * 1024)
    ok, detail = kernel_budget.check_instance(big)
    assert not ok and "shared memory" in detail
    greedy = dataclasses.replace(inst, assumed=9)
    ok, detail = kernel_budget.check_instance(greedy)
    assert not ok and "assumes 9" in detail
    ok, detail = kernel_budget.check_instance(inst, regs=inst.cap + 8)
    assert not ok and "cap" in detail
    # past the 48 KB default with a dynamic part rq_allow_smem leaves alone
    # (the bf16 two-state update at B = 4096 before its threshold moved)
    edge = dataclasses.replace(inst, dynamic_smem=40 * 1024,
                               static_smem=9 * 1024)
    ok, detail = kernel_budget.check_instance(edge)
    assert not ok and "default" in detail


def test_ns_shapes_and_envelope():
    """No shared-memory envelope bounds the Newton–Schulz m: every matrix
    leaf of paper-lm-209m is a shape the launches accept, up to the
    head's, and a shape they refuse is caught."""
    shapes = kernel_budget.ns_leaf_shapes()
    assert (1024, 50264) in shapes
    assert kernel_budget.ns_padded((1024, 50264)) == (1024, 50432)
    assert all(kernel_budget.ns_accepts(*kernel_budget.ns_padded(s))
               for s in shapes)
    assert not kernel_budget.ns_accepts(1026, 2048)
    assert not kernel_budget.ns_accepts(256, 128)


def test_grid_alignment_checks():
    ok, detail = kernel_budget.check_grid_alignment(12345, 4, 2, grid=8)
    assert ok, detail
    ok, detail = kernel_budget.check_grid_alignment(1000, 4, 2, grid=4)
    assert ok, detail
    part = optim_base.make_partition(1000, 4, grid=4)
    plan = optim_base.make_buckets(part, 2, grid=4)
    assert kernel_budget.check_partition_plan(part, plan, grid=4)[0]
    bad_ranges = ((0, 3),) + tuple((3 if k0 == plan.ranges[1][0] else k0, k1)
                                   for k0, k1 in plan.ranges[1:])
    ok, detail = kernel_budget.check_partition_plan(
        part, dataclasses.replace(plan, ranges=bad_ranges), grid=4)
    assert not ok and "misaligned" in detail
    ok, _ = kernel_budget.check_partition_plan(
        part, dataclasses.replace(plan, ranges=plan.ranges[:-1]), grid=4)
    assert not ok
    bad_part = dataclasses.replace(part, span_pad=part.span_pad + 1)
    ok, detail = kernel_budget.check_partition_plan(bad_part, None, grid=4)
    assert not ok and "span_pad" in detail


def test_grid_alignment_matches_jax():
    """Both packages' check_grid_alignment give the same (ok, detail) on
    the JAX audit's cases."""
    from repro.analysis import kernel_budget as jkb
    for total, shards, buckets, grid in kernel_budget.GRID_CASES:
        assert kernel_budget.check_grid_alignment(total, shards, buckets,
                                                  grid) == \
            jkb.check_grid_alignment(total, shards, buckets, grid=grid)


def test_budget_table_shape_and_ptxas_parser(tmp_path):
    """Every instance's residency is the least of its limits; ptxas's
    report parses into registers, spill and static shared memory under
    the demangled instance name."""
    for inst in kernel_budget.instances():
        lim = inst.limits()
        assert inst.resident() == min(lim.values()) >= 1
    log = tmp_path / "fused_update.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119"
        "fused_update_kernelIfLi0ELi256ELb1ELb0EEEvPT_PKfPhPfS6_S7_S4_S4_"
        "S4_PKiSA_S7_iiiN2rq7ScalarsE' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_1\n"
        "    0 bytes stack frame, 12 bytes spill stores, 12 bytes spill "
        "loads\n"
        "ptxas info    : Used 48 registers, used 1 barriers, 4360 bytes "
        "smem, 440 bytes cmem[0]\n")
    got = kernel_budget.ptxas_entries(log)
    assert got == {"fused_update_kernel<f32,0,256,1,0>": dict(
        registers=48, smem=4360, stack=0, spill_stores=12, spill_loads=12)}
    assert kernel_budget.demangle("_Z17dequantize_kernelI13__nv_bfloat16"
                                  "Lb1EEvPKhPKfS4_PT_ii") == \
        "dequantize_kernel<bf16,1>"


# ----------------------------------------------------- mutation self-tests
def test_mutation_promote_f64_trips_no_dtype():
    """Seeded float64 in ops.fused_update must trip fused_update.no_f64 and
    train_step.no_f64; clean, both pass."""
    runner.register_all()
    specs = {s.name: s for s in contracts.all_contracts()}
    clean = runner.trace_update("adamw", 8, device="cpu")
    assert specs["fused_update.no_f64"].check(clean, None)[0]
    with mutations.seeded("promote_f64"):
        upd = runner.trace_update("adamw", 8, device="cpu")
        step = runner.trace_step(CELLS["adamw8-b88-pooled"], device="cpu")
    for name, t in (("fused_update.no_f64", upd),
                    ("train_step.no_f64", step)):
        ok, detail = specs[name].check(t, None)
        assert not ok and "f64" in detail, (name, detail)


def test_mutation_drop_replication_pin_trips_replicated():
    """Handing back only the caller's span of the partials must strip the
    whole-arena gather and trip partitioned_step.replicated_scales."""
    runner.register_all()
    cell = CELLS["lamb8-b88-part4"]
    (spec,) = [c for c in contracts.all_contracts()
               if c.name == "partitioned_step.replicated_scales"]
    assert spec.check(runner.trace_step(cell, device="cpu"), cell)[0]
    with mutations.seeded("drop_replication_pin"):
        mutated = runner.trace_step(cell, device="cpu")
    assert contracts.replicated_pins(mutated) == 0
    ok, detail = spec.check(mutated, cell)
    assert not ok, f"auditor failed to fire: {detail}"
    # an unpartitioned or trust-ratio-free cell carries no such contract
    assert spec.check(mutated, CELLS["adamw8-b88-part4"]) is None


def test_no_f64_fires_without_the_exempt_scope(monkeypatch):
    """sqrt_rn's float64 is allowed only inside its named scope: with the
    scope gone, the update's no_f64 fires."""
    monkeypatch.setattr(contracts, "exempt",
                        lambda dtype, scope: contextlib.nullcontext())
    trace = runner.trace_update("adamw", 8, device="cpu")
    ok, detail = contracts.check_no_dtype(trace, "f64")
    assert not ok and "f64" in detail, detail


def test_mutation_unknown_name_rejected():
    with pytest.raises(ValueError):
        with mutations.seeded("not_a_mutation"):
            pass
    assert not mutations.active("promote_f64")


def test_mutation_host_sync_lint_fires(tmp_path):
    """The host-sync rule must fire on .item() / .cpu() /
    torch.cuda.synchronize() in a function of a step module, and not
    outside the step's modules."""
    src = ("import torch\n"
           "def step(x):\n"
           "    s = x.sum().item()\n"
           "    torch.cuda.synchronize()\n"
           "    return s, x.cpu()\n")
    for rel in ("train/loop.py", "kernels/x.py", "launch/train.py",
                "kernels/build.py"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(src)
    vs = lint.lint_paths(str(tmp_path))
    hits = sorted((v.file, v.rule) for v in vs)
    assert hits == [("kernels/x.py", "host-sync-in-step")] * 3 + \
        [("train/loop.py", "host-sync-in-step")] * 3, vs


def test_lint_rules_on_synthetic_sources(tmp_path):
    (tmp_path / "m.py").write_text(
        "import os\n"
        "import os\n"
        "def f():\n"
        "    assert True\n"
        "    return os.environ.get('X')\n")
    vs = lint.lint_paths(str(tmp_path))
    assert sorted(v.rule for v in vs) == ["bare-assert", "duplicate-import",
                                          "env-read-at-trace"]


LINT_SOURCES = {
    "a.py": ("import os\nimport os\nfrom x import y\nfrom x import y\n"
             "def f(v):\n    assert v\n    return os.getenv('A')\n"
             "class C:\n    def g(self):\n        assert self\n"
             "        return os.environ['B']\n"),
    "b.py": ("import sys\nX = 1\nassert X\n"
             "def h():\n    def inner():\n        return os.environ\n"
             "    return inner\n"),
}


def test_lint_shared_rules_match_jax(tmp_path):
    """The JAX lint's _check_file and the port's give the same violations
    of the three shared rules on the same sources."""
    from repro.analysis import lint as jlint
    shared = ("bare-assert", "env-read-at-trace", "duplicate-import")
    for rel, src in LINT_SOURCES.items():
        (tmp_path / rel).write_text(src)
        path = str(tmp_path / rel)
        pick = lambda vs: sorted((v.line, v.rule) for v in vs
                                 if v.rule in shared)
        got = pick(lint._check_file(path, rel))
        assert got == pick(jlint._check_file(path, rel)) and got


def test_lint_baseline_gate(tmp_path):
    (tmp_path / "m.py").write_text("def f():\n    assert True\n")
    base = tmp_path / "baseline.json"
    ok, _ = lint.run(str(tmp_path), baseline_path=str(base))
    assert not ok
    ok, _ = lint.run(str(tmp_path), baseline_path=str(base),
                     update_baseline=True)
    assert ok and json.loads(base.read_text()) == {"m.py::bare-assert": 1}
    ok, _ = lint.run(str(tmp_path), baseline_path=str(base))
    assert ok
    (tmp_path / "m.py").write_text(
        "def f():\n    assert True\n    assert False\n")
    ok, lines = lint.run(str(tmp_path), baseline_path=str(base))
    assert not ok and any("NEW" in ln for ln in lines)


def test_repo_lint_is_clean_against_baseline():
    root = os.path.dirname(os.path.dirname(lint.__file__))
    ok, lines = lint.run(root)
    assert ok, "\n".join(lines)


# --------------------------------------------------------- the package
def test_stdlib_modules_import_without_torch():
    """contracts, mutations, dtypes and lint import with torch blocked:
    production modules import them at module level."""
    code = ("import sys\nsys.modules['torch'] = None\n"
            "import repro_torch.analysis.contracts, "
            "repro_torch.analysis.mutations, repro_torch.analysis.dtypes, "
            "repro_torch.analysis.lint\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cli_on_the_cpu(capsys):
    """`python -m repro_torch.analysis all --device cpu` passes; the
    contracts raise for a card this machine lacks."""
    assert cli.main(["all", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "ANALYSIS PASS" in out and "[FAIL]" not in out
    n = int(out.split("contracts: ")[1].split("/")[0])
    assert n >= 40, out[-2000:]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            runner.run_contracts(device="cuda")


@pytest.mark.parametrize("mutation,cell,contract", [
    ("promote_f64", "adamw8-b88-pooled", "train_step.no_f64"),
    ("drop_replication_pin", "lamb8-b88-part4",
     "partitioned_step.replicated_scales")])
def test_cli_exits_1_under_a_mutation(monkeypatch, capsys, mutation, cell,
                                      contract):
    monkeypatch.setattr(runner, "default_cells", lambda: [CELLS[cell]])
    with mutations.seeded(mutation):
        assert cli.main(["contracts", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert f"[FAIL] {contract}" in out and "ANALYSIS FAIL" in out


# ------------------------------------------------- against the JAX package
def _jax_verdicts() -> dict:
    """{(subject, contract): ok} of the JAX package (seven lowerings)."""
    import repro.kernels.ops  # noqa: F401 — registrations
    import repro.serve.kvcache  # noqa: F401
    import repro.train.loop  # noqa: F401
    from repro.analysis import contracts as jc
    from repro.analysis import runner as jr
    cell = jr.Cell("adamw8-b88-pooled", "adamw8", (8, 8))
    base = jr.lower_step(cell)
    subjects = {
        "step": ("step", base, cell),
        "telemetry": ("pair:telemetry", {0: base, 2: jr.lower_step(
            cell, telemetry_every=2)}, cell),
        "sentinel": ("pair:sentinel", {
            "off": base, "off_explicit": jr.lower_step(cell, sentinel=False),
            "on": jr.lower_step(cell, sentinel=True)}, cell),
        "update:adamw": ("update", jr.lower_update("adamw", 8),
                         jr.Cell("u", "adamw", (8, 8))),
        "update:muon": ("update", jr.lower_update("muon", 8),
                        jr.Cell("u", "muon", (8, 8))),
        "serve": ("serve", jr.lower_serve(8), jr.Cell("s", "serve", (8,))),
    }
    out = {}
    for key, (scope, subject, c) in subjects.items():
        for spec in jc.contracts_for(scope):
            r = jc.evaluate(spec, subject, c)
            if r is not None:
                out[(key, r.contract)] = r.ok
    return out


def _port_verdicts() -> dict:
    runner.register_all()
    cell = CELLS["adamw8-b88-pooled"]
    subjects = {
        "step": ("step", runner.trace_step(cell, device="cpu"), cell),
        "telemetry": ("pair:telemetry", runner.pair_traces(
            "pair:telemetry", cell, device="cpu"), cell),
        "sentinel": ("pair:sentinel", runner.pair_traces(
            "pair:sentinel", cell, device="cpu"), cell),
        "update:adamw": ("update", runner.trace_update("adamw", 8,
                                                       device="cpu"),
                         runner.Cell("u", "adamw", (8, 8))),
        "update:muon": ("update", runner.trace_update("muon", 8,
                                                      device="cpu"),
                        runner.Cell("u", "muon", (8, 8))),
        "serve": ("serve", runner.trace_serve(8, device="cpu"),
                  runner.Cell("s", "serve", (8,))),
    }
    out = {}
    for key, (scope, subject, c) in subjects.items():
        for spec in contracts.contracts_for(scope):
            r = contracts.evaluate(spec, subject, c)
            if r is not None:
                out[(key, r.contract)] = r.ok
    return out


def test_contract_verdicts_match_jax():
    """Contract by contract, the same verdict from both packages on the
    pooled adamw8 (8, 8) step (donates, no_f64, the telemetry and
    sentinel invariants), the adamw and muon 8-bit updates and the kv-8
    decode step."""
    want = _jax_verdicts()
    got = _port_verdicts()
    assert set(got) == set(want), (sorted(got), sorted(want))
    assert got == want
    assert all(got.values()), got
