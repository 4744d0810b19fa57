"""The partitioned (ZeRO-1) arena, the ZeRO-2 gradient buffer and the
bucketed dispatch of the port in one process (mirrors
``tests/test_partition.py`` and ``tests/test_overlap.py``; the process
groups are ``tests/test_torch_dist.py``'s).

Held live to the JAX package where its own test passes on this toolchain:
  * ``make_partition`` / ``make_buckets``: every field, ``owner_of`` and
    ``bucket_of``, over the reference's property cases;
  * the unrolled apply at 2 and 3 shards, bit for bit, for the algorithms
    whose pooled path the port matches exactly (adamw, momentum, adagrad,
    adam on (4, 8) states);
  * the GradBuffer's accumulation (exact) and norm (to rounding: the two
    packages sum in other orders), ``grad_buffer_bytes``, the owned-state
    accounting and Muon's owner map, exactly;
  * the ZeRO-2 train loop with percentile clipping: losses, grad norms and
    clip scales at the golden tests' rtol=2e-4 (``tests/test_torch_train``'s
    rule for loss traces).
Everywhere else (3 and 4 shards with buckets, uneven spans, lamb/lars,
Muon, the sentinel, checkpoints, the qhealth probe) the port is held bit
for bit to its own unpartitioned pooled run, since the reference's
unrolled bucket cases differ from its own single dispatch by one ULP here
(ROADMAP C10).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg, tiny_pipe

from repro.core import optim as jopt
from repro.core.optim import base as jbase
from repro.train import loop as JL
from repro_torch import convert
from repro_torch import telemetry as tel
from repro_torch.configs import base as tcb
from repro_torch.core import optim as topt
from repro_torch.core.lowbit import PackedCodes
from repro_torch.core.optim import base as tbase
from repro_torch.core.optim import blockopt
from repro_torch.kernels import fused_update as kfu
from repro_torch.kernels import ops
from repro_torch.train import checkpoint as TC
from repro_torch.train import loop as TL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (2800 elements: a padded last block; block 256 gives the spans and
# buckets something to cut: 79 arena blocks)
SHAPES = {"dense/w": (64, 128), "dense/v": (48, 64), "stack": (3, 16, 64),
          "out": (96, 32), "embed/w": (128, 64), "bias": (10,),
          "small": (17,), "u": (40, 70)}
KW = dict(lr=1e-2, min_8bit_size=1024, weight_decay=0.01, block_size=256)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: PyTorch's CPU embedding backward adds a
    repeated token's rows in an order that varies from run to run when it
    runs on several threads, and the runs here are compared bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(seed, scale):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _run(name, steps=3, poison=False, **kw):
    """``steps`` port steps from the same params and grads; returns (opt,
    params, state, health vectors)."""
    opt = topt.make_optimizer(name, device="cpu", **dict(KW, **kw))
    params = {k: torch.from_numpy(v.copy()) for k, v in _np(0, 0.5).items()}
    state = opt.init(params)
    health = []
    for i in range(steps):
        g = {k: torch.from_numpy(v) for k, v in _np(100 + i, 0.1).items()}
        if poison and i == 1:
            g["dense/w"][0, :3] = torch.tensor([np.nan, np.inf, -np.inf])
            g["u"][5, 5] = 1e31
        out = opt.apply(g, state)
        state = out[1]
        health += out[2:]
    return opt, params, state, health


def _nest(flat):
    """{'a/b': array} -> the JAX package's nested dict of jnp arrays."""
    out = {}
    for path, v in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return out


def _bits(t):
    t = getattr(t, "packed", t)
    return t if t.dtype == torch.uint8 else t.view(torch.int32)


def _diff(a, b) -> list:
    """Keys of two trees' canonical arrays that differ bitwise."""
    fa, fb = TC._flatten(a), TC._flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    return [k for (k, x), (_, y) in zip(fa, fb)
            if not (x == y if isinstance(x, int)
                    else torch.equal(_bits(x), _bits(y)))]


def _assert_matches_pooled(name, shards, buckets, **kw):
    oa, pa, sa, ha = _run(name, partition=True, partition_shards=shards,
                          overlap_buckets=buckets, **kw)
    ob, pb, sb, hb = _run(name, **kw)
    assert sa.arena.partition.n_shards == shards
    assert sa.arena.codes_m is None and sa.arena.pieces
    assert _diff(sa, sb) == []
    for k in pa:
        assert torch.equal(_bits(pa[k]), _bits(pb[k])), k
    assert len(ha) == len(hb) and all(torch.equal(x, y)
                                      for x, y in zip(ha, hb))
    sta, stb = oa.state_bytes(sa), ob.state_bytes(sb)
    assert {k: sta[k] for k in stb} == stb
    return sa, ha


# ------------------------------------------------- layout, against JAX
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_partition_and_buckets_match_jax(shards):
    for total in (0, 1, 7, 16, 31, 64, 97, 127552):
        for grid in (1, 4):
            owners = tuple((f"m{k}", k % shards) for k in range(3))
            tp = tbase.make_partition(total, shards, grid, owners)
            jp = jbase.make_partition(total, shards, grid, owners)
            assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
            assert tp.padded_total == jp.padded_total
            assert tp.max_owned == jp.max_owned
            for n_buckets in (1, 2, 3, 5):
                tb = tbase.make_buckets(tp, n_buckets, grid)
                jb = jbase.make_buckets(jp, n_buckets, grid)
                assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
                for row in range(min(total, 200)):
                    assert tp.owner_of(row) == jp.owner_of(row)
                    assert tb.bucket_of(row, tp) == jb.bucket_of(row, jp)
                # the (span, bucket) pieces cover the real rows once, in
                # arena order
                rows = [r for start, n in tp.spans for k0, k1 in tb.ranges
                        for r in range(start + k0, start + min(n, k1))]
                assert rows == list(range(total))


SR = {"stochastic_rounding": True}
EXACT = [("adamw8", SR, 2), ("adamw8", SR, 3), ("momentum8", {}, 2),
         ("adagrad8", {}, 3), ("adam8", dict(SR, state_bits=(4, 8)), 3)]


@pytest.mark.parametrize("name,kw,shards", EXACT,
                         ids=[f"{c[0]}-{c[2]}" for c in EXACT])
def test_unrolled_apply_matches_jax(name, kw, shards):
    """The unrolled span dispatch of both packages from the same numpy
    params and grads (2 steps): every array equal bit for bit."""
    kw = dict(KW, partition=True, partition_shards=shards, **kw)
    jo = jopt.make_optimizer(name, impl="jnp", **kw)
    js = jo.init(_nest(_np(0, 0.5)))
    for i in range(2):
        _, js = jo.apply(_nest(_np(100 + i, 0.1)), js)
    to, _, ts, _ = _run(name, 2, **{k: v for k, v in kw.items()
                                    if k not in KW})
    assert dataclasses.asdict(ts.arena.partition) == \
        dataclasses.asdict(js.arena.partition)
    jl = {jbase.path_str(p): leaf for p, leaf in
          jax.tree_util.tree_leaves_with_path(
              jopt.unpool_state(js).leaves, is_leaf=lambda x: isinstance(
                  x, (jbase.Quant8Leaf, jbase.Full32Leaf)))}
    tl = topt.unpool_state(ts).leaves
    assert sorted(jl) == sorted(tl)
    for path, j in jl.items():
        for f in ("master", "codes_m", "absmax_m", "codes_r", "absmax_r",
                  "m", "r"):
            a = getattr(j, f, None)
            if a is None:
                continue
            b = getattr(tl[path], f)
            np.testing.assert_array_equal(
                getattr(b, "packed", b).numpy(),
                np.asarray(getattr(a, "packed", a)), err_msg=f"{path} {f}")
    assert to.state_bytes(ts) == jo.state_bytes(js)


def _grads_of(shapes, key):
    ks = jax.random.split(jax.random.PRNGKey(key), len(shapes))
    return {p: np.array(jax.random.normal(k, s) * 0.02)
            for k, (p, s) in zip(ks, sorted(shapes.items()))}


def test_grad_buffer_accumulate_and_norm_match_jax():
    """Two microbatches into the owned-span buffer: every leaf's view
    equals the JAX buffer's (and the param-shaped sum) bit for bit; the
    buffer norm equals ``train.loop.global_norm`` of the sum bit for bit
    and the JAX buffer's norm to rounding."""
    kw = dict(lr=1e-2, min_8bit_size=1024, block_size=256, partition=True,
              partition_shards=3, shard_grads=True, overlap_buckets=2)
    to = topt.make_optimizer("adamw8", device="cpu", **kw)
    jo = jopt.make_optimizer("adamw8", **kw)
    params = _np(0, 0.5)
    ts = to.init({k: torch.from_numpy(v.copy()) for k, v in params.items()})
    js = jo.init(_nest(params))
    g1, g2 = _grads_of(SHAPES, 1), _grads_of(SHAPES, 2)
    tb = to.init_grad_buffer(ts)
    for g in (g1, g2):
        to.accumulate_grads(tb, {k: torch.from_numpy(v) for k, v in
                                 g.items()})
    to.finish_grads(tb)
    jb = jo.accumulate_grads(jo.init_grad_buffer(js),
                             _nest(g1))
    jb = jo.accumulate_grads(jb, _nest(g2))
    order = topt.blockopt.leaf_order(params)
    tv = to._grad_views(tb)
    for path, jv in zip(order, jo._grad_views(jb)):
        np.testing.assert_array_equal(tv[path].numpy(), np.asarray(jv),
                                      err_msg=path)
        np.testing.assert_array_equal(tv[path].numpy(), g1[path] + g2[path])
    gsum = {k: torch.from_numpy(g1[k] + g2[k]) for k in g1}
    norm = to.grad_buffer_norm(tb)
    assert torch.equal(norm, TL.global_norm(gsum))
    np.testing.assert_allclose(float(norm), float(jo.grad_buffer_norm(jb)),
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["adam8", "muon8"])
def test_accounting_matches_jax(name):
    """grad_buffer_bytes, the owned-state bytes and Muon's owner map of a
    4-way partition with ZeRO-2, equal to the JAX package's."""
    kw = dict(lr=1e-2, min_8bit_size=256, block_size=256,
              override_32bit=lambda p: False, partition=True,
              partition_shards=4, shard_grads=True)
    to = topt.make_optimizer(name, device="cpu", **kw)
    jo = jopt.make_optimizer(name, **kw)
    params = _np(0, 0.5)
    ts = to.init({k: torch.from_numpy(v.copy()) for k, v in params.items()})
    js = jo.init(_nest(params))
    assert to.grad_buffer_bytes(ts) == jo.grad_buffer_bytes(js)
    assert to.state_bytes(ts) == jo.state_bytes(js)
    assert ts.arena.partition.matrix_owners == js.arena.partition.matrix_owners
    if name == "muon8":
        owners = dict(ts.arena.partition.matrix_owners)
        assert list(owners.values()) == [k % 4 for k in range(len(owners))]
        assert len(owners) >= 3


def _jax_zero2_run(steps, **kw):
    jo = jopt.make_optimizer("adamw8", **kw)
    state, _ = JL.init_train_state(tiny_cfg(), jo, jax.random.PRNGKey(0))
    step = JL.jit_train_step(tiny_cfg(), jo, JL.TrainHyper(microbatches=2))
    trace = []
    for i in range(steps):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in tiny_pipe().batch_at(i).items()})
        trace.append([float(m[k]) for k in ("loss", "grad_norm",
                                            "pclip_scale")])
    return trace, m


def _port_loop(steps, **kw):
    params, _ = __import__("repro.models.model", fromlist=["init_model"]) \
        .init_model(tiny_cfg(), jax.random.PRNGKey(0))
    model = convert.params_from_numpy(jax.device_get(params), tcb.reduced(
        tcb.get_config("paper-lm-209m"), d_model=64, n_layers=2,
        vocab_size=128), device="cpu")
    to = topt.make_optimizer("adamw8", device="cpu", **kw)
    state = TL.TrainState(to.init(model.param_dict()), 0)
    step = TL.make_train_step(model.cfg, model, to,
                              TL.TrainHyper(microbatches=2))
    trace = []
    for i in range(steps):
        state, m = step(state, tiny_pipe().batch_at(i))
        trace.append([float(m[k]) for k in ("loss", "grad_norm",
                                            "pclip_scale")])
    return state, trace, m


def test_zero2_train_loop_and_pclip_match_sequential_and_jax():
    """The ZeRO-2 loop (two microbatches into the GradBuffer, the clip
    from its norm, percentile clipping off the buffer, the apply from it)
    against the sequential partitioned loop of the port, bit for bit
    (losses, grad norms, clip scales, final state, clip history), and
    against the JAX package's ZeRO-2 loop at rtol=2e-4."""
    kw = dict(lr=5e-3, min_8bit_size=1024, stochastic_rounding=True,
              partition=True, partition_shards=2, percentile_clipping=50,
              pclip_history=3)
    st_s, tr_s, _ = _port_loop(3, **kw)
    st_o, tr_o, m_o = _port_loop(3, shard_grads=True, overlap_buckets=2,
                                 **kw)
    assert tr_s == tr_o, (tr_s, tr_o)
    assert _diff(st_s.opt_state, st_o.opt_state) == []
    assert torch.equal(st_s.opt_state.gnorm_vec, st_o.opt_state.gnorm_vec)
    tr_j, m_j = _jax_zero2_run(3, shard_grads=True, overlap_buckets=2, **kw)
    np.testing.assert_allclose(np.array(tr_o), np.array(tr_j), rtol=2e-4)
    for k in ("peak_grad_bytes", "replicated_grad_bytes",
              "opt_owned_blocks", "opt_owned_state_bytes_per_param"):
        assert m_o[k] == pytest.approx(float(m_j[k]), rel=1e-6), k
    assert m_o["peak_grad_bytes"] < m_o["replicated_grad_bytes"]


# ------------------------------------ partitioned == pooled, in the port
PORT_CASES = [
    (f"{a}8", {"stochastic_rounding": True}, s, b)
    for a in ("adam", "adamw", "momentum", "lamb", "lars", "adagrad")
    for s, b in ((3, 1), (4, 3))] + [
    ("adam8", {"state_bits": (4, 8), "stochastic_rounding": True,
               "percentile_clipping": 50, "pclip_history": 3}, s, b)
    for s, b in ((2, 2), (4, 4))] + [
    ("lamb8", {"state_bits": (4, 8), "impl": "torch"}, 3, 2),
    ("muon8", {"stochastic_rounding": True}, 2, 1),
    ("muon8", {"state_bits": (4, 8)}, 3, 2)]


@pytest.mark.parametrize("name,kw,shards,buckets", PORT_CASES, ids=[
    f"{n}-{'-'.join(map(str, k))}-{s}x{b}" for n, k, s, b in PORT_CASES])
def test_partitioned_matches_pooled(name, kw, shards, buckets):
    _assert_matches_pooled(name, shards, buckets, **kw)


@pytest.mark.parametrize("poison", [False, True], ids=["clean", "poisoned"])
@pytest.mark.parametrize("name,kw", [("adamw8", {}),
                                     ("lamb8", {"state_bits": (4, 8)})])
def test_partitioned_sentinel_matches_pooled(name, kw, poison):
    _, health = _assert_matches_pooled(name, 4, 2, sentinel=True,
                                       poison=poison, **kw)
    assert len(health) == 3
    if poison:
        assert float(health[1][0]) == 3.0         # nonfinite grads


def test_uneven_spans_and_piece_alignment():
    """An arena whose blocks do not divide by the shards: the last owner
    holds a short span, and pieces start off the 4-block grid; every
    piece's tensors are
    its own (16-byte aligned whatever row it starts at) and every kernel
    call gets aligned operands, one fused update per piece and step (and
    one norm prologue per piece for lamb)."""
    calls, kernel = [], ops._REGISTRY[("lamb", "cuda")]
    norm = kfu.norm_partials_cuda

    def spy(*args, **kw):
        tensors = [a for a in args if isinstance(a, torch.Tensor)] + [
            v for v in kw.values() if isinstance(v, torch.Tensor)]
        calls.append(all(t.data_ptr() % 16 == 0 for t in tensors))
        return kernel(*args, **kw)

    def norm_spy(*args, **kw):
        calls.append("norm")
        return norm(*args, **kw)

    ops._REGISTRY[("lamb", "cuda")] = spy
    kfu.norm_partials_cuda = norm_spy
    try:
        opt, _, st, _ = _run("lamb8", 2, partition=True, partition_shards=3,
                             overlap_buckets=2)
    finally:
        ops._REGISTRY[("lamb", "cuda")] = kernel
        kfu.norm_partials_cuda = norm
    part, pieces = st.arena.partition, st.arena.pieces
    assert part.total % part.n_shards != 0
    assert [(pc.start, pc.n) for pc in pieces] == [
        (s + k0, min(n, k1) - k0) for s, n in part.spans
        for k0, k1 in st.arena.buckets.ranges if min(n, k1) > k0]
    assert any(pc.start % 4 for pc in pieces)      # unaligned starts
    assert calls.count("norm") == 2 * len(pieces)
    assert [c for c in calls if c != "norm"] == [True] * 2 * len(pieces)
    for pc in pieces:
        for t in (pc.codes_m, pc.absmax_m, pc.codes_r, pc.absmax_r,
                  pc.block_offsets, pc.leaf_seeds):
            assert getattr(t, "packed", t).data_ptr() % 16 == 0
    assert st.arena.master.shape[0] == part.padded_total
    assert opt.state_bytes(st)["owned_blocks"] == part.max_owned


def test_zero2_buffer_apply_matches_dict_apply():
    """apply(GradBuffer) against apply(param-shaped grads), one process:
    packed (4, 8) states with buckets, and Muon's matrix leaves riding
    the buffer param-shaped; bit for bit."""
    for name, kw in (("adam8", {"state_bits": (4, 8),
                                "stochastic_rounding": True}),
                     ("muon8", {"override_32bit": lambda p: False,
                                "min_8bit_size": 256})):
        kw = dict(KW, partition=True, partition_shards=3, **kw)
        grads = {k: torch.from_numpy(v) for k, v in _np(7, 0.1).items()}
        out = []
        for sg in (False, True):
            opt = topt.make_optimizer(name, device="cpu", shard_grads=sg,
                                      overlap_buckets=2, **kw)
            st = opt.init({k: torch.from_numpy(v.copy())
                           for k, v in _np(0, 0.5).items()})
            g = grads
            if sg:
                g = opt.finish_grads(opt.accumulate_grads(
                    opt.init_grad_buffer(st), grads))
            out.append(opt.apply(g, st)[1])
        assert _diff(*out) == [], name


# ------------------------------------------------ checkpoints and probe
def test_checkpoint_interchange_partitioned(tmp_path):
    """A partitioned state (3 uneven spans x 2 buckets, (4, 8) states)
    saves as the pooled one does; it restores into pooled, per-leaf and
    other partitioned templates, a per-leaf checkpoint restores into it,
    and a resumed partitioned step equals the pooled continuation."""
    kw = dict(state_bits=(4, 8), stochastic_rounding=True)
    _, _, sp, _ = _run("adam8", partition=True, partition_shards=3,
                       overlap_buckets=2, **kw)
    _, _, so, _ = _run("adam8", **kw)
    d = str(tmp_path)
    TC.save(d, 3, sp)
    TC.save(d, 4, so)
    saved = TC.read(d, 3)["state"]
    for k, v in TC.read(d, 4)["state"].items():
        np.testing.assert_array_equal(saved[k], v, err_msg=k)

    def template(**more):
        opt = topt.make_optimizer("adam8", device="cpu",
                                  **dict(KW, **kw, **more))
        return opt, opt.init({k: torch.zeros(s) for k, s in SHAPES.items()})

    for more in ({}, {"pooled": False}, {"partition": True,
                                         "partition_shards": 2},
                 {"partition": True, "partition_shards": 4,
                  "overlap_buckets": 3}):
        _, st = template(**more)
        st = TC.restore(d, 3, st)
        assert _diff(st, so) == [], more
    opt_p, st_p = template(partition=True, partition_shards=3,
                           overlap_buckets=2)
    st_p = TC.restore(d, 4, st_p)
    opt_o, st_o = template()
    st_o = TC.restore(d, 4, st_o)
    g = {k: torch.from_numpy(v) for k, v in _np(9, 0.1).items()}
    assert _diff(opt_p.apply(g, st_p)[1], opt_o.apply(g, st_o)[1]) == []


def test_qhealth_probe_partitioned_matches_unpartitioned():
    """The probe on a partitioned state (4 spans x 2 buckets) gives the
    unpartitioned state's events, value for value."""
    events = []
    for kw in ({}, {"partition": True, "partition_shards": 4,
                    "overlap_buckets": 2}):
        opt, _, st, _ = _run("adam8", 2, **kw)
        events.append(tel.QHealthProbe(opt).probe(st, step=1))
    assert len(events[0]) == len(events[1]) > 0
    assert json.dumps(events[0]) == json.dumps(events[1])


def test_anomaly_injection_e2e_partitioned(tmp_path):
    """lr=1e18 with the sentinel until a fatal anomaly, partitioned over 4
    spans and unpartitioned: the same metrics every step, the same trigger
    step, and the partitioned dump restores into a partitioned state bit
    for bit equal to the unpartitioned run's last healthy state."""
    cfg = tcb.reduced(tcb.get_config("paper-lm-209m"), d_model=64,
                      n_layers=2, vocab_size=128)
    pipe = tiny_pipe()
    kw = dict(lr=1e18, min_8bit_size=256, override_32bit=lambda p: False,
              sentinel=True, device="cpu")

    def fresh(**more):
        opt = topt.make_optimizer("adam8", **kw, **more)
        state, model = TL.init_train_state(
            cfg, opt, torch.Generator().manual_seed(0), device="cpu")
        return opt, state, TL.make_train_step(cfg, model, opt)

    runs = []
    for more in ({}, {"partition": True, "partition_shards": 4}):
        _, state, step = fresh(**more)
        det, fr = tel.AnomalyDetector(), tel.FlightRecorder(ring=8)
        metrics, healthy = [], None
        for i in range(40):
            state, m = step(state, pipe.batch_at(i))
            # (the dispatch counts differ by design: 4 spans against 1)
            metrics.append({k: float(v) for k, v in m.items()
                            if not k.startswith("opt_")})
            evs = det.observe_step(i, m)
            for ev in evs:
                fr.note_anomaly(ev)
            fr.record(i, m)
            if any(e["severity"] == "fatal" for e in evs):
                dump = fr.dump(str(tmp_path / f"dump{len(runs)}"),
                               reason=evs[0]["reason"], trigger_step=i)
                break
            fr.snapshot(i, state)
            healthy = TC.state_dict(state)
            healthy = {k: v if isinstance(v, int) else v.clone()
                       for k, v in healthy["state"].items()}
        else:
            pytest.fail("lr=1e18 did not produce a fatal anomaly")
        runs.append((i, metrics, dump, healthy))
    assert runs[0][0] == runs[1][0]
    assert json.dumps(runs[0][1]) == json.dumps(runs[1][1])
    _, fresh_state, _ = fresh(partition=True, partition_shards=4)
    snap, restored = tel.restore_state(runs[1][2], fresh_state)
    assert snap == runs[0][0] - 1
    got = TC.state_dict(restored)["state"]
    assert list(got) == list(runs[0][3])
    for k, v in runs[0][3].items():
        assert (got[k] == v) if isinstance(v, int) else \
            torch.equal(_bits(got[k]), _bits(v)), k


# ------------------------------------------- launcher, quickstart, face
def test_launcher_zero2_flags(tmp_path):
    """``--partition 2 --shard-grads --overlap-buckets 2`` on the train
    launcher (ZeRO-1 spans and ZeRO-2 in one process, two microbatches):
    4 fused launches a step (2 spans x 2 buckets) against 1, and the loss
    and grad-norm trace of the run without the flags, bit for bit.
    ``--overlap-buckets`` without ``--partition`` is an argument error."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train as launch
    argv = ["--device", "cpu", "--d-model", "64", "--n-layers", "2",
            "--vocab", "256", "--steps", "2", "--batch", "4", "--seq-len",
            "16", "--microbatches", "2", "--optimizer", "adamw8"]
    traces, launches = [], []
    for i, extra in enumerate(([], ["--partition", "2", "--shard-grads",
                                    "--overlap-buckets", "2"])):
        out = tmp_path / f"m{i}.jsonl"
        n0 = kops.fused_update_count()
        assert launch.main([*argv, "--out", str(out), *extra]) == 0
        launches.append(kops.fused_update_count() - n0)
        traces.append([(r["loss"], r["grad_norm"]) for r in map(
            json.loads, out.read_text().splitlines())])
    assert launches == [2 * 1, 2 * 4]
    assert len(traces[0]) == 2 and traces[0] == traces[1]
    with pytest.raises(SystemExit) as exc:
        launch.main([*argv, "--overlap-buckets", "2"])
    assert exc.value.code == 2


def test_quickstart_partition_flags(capsys):
    """The quickstart's --partition / --shard-grads / --overlap run (16
    fused dispatches a step: 4 spans x 4 buckets) and its argument
    errors (exit 2)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", os.path.join(ROOT, "examples",
                                         "quickstart_torch.py"))
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    assert qs.main(["--device", "cpu", "--steps", "1", "--partition", "4",
                    "--shard-grads", "--overlap", "4"]) == 0
    out = capsys.readouterr().out
    line = [x for x in out.splitlines()
            if x.startswith("fused dispatches/step")][0]
    assert line.split()[-1] == "16", line
    assert "over 4 owners" in out
    for args, msg in ((["--partition", "2", "--no-pooled"], "--no-pooled"),
                      (["--shard-grads", "--no-pooled"], "--no-pooled"),
                      (["--overlap", "2"], "--partition")):
        with pytest.raises(SystemExit) as exc:
            qs.main(["--device", "cpu", *args])
        assert exc.value.code == 2
        assert msg in capsys.readouterr().err, args


def test_face_shard_grads_matches_face():
    """The torch.optim face with shard_grads and a partition applies from
    the GradBuffer, bit for bit as the plain face."""
    cfg = tcb.reduced(tcb.get_config("paper-lm-209m"), d_model=64,
                      n_layers=2, vocab_size=128)
    from repro_torch.models import model as M
    states = []
    for kw in ({}, {"partition": True, "partition_shards": 3,
                    "shard_grads": True, "overlap_buckets": 2}):
        model = M.init_model(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        opt = topt.BlockOptimizer(model.named_parameters(), "adamw8",
                                  lr=1e-2, device="cpu", **kw)
        for i in range(2):
            tokens = torch.as_tensor(tiny_pipe().batch_at(i)["tokens"])
            logits, _ = M.forward(cfg, model, tokens[:, :-1])
            TL.cross_entropy(logits, tokens[:, 1:]).backward()
            opt.step()
            opt.zero_grad()
        states.append(opt.opt_state)
    assert _diff(*states) == []
    assert isinstance(states[1].arena.pieces[0].codes_m, torch.Tensor)
    assert not isinstance(states[1].arena.pieces[0].codes_m, PackedCodes)
    assert blockopt.GradBuffer is topt.GradBuffer
