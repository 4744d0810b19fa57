"""The port's data-parallel paths on real process groups: ``gloo`` on the
CPU, worlds of 2 and 4 processes (mirrors the mesh cases of
``tests/test_partition.py``, ``tests/test_overlap.py``,
``test_sentinel.py::test_anomaly_injection_e2e_zero1`` and
``test_telemetry.py::test_qhealth_probe_partitioned_matches_unpartitioned``,
which fail on this toolchain: ROADMAP C1).

One world of each size is spawned once for the file (a ``FileStore`` in a
temporary directory; no network).  Its ranks run every case, each rank on
its own rows of the batch, and each rank records its verdicts; the
parametrised tests read them, so each case still counts.  The contract:
on one world, the partitioned (ZeRO-1) and ZeRO-2 runs are bit-identical to
the port's unpartitioned data-parallel pooled run (losses, grad norms,
health counts, every state array), on every rank; and every mode (the
unpartitioned one too) agrees with plain PyTorch in one process over the
whole batch (see "against plain PyTorch" below).  The reference's
``impl="jnp"`` mesh tests are not run here: this file imports no JAX, so
that the spawned ranks start fast.
"""
import contextlib
import datetime
import hashlib
import json
import os
import tempfile
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import telemetry as tel
from repro_torch.analysis import contracts, runner
from repro_torch.configs import base as tcb
from repro_torch.core import optim as topt
from repro_torch.core.optim import blockopt
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
from repro_torch.errors import ConfigError
from repro_torch.launch import mesh as ML
from repro_torch.train import checkpoint as TC
from repro_torch.train import loop as TL

WORLDS = (2, 4)
STEPS = 3


def _cfg():
    return tcb.reduced(tcb.get_config("paper-lm-209m"), d_model=64,
                       n_layers=2, vocab_size=128)


def _pipe():
    return SyntheticLMPipeline(DataConfig(vocab_size=128, seq_len=32,
                                          global_batch=8))


def _bits(t):
    t = getattr(t, "packed", t)
    return t if t.dtype == torch.uint8 else t.view(torch.int32)


def _digest(state) -> str:
    """Hash of a train state's canonical arrays (its spans gathered)."""
    tree = blockopt.map_opt_states(state, blockopt.gathered_state)
    h = hashlib.sha256()
    for key, v in TC._flatten(tree):
        h.update(key.encode())
        h.update(str(v).encode() if isinstance(v, int)
                 else _bits(v).contiguous().numpy().tobytes())
    return h.hexdigest()


def _loop(mesh, name, steps=STEPS, microbatches=2, stop_on_fatal=False,
          each_step=None, **kw):
    """The train loop on the group: (optimizer, state, per-step metrics,
    the flight recorder and the trigger step of a fatal anomaly);
    ``each_step(state)`` is called after every step."""
    opt = topt.make_optimizer(name, device="cpu", mesh=mesh, **kw)
    state, model = TL.init_train_state(
        _cfg(), opt, torch.Generator().manual_seed(0), device="cpu")
    step = TL.make_train_step(_cfg(), model, opt,
                              TL.TrainHyper(microbatches=microbatches))
    det, fr = tel.AnomalyDetector(), tel.FlightRecorder(ring=8)
    trace, trigger = [], None
    for i in range(steps):
        state, m = step(state, _pipe().batch_at(i))
        if each_step is not None:
            each_step(state)
        # (the dispatch counts and the partition's and ZeRO-2's own
        # accounting differ from the oracle's by design)
        trace.append({k: float(v) for k, v in m.items()
                      if not k.startswith("opt_")
                      and not k.endswith("grad_bytes")})
        if stop_on_fatal:
            evs = det.observe_step(i, m)
            fr.record(i, m)
            if any(e["severity"] == "fatal" for e in evs):
                trigger = i
                break
            fr.snapshot(i, state)
    return opt, state, trace, fr, trigger


def _same_on_ranks(value: str, group=None) -> bool:
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, value, group=group)
    return len(set(out)) == 1


def _compare(mesh, name, oracle_kw, kw, steps=STEPS, microbatches=2):
    """The run with ``kw`` against the unpartitioned run with
    ``oracle_kw``: traces and state digests equal, on every rank."""
    _, s_o, t_o, _, _ = _loop(mesh, name, steps, microbatches,
                              **oracle_kw)
    _, s_p, t_p, _, _ = _loop(mesh, name, steps, microbatches, **kw)
    d_o, d_p = _digest(s_o), _digest(s_p)
    # every rank takes part in every collective, whatever it found so far
    same = _same_on_ranks(d_p) & _same_on_ranks(json.dumps(t_p))
    ok = json.dumps(t_o) == json.dumps(t_p) and d_o == d_p and same
    return ok, f"traces {t_o} vs {t_p}; digests {d_o[:12]} {d_p[:12]}"


BASE = dict(lr=5e-3, min_8bit_size=1024, block_size=256)
ORACLE = dict(BASE, partition=False)


def case_zero1_adamw8_sr(mesh, world, tmp):
    kw = dict(BASE, stochastic_rounding=True)
    return _compare(mesh, "adamw8", dict(kw, partition=False),
                    dict(kw, overlap_buckets=2))


def case_zero1_lamb8(mesh, world, tmp):
    return _compare(mesh, "lamb8", ORACLE, dict(BASE, overlap_buckets=3))


def case_zero1_lars8(mesh, world, tmp):
    return _compare(mesh, "lars8", ORACLE, BASE)


def case_zero1_adam8_4_8_pclip(mesh, world, tmp):
    kw = dict(BASE, state_bits=(4, 8), stochastic_rounding=True,
              percentile_clipping=50, pclip_history=2)
    return _compare(mesh, "adam8", dict(kw, partition=False),
                    dict(kw, overlap_buckets=2))


def case_zero1_muon8_owner_routing(mesh, world, tmp):
    # the head and the (2, 64) norm stacks are quantized matrix leaves
    kw = dict(BASE, min_8bit_size=64, stochastic_rounding=True)
    ok, detail = _compare(mesh, "muon8", dict(kw, partition=False), kw)
    opt = topt.make_optimizer("muon8", device="cpu", mesh=mesh, **kw)
    st = opt.init(TL.init_train_state(_cfg(), opt, torch.Generator()
                                      .manual_seed(0), device="cpu")[1]
                  .param_dict())
    owners = [o for _, o in st.arena.partition.matrix_owners]
    return ok and owners == [k % world for k in range(len(owners))] \
        and len(owners) > world, f"{detail}; owners {owners}"


def case_zero2_adamw8(mesh, world, tmp):
    kw = dict(BASE, stochastic_rounding=True)
    return _compare(mesh, "adamw8", dict(kw, partition=False),
                    dict(kw, shard_grads=True, overlap_buckets=3))


def case_zero2_lamb8_4_8(mesh, world, tmp):
    kw = dict(BASE, state_bits=(4, 8))
    return _compare(mesh, "lamb8", dict(kw, partition=False),
                    dict(kw, shard_grads=True))


def case_zero2_sentinel_and_memory(mesh, world, tmp):
    """ZeRO-2 with the sentinel: health counts summed over the spans, the
    rank holding only its own span's pieces and no whole gradient."""
    kw = dict(BASE, sentinel=True)
    ok, detail = _compare(mesh, "adamw8", dict(kw, partition=False),
                          dict(kw, shard_grads=True, overlap_buckets=2))
    opt, st, trace, _, _ = _loop(mesh, "adamw8", 1, shard_grads=True,
                                 **kw)
    arena, rank = st.opt_state.arena, dist.get_rank()
    held = {pc.owner for pc in arena.pieces}
    gb = opt.grad_buffer_bytes(st.opt_state)
    ok = ok and held == {rank} and arena.grad is None and \
        gb["grad_partition_shards"] == world and \
        trace[0]["sent_nonfinite_grad"] == 0.0
    return ok, f"{detail}; held {held}; {gb}"


def case_sentinel_blowup_zero1(mesh, world, tmp):
    """lr=1e18 with the sentinel (mirrors the JAX package's
    ``test_anomaly_injection_e2e_zero1``): the partitioned run trips the
    same fatal anomaly on the same step with the same metrics as the
    unpartitioned one, and its flight snapshot (its spans gathered on
    every rank) restores into a partitioned state equal to the
    unpartitioned run's last healthy state."""
    kw = dict(BASE, lr=1e18, min_8bit_size=256,
              override_32bit=lambda p: False, sentinel=True)
    runs = [_loop(mesh, "adam8", 40, 1, stop_on_fatal=True, **more)
            for more in (dict(kw, partition=False), kw)]
    (_, _, t_o, fr_o, k_o), (_, _, t_p, fr_p, k_p) = runs
    ok = k_o is not None and k_o == k_p and \
        json.dumps(t_o) == json.dumps(t_p)
    d = os.path.join(tmp, "blowup")
    if dist.get_rank() == 0:
        fr_p.dump(d, reason="fatal", trigger_step=k_p)
        fr_o.dump(d + "_o", reason="fatal", trigger_step=k_o)
    dist.barrier()
    digests = []
    for path, more in ((d, kw), (d + "_o", dict(kw, partition=False))):
        opt = topt.make_optimizer("adam8", device="cpu", mesh=mesh, **more)
        fresh, _ = TL.init_train_state(_cfg(), opt, torch.Generator()
                                       .manual_seed(5), device="cpu")
        snap, restored = tel.restore_state(path, fresh)
        ok = ok and snap == k_o - 1
        digests.append(_digest(restored))
    same = _same_on_ranks(digests[0])
    ok = ok and digests[0] == digests[1] and same
    return ok, f"trigger {k_o} vs {k_p}; digests {digests}"


def case_checkpoint_interchange(mesh, world, tmp):
    """A partitioned state saved on the group (spans gathered to rank 0)
    holds the unpartitioned run's arrays; it restores into partitioned
    and unpartitioned templates on every rank, and a resumed partitioned
    step equals the unpartitioned continuation."""
    kw = dict(BASE, state_bits=(4, 8), stochastic_rounding=True)
    _, s_p, _, _, _ = _loop(mesh, "adam8", 2, overlap_buckets=2, **kw)
    _, s_o, _, _, _ = _loop(mesh, "adam8", 2, partition=False, **kw)
    d = os.path.join(tmp, "ckpt")
    TC.save(d, 2, s_p)
    TC.save(d + "_o", 2, s_o)
    dist.barrier()
    a, b = TC.read(d, 2)["state"], TC.read(d + "_o", 2)["state"]
    ok = list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)
    digests, steps = [], []
    for more in (dict(kw, overlap_buckets=2), dict(kw, partition=False)):
        opt = topt.make_optimizer("adam8", device="cpu", mesh=mesh, **more)
        st, model = TL.init_train_state(_cfg(), opt, torch.Generator()
                                        .manual_seed(7), device="cpu")
        st = TC.restore(d, 2, st)
        digests.append(_digest(st))
        step = TL.make_train_step(_cfg(), model, opt,
                                  TL.TrainHyper(microbatches=2))
        st, m = step(st, _pipe().batch_at(2))
        steps.append((float(m["loss"]), _digest(st)))
    want, same = _digest(s_o), _same_on_ranks(steps[0][1])
    ok = ok and digests[0] == digests[1] == want and \
        steps[0] == steps[1] and same
    return ok, f"{digests} {steps}"


def case_qhealth_probe(mesh, world, tmp):
    """The probe on a partitioned state gives the unpartitioned state's
    events, on every rank."""
    events = []
    for more in (dict(partition=False), dict(overlap_buckets=2)):
        opt, st, _, _, _ = _loop(mesh, "adam8", 2, **dict(BASE, **more))
        events.append(json.dumps(tel.QHealthProbe(opt).probe(
            st.opt_state, step=1)))
    same = _same_on_ranks(events[1])
    return events[0] == events[1] and same and \
        len(json.loads(events[0])) > 0, events[1][:200]


# ---- against plain PyTorch in one process (independent of the group code)
#
# Every case above holds a group run to the port's unpartitioned run on the
# same group, which shares its batch split and gradient reduction.  These
# hold the group runs to the pooled optimizer in one process with no mesh,
# fed by plain autograd over the whole batch (W x n microbatches, so the
# rows of every rank's microbatches, in the same order).  Where the two
# sum the same terms in the same order they must agree bit for bit: at
# W = 2 a sum over the ranks has two terms, so its order does not matter.
# Elsewhere the sums differ in order only, and agree to a few f32 ULPs:
# GRAD_RTOL of each leaf's largest gradient, TRACE_RTOL on losses and grad
# norms.  The reordered sum can move an 8-bit statistic across a rounding
# boundary of its code, and over the steps that element's moment carries
# the difference on (its update then moves by a fraction of lr, or more
# once its code has moved a few levels; its param keeps the difference
# after the codes agree again): so the elements whose codes differed from
# the reference's after some step are counted and bounded by CODE_FLIPS
# of a leaf (as tests/test_torch_models.py bounds them), and every other
# element's final param agrees within PARAM_ATOL.  A wrong rank's rows, a
# wrong span offset or a second division by W moves the gradient by whole
# values, and the loss and grad norm by far more than these.

MODES = (("unpartitioned", dict(partition=False)),
         ("zero1", dict(overlap_buckets=3)),
         ("zero2", dict(shard_grads=True, overlap_buckets=2)))
GRAD_RTOL = 1e-6
TRACE_RTOL = 2e-6
PARAM_ATOL = 1e-2 * BASE["lr"]
CODE_FLIPS = 1e-3          # fraction of a leaf's elements whose codes differ


def _batch_tokens(i: int) -> torch.Tensor:
    return torch.as_tensor(_pipe().batch_at(i)["tokens"]).long()


def _plain_grads(model, tokens, n) -> list:
    """{path: .grad} of each of ``n`` microbatches of ``tokens``, by plain
    autograd on ``model``."""
    params = model.param_dict()
    out = []
    for mb in tokens.chunk(n, dim=0):
        model.zero_grad(set_to_none=True)
        logits, _ = TL.M.forward(_cfg(), model, mb[:, :-1])
        TL.cross_entropy(logits, mb[:, 1:]).backward()
        out.append({k: p.grad.detach().clone() for k, p in params.items()})
    model.zero_grad(set_to_none=True)
    return out


def _mean(grads: list, terms) -> dict:
    """The sum of ``grads`` in list order, divided by ``terms``."""
    acc = {k: v.clone() for k, v in grads[0].items()}
    for g in grads[1:]:
        for k in acc:
            acc[k].add_(g[k])
    return {k: v.div_(terms) for k, v in acc.items()}


def _leaf_gap(a: dict, b: dict) -> float:
    """Largest difference of ``a`` and ``b`` over the leaves, each in units
    of the leaf's largest magnitude in ``b``."""
    return max(((a[k] - b[k]).abs().max() / b[k].abs().max().clamp(
        min=1e-30)).item() for k in b)


def _element_codes(state) -> dict:
    """{path: (n,) codes of each state slot stacked, (slots, n)} of every
    quantized leaf, element for element (spans gathered on every rank)."""
    per_leaf = blockopt.unpool_state(blockopt.gathered_state(
        state.opt_state))
    out = {}
    for path, leaf in per_leaf.leaves.items():
        if isinstance(leaf, topt.Quant8Leaf):
            out[path] = torch.stack([
                _bits(c).reshape(-1)[:leaf.n]
                for c in (leaf.codes_m, leaf.codes_r) if c is not None])
    return out


def _run(mesh, name, steps, microbatches, **kw):
    """(trace, state digest, {path: param}, [{path: element codes} after
    each step]) of the train loop."""
    codes = []
    opt, state, trace, _, _ = _loop(
        mesh, name, steps, microbatches,
        each_step=lambda st: codes.append(_element_codes(st)), **kw)
    return trace, _digest(state), opt.params_view(state.opt_state), codes


def _param_gap(p: dict, p_ref: dict, codes: list, codes_ref: list) -> tuple:
    """(largest param difference over the elements whose codes agreed with
    the reference's after every step, the largest fraction of a leaf's
    codes of one state that differed after one step).  Leaves without
    codes are compared whole."""
    gap, flips = 0.0, 0.0
    for k in p_ref:
        diff = (p[k] - p_ref[k]).abs().reshape(-1)
        if k in codes_ref[0]:
            differ = torch.stack([c[k] != r[k]
                                  for c, r in zip(codes, codes_ref)])
            n = differ.shape[-1]
            flips = max(flips, differ.sum(dim=-1).max().item() / n)
            diff = diff[~differ.any(dim=0).any(dim=0)]
        if diff.numel():
            gap = max(gap, diff.max().item())
    return gap, flips


def _close_traces(a: list, b: list) -> bool:
    return [sorted(x) for x in a] == [sorted(y) for y in b] and all(
        abs(x[k] - y[k]) <= TRACE_RTOL * abs(y[k]) for x, y in zip(a, b)
        for k in y)


def _plain_reference(mesh, world, name, kw):
    """The group runs of every mode, 1 and 2 microbatches a rank, against
    the run in one process with no mesh over the whole batch."""
    rows, ok = [], True
    for n in (1, 2):
        t_ref, d_ref, p_ref, c_ref = _run(None, name, STEPS, world * n,
                                          **dict(kw, partition=False))
        exact = world == 2 and n == 1
        for mode, more in MODES:
            t, d, p, c = _run(mesh, name, STEPS, n, **dict(kw, **more))
            gap, flips = _param_gap(p, p_ref, c, c_ref)
            if exact:
                good = json.dumps(t) == json.dumps(t_ref) and d == d_ref
            else:
                good = (_close_traces(t, t_ref) and gap <= PARAM_ATOL
                        and flips <= CODE_FLIPS)
            ok = ok and good and _same_on_ranks(d)
            rows.append(f"n={n} {mode}: {'exact' if exact else 'close'} "
                        f"{good}, params off by {gap:.3g} where the codes "
                        f"agreed, codes differed on {flips:.3g} of a leaf")
    return ok, "; ".join(rows)


def case_plain_reference_adamw8_pclip(mesh, world, tmp):
    return _plain_reference(mesh, world, "adamw8", dict(
        BASE, percentile_clipping=50, pclip_history=2))


def case_plain_reference_lamb8(mesh, world, tmp):
    return _plain_reference(mesh, world, "lamb8", BASE)


def case_reduced_grad_plain_sum(mesh, world, tmp):
    """Step 0's reduced gradient of every mode (each rank's own rows of the
    batch, 1 and 2 microbatches, through ``accumulate_grads`` /
    ``finish_grads``, all-gathered whole) against two plain versions:
    every rank's microbatch ``.grad``s all-gathered, summed in rank order
    and divided by W, the microbatches then averaged (bit for bit at
    W = 2); and the whole batch's gradient in one process (W x n
    microbatches; bit for bit at W = 2 with one microbatch)."""
    rank, rows, ok = dist.get_rank(), [], True
    tokens = _batch_tokens(0)
    for n in (1, 2):
        for mode, more in MODES:
            opt = topt.make_optimizer("adamw8", device="cpu", mesh=mesh,
                                      **dict(BASE, **more))
            state, model = TL.init_train_state(
                _cfg(), opt, torch.Generator().manual_seed(0), device="cpu")
            mine = _plain_grads(model, tokens.chunk(world, dim=0)[rank], n)
            buf = opt.init_grad_buffer(state.opt_state)
            for g in mine:
                opt.accumulate_grads(buf, g)
            got = opt._grad_views(opt.finish_grads(buf, n))
            summed = []
            for g in mine:
                per_rank = {}
                for k, v in g.items():
                    parts = [torch.empty_like(v) for _ in range(world)]
                    dist.all_gather(parts, v)
                    per_rank[k] = parts
                summed.append(_mean([{k: ps[r] for k, ps in per_rank.items()}
                                     for r in range(world)], world))
            plain_sum = _mean(summed, n)
            whole = _mean(_plain_grads(model, tokens, world * n), world * n)
            gap_sum, gap_whole = _leaf_gap(got, plain_sum), \
                _leaf_gap(got, whole)
            good = (gap_sum == 0.0 if world == 2 else gap_sum <= GRAD_RTOL) \
                and (gap_whole == 0.0 if world == 2 and n == 1
                     else gap_whole <= GRAD_RTOL) and set(got) == set(whole)
            ok = ok and good
            rows.append(f"n={n} {mode}: {good}, off the rank sum by "
                        f"{gap_sum:.3g}, off the whole batch by "
                        f"{gap_whole:.3g}")
    return ok, "; ".join(rows)


def case_config_guards(mesh, world, tmp):
    """A partition that does not match the group, and ZeRO-2 on a group
    without a partition, raise ConfigError; the shard count comes from the
    mesh."""
    raised = 0
    for kw in (dict(partition=True, partition_shards=world + 1),
               dict(partition=False, shard_grads=True)):
        try:
            topt.make_optimizer("adamw8", device="cpu", mesh=mesh, **kw)
        except ConfigError:
            raised += 1
    opt = topt.make_optimizer("adamw8", device="cpu", mesh=mesh)
    ok = raised == 2 and opt.cfg.partition_shards == world and \
        opt.cfg.partition_active and \
        ML.data_parallel_degree(mesh) == world
    return ok, f"raised {raised}, shards {opt.cfg.partition_shards}"


# tensor parallelism: a (world / 2) x 2 ("data", "model") mesh, the
# parameters placed by the port's rules and the activation constraints on,
# against the same model unsharded in one process (f32 compute): the loss
# to TP_LOSS_RTOL, each gradient to TP_GRAD_TOL of its largest magnitude
# (the sharded products and reductions sum in another order); the serving
# logits of prefill and decode_step, with the caches placed by
# ``cache_shardings``, to TP_LOGIT_TOL of their largest magnitude
TP_LOSS_RTOL = 1e-5
TP_GRAD_TOL = 1e-5
TP_LOGIT_TOL = 1e-5


def _tp_cfgs():
    base = tcb.get_config("paper-lm-209m")
    small = lambda arch, **kw: tcb.reduced(tcb.get_config(arch),
                                           vocab_size=128, **kw)
    return {"paper_lm": _cfg(),
            # 3 heads: the model axis (2) does not divide them
            "heads_3": tcb.reduced(base, d_model=48, n_heads=3,
                                   n_kv_heads=3, head_dim=16, n_layers=2,
                                   vocab_size=128),
            # the MoE's replicated dispatch and combine, experts on "model"
            "mixtral": small("mixtral-8x22b", n_layers=2),
            # the recurrent blocks run batch-local: RG-LRU + local attention
            # (one kv head: the kv groups gathered; a window of 16, so the
            # serving cache is a ring that the prompt wraps), mLSTM, sLSTM
            "recurrentgemma": small("recurrentgemma-9b", n_layers=3,
                                    window=16),
            "xlstm": small("xlstm-350m")}


def _tp_model(mesh, cfg):
    """The reduced model of ``cfg`` from seed 0, its parameters placed by
    the rules on ``mesh`` (as they are when ``mesh`` is None)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models import model as TM
    from repro_torch.sharding import rules as R
    model = TM.init_model(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    if mesh is None:
        return model, None
    spec = R.param_shardings(TM.logical_axes(cfg, model), model.param_dict(),
                             mesh, R.ShardingPolicy())
    for path, p in list(model.param_dict().items()):
        *parents, leaf = path.split("/")
        mod = model
        for name in parents:
            mod = getattr(mod, name)
        setattr(mod, leaf, torch.nn.Parameter(distribute_tensor(
            p.detach(), mesh, R.placements(spec[path], mesh))))
    return model, spec


@contextlib.contextmanager
def _tp_axes(mesh, spec):
    """The activation axes of ``mesh`` set, as the dry run sets them (none
    when ``mesh`` is None)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import constrain as C
    from repro_torch.sharding import rules as R
    if mesh is None:
        yield
        return
    sizes = R.mesh_sizes(mesh)
    C.set_activation_axes(("data",), "model", sizes["data"], sizes["model"])
    C.set_block_param_specs({k[len("blocks/"):]: v for k, v in spec.items()
                             if k.startswith("blocks/")})
    try:
        with implicit_replication():
            yield
    finally:
        C.clear_activation_axes()


def _tp_batch(mesh, t):
    """``t`` (batch first) placed by ``batch_sharding`` on ``mesh``."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.sharding import rules as R
    if mesh is None:
        return t
    return distribute_tensor(t, mesh, R.placements(R.batch_sharding(
        mesh, R.ShardingPolicy(), t.dim(), t.shape[0]), mesh))


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _tp_run(mesh, cfg, tokens, hyper=TL.TrainHyper()):
    """(loss, {path: gradient}) of one forward and backward of ``cfg``
    from seed 0 under ``hyper``: unsharded when ``mesh`` is None, else on
    DTensors placed by the rules on ``mesh`` with the activation axes
    set."""
    model, spec = _tp_model(mesh, cfg)
    with _tp_axes(mesh, spec):
        loss, _ = TL.microbatch_loss(cfg, model, hyper,
                                     _tp_batch(mesh, tokens), None)
        loss.backward()
        return _whole(loss).detach(), {
            k: _whole(p.grad) for k, p in model.param_dict().items()}


def _tp_serve(mesh, cfg, tokens, prompt: int, steps: int):
    """The logits of ``prefill`` over ``tokens[:, :prompt]`` and of
    ``steps`` ``decode_step`` calls teacher-forced on the tokens after it,
    the caches made by ``init_cache`` and placed by ``cache_shardings``
    on ``mesh`` (unsharded when ``mesh`` is None)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.dryrun import _tree_map
    from repro_torch.models import model as TM
    from repro_torch.sharding import rules as R
    model, spec = _tp_model(mesh, cfg)
    max_len = prompt + steps
    caches = TM.init_cache(cfg, tokens.shape[0], max_len, device="cpu")
    if mesh is not None:
        cspec = R.cache_shardings(caches, cfg, mesh, R.ShardingPolicy())
        caches = _tree_map(caches, lambda path, t: distribute_tensor(
            t, mesh, R.placements(cspec[path], mesh)))
    with _tp_axes(mesh, spec):
        logits, caches = TM.prefill(cfg, model,
                                    _tp_batch(mesh, tokens[:, :prompt]),
                                    max_len, caches=caches)
        out = [_whole(logits)]
        for i in range(prompt, max_len):
            logits, caches = TM.decode_step(
                cfg, model, _tp_batch(mesh, tokens[:, i:i + 1]), caches, i)
            out.append(_whole(logits))
    return torch.cat(out, dim=1)


def _gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def case_tensor_parallel_matches_unsharded(mesh, world, tmp):
    """The (world/2, 2) tensor-parallel forward and backward of every
    config of ``_tp_cfgs`` equal the unsharded ones: loss to TP_LOSS_RTOL,
    gradients to TP_GRAD_TOL of each leaf's largest magnitude."""
    tp_mesh = ML.make_mesh((world // 2, 2), ("data", "model"), "cpu")
    tokens = _batch_tokens(0)
    ok, rows = True, []
    for name, cfg in _tp_cfgs().items():
        loss_ref, g_ref = _tp_run(None, cfg, tokens)
        loss_tp, g_tp = _tp_run(tp_mesh, cfg, tokens)
        rel = float(abs(loss_tp - loss_ref) / abs(loss_ref))
        gap = max(_gap(g_tp[k], g_ref[k]) for k in g_ref)
        good = rel <= TP_LOSS_RTOL and gap <= TP_GRAD_TOL \
            and set(g_tp) == set(g_ref)
        ok = ok and good
        rows.append(f"{name}: loss rel {rel:.3g}, grads {gap:.3g} of the "
                    f"largest")
    return ok, "; ".join(rows)


def case_tensor_parallel_label_smoothing_matches_unsharded(mesh, world,
                                                          tmp):
    """With ``label_smoothing`` 0.1 the (world/2, 2) forward and backward
    of the 3-head config of ``_tp_cfgs`` (its vocab of 128 split on
    "model": the loss reduced on the vocab shards) equal the unsharded
    ones at the tolerances of the case above."""
    tp_mesh = ML.make_mesh((world // 2, 2), ("data", "model"), "cpu")
    tokens = _batch_tokens(2)
    cfg = _tp_cfgs()["heads_3"]
    hyper = TL.TrainHyper(label_smoothing=0.1)
    loss_ref, g_ref = _tp_run(None, cfg, tokens, hyper)
    loss_tp, g_tp = _tp_run(tp_mesh, cfg, tokens, hyper)
    rel = float(abs(loss_tp - loss_ref) / abs(loss_ref))
    gap = max(_gap(g_tp[k], g_ref[k]) for k in g_ref)
    ok = rel <= TP_LOSS_RTOL and gap <= TP_GRAD_TOL and set(g_tp) == set(g_ref)
    return ok, f"loss rel {rel:.3g}, grads {gap:.3g} of the largest"


def case_tensor_parallel_serving_matches_unsharded(mesh, world, tmp):
    """On the (world/2, 2) mesh, ``prefill`` of 24 tokens and 4
    ``decode_step`` calls of every config of ``_tp_cfgs`` (the caches
    placed by ``cache_shardings``) give the unsharded logits to
    TP_LOGIT_TOL of their largest magnitude."""
    tp_mesh = ML.make_mesh((world // 2, 2), ("data", "model"), "cpu")
    tokens = _batch_tokens(1)
    ok, rows = True, []
    for name, cfg in _tp_cfgs().items():
        ref = _tp_serve(None, cfg, tokens, 24, 4)
        gap = _gap(_tp_serve(tp_mesh, cfg, tokens, 24, 4), ref)
        ok = ok and gap <= TP_LOGIT_TOL
        rows.append(f"{name}: logits {gap:.3g} of the largest")
    return ok, "; ".join(rows)


def case_contract_collective_order(mesh, world, tmp):
    """The step contracts on the group: one recorded ZeRO-2 adamw8 step
    (2 buckets) must reduce-scatter its gradients, then dispatch the
    span's fused update, then all-gather the masters
    (``train_step.collective_order``), keep its state in place and hold
    no float64 (``analysis.runner``'s recorder sees gloo's collectives as
    the ``c10d`` ops they dispatch)."""
    cell = runner.Cell(f"zero2-world{world}", "adamw8", (8, 8),
                       partition=world, shard_grads=True, overlap_buckets=2,
                       world=world)
    trace = runner.trace_step(cell, device="cpu", cfg=_cfg(),
                              batch=_pipe().batch_at(0), mesh=mesh)
    runner.register_all()
    results = [contracts.evaluate(spec, trace, cell)
               for spec in contracts.contracts_for("step")]
    results = [r for r in results if r is not None]
    names = {r.contract for r in results}
    ok = all(r.ok for r in results) and {
        "train_step.collective_order", "train_step.donates",
        "train_step.no_f64"} <= names
    return ok, "; ".join(str(r) for r in results)


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def _worker(rank, world, store, tmp, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=180))
    mesh = ML.make_mesh((world,), ("data",), "cpu")
    results = {}
    for name, fn in CASES.items():
        t0 = time.perf_counter()
        try:
            ok, detail = fn(mesh, world, tmp)
        except Exception:                 # recorded, the other cases run
            ok, detail = False, traceback.format_exc()
        results[name] = {"ok": bool(ok), "detail": str(detail)[:4000],
                         "s": round(time.perf_counter() - t0, 2)}
    with open(f"{out}.{rank}.tmp", "w") as f:
        json.dump(results, f)
    os.replace(f"{out}.{rank}.tmp", f"{out}.{rank}")
    # every rank's verdicts are on disk: a rank that leaves the group
    # early (gloo closes its pairs) must not turn them into an error
    try:
        dist.barrier()
        dist.destroy_process_group()
    except RuntimeError:
        pass


def _spawn(world: int, tmp: str) -> dict:
    """{case: verdict} of a spawned world: a case passes when it passed on
    every rank."""
    out = os.path.join(tmp, "results.json")
    ctx = mp.start_processes(_worker, args=(world, os.path.join(tmp, "store"),
                                            tmp, out),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + 900
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"gloo world of {world} did not finish")
    ranks = []
    for rank in range(world):
        with open(f"{out}.{rank}") as f:
            ranks.append(json.load(f))
    return {case: {"ok": all(r[case]["ok"] for r in ranks),
                   "detail": " | ".join(f"rank {i}: {r[case]['detail']}"
                                        for i, r in enumerate(ranks)
                                        if not r[case]["ok"])
                   or ranks[0][case]["detail"]}
            for case in ranks[0]}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: {case: verdict}}, one spawned world of each size."""
    out = {}
    for world in WORLDS:
        tmp = tempfile.mkdtemp(dir=tmp_path_factory.mktemp(f"w{world}"))
        out[world] = _spawn(world, tmp)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_group_case(worlds, world, case):
    res = worlds[world][case]
    assert res["ok"], res["detail"]
