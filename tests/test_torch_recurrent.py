"""The recurrent family of the port against the live JAX package, on the
CPU: the checkpointed scan, the RG-LRU, mLSTM and sLSTM blocks, and the
two architectures built from them — recurrentgemma-9b at ``reduced()``
widths with 5 layers (one (rglru, rglru, attn) super-block and 2 remainder
rglru layers) and xlstm-350m at ``reduced()`` widths (one super-block of
7 mLSTM + 1 sLSTM) — from the same weights (``repro_torch.convert``).

Checked: ``checkpointed_scan`` chunked against the plain loop (values and
gradients bit-identical) and against the JAX package's; each block with
state in and out (a prefill, then decode steps) against the JAX block;
sLSTM's step-0 gradients (m starts at -inf) finite; mLSTM's stabilizer
against its one-step recurrence, and the block's memory linear in the
sequence; for each architecture
the parameter tree and leaf order, the forward logits, three adamw8 steps
against JAX's jitted train step, greedy decode through the contiguous and
the paged caches (the recurrent state inserted at the request's slot),
the JAX prefill cache carried into the port (tuple states included); and
on the hybrid the continuous-batching scheduler (two requests in
different slots) and its eviction token-invariance.

Tolerances are ``test_torch_models.py``'s: the scans add T steps of f32
rounding and the port's matmuls and einsums sum in another order than
XLA's, so blocks and logits agree to ``LOGIT_RTOL`` / ``LOGIT_ATOL``
(measured ~1e-6 absolute on O(1) logits here).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.core.optim.base import path_str
from repro.models import recurrent as JR
from repro.models import scan_utils as JS
from repro.models import xlstm as JX
from repro_torch import convert
from repro_torch.configs import base as TB
from repro_torch.core import optim as topt
from repro_torch.models import model as TM
from repro_torch.models import recurrent as TR
from repro_torch.models import scan_utils as TS
from repro_torch.models import xlstm as TX
from repro_torch.serve.kvcache import PagedKVConfig
from repro_torch.serve.scheduler import (ContinuousBatchingEngine, Request,
                                         SchedulerConfig)
from repro_torch.telemetry import MetricRegistry
from test_torch_models import (LOGIT_ATOL, LOGIT_RTOL, arch_setup,
                               check_greedy, check_train, forward_both,
                               greedy_both, inputs, jax_serving, paged_both,
                               port_model, train_both)

# arch -> the reduced() overrides of its test configuration
ARCHS = {"recurrentgemma-9b": dict(n_layers=5), "xlstm-350m": {}}
HYBRID = "recurrentgemma-9b"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the scans are thousands of tiny ops, and with
    several test workers on the machine each op's thread pool
    oversubscribes the cores (xlstm's train test ran 109 s among 6
    workers, 16 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _same_bits(a, b) -> bool:
    """f32 tensors equal bit for bit (-0.0 is not 0.0)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# ------------------------------------------------------------ the scan

def _scan_step(w, lib):
    """A step with a tuple carry, a tuple input and a closure weight, in
    either package (``lib`` is jnp or torch)."""
    def step(carry, x):
        h, c = carry
        a, b = x
        h = lib.tanh(h @ w + a)
        c = 0.9 * c + h * b
        return (h, c), h * c
    return step


def test_checkpointed_scan_matches_plain_and_jax():
    """T 16 in chunks of 4: values and gradients bit-identical to the
    plain loop (chunk > T), values equal to the JAX package's
    ``checkpointed_scan`` at f32 rounding."""
    rng = np.random.RandomState(0)
    W, H0, C0, A, B = (rng.randn(*s).astype(np.float32) * 0.3 for s in
                       ((8, 8), (3, 8), (3, 8), (16, 3, 8), (16, 3, 8)))
    out = {}
    for chunk in (4, 64):
        leaves = [_t(v).requires_grad_() for v in (W, H0, C0, A, B)]
        w, h0, c0, a, b = leaves
        (hT, cT), ys = TS.checkpointed_scan(_scan_step(w, torch), (h0, c0),
                                            (a, b), chunk=chunk)
        (ys.sum() + hT.sum() * 2 + cT.sum()).backward()
        out[chunk] = [ys.detach(), hT.detach(), cT.detach()] + \
            [t.grad for t in leaves]
    assert all(_same_bits(x, y) for x, y in zip(out[4], out[64]))
    (jh, jc), jy = JS.checkpointed_scan(
        _scan_step(jnp.asarray(W), jnp), (jnp.asarray(H0), jnp.asarray(C0)),
        (jnp.asarray(A), jnp.asarray(B)), chunk=4)
    for got, want in zip(out[4][:3], (jy, jh, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------- the blocks

BLOCKS = {
    "rglru": (JR.init_rglru_block, JR.apply_rglru_block, TR,
              TR.apply_rglru_block),
    "mlstm": (JX.init_mlstm_block, JX.apply_mlstm_block, TX,
              TX.apply_mlstm_block),
    "slstm": (JX.init_slstm_block, JX.apply_slstm_block, TX,
              TX.apply_slstm_block),
}


@functools.lru_cache(maxsize=None)
def _block_setup(kind):
    """(JAX cfg, JAX params, the port's copy, the JAX apply jitted)."""
    arch = HYBRID if kind == "rglru" else "xlstm-350m"
    cfg = JB.reduced(JB.get_config(arch))
    p, _ = BLOCKS[kind][0](jax.random.PRNGKey(3), cfg)
    apply = jax.jit(lambda p, x, s: BLOCKS[kind][1](p, x, cfg, state=s))
    return cfg, p, {k: _t(v) for k, v in jax.device_get(p).items()}, apply


def _close(got, want):
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


@pytest.mark.parametrize("kind", BLOCKS)
def test_block_state_in_and_out_matches_jax(kind):
    """A prefill of 9 positions from no state, then 3 one-position steps
    with the state carried: every output and state against the JAX
    block's."""
    cfg, jp, tp, japply = _block_setup(kind)
    tapply = BLOCKS[kind][3]
    x = np.random.RandomState(1).randn(2, 12, cfg.d_model).astype(
        np.float32)
    jo, js = japply(jp, jnp.asarray(x[:, :9]), None)
    to, ts = tapply(tp, _t(x[:, :9]), cfg)
    _close(to.detach(), jo)
    _close(jax.tree_util.tree_map(lambda t: t.detach().numpy(), ts), js)
    for i in range(9, 12):
        jo, js = japply(jp, jnp.asarray(x[:, i:i + 1]), js)
        with torch.no_grad():
            to, ts = tapply(tp, _t(x[:, i:i + 1]), cfg, state=ts)
        _close(to, jo)
        _close(jax.tree_util.tree_map(lambda t: t.numpy(), ts), js)


@pytest.mark.parametrize("kind", BLOCKS)
def test_block_chunked_scan_bit_identical(kind, monkeypatch):
    """The block's forward and its parameter gradients through the
    chunked scan (16 positions in chunks of 4) equal the plain loop's
    bit for bit."""
    cfg, _, tp, _ = _block_setup(kind)
    mod, tapply = BLOCKS[kind][2:]
    x = _t(np.random.RandomState(2).randn(2, 16, cfg.d_model)
           .astype(np.float32))
    out = []
    for chunk in (64, 4):
        monkeypatch.setattr(mod, "checkpointed_scan", functools.partial(
            TS.checkpointed_scan, chunk=chunk))
        p = {k: v.clone().requires_grad_() for k, v in tp.items()}
        y, st = tapply(p, x, cfg)
        (y.square().sum() + sum(t.sum() for t in
                                jax.tree_util.tree_leaves(st))).backward()
        out.append([y.detach()] + [p[k].grad for k in sorted(p)])
    assert all(_same_bits(a, b) for a, b in zip(*out))


def test_slstm_step0_gradients_finite():
    """sLSTM's stabilizer starts at -inf: the gradients of the first
    steps, to the input and every parameter, are finite."""
    cfg, _, tp, _ = _block_setup("slstm")
    for S in (1, 3):
        p = {k: v.clone().requires_grad_() for k, v in tp.items()}
        x = _t(np.random.RandomState(S).randn(2, S, cfg.d_model)
               .astype(np.float32)).requires_grad_()
        y, (c, n, h, m) = TX.apply_slstm_block(p, x, cfg)
        (y.sum() + c.sum() + n.sum() + h.sum() + m.sum()).backward()
        assert torch.isfinite(x.grad).all()
        for k, v in p.items():
            assert torch.isfinite(v.grad).all(), (S, k)


def _recurrence_m(log_i, log_f, m0):
    """mLSTM's stabilizer as the JAX package's scan carries it, one step
    at a time: m_t = max(log_f_t + m_{t-1}, log_i_t)."""
    m, out = m0, []
    for li, lf in zip(log_i, log_f):
        m = torch.maximum(lf + m, li)
        out.append(m)
    return torch.stack(out)


def test_mlstm_stabilizer_matches_recurrence():
    """The stabilizer of every step at once equals the one-step recurrence
    (values and gradients, to rounding: the cumulative sum adds in another
    order); its running max equals ``torch.cummax``'s values bit for bit
    and its gradient, summed in a fixed order, equals ``cummax``'s
    scatter-add gradient to rounding, ties included."""
    rng = np.random.RandomState(4)
    T, B, H = 37, 2, 3
    li = _t(rng.randn(T, B, H).astype(np.float32) - 1)
    lf = _t(-np.abs(rng.randn(T, B, H)).astype(np.float32) * 0.1)
    m0 = _t(rng.randn(B, H).astype(np.float32))
    w = _t(rng.randn(T, B, H).astype(np.float32))
    grads = []
    for fn in (TX._stabilizer, _recurrence_m):
        a, b = li.clone().requires_grad_(), lf.clone().requires_grad_()
        m = fn(a, b, m0)
        (m * w).sum().backward()
        grads.append((m.detach(), a.grad, b.grad))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    # ties: steps 5-19 repeat one value, so the argmax runs are long
    g = _t(np.where(np.arange(T)[:, None, None] % 15 < 10, 0.5,
                    rng.randn(T, B, H)).astype(np.float32))
    out = []
    for fn in (TX._RunningMax.apply, lambda x: torch.cummax(x, 0).values):
        x = g.clone().requires_grad_()
        y = fn(x)
        (y * w).sum().backward()
        out.append((y.detach(), x.grad))
    assert _same_bits(out[0][0], out[1][0])
    np.testing.assert_allclose(out[0][1].numpy(), out[1][1].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_mlstm_block_memory_linear_in_time():
    """No tensor of the mLSTM block's forward or backward grows with the
    square of the sequence: at T 256 (4 chunks of the scan) every op's
    output holds at most 2 x B x T x W elements (a (T, T, B, H) tensor
    would hold 4x that)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Largest(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.numel, self.ops = 0, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.numel = max(self.numel, t.numel())
            self.ops += 1
            return out

    cfg, _, tp, _ = _block_setup("mlstm")
    T, W = 256, tp["w_up"].shape[1]
    p = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = _t(np.random.RandomState(5).randn(1, T, cfg.d_model)
           .astype(np.float32))
    with Largest() as mode:
        y, _ = TX.apply_mlstm_block(p, x, cfg)
        forward_ops = mode.ops
        y.square().sum().backward()
    assert mode.ops > 2 * forward_ops        # the backward was recorded
    assert all(torch.isfinite(v.grad).all() for v in p.values())
    assert mode.numel <= 2 * T * W, mode.numel


# ------------------------------------------------------ the architectures

def test_registry_has_the_recurrent_configs():
    for arch in ARCHS:
        assert dataclasses.asdict(TB.get_config(arch)) == \
            dataclasses.asdict(JB.get_config(arch))
    cut = dataclasses.replace(TB.get_config(HYBRID), n_layers=5)
    assert (cut.n_superblocks, cut.n_remainder_layers) == (1, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    """Names, shapes, dtypes and leaf order of the JAX tree (the remainder
    layers keyed by their kind), for the port's own init and for the
    carried weights."""
    jcfg, tcfg, params, _ = arch_setup(arch, **ARCHS[arch])
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    want = [path_str(p) for p, _ in flat]
    model = TM.init_model(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    got = model.param_dict()
    assert topt.blockopt.leaf_order(got) == want
    assert topt.blockopt.leaf_order(
        port_model(arch, **ARCHS[arch]).param_dict()) == want
    for p, leaf in flat:
        assert tuple(got[path_str(p)].shape) == leaf.shape, path_str(p)
        assert torch.isfinite(got[path_str(p)]).all()
    if arch == HYBRID:
        assert "rem_blocks/1/rglru/rec/lam" in got


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg = arch_setup(arch, **ARCHS[arch])[0]
    tok, emb = inputs(jcfg, 2, 12, 1)
    lj, mj, lt, mt = forward_both(arch, tok, emb, **ARCHS[arch])
    assert lt.shape == lj.shape == (2, 12, jcfg.vocab_size)
    np.testing.assert_allclose(lt, lj, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    assert mt == mj == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    check_train(*train_both(arch, **ARCHS[arch]))


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_jax(arch):
    check_greedy(greedy_both(arch, **ARCHS[arch]))


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_matches_jax(arch):
    """Three requests in three slots: each slot's recurrent state comes
    from its own prefill, inserted at its slot."""
    cfg = arch_setup(arch, **ARCHS[arch])[0]
    prompts = [np.random.RandomState(s).randint(0, cfg.vocab_size, P)
               .astype(np.int32) for s, P in ((1, 9), (2, 14), (3, 5))]
    check_greedy(paged_both(arch, prompts, n_new=5, **ARCHS[arch]))


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_prefill_cache_carries_into_port(arch):
    """The JAX prefill's cache (the recurrent tuples and dicts, and the
    attn rows) equals the port's leaf for leaf, and the port's decode
    step from the carried cache gives the JAX decode step's logits."""
    jcfg, tcfg, params, _ = arch_setup(arch, **ARCHS[arch])
    model = port_model(arch, **ARCHS[arch])
    tok, _ = inputs(jcfg, 2, 10, 4)
    js = jax_serving(jcfg)
    _, cj = js["prefill"](params, jnp.asarray(tok), 12, None)
    _, ct = TM.prefill(tcfg, model, _t(tok), 12)
    carried = convert.cache_from_numpy(jax.device_get(cj), device="cpu")
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, carried)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, ct))
    _close(jax.tree_util.tree_map(lambda t: t.numpy(), ct), cj)
    nxt = np.array([[3], [5]], np.int32)
    lj, _ = js["decode"](params, jnp.asarray(nxt), cj, jnp.int32(10))
    lt, _ = TM.decode_step(tcfg, model, _t(nxt), carried, 10)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)


# ------------------------------------------------- the hybrid's scheduler

def _hybrid():
    return arch_setup(HYBRID, **ARCHS[HYBRID])[1], \
        port_model(HYBRID, **ARCHS[HYBRID])


def _oracle(cfg, model, prompt, n_new):
    """Greedy tokens of one request through the contiguous f32 cache."""
    P = len(prompt)
    logits, cache = TM.prefill(cfg, model, torch.tensor([list(prompt)]),
                               max_len=P + n_new)
    toks = [int(logits[0, -1].argmax())]
    for i in range(n_new - 1):
        lg, cache = TM.decode_step(cfg, model, torch.tensor([[toks[-1]]]),
                                   cache, P + i)
        toks.append(int(lg[0, 0].argmax()))
    return np.asarray(toks, np.int32)


def _reqs(vocab, spec):
    rng = np.random.RandomState(11)
    return [Request(rid=i, prompt=tuple(rng.randint(0, vocab, P).tolist()),
                    max_new_tokens=n) for i, (P, n) in enumerate(spec)]


def test_hybrid_scheduler_two_slots_match_oracle():
    """Two requests admitted into two slots (the second joins mid-stream
    while the first decodes): each one's greedy tokens equal its own
    contiguous-cache run, so no slot's recurrent state leaks into
    another's."""
    cfg, model = _hybrid()
    reqs = _reqs(cfg.vocab_size, ((7, 9), (13, 6), (4, 5)))
    eng = ContinuousBatchingEngine(cfg, model, SchedulerConfig(
        kv=PagedKVConfig(page_size=4, n_pages=24, n_slots=2,
                         max_pages_per_seq=8, kv_bits=8), impl="torch"))
    out = eng.serve(reqs)
    for r in reqs:
        np.testing.assert_array_equal(
            out[r.rid], _oracle(cfg, model, r.prompt, r.max_new_tokens),
            err_msg=f"rid {r.rid}")
    eng.kv.check_invariants()


def test_hybrid_eviction_is_token_invariant():
    """A pool too small for the working set preempts (LIFO); a preempted
    request is prefilled again into a slot whose recurrent state the other
    requests advanced meanwhile, and its tokens equal the big pool's."""
    cfg, model = _hybrid()
    reqs = _reqs(cfg.vocab_size, ((7, 9), (13, 6), (4, 8)))
    kw = dict(temperature=0.8, seed=5, impl="torch")
    ref = ContinuousBatchingEngine(cfg, model, SchedulerConfig(
        kv=PagedKVConfig(page_size=4, n_pages=24, n_slots=3,
                         max_pages_per_seq=8, kv_bits=8), **kw)).serve(reqs)
    reg = MetricRegistry()
    out = ContinuousBatchingEngine(cfg, model, SchedulerConfig(
        kv=PagedKVConfig(page_size=4, n_pages=7, n_slots=3,
                         max_pages_per_seq=6, kv_bits=8), **kw),
        registry=reg).serve(reqs)
    assert reg.metrics()["serve/sched/evictions"] > 0
    for r in reqs:
        np.testing.assert_array_equal(ref[r.rid], out[r.rid])
