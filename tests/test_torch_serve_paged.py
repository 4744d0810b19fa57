"""The port's paged quantized KV serving path (mirrors
tests/test_serve_paged.py) on the CPU, with the JAX package's weights
carried over by ``repro_torch.convert``.

The reference suite's model is gated (``gated_mlp`` defaults to True);
these tests use the same widths with the non-gated MLP and the stable
embedding (the gated, sliding-window and MoE models' paged decode is
``test_torch_models.py``'s and ``test_torch_moe.py``'s).  Locks: prefill and
decode logits agree with the JAX package's; 8-bit paged greedy decode
gives the JAX package's paged tokens and the port's f32 contiguous-cache
oracle's up to a near-tie (the oracle itself held to the JAX oracle's
logits); 4-bit holds the reference's logit-drift bound;
the continuous-batching scheduler is token-exact against the per-request
oracle and eviction cannot change tokens; the page-table bookkeeping
keeps its invariants under random schedules.  The port's scheduler is
held to the per-request oracle, never to the JAX scheduler's output
(ROADMAP C: the reference scheduler uploads aliases of host arrays it
then mutates).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.errors import ConfigError
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve.kvcache import (PageAllocator, PagedKVCache,
                                       PagedKVConfig, kv_bytes_per_token)
from repro_torch.serve.scheduler import (ContinuousBatchingEngine, Request,
                                         SchedulerConfig)
from repro_torch.telemetry import MetricRegistry

WIDTHS = dict(arch_id="t", family="dense", n_layers=2, d_model=32,
              n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=97, head_dim=8,
              compute_dtype="float32", remat="none", attn_chunk=16,
              gated_mlp=False)
CFG = ModelConfig(**WIDTHS)
# f32 throughout; the port's attention is one masked softmax where the JAX
# package's prefill is a chunked online softmax (and its paged decode sums
# in another einsum order): the logits differ by f32 rounding of sums
# over <= 20 positions of O(1) terms, ~1e-6 here; 2e-5 leaves room.
LOGIT_ATOL = 2e-5


@pytest.fixture(scope="module")
def weights():
    params, _ = JM.init_model(JConfig(**WIDTHS), jax.random.PRNGKey(0))
    return params, convert.params_from_numpy(jax.device_get(params), CFG,
                                             device="cpu")


def _oracle_greedy(model, prompt, n_new):
    """f32 contiguous-cache reference: greedy tokens + per-step logits."""
    P = len(prompt)
    logits, cache = M.prefill(CFG, model, torch.tensor([list(prompt)]),
                              max_len=P + n_new)
    toks, rows = [int(logits[0, -1].argmax())], [logits[0, -1]]
    for i in range(n_new - 1):
        lg, cache = M.decode_step(CFG, model, torch.tensor([[toks[-1]]]),
                                  cache, P + i)
        toks.append(int(lg[0, 0].argmax()))
        rows.append(lg[0, 0])
    return np.asarray(toks, np.int32), torch.stack(rows).numpy()


def _paged_greedy(model, prompt, n_new, page_size, kv_bits, scramble=False,
                  teacher_tokens=None, impl="cuda"):
    """Single-slot paged decode: prefill-commit then n_new - 1 paged steps
    (``scramble`` permutes the physical page order; ``teacher_tokens``
    forces the inputs, for the 4-bit drift)."""
    P = len(prompt)
    total = P + n_new
    n_pages = -(-total // page_size) + 2
    table = np.full((1, -(-total // page_size)), -1, np.int32)
    order = np.arange(n_pages, dtype=np.int32)
    if scramble:
        order = np.random.RandomState(7).permutation(n_pages).astype(
            np.int32)
    table[0, :] = order[:table.shape[1]]
    caches = M.init_paged_cache(CFG, 1, n_pages, page_size, kv_bits,
                                device="cpu")
    cfg16 = dataclasses.replace(CFG, kv_cache_bits=16)
    logits, dense = M.prefill(cfg16, model, torch.tensor([list(prompt)]),
                              max_len=P)
    M.commit_prefill_to_paged(CFG, caches, dense, 0,
                              torch.from_numpy(table[0]), P, kv_bits=kv_bits)
    toks, rows = [int(logits[0, -1].argmax())], [logits[0, -1]]
    for i in range(n_new - 1):
        paged = L.PagedContext(torch.from_numpy(table),
                               torch.tensor([P + i], dtype=torch.int32),
                               impl=impl)
        feed = toks[-1] if teacher_tokens is None else \
            int(teacher_tokens[i])
        lg, caches = M.paged_decode_step(CFG, model, torch.tensor([[feed]]),
                                         caches, paged)
        toks.append(int(lg[0, 0].argmax()))
        rows.append(lg[0, 0])
    return np.asarray(toks, np.int32), torch.stack(rows).numpy()


def _prompt(P, page):
    return np.random.RandomState(P * page).randint(
        0, CFG.vocab_size, P).astype(np.int32)


# ---------------------------------------------------- logits vs the JAX side

def test_prefill_and_decode_logits_match_jax(weights):
    params, model = weights
    jcfg = JConfig(**WIDTHS)
    tok = np.random.RandomState(0).randint(0, 97, (2, 20)).astype(np.int32)
    P = 12
    lj, cj = JM.prefill(jcfg, params, jnp.asarray(tok[:, :P]), max_len=20)
    lt, ct = M.prefill(CFG, model, torch.from_numpy(tok[:, :P]), max_len=20)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGIT_ATOL)
    for name in ("k", "v"):          # same layout, leaf by leaf
        np.testing.assert_allclose(ct["scan"]["b0_attn"][name].numpy(),
                                   np.asarray(cj["scan"]["b0_attn"][name]),
                                   rtol=0, atol=LOGIT_ATOL)
    for t in range(P, 20):
        lj, cj = JM.decode_step(jcfg, params, jnp.asarray(tok[:, t:t + 1]),
                                cj, t)
        lt, ct = M.decode_step(CFG, model, torch.from_numpy(tok[:, t:t + 1]),
                               ct, t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=LOGIT_ATOL)


def test_int8_contiguous_cache_matches_jax(weights):
    """``kv_cache_bits=8``: the prefill's codes equal the JAX package's and
    the int8-cache decode logits agree with its."""
    params, model = weights
    jcfg = dataclasses.replace(JConfig(**WIDTHS), kv_cache_bits=8)
    tcfg = dataclasses.replace(CFG, kv_cache_bits=8)
    tok = np.random.RandomState(1).randint(0, 97, (2, 16)).astype(np.int32)
    P = 9
    lj, cj = JM.prefill(jcfg, params, jnp.asarray(tok[:, :P]), max_len=16)
    lt, ct = M.prefill(tcfg, model, torch.from_numpy(tok[:, :P]), max_len=16)
    np.testing.assert_array_equal(ct["scan"]["b0_attn"]["k_codes"].numpy(),
                                  np.asarray(cj["scan"]["b0_attn"]["k_codes"]))
    for t in range(P, 16):
        lj, cj = JM.decode_step(jcfg, params, jnp.asarray(tok[:, t:t + 1]),
                                cj, t)
        lt, ct = M.decode_step(tcfg, model, torch.from_numpy(tok[:, t:t + 1]),
                               ct, t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=LOGIT_ATOL)


def test_paged_decode_matches_jax_paged_decode(weights):
    """One paged decode run in both packages (JAX through its Pallas
    kernel in interpret mode): the committed pages agree after the
    prefill, and the logits at every step."""
    params, model = weights
    jcfg = JConfig(**WIDTHS)
    prompt, n_new, page, bits = _prompt(7, 4), 6, 4, 8
    P = len(prompt)
    n_pages = -(-(P + n_new) // page) + 2
    table = np.random.RandomState(7).permutation(n_pages).astype(
        np.int32)[None, :-(2)]
    jc = JM.init_paged_cache(jcfg, 1, n_pages, page, bits)
    _, dense = JM.prefill(dataclasses.replace(jcfg, kv_cache_bits=16),
                          params, jnp.asarray(prompt[None]), max_len=P)
    jc = JM.commit_prefill_to_paged(jcfg, jc, dense, 0,
                                    jnp.asarray(table[0]), P, kv_bits=bits)
    tc = M.init_paged_cache(CFG, 1, n_pages, page, bits, device="cpu")
    _, tdense = M.prefill(dataclasses.replace(CFG, kv_cache_bits=16), model,
                          torch.from_numpy(prompt[None]), max_len=P)
    M.commit_prefill_to_paged(CFG, tc, tdense, 0, torch.from_numpy(table[0]),
                              P, kv_bits=bits)
    # the rows come from f32 products summed in other orders (XLA's and
    # PyTorch's CPU matmuls), ~1 ULP apart: absmax agrees to rounding and
    # a code may flip only where a normalized value sits within a few ULP
    # of a codebook midpoint — counted and bounded, not toleranced away
    for name in ("k", "v"):
        leaf = lambda c, n: c["scan"]["b0_attn"][f"{name}_{n}"]
        np.testing.assert_allclose(leaf(tc, "absmax").numpy(),
                                   np.asarray(leaf(jc, "absmax")),
                                   rtol=1e-5, atol=0)
        n_bad = int((leaf(tc, "codes").numpy()
                     != np.asarray(leaf(jc, "codes"))).sum())
        assert n_bad <= 2, (name, n_bad)
    feed = prompt[-3:]
    for i, tok in enumerate(feed):
        pos = np.asarray([P + i], np.int32)
        lj, jc = JM.paged_decode_step(
            jcfg, params, jnp.asarray([[tok]], jnp.int32), jc,
            JL.PagedContext(jnp.asarray(table), jnp.asarray(pos),
                            impl="interpret"))
        lt, tc = M.paged_decode_step(
            CFG, model, torch.tensor([[int(tok)]]), tc,
            L.PagedContext(torch.from_numpy(table), torch.from_numpy(pos)))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=LOGIT_ATOL)


# -------------------------------------------------- differential matrix

# the reference's dense rows (arch, page_size, prompt_len, n_new): odd
# prompts, pages from 2 to larger than the prompt, decodes that straddle
# several page boundaries, scrambled physical order everywhere
MATRIX = [
    (2, 5, 9),
    (4, 7, 9),
    (8, 3, 13),
    (16, 7, 6),       # page larger than prompt
]


def _jax_paged_greedy(params, prompt, n_new, page_size, kv_bits):
    """The JAX package's single-slot paged decode on the same scrambled
    table as ``_paged_greedy(scramble=True)`` (its jnp gather)."""
    jcfg = JConfig(**WIDTHS)
    P = len(prompt)
    total = P + n_new
    n_pages = -(-total // page_size) + 2
    order = np.random.RandomState(7).permutation(n_pages).astype(np.int32)
    table = order[None, :-(-total // page_size)]
    caches = JM.init_paged_cache(jcfg, 1, n_pages, page_size, kv_bits)
    logits, dense = JM.prefill(dataclasses.replace(jcfg, kv_cache_bits=16),
                               params, jnp.asarray(prompt[None]), max_len=P)
    caches = JM.commit_prefill_to_paged(jcfg, caches, dense, 0,
                                        jnp.asarray(table[0]), P,
                                        kv_bits=kv_bits)
    toks = [int(np.argmax(np.asarray(logits[0, -1])))]
    for i in range(n_new - 1):
        paged = JL.PagedContext(jnp.asarray(table),
                                jnp.asarray([P + i], np.int32))
        lg, caches = JM.paged_decode_step(
            jcfg, params, jnp.asarray([[toks[-1]]], jnp.int32), caches, paged)
        toks.append(int(np.argmax(np.asarray(lg[0, 0]))))
    return np.asarray(toks, np.int32)


@pytest.mark.parametrize("page,P,n_new", MATRIX)
def test_paged8_greedy_token_exact(weights, page, P, n_new):
    """8-bit paged greedy tokens equal the JAX package's paged tokens on
    the same weights, and the f32 oracle's up to a near-tie: where they
    first differ, the oracle's top-2 logit margin is below the 8-bit
    teacher-forced logit drift.  (The reference's token-exactness against
    the oracle holds for its own gated weights; on these non-gated ones
    row (16, 7, 6) flips at step 1 in the JAX package too: margin 0.0101
    against a drift of 0.0092, ROADMAP C.)"""
    params, model = weights
    prompt = _prompt(P, page)
    exp, rows = _oracle_greedy(model, prompt, n_new)
    got, _ = _paged_greedy(model, prompt, n_new, page, 8, scramble=True)
    np.testing.assert_array_equal(got, _jax_paged_greedy(params, prompt,
                                                         n_new, page, 8))
    diff = np.flatnonzero(got != exp)
    if diff.size:
        _, rows8 = _paged_greedy(model, prompt, n_new, page, 8,
                                 scramble=True, teacher_tokens=exp[:-1])
        drift = np.abs(rows8 - rows).max()
        top2 = np.sort(rows[diff[0]])[-2:]
        assert top2[1] - top2[0] < drift, (diff[0], top2, drift)


@pytest.mark.parametrize("page,P,n_new", MATRIX)
def test_oracle_matches_jax_oracle(weights, page, P, n_new):
    """The port's oracle against the JAX package's, teacher-forced on the
    JAX trajectory: logits within LOGIT_ATOL at every step."""
    params, model = weights
    jcfg = JConfig(**WIDTHS)
    prompt = _prompt(P, page)
    lj, cache = JM.prefill(jcfg, params, jnp.asarray(prompt[None]),
                           max_len=P + n_new)
    rows, toks = [np.asarray(lj[0, -1])], [int(np.argmax(lj[0, -1]))]
    for i in range(n_new - 1):
        lg, cache = JM.decode_step(jcfg, params,
                                   jnp.asarray([[toks[-1]]], jnp.int32),
                                   cache, P + i)
        rows.append(np.asarray(lg[0, 0]))
        toks.append(int(np.argmax(lg[0, 0])))
    got_toks, got_rows = _oracle_greedy(weights[1], prompt, n_new)
    np.testing.assert_array_equal(got_toks, toks)
    np.testing.assert_allclose(got_rows, np.stack(rows), rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("page,P,n_new", MATRIX)
def test_paged4_logit_drift_bounded(weights, page, P, n_new):
    """4-bit KV, teacher-forced on the oracle trajectory: per-step logit
    drift under 0.15 x the logits' spread, and 8-bit under 0.2 x the 4-bit
    drift (the reference's bounds)."""
    _, model = weights
    prompt = _prompt(P, page)
    toks, rows = _oracle_greedy(model, prompt, n_new)
    _, rows4 = _paged_greedy(model, prompt, n_new, page, 4, scramble=True,
                             teacher_tokens=toks[:-1])
    drift = np.abs(rows4 - rows).max()
    spread = rows.max() - rows.min()
    assert drift < 0.15 * spread, (drift, spread)
    _, rows8 = _paged_greedy(model, prompt, n_new, page, 8, scramble=True,
                             teacher_tokens=toks[:-1])
    assert np.abs(rows8 - rows).max() < 0.2 * drift


def test_paged_impls_agree(weights):
    """The kernel route (its plain version on CPU tensors) and the torch
    route give the same tokens and the same logits bit for bit."""
    _, model = weights
    prompt = np.random.RandomState(0).randint(0, 97, 7).astype(np.int32)
    for bits in (8, 4):
        a, ra = _paged_greedy(model, prompt, 8, 4, bits, scramble=True)
        b, rb = _paged_greedy(model, prompt, 8, 4, bits, scramble=True,
                              impl="torch")
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ra, rb)


def test_paged_decode_updates_pool_in_place(weights):
    """A paged decode step writes its pages into the pool it was given:
    no leaf of the cache is reallocated (the counterpart of the JAX
    package's donated cache)."""
    _, model = weights
    caches = M.init_paged_cache(CFG, 2, 6, 4, 8, device="cpu")
    leaves = caches["scan"]["b0_attn"]
    ptrs = {k: t.data_ptr() for k, t in leaves.items()}
    table = torch.tensor([[3, 1], [0, -1]], dtype=torch.int32)
    paged = L.PagedContext(table, torch.tensor([5, -1], dtype=torch.int32))
    _, out = M.paged_decode_step(CFG, model, torch.tensor([[4], [9]]),
                                 caches, paged)
    assert out is caches
    assert {k: t.data_ptr() for k, t in
            out["scan"]["b0_attn"].items()} == ptrs
    # slot 0 wrote position 5 = page 1 (logical 1), offset 1, every layer;
    # the inactive slot 1 wrote nothing
    absmax = leaves["k_absmax"]
    assert bool((absmax[:, 1, 1] > 0).all())
    assert int((absmax != 0).sum()) == absmax.shape[0] * CFG.n_kv_heads


# ------------------------------------------------ engine-level parity

def _reqs(spec, seed=1):
    rng = np.random.RandomState(seed)
    return [Request(rid=i, prompt=tuple(rng.randint(0, 97, p).tolist()),
                    max_new_tokens=n) for i, (p, n) in enumerate(spec)]


SPEC = [(7, 9), (12, 4), (3, 12), (10, 1), (5, 6), (9, 8)]


@pytest.mark.parametrize("kv_bits", [8])
def test_scheduler_greedy_matches_oracle(weights, kv_bits):
    """Mixed-length continuous batching, 8-bit pages: every request's
    greedy completion is token-exact against the f32 oracle."""
    _, model = weights
    reqs = _reqs(SPEC)
    kv = PagedKVConfig(page_size=4, n_pages=24, n_slots=3,
                       max_pages_per_seq=8, kv_bits=kv_bits)
    eng = ContinuousBatchingEngine(CFG, model, SchedulerConfig(kv=kv))
    out = eng.serve(reqs)
    for r in reqs:
        exp, _ = _oracle_greedy(model, r.prompt, r.max_new_tokens)
        np.testing.assert_array_equal(exp, out[r.rid],
                                      err_msg=f"rid {r.rid}")
    eng.kv.check_invariants()
    assert eng.kv.n_active == 0 and eng.kv.alloc.n_free == kv.n_pages


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_scheduler_eviction_is_token_invariant(weights, kv_bits,
                                               temperature):
    """A pool too small for the working set forces LIFO preemption; the
    restart-safe sampling makes the output identical to the big-pool run,
    greedy and sampled."""
    _, model = weights
    reqs = _reqs(SPEC[:3])
    sc = dict(temperature=temperature, seed=5)
    big = ContinuousBatchingEngine(CFG, model, SchedulerConfig(
        kv=PagedKVConfig(page_size=4, n_pages=24, n_slots=3,
                         max_pages_per_seq=8, kv_bits=kv_bits), **sc))
    ref = big.serve(reqs)
    reg = MetricRegistry()
    tight = ContinuousBatchingEngine(CFG, model, SchedulerConfig(
        kv=PagedKVConfig(page_size=4, n_pages=7, n_slots=3,
                         max_pages_per_seq=4, kv_bits=kv_bits), **sc),
        registry=reg)
    out = tight.serve(reqs)
    assert reg.metrics()["serve/sched/evictions"] > 0, \
        "pool was not tight enough to exercise preemption"
    for r in reqs:
        np.testing.assert_array_equal(ref[r.rid], out[r.rid])
        assert len(out[r.rid]) == r.max_new_tokens
    tight.kv.check_invariants()


def test_scheduler_sampling_depends_on_seed(weights):
    _, model = weights
    reqs = _reqs([(6, 12), (4, 12)])
    kv = PagedKVConfig(page_size=4, n_pages=16, n_slots=2,
                       max_pages_per_seq=8)
    run = lambda seed: ContinuousBatchingEngine(CFG, model, SchedulerConfig(
        kv=kv, temperature=1.0, seed=seed)).serve(reqs)
    a, b, a2 = run(1), run(2), run(1)
    assert any(not np.array_equal(a[r.rid], b[r.rid]) for r in reqs)
    for r in reqs:
        np.testing.assert_array_equal(a[r.rid], a2[r.rid])


def test_scheduler_uploads_copies_of_host_bookkeeping(weights,
                                                      monkeypatch):
    """Every page table and position vector a decode step sees is a
    private copy, never a view of the host arrays PagedKVCache keeps
    writing (the reference's fault, ROADMAP C)."""
    _, model = weights
    seen = []
    real = M.paged_decode_step

    def spy(cfg, model_, token, caches, paged):
        seen.append((paged.page_table, paged.positions))
        return real(cfg, model_, token, caches, paged)

    monkeypatch.setattr(M, "paged_decode_step", spy)
    kv = PagedKVConfig(page_size=4, n_pages=24, n_slots=3,
                       max_pages_per_seq=8)
    eng = ContinuousBatchingEngine(CFG, model, SchedulerConfig(kv=kv))
    eng.serve(_reqs(SPEC[:3]))
    assert seen
    for table, pos in seen:
        assert not np.shares_memory(table.numpy(), eng.kv.page_table)
        assert not np.shares_memory(pos.numpy(), eng.kv.positions)


def test_scheduler_rejects_impossible_request(weights):
    _, model = weights
    kv = PagedKVConfig(page_size=4, n_pages=8, n_slots=2,
                       max_pages_per_seq=4)
    eng = ContinuousBatchingEngine(CFG, model, SchedulerConfig(kv=kv))
    with pytest.raises(ConfigError, match="pool caps"):
        eng.serve([Request(rid=0, prompt=tuple(range(20)),
                           max_new_tokens=10)])
    with pytest.raises(ConfigError, match="positive"):
        eng.serve([Request(rid=0, prompt=(1, 2), max_new_tokens=0)])


def test_kv_bytes_per_token_accounting():
    cfg = dataclasses.replace(CFG, head_dim=64, d_model=128, n_heads=2,
                              n_kv_heads=2)
    base = kv_bytes_per_token(cfg, 16)
    assert base == 2 * 2 * 128 * 2      # k+v, 2 kv heads, 2B*64, 2 layers
    assert kv_bytes_per_token(cfg, 8) / base == pytest.approx(68 / 128)
    assert kv_bytes_per_token(cfg, 4) / base == pytest.approx(36 / 128)
    assert kv_bytes_per_token(cfg, 4) / base <= 0.30
    from repro.serve.kvcache import kv_bytes_per_token as jbytes
    for bits in (16, 8, 4):
        assert kv_bytes_per_token(cfg, bits) == jbytes(cfg, bits)


def test_kv_bytes_per_token_paper_lm():
    """Full-width paper-lm-209m: 10 layers, 16 kv heads, head_dim 64."""
    from repro_torch.configs import base
    cfg = base.get_config("paper-lm-209m")
    assert kv_bytes_per_token(cfg, 16) == 40960.0
    assert kv_bytes_per_token(cfg, 8) == 21760.0
    assert kv_bytes_per_token(cfg, 4) == 11520.0


# -------------------------------------- allocator / page-table invariants

def _random_schedule(seed: int, n_ops: int = 120):
    """Drive PagedKVCache through a random admit/extend/advance/release
    schedule, checking the invariants after every transition."""
    rng = np.random.RandomState(seed)
    kvc = PagedKVConfig(page_size=int(rng.choice([2, 4, 8])),
                        n_pages=int(rng.randint(4, 24)),
                        n_slots=int(rng.randint(1, 5)),
                        max_pages_per_seq=int(rng.randint(2, 8)))
    kv = PagedKVCache(kvc)
    next_rid = 0
    live: list = []
    for _ in range(n_ops):
        op = rng.randint(4)
        if op == 0:    # admit
            cap = min(kvc.max_pages_per_seq, kvc.n_pages) * kvc.page_size
            P = int(rng.randint(1, max(2, cap)))
            slot = kv.admit(next_rid, P)
            if slot is not None:
                assert kv.slot_of(next_rid) == slot
                live.append(next_rid)
                next_rid += 1
        elif op == 1 and live:   # advance + lazy extend
            rid = int(rng.choice(live))
            st = kv.slots[kv.slot_of(rid)]
            if st.position + 1 < kvc.max_tokens_per_seq():
                if kv.extend(rid):
                    kv.advance(rid)
        elif op == 2 and live:   # release (completion or eviction)
            rid = live.pop(int(rng.randint(len(live))))
            kv.release(rid)
        elif op == 3 and live:   # double-free must raise, state unchanged
            rid = int(rng.choice(live))
            pages = list(kv.slots[kv.slot_of(rid)].pages)
            kv.release(rid)
            live.remove(rid)
            with pytest.raises(ConfigError, match="double-free"):
                kv.alloc.free(pages)
        kv.check_invariants()
        assert kv.alloc.n_free + kv.alloc.n_allocated == kvc.n_pages
    for rid in live:
        kv.release(rid)
    kv.check_invariants()
    assert kv.alloc.n_free == kvc.n_pages and kv.n_active == 0


@pytest.mark.parametrize("seed", range(8))
def test_page_table_invariants_seeded(seed):
    _random_schedule(seed)


def test_page_table_invariants_hypothesis():
    """Hypothesis variant of the schedule property; a wider seeded sweep
    when hypothesis is not installed (the property still runs)."""
    try:
        from hypothesis import given, settings, strategies as st
    except ImportError:
        for seed in range(8, 40):
            _random_schedule(seed, n_ops=60)
        return

    @settings(max_examples=40, deadline=None)
    @given(seed=st.integers(0, 10_000))
    def prop(seed):
        _random_schedule(seed, n_ops=60)

    prop()


def test_bookkeeping_matches_jax_package():
    """The same random schedule through both packages' PagedKVCache
    leaves identical page tables, positions and free lists."""
    from repro.serve.kvcache import PagedKVCache as JCache
    from repro.serve.kvcache import PagedKVConfig as JKVConfig
    rng = np.random.RandomState(3)
    args = dict(page_size=4, n_pages=12, n_slots=3, max_pages_per_seq=5)
    a, b = PagedKVCache(PagedKVConfig(**args)), JCache(JKVConfig(**args))
    live, rid = [], 0
    for _ in range(80):
        op = rng.randint(3)
        if op == 0:
            P = int(rng.randint(1, 15))
            sa, sb = a.admit(rid, P), b.admit(rid, P)
            assert sa == sb
            if sa is not None:
                live.append(rid)
                rid += 1
        elif op == 1 and live:
            r = int(rng.choice(live))
            if a.slots[a.slot_of(r)].position + 1 < 20:
                ea, eb = a.extend(r), b.extend(r)
                assert ea == eb
                if ea:
                    a.advance(r)
                    b.advance(r)
        elif op == 2 and live:
            r = live.pop(int(rng.randint(len(live))))
            a.release(r)
            b.release(r)
        np.testing.assert_array_equal(a.page_table, b.page_table)
        np.testing.assert_array_equal(a.positions, b.positions)
        assert a.alloc._free == b.alloc._free
        assert a.youngest_rid() == b.youngest_rid()


def test_allocator_edges():
    with pytest.raises(ConfigError):
        PageAllocator(0)
    a = PageAllocator(3)
    assert a.alloc(4) is None and a.n_free == 3    # all-or-nothing
    got = a.alloc(3)
    assert sorted(got) == [0, 1, 2] and a.occupancy == 1.0
    assert a.alloc(1) is None
    with pytest.raises(ConfigError):
        a.free([5])
    a.free(got)
    with pytest.raises(ConfigError, match="double-free"):
        a.free(got)
    with pytest.raises(ConfigError):
        PagedKVConfig(kv_bits=5)
    with pytest.raises(ConfigError):
        PagedKVConfig(n_slots=0)
