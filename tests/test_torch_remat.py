"""Activation remat in the port (``cfg.remat``, ``cfg.attn_chunk``), on the
CPU:

  * the chunked online-softmax attention (``layers.causal_attention``)
    against the JAX package's ``_chunked_causal_attention`` on the same
    numpy inputs (B 2, H 4, KV 2, D 8, S 40), values and gradients (against
    ``jax.vjp``), at chunk 16 (the keys padded; the online softmax) and
    64 (one chunk: the port's softmax, the same function), window
    0 and 12 (late rows meet chunks that are wholly masked: the ``-inf``
    guards); and its rows from a query-row split (``q_offset``) against the
    same rows of the whole call;
  * remat "none", "full" and "dots" give bit-identical logits, metrics and
    parameter gradients on reduced paper-lm-209m (scanned), mixtral-8x22b
    (MoE) and xlstm-350m at S 128 (past its scan's chunk of 64: the scan's
    checkpoints nested in the super-block's);
  * the peak of live bytes of one forward and backward, counted by
    ``DeviceCounter`` on fake tensors at 4 layers and S = 4 x attn_chunk,
    orders full < dots < none, and the chunked attention's peak is below
    the whole softmax's (one chunk of S keys); its breakdown by allocating
    op sums to the peak above the arguments, the logits its largest entry
    at a wide vocab;
  * "dots" recomputes no ``aten.mm`` in the backward; "full" recomputes
    every 2-D product of the super-blocks (with the checkpoint's early
    stop off; with it on, the default, the last product of each
    super-block, whose output the backward does not read, is skipped, as
    XLA drops it from a ``jax.checkpoint``).

Tolerance of the attention: rtol 1e-5, atol 1e-6.  Measured here: values
within 3.6e-7 and gradients within 1.5e-6 absolute of the JAX package's
(O(1) numbers: the two sum the same f32 terms in other orders), at most
0.40 of the allowance (|a - b| / (atol + rtol |b|)).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro.models import layers as JLy
from repro_torch.configs import base as TB
from repro_torch.models import layers as TLy
from repro_torch.models import model as TM
from repro_torch.roofline.analysis import DeviceCounter

RTOL, ATOL = 1e-5, 1e-6
B, H, KV, D, S = 2, 4, 2, 8, 40
MODES = ("none", "full", "dots")
# arch -> (reduced() overrides, sequence length)
EXACT = {"paper-lm-209m": ({}, 48), "mixtral-8x22b": ({}, 48),
         "xlstm-350m": ({}, 128)}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these models' ops are small (xlstm's scans
    most), where more threads cost time and contend with the other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkvg(seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, S, n, D).astype(np.float32)
                 for n in (H, KV, KV, H))


@pytest.mark.parametrize("window", [0, 12])
@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_attention_matches_jax(chunk, window):
    q, k, v, g = _qkvg()
    out_j, vjp = jax.vjp(
        lambda q, k, v: JLy._chunked_causal_attention(
            q, k, v, window=window, chunk=chunk),
        *(jnp.asarray(a) for a in (q, k, v)))
    grads_j = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out_t = TLy.causal_attention(tq, tk, tv, window=window, chunk=chunk)
    out_t.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)
    for name, t, want in zip("qkv", (tq, tk, tv), grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("window", [0, 12])
def test_chunked_attention_query_rows(window):
    """A query-row split's rows (``q_offset``) against every key equal the
    same rows of the whole call."""
    q, k, v, _ = (torch.from_numpy(a) for a in _qkvg(1))
    whole = TLy.causal_attention(q, k, v, window=window, chunk=16)
    for lo, hi in ((0, 13), (13, 29), (29, S)):
        part = TLy.causal_attention(q[:, lo:hi], k, v, window=window,
                                    q_offset=lo, chunk=16)
        np.testing.assert_allclose(part.numpy(), whole[:, lo:hi].numpy(),
                                   rtol=RTOL, atol=ATOL)


def _grads(cfg, tokens):
    """(logits, metrics, {name: grad}) of one forward and backward."""
    model = TM.init_model(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    logits, mt = model(tokens)
    loss = logits.float().logsumexp(-1).mean() + sum(mt.values(), 0.0)
    loss.backward()
    return (logits.detach(), {k: v.detach() for k, v in mt.items()},
            {k: p.grad for k, p in model.named_parameters()})


@pytest.mark.parametrize("arch", list(EXACT))
def test_remat_modes_bit_identical(arch):
    overrides, seq = EXACT[arch]
    cfg = TB.reduced(TB.get_config(arch), **overrides)
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, seq)))
    runs = {m: _grads(dataclasses.replace(cfg, remat=m), tokens)
            for m in MODES}
    ref_logits, ref_mt, ref_g = runs["none"]
    if cfg.is_moe:
        assert "moe_drop_frac" in ref_mt
    for mode in ("full", "dots"):
        logits, mt, g = runs[mode]
        assert torch.equal(logits, ref_logits), mode
        assert mt.keys() == ref_mt.keys()
        for k in mt:
            assert torch.equal(mt[k], ref_mt[k]), (mode, k)
        assert g.keys() == ref_g.keys()
        for k in g:
            assert torch.equal(g[k], ref_g[k]), (mode, k)


def _peak_bytes(cfg, seq, batch=2) -> int:
    """Peak live bytes above the parameters of one forward and backward,
    on fake tensors."""
    counter = DeviceCounter()
    with FakeTensorMode(), counter:
        with counter.arguments():
            model = TM.Model(cfg, device="cpu")
            tokens = torch.zeros((batch, seq), dtype=torch.long)
        logits, _ = model(tokens)
        logits.float().mean().backward()
    return counter.peak_bytes - counter.tracked_bytes


def test_remat_lowers_peak_bytes():
    # a chunk of 64 keys: at reduced()'s 32 the four chunks' saved carries
    # (each S x (head_dim + 2) f32 a head) outweigh one chunk of S x S
    # scores at head_dim 16
    cfg = TB.reduced(TB.get_config("paper-lm-209m"), n_layers=4,
                     attn_chunk=64)
    seq = 4 * cfg.attn_chunk
    peak = {m: _peak_bytes(dataclasses.replace(cfg, remat=m), seq)
            for m in MODES}
    assert peak["full"] < peak["dots"] < peak["none"], peak
    whole = _peak_bytes(dataclasses.replace(cfg, attn_chunk=seq), seq)
    assert peak["none"] < whole, (peak, whole)


def test_peak_breakdown_sums_to_the_peak():
    """``DeviceCounter.peak_by_op``: what was live at the peak above the
    arguments, by allocating op, sums to the peak less the arguments; at a
    vocab far wider than the model the largest entry is logits-shaped."""
    cfg = TB.reduced(TB.get_config("paper-lm-209m"), vocab_size=4096)
    counter = DeviceCounter()
    with FakeTensorMode(), counter:
        with counter.arguments():
            model = TM.Model(cfg, device="cpu")
            tokens = torch.zeros((2, 64), dtype=torch.long)
        logits, _ = model(tokens)
        logits.float().mean().backward()
    assert sum(counter.peak_by_op.values()) == \
        counter.peak_bytes - counter.tracked_bytes > 0
    rows = counter.peak_breakdown(top=3)
    assert [r[0] for r in rows] == sorted((r[0] for r in rows), reverse=True)
    b, op, shape, dtype = rows[0]
    assert math.prod(shape) == 2 * 64 * 4096 and dtype == "float32", rows
    assert b == 4 * math.prod(shape)


class _CountMM(TorchDispatchMode):
    """Counts the 2-D products dispatched under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _mm_counts(cfg, tokens) -> tuple:
    """(2-D products of the forward, of the backward)."""
    model = TM.init_model(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    with _CountMM() as fwd:
        logits, _ = model(tokens)
        loss = logits.float().mean()
    with _CountMM() as bwd:
        loss.backward()
    return fwd.n, bwd.n


def test_dots_recomputes_no_products():
    n_layers = 4
    cfg = TB.reduced(TB.get_config("paper-lm-209m"), n_layers=n_layers)
    tokens = torch.zeros((2, 2 * cfg.attn_chunk), dtype=torch.long)
    counts = {m: _mm_counts(dataclasses.replace(cfg, remat=m), tokens)
              for m in MODES}
    fwd, bwd = counts["none"]
    blocks = fwd - 1                   # all but the head's product
    assert blocks % n_layers == 0 and blocks > 0
    assert counts["dots"] == (fwd, bwd)
    assert counts["full"] == (fwd, bwd + blocks - n_layers)
    with set_checkpoint_early_stop(False):
        full = _mm_counts(dataclasses.replace(cfg, remat="full"), tokens)
    assert full == (fwd, bwd + blocks)
