"""The MoE architectures (mixtral-8x22b, kimi-k2-1t-a32b) and the
sliding window of the port against the live JAX package, at ``reduced()``
widths (d_model 64, 2 layers, 4 experts top-2, window 32, f32), from the
same weights (``repro_torch.convert``).

Checked: the forward logits and the MoE metrics (aux loss, z-loss, drop
fraction); three adamw8 steps with the aux and z losses in the loss;
greedy decode through the contiguous cache (a ring of ``window`` rows) and
through the paged cache (the window term of its mask) with prompts longer
than the window; and a dispatch whose capacity drops tokens, at training
shapes and at decode, where T is the slot count, so the drop order (a
stable sort by expert) matters.  Tolerances as ``test_torch_models.py``
states them; the drop fraction is a count and equals the JAX value
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMoE
from repro_torch.models import moe as TMoE
from test_torch_models import (LOGIT_ATOL, LOGIT_RTOL, arch_setup,
                               check_greedy, check_train, forward_both,
                               greedy_both, inputs, paged_both, train_both)

MOE = ("mixtral-8x22b", "kimi-k2-1t-a32b")
DROP = dict(capacity_factor=0.5)       # capacity below the mean load


def _metrics_close(mt, mj):
    assert set(mt) == set(mj) == {"moe_aux_loss", "moe_z_loss",
                                  "moe_drop_frac"}
    for k in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(mt[k], mj[k], rtol=1e-5, err_msg=k)
    assert mt["moe_drop_frac"] == mj["moe_drop_frac"]


@pytest.mark.parametrize("arch", MOE)
def test_forward_and_metrics_match_jax(arch):
    jcfg = arch_setup(arch)[0]
    tok, emb = inputs(jcfg, 2, 12, 1)
    lj, mj, lt, mt = forward_both(arch, tok, emb)
    np.testing.assert_allclose(lt, lj, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    _metrics_close(mt, mj)


@pytest.mark.parametrize("arch", MOE)
def test_train_steps_match_jax(arch):
    jm, tm, js, ts = train_both(arch)
    check_train(jm, tm, js, ts)
    for m_t, m_j in zip(tm, jm):
        _metrics_close({k: v for k, v in m_t.items() if k.startswith("moe_")},
                       {k: v for k, v in m_j.items() if k.startswith("moe_")})
    # the aux and z losses are in the loss the step differentiates
    assert tm[0]["loss"] > tm[0]["ce_loss"]


def test_dispatch_drops_as_jax():
    """A capacity below the load drops tokens: the same ones (the stable
    sort by expert), so the output and the drop fraction equal JAX's."""
    jcfg = arch_setup("mixtral-8x22b", **DROP)[0]
    _, _, _, host = arch_setup("mixtral-8x22b", **DROP)
    p = {k: v[0] for k, v in host["blocks"]["b0_attn"]["moe"].items()}
    x = np.random.RandomState(5).randn(3, 16, jcfg.d_model).astype(
        np.float32)
    oj, mj = JMoE.apply_moe({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), jcfg)
    ot, mt = TMoE.apply_moe({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), jcfg)
    assert float(mj["moe_drop_frac"]) > 0
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)
    _metrics_close({k: float(v) for k, v in mt.items()},
                   {k: float(v) for k, v in mj.items()})


def test_forward_with_drops_matches_jax():
    jcfg = arch_setup("mixtral-8x22b", **DROP)[0]
    tok, _ = inputs(jcfg, 2, 24, 2)
    lj, mj, lt, mt = forward_both("mixtral-8x22b", tok, None, **DROP)
    assert mj["moe_drop_frac"] > 0
    np.testing.assert_allclose(lt, lj, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    _metrics_close(mt, mj)


@pytest.mark.parametrize("arch", MOE)
def test_greedy_decode_matches_jax(arch):
    check_greedy(greedy_both(arch))


def test_sliding_window_ring_matches_jax():
    """window 32, prompt 40: the prefill keeps the last 32 rows in a ring
    and the decode steps wrap it; logits and greedy tokens as JAX's."""
    jcfg = arch_setup("mixtral-8x22b")[0]
    assert jcfg.attn_type == "swa" and jcfg.window == 32
    check_greedy(greedy_both("mixtral-8x22b", P=40, n_new=8))


def test_paged_window_and_decode_drops_match_jax():
    """Paged decode over 4 slots (prompts 40, 35, 9 and 33 > the window
    of 32 but one) with a capacity that drops tokens at decode (T = 4
    slots): the window term of the paged mask and the drop order."""
    cfg = arch_setup("mixtral-8x22b", **DROP)[0]
    prompts = [np.random.RandomState(s).randint(0, cfg.vocab_size, P)
               .astype(np.int32) for s, P in ((1, 40), (2, 35), (3, 9),
                                               (4, 33))]
    check_greedy(paged_both("mixtral-8x22b", prompts, n_new=6, **DROP))


@pytest.mark.parametrize("arch", MOE)
def test_paged_decode_matches_jax(arch):
    cfg = arch_setup(arch)[0]
    prompts = [np.random.RandomState(s).randint(0, cfg.vocab_size, P)
               .astype(np.int32) for s, P in ((1, 9), (2, 14))]
    check_greedy(paged_both(arch, prompts, n_new=5))
