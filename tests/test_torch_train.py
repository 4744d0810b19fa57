"""The slice end to end on the CPU: the reduced paper LM (d_model 64, 2
layers, vocab 128, seq 32, batch 8, as ``helpers.tiny_cfg``) trained by
both packages from the same weights (carried over with
``repro_torch.convert``) on the same ``SyntheticLMPipeline`` batches.  Loss
traces are held to a live JAX run at the golden tests' rtol=2e-4 — never to
``tests/golden/*.json``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg, tiny_pipe
from repro.core import optim as jopt
from repro.models import model as jm
from repro.train import loop as JL
from repro_torch import convert
from repro_torch.configs import base as tcb
from repro_torch.core import optim as topt
from repro_torch.data import pipeline as tpl
from repro_torch.errors import FormatError
from repro_torch.models import model as tm
from repro_torch.train import loop as TL

STEPS = 10


def _tcfg():
    return tcb.reduced(tcb.get_config("paper-lm-209m"), d_model=64,
                       n_layers=2, vocab_size=128)


def _jax_weights(cfg):
    params, _ = jm.init_model(cfg, jax.random.PRNGKey(0))
    return params, jax.device_get(params)


def test_configs_match_jax():
    from repro.configs import base as jcb
    for arch in ("paper-lm-209m", "paper-lm-1.5b"):
        assert tcb.get_config(arch).__dict__ == jcb.get_config(arch).__dict__
    assert _tcfg().__dict__ == tiny_cfg().__dict__


def test_pipeline_matches_jax():
    tp = tpl.SyntheticLMPipeline(tpl.DataConfig(vocab_size=128, seq_len=32,
                                                global_batch=8))
    jp = tiny_pipe()
    for i in (0, 1, 7):
        np.testing.assert_array_equal(tp.batch_at(i)["tokens"],
                                      jp.batch_at(i)["tokens"])
    assert tp.bigram_entropy() == jp.bigram_entropy()


def test_forward_matches_jax():
    jcfg = tiny_cfg()
    params, host = _jax_weights(jcfg)
    model = convert.params_from_numpy(host, _tcfg(), device="cpu")
    tokens = tiny_pipe().batch_at(0)["tokens"][:, :-1]
    lj, _ = jm.forward(jcfg, params, jnp.asarray(tokens))
    with torch.no_grad():
        lt, _ = tm.forward(model.cfg, model, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-5)
    labels = tiny_pipe().batch_at(0)["tokens"][:, 1:]
    np.testing.assert_allclose(
        float(TL.cross_entropy(lt, torch.from_numpy(labels))),
        float(JL.cross_entropy(lj, jnp.asarray(labels))), rtol=1e-6)


def test_convert_rejects_mismatched_trees():
    _, host = _jax_weights(tiny_cfg())
    bad = dict(host, head={"w": np.zeros((64, 127), np.float32)})
    with pytest.raises(FormatError):
        convert.params_from_numpy(bad, _tcfg(), device="cpu")
    del bad["head"]
    with pytest.raises(FormatError):
        convert.params_from_numpy(bad, _tcfg(), device="cpu")


@pytest.mark.parametrize("name", ["adamw8", "adamw32"])
def test_loss_trace_matches_live_jax(name):
    jcfg, pipe = tiny_cfg(), tiny_pipe()
    jo = jopt.make_optimizer(name, pooled=False, weight_decay=0.01)
    state, _ = JL.init_train_state(jcfg, jo, jax.random.PRNGKey(0))
    step = JL.jit_train_step(jcfg, jo)
    jloss = []
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}
        state, m = step(state, batch)
        jloss.append(float(m["loss"]))

    _, host = _jax_weights(jcfg)            # the weights JAX started from
    model = convert.params_from_numpy(host, _tcfg(), device="cpu")
    to = topt.make_optimizer(name, weight_decay=0.01, pooled=False,
                             device="cpu")
    ts = TL.TrainState(to.init(model.param_dict()), 0)
    tstep = TL.make_train_step(model.cfg, model, to)
    tloss = []
    for i in range(STEPS):
        ts, tm_ = tstep(ts, pipe.batch_at(i))
        tloss.append(float(tm_["loss"]))
    np.testing.assert_allclose(tloss, jloss, rtol=2e-4)
    assert tloss[-1] < tloss[0]
    assert tm_["opt_fused_dispatches"] == float(m["opt_fused_dispatches"])
    assert tm_["state_bytes_per_param"] == pytest.approx(
        float(m["state_bytes_per_param"]), rel=1e-6)
    np.testing.assert_allclose(float(tm_["grad_norm"]),
                               float(m["grad_norm"]), rtol=2e-4)


def test_microbatches_and_schedule():
    """Two microbatches average to the full-batch gradient; the schedule
    matches the JAX one."""
    cfg = _tcfg()
    batch = tiny_pipe().batch_at(0)
    grads = []
    for n in (1, 2):
        to = topt.make_optimizer("adamw32", device="cpu")
        state, model = TL.init_train_state(
            cfg, to, torch.Generator().manual_seed(0), device="cpu")
        TL.make_train_step(cfg, model, to, TL.TrainHyper(
            microbatches=n, grad_clip=1e9))(state, batch)
        grads.append({k: p.grad.clone() for k, p in
                      model.param_dict().items()})
    for k in grads[0]:
        np.testing.assert_allclose(grads[1][k].numpy(), grads[0][k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    js, ts = JL.warmup_cosine(1e-3, 3, 10), TL.warmup_cosine(1e-3, 3, 10)
    for i in range(12):
        np.testing.assert_allclose(float(ts(i)), float(js(jnp.int32(i))),
                                   rtol=1e-6)


def test_global_norm_clip():
    rng = np.random.RandomState(0)
    tree = {k: rng.randn(5, 7).astype(np.float32) for k in "abc"}
    jt, jn = JL.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in tree.items()}, 0.5)
    tt, tn = TL.clip_by_global_norm(
        {k: torch.from_numpy(v.copy()) for k, v in tree.items()}, 0.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("norm_type", ["layernorm", "rmsnorm"])
def test_norm_and_rope_match_jax(norm_type):
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    scale = rng.randn(16).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    p = {"scale": jnp.asarray(scale)}
    if norm_type == "layernorm":
        p["bias"] = jnp.asarray(bias)
    want = jl.apply_norm(p, jnp.asarray(x), norm_type)
    got = tl.apply_norm(torch.from_numpy(scale),
                        torch.from_numpy(bias) if "bias" in p else None,
                        torch.from_numpy(x), norm_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    pos = np.arange(5)[None, :]
    np.testing.assert_allclose(
        tl.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        rtol=1e-5, atol=1e-6)
