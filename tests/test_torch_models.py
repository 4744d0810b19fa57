"""The attention-family architectures of the port against the live JAX
package, at ``reduced()`` widths (d_model 64, 2 layers, vocab 256, f32):
the registry and parameter trees, the forward logits, three adamw8 train
steps, and greedy serving through the contiguous and the paged caches.
Both packages start from the same weights, made by the JAX package's
``init_model`` and carried over with ``repro_torch.convert``.

Tolerances: both packages' attention is the online softmax over KV
chunks of ``attn_chunk`` keys, in the same chunk order, but the port's
matmuls and einsums sum in another order than XLA's, so f32 logits agree
to ``LOGIT_RTOL`` / ``LOGIT_ATOL`` (measured ~1e-6 relative here); loss traces at the golden tests' rtol=2e-4; a code
may flip by one level where a state lies within rounding of a codebook
midpoint (ROADMAP's midpoint rule), and over three steps the flipped
element's moment carries that difference on (its code may then sit a few
levels off, its master a step off), so the differing codes and masters
are counted and bounded by ``CODE_FLIPS`` of a leaf; greedy tokens are
equal except at a near-tie of the two best logits (gap below
``TIE_GAP``).  The MoE architectures and the sliding window are
``test_torch_moe.py``'s.  The JAX side's serving functions are jitted
(compiled once per architecture).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.core import optim as jopt
from repro.core.optim.base import path_str
from repro.models import layers as JLy
from repro.models import model as JM
from repro.train import loop as JL
from repro_torch import convert
from repro_torch.configs import base as TB
from repro_torch.core import optim as topt
from repro_torch.models import layers as TLy
from repro_torch.models import model as TM
from repro_torch.train import loop as TL

DENSE = ("stablelm-1.6b", "granite-3-8b", "qwen1.5-32b", "command-r-35b",
         "llava-next-34b", "musicgen-medium")
RECURRENT = ("recurrentgemma-9b", "xlstm-350m")
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-4
CODE_FLIPS = 1e-3          # fraction of a leaf's codes allowed one level off
TIE_GAP = 1e-3
STEPS = 3


@functools.lru_cache(maxsize=None)
def jax_serving(jcfg):
    """The JAX package's serving functions for ``jcfg``, jitted."""
    j16 = dataclasses.replace(jcfg, kv_cache_bits=16)
    return dict(
        prefill=jax.jit(functools.partial(JM.prefill, jcfg),
                        static_argnums=(2,)),
        prefill16=jax.jit(functools.partial(JM.prefill, j16),
                          static_argnums=(2,)),
        decode=jax.jit(functools.partial(JM.decode_step, jcfg)),
        paged=jax.jit(functools.partial(JM.paged_decode_step, jcfg)),
        commit=jax.jit(functools.partial(JM.commit_prefill_to_paged, jcfg),
                       static_argnums=(4, 5)))


@functools.lru_cache(maxsize=None)
def arch_setup(arch, **overrides):
    """(JAX cfg, port cfg, JAX params, their numpy copy) of the reduced
    arch, built once per module."""
    jcfg = JB.reduced(JB.get_config(arch), **overrides)
    tcfg = TB.reduced(TB.get_config(arch), **overrides)
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, params, jax.device_get(params)


def port_model(arch, **overrides):
    _, tcfg, _, host = arch_setup(arch, **overrides)
    return convert.params_from_numpy(host, tcfg, device="cpu")


def inputs(cfg, batch, seq, seed):
    """(tokens (batch, seq) int32, embeds or None) from numpy."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    emb = (rng.randn(batch, cfg.frontend_tokens, cfg.d_model)
           .astype(np.float32) if cfg.frontend_tokens else None)
    return tok, emb


def forward_both(arch, tok, emb, **overrides):
    jcfg, tcfg, params, _ = arch_setup(arch, **overrides)
    model = port_model(arch, **overrides)
    lj, mj = JM.forward(jcfg, params, jnp.asarray(tok),
                        embeds=None if emb is None else jnp.asarray(emb))
    with torch.no_grad():
        lt, mt = TM.forward(tcfg, model, torch.from_numpy(tok),
                            embeds=None if emb is None
                            else torch.from_numpy(emb))
    return (np.asarray(lj), {k: float(v) for k, v in mj.items()},
            lt.numpy(), {k: float(v) for k, v in mt.items()})


def code_flips(tc, jc) -> tuple:
    """(codes that differ, the largest level difference) of two uint8
    code arrays."""
    d = np.abs(np.asarray(tc, np.int64) - np.asarray(jc, np.int64))
    return int((d != 0).sum()), int(d.max()) if d.size else 0


def train_both(arch, name="adamw8", steps=STEPS, **overrides):
    """``steps`` steps of ``name`` (per-leaf state) in both packages on the
    same batches; returns (JAX metrics, port metrics, JAX state, port
    state) per step."""
    jcfg, tcfg, params, _ = arch_setup(arch, **overrides)
    batches = []
    for i in range(steps):
        tok, emb = inputs(jcfg, 4, 17, 100 + i)
        batches.append({"tokens": tok} if emb is None
                       else {"tokens": tok, "embeds": emb})
    jo = jopt.make_optimizer(name, pooled=False, impl="jnp",
                             weight_decay=0.01)
    js = JL.TrainState(jo.init(params), jnp.zeros((), jnp.int32))
    jstep = JL.jit_train_step(jcfg, jo, donate=False)
    jm = []
    for b in batches:
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        jm.append({k: float(v) for k, v in m.items()})
    model = port_model(arch, **overrides)
    to = topt.make_optimizer(name, pooled=False, weight_decay=0.01,
                             device="cpu")
    ts = TL.TrainState(to.init(model.param_dict()), 0)
    tstep = TL.make_train_step(tcfg, model, to)
    tm = []
    for b in batches:
        ts, m = tstep(ts, b)
        tm.append({k: float(v) for k, v in m.items()})
    return jm, tm, js, ts


def check_train(jm, tm, js, ts):
    for key in ("loss", "ce_loss", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in tm],
                                   [m[key] for m in jm], rtol=2e-4,
                                   err_msg=key)
    assert set(tm[0]) >= {k for k in jm[0] if k.startswith("moe_")}
    jleaves = {path_str(p): leaf for p, leaf in
               jax.tree_util.tree_flatten_with_path(
                   js.opt_state.leaves, is_leaf=lambda x: hasattr(
                       x, "master"))[0]}
    n_quant = 0
    for path, leaf in ts.opt_state.leaves.items():
        if path.endswith("attn/bk"):
            # softmax is invariant to a shift of all keys: the k bias's
            # gradient is zero up to rounding, and Adam's normalized step
            # turns that rounding into steps of +-lr
            continue
        jl = jleaves[path]
        # masters within rounding, but for the elements whose moment code
        # flipped at a midpoint (one per flip)
        off = ~np.isclose(leaf.master.numpy(), np.asarray(jl.master),
                          rtol=1e-4, atol=1e-5)
        assert off.sum() <= CODE_FLIPS * leaf.master.numel(), \
            (path, int(off.sum()))
        if isinstance(leaf, topt.Quant8Leaf):
            n_quant += 1
            for name in ("codes_m", "codes_r"):
                n, worst = code_flips(getattr(leaf, name).numpy(),
                                      np.asarray(getattr(jl, name)))
                assert n <= CODE_FLIPS * leaf.n, (path, name, n, worst)
    assert n_quant > 0


def greedy_both(arch, P=10, n_new=6, batch=2, **overrides):
    """Greedy decode through the contiguous cache in both packages, each
    step fed JAX's token; returns the per-step (JAX, port) logits."""
    jcfg, tcfg, params, _ = arch_setup(arch, **overrides)
    model = port_model(arch, **overrides)
    tok, emb = inputs(jcfg, batch, P, 7)
    pre = 0 if emb is None else jcfg.frontend_tokens
    max_len = pre + P + n_new
    js = jax_serving(jcfg)
    lj, cj = js["prefill"](params, jnp.asarray(tok), max_len,
                           None if emb is None else jnp.asarray(emb))
    lt, ct = TM.prefill(tcfg, model, torch.from_numpy(tok), max_len,
                        embeds=None if emb is None else torch.from_numpy(emb))
    out = [(np.asarray(lj[:, -1]), lt[:, -1].numpy())]
    for i in range(n_new - 1):
        nxt = np.array(jnp.argmax(lj[:, -1], -1))[:, None]
        lj, cj = js["decode"](params, jnp.asarray(nxt), cj,
                              jnp.int32(pre + P + i))
        lt, ct = TM.decode_step(tcfg, model, torch.from_numpy(nxt), ct,
                                pre + P + i)
        out.append((np.asarray(lj[:, -1]), lt[:, -1].numpy()))
    return out


def paged_both(arch, prompts, n_new, page=8, kv_bits=8, **overrides):
    """Continuous-batching decode of ``prompts`` (one slot each) through the
    paged caches of both packages: prefill (16-bit), commit into the
    slot's pages, then ``n_new - 1`` paged steps over every slot, each fed
    JAX's greedy token.  Returns the per-step (JAX, port) logits."""
    jcfg, tcfg, params, _ = arch_setup(arch, **overrides)
    model = port_model(arch, **overrides)
    n = len(prompts)
    per = -(-max(len(p) + n_new for p in prompts) // page)
    n_pages = n * per
    table = np.arange(n_pages, dtype=np.int32)[::-1].reshape(n, per).copy()
    js = jax_serving(jcfg)
    jc = JM.init_paged_cache(jcfg, n, n_pages, page, kv_bits)
    tc = TM.init_paged_cache(tcfg, n, n_pages, page, kv_bits, device="cpu")
    t16 = dataclasses.replace(tcfg, kv_cache_bits=16)
    first_j, first_t = [], []
    for s, p in enumerate(prompts):
        P = len(p)
        lj, dj = js["prefill16"](params, jnp.asarray(p)[None], P)
        jc = js["commit"](jc, dj, s, jnp.asarray(table[s]), P, kv_bits)
        lt, dt = TM.prefill(t16, model, torch.from_numpy(p)[None], P)
        TM.commit_prefill_to_paged(tcfg, tc, dt, s,
                                   torch.from_numpy(table[s]), P, kv_bits)
        first_j.append(np.asarray(lj[0, -1]))
        first_t.append(lt[0, -1].numpy())
    out = [(np.stack(first_j), np.stack(first_t))]
    pos = np.asarray([len(p) for p in prompts], np.int32)
    last = out[0][0]
    for _ in range(n_new - 1):
        nxt = last.argmax(-1).astype(np.int32)[:, None]
        lj, jc = js["paged"](
            params, jnp.asarray(nxt), jc,
            JLy.PagedContext(jnp.asarray(table), jnp.asarray(pos), "jnp"))
        lt, tc = TM.paged_decode_step(
            tcfg, model, torch.from_numpy(nxt), tc,
            TLy.PagedContext(torch.from_numpy(table), torch.from_numpy(pos),
                             impl="torch"))
        last = np.asarray(lj[:, 0])
        out.append((last, lt[:, 0].numpy()))
        pos = pos + 1
    return out


def check_greedy(steps, atol=LOGIT_ATOL):
    """Logits close; greedy tokens equal unless JAX's two best logits are a
    near-tie."""
    for lj, lt in steps:
        np.testing.assert_allclose(lt, lj, rtol=LOGIT_RTOL, atol=atol)
        top2 = np.sort(lj, axis=-1)[:, -2:]
        tie = (top2[:, 1] - top2[:, 0]) < TIE_GAP
        same = lt.argmax(-1) == lj.argmax(-1)
        assert np.all(same | tie)


# ----------------------------------------------------------------- registry

def test_registry_matches_jax():
    """The port registers every JAX architecture (the twelve, the recurrent
    ones included), with the JAX package's values."""
    want = sorted(JB.list_archs())
    assert TB.list_archs() == want and len(want) == 12
    assert set(RECURRENT) <= set(want)
    for arch in want:
        assert dataclasses.asdict(TB.get_config(arch)) == \
            dataclasses.asdict(JB.get_config(arch)), arch


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_kinds_refused(arch):
    """The recurrent block kinds were refused before they were ported; they
    now build, in a pattern of their own on another architecture's
    widths, with the JAX package's tree (the architectures themselves are
    ``test_torch_recurrent.py``'s)."""
    kw = dict(block_pattern=JB.get_config(arch).block_pattern, n_layers=3,
              lru_width=64)
    cfg = TB.reduced(dataclasses.replace(TB.get_config("paper-lm-209m"),
                                         **kw))
    jcfg = JB.reduced(dataclasses.replace(JB.get_config("paper-lm-209m"),
                                          **kw))
    got = TM.Model(cfg, device="cpu").param_dict()
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    assert topt.blockopt.leaf_order(got) == [path_str(p) for p, _ in flat]
    for p, leaf in flat:
        assert tuple(got[path_str(p)].shape) == leaf.shape, path_str(p)


@pytest.mark.parametrize("arch", DENSE)
def test_param_tree_matches_jax(arch):
    """Names, shapes, dtypes and the leaf order of the JAX tree."""
    jcfg, tcfg, params, _ = arch_setup(arch)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    model = TM.init_model(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    got = model.param_dict()
    assert topt.blockopt.leaf_order(got) == [path_str(p) for p, _ in flat]
    for p, leaf in flat:
        assert tuple(got[path_str(p)].shape) == leaf.shape, path_str(p)
        assert got[path_str(p)].dtype == getattr(torch, tcfg.param_dtype)


@pytest.mark.parametrize("kw", [dict(scan_layers=False, n_layers=3),
                                dict(block_pattern=("attn", "attn"),
                                     n_layers=3)],
                         ids=["blocks_list", "remainder"])
def test_unscanned_layers_match_jax(kw):
    """``scan_layers=False`` (the JAX tree's ``blocks_list``, one block per
    layer) and a pattern of two attn blocks over 3 layers (a scanned
    super-block of ``b0_attn`` and ``b1_attn``, then ``rem_blocks``): the
    leaf order, the forward and greedy decode."""
    arch = "command-r-35b"
    jcfg, tcfg, params, _ = arch_setup(arch, **kw)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    model = port_model(arch, **kw)
    assert topt.blockopt.leaf_order(model.param_dict()) == \
        [path_str(p) for p, _ in flat]
    tok, emb = inputs(jcfg, 2, 12, 3)
    lj, _, lt, _ = forward_both(arch, tok, emb, **kw)
    np.testing.assert_allclose(lt, lj, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    check_greedy(greedy_both(arch, **kw))


def test_bf16_params_are_the_config_dtype():
    """A bf16-parameter architecture's leaves are bf16 (the JAX package's
    forward sees its masters cast to param_dtype), rounded to nearest even
    from the JAX package's f32 init."""
    cfg = TB.reduced(TB.get_config("qwen1.5-32b"), param_dtype="bfloat16")
    jcfg = JB.reduced(JB.get_config("qwen1.5-32b"), param_dtype="bfloat16")
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(1))
    host = jax.device_get(params)
    model = convert.params_from_numpy(host, cfg, device="cpu")
    for path, p in model.param_dict().items():
        assert p.dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(host["blocks"]["b0_attn"]["attn"]["wq"])
                      .astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(
        model.param_dict()["blocks/b0_attn/attn/wq"].detach().float().numpy(),
        want)


# ------------------------------------------------------------------ forward

@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch):
    jcfg = arch_setup(arch)[0]
    tok, emb = inputs(jcfg, 2, 12, 1)
    lj, mj, lt, mt = forward_both(arch, tok, emb)
    assert lt.shape == lj.shape == (2, 12 + jcfg.frontend_tokens,
                                    jcfg.vocab_size)
    np.testing.assert_allclose(lt, lj, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    assert mt == mj == {}


# -------------------------------------------------------------------- train

# (arch, remat): reduced() trains with remat "none"; one more case holds
# the port's remat "full" (checkpointed super-blocks) to the JAX package's
TRAIN_CASES = [(arch, None) for arch in DENSE] + [("paper-lm-209m", "full")]


@pytest.mark.parametrize(
    "arch,remat", TRAIN_CASES,
    ids=[a if r is None else f"{a}-remat-{r}" for a, r in TRAIN_CASES])
def test_train_steps_match_jax(arch, remat):
    check_train(*train_both(arch, **({} if remat is None
                                     else {"remat": remat})))


# -------------------------------------------------------------------- serve

@pytest.mark.parametrize("arch", DENSE)
def test_greedy_decode_matches_jax(arch):
    check_greedy(greedy_both(arch))


@pytest.mark.parametrize("arch", DENSE)
def test_paged_decode_matches_jax(arch):
    cfg = arch_setup(arch)[0]
    prompts = [np.random.RandomState(s).randint(0, cfg.vocab_size, P)
               .astype(np.int32) for s, P in ((1, 9), (2, 14), (3, 5))]
    check_greedy(paged_both(arch, prompts, n_new=5))
