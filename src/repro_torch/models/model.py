"""Decoder LM (mirrors ``repro.models.model``): the train forward and the
serving path (caches, prefill, decode, paged decode).

A model is a stack of blocks cycled from ``cfg.block_pattern`` (attn |
rglru | mlstm | slstm).  Layers are grouped into super-blocks (one full
pattern cycle); the ``n_layers % len(pattern)`` remainder layers follow
them, each of the kind its index in the pattern gives.

  * ``attn``: pre-norm attention (GQA/MQA, optional q/k/v biases, full or
    sliding-window) and an FFN — the GELU MLP, the gated SiLU MLP or a
    top-k MoE — either in sequence (``norm2`` before the FFN) or in
    parallel from one norm (``parallel_block``: ``x + attn(h) + ffn(h)``).
  * ``rglru``: ``norm1`` and the RG-LRU block ``rec``
    (``models/recurrent.py``), then ``norm2`` and the MLP when ``d_ff`` is
    set.
  * ``mlstm`` / ``slstm``: ``norm1`` and the xLSTM block ``cell``
    (``models/xlstm.py``).

A train forward (no caches, gradients on) runs each scanned super-block
under ``cfg.remat``'s activation checkpoint, as the JAX package wraps its
scan body (``_remat_wrap``); attention goes over KV chunks of
``cfg.attn_chunk`` keys (``layers.causal_attention``).

Embeddings are the stable or the baseline one, the head untied or tied to
the embedding table, and a modality frontend stub may prepend projected
precomputed features (``embeds``).

Parameters keep the JAX package's tree, names and leaf order: with
``scan_layers`` (the default) one parameter per weight kind with a leading
layer axis (``blocks/b0_attn/attn/wq`` is ``(n_super, d_model, H*Dh)``),
else one block per layer (``blocks_list/<i>/b0_attn/attn/wq``); the
remainder layers are ``rem_blocks/<i>/<kind>/...``; all named with the
path strings the JAX package's ``path_str`` gives, once '.' is read as
'/'.  The layout is not cosmetic: the optimizer picks 8-bit or 32-bit
state per leaf by its size, cuts blocks per leaf and seeds its stochastic
rounding by the leaf's index in tree order.  Every leaf is held in
``cfg.param_dtype``: what the JAX package's forward sees, its masters cast
to that dtype.

    model = init_model(cfg, generator, device="cuda")
    logits, metrics = forward(cfg, model, tokens, embeds=None)
    logits, cache = prefill(cfg, model, tokens, max_len, embeds=None)
    logits, cache = decode_step(cfg, model, token, cache, pos)

Caches keep the JAX package's pytree layout, ``{"scan": {"b0_attn":
{"k": (n_super, B, eff, KV, Dh), ...}, "b1_rglru": {"h": (n_super, B, W),
"conv": ...}, "b0_mlstm": (C, n, m)}, "rem": [...]}`` (a leading layer
axis, as the parameters have; a list of per-layer dicts without
``scan_layers``), so the two packages' caches compare leaf by leaf; an
attn layer's ``eff`` is ``min(max_len, window)`` under sliding-window
attention, a ring.  A recurrent layer's cache is its block's f32 state:
the RG-LRU dict ``{h, conv}``, mLSTM's tuple ``(C, n, m)``, sLSTM's ``(c,
n, h, m)`` (m starting at -inf).  Caches are updated in place: a decode
step copies no cache and no page pool (the JAX package donates them
instead).  The paged cache keeps one quantized page pool per attn layer
and the recurrent layers' dense state per slot.  The MoE metrics
(``moe_aux_loss``, ``moe_z_loss``, ``moe_drop_frac``) are the mean over
the scanned layers, or the last layer's without ``scan_layers``, as in the
JAX package.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import device as device_lib
from repro_torch.errors import ConfigError
from repro_torch.kernels import paged_kv
from repro_torch.models import embedding as emb
from repro_torch.models import layers, moe, recurrent, xlstm
from repro_torch.models.constrain import (batch_local, constrain_block_params,
                                          seq_gather, seq_scatter)


class _Params(nn.Module):
    """A node of the parameter tree: named tensors and child nodes."""

    def __init__(self, **params):
        super().__init__()
        for name, value in params.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(name, nn.Parameter(value))


def _block_names(cfg) -> list:
    """(name, kind) of each block of a super-block: ``b<i>_<kind>``."""
    return [(f"b{i}_{kind}", kind) for i, kind in enumerate(cfg.block_pattern)]


def _norm(shape: tuple, norm_type: str, dev, dt) -> _Params:
    p = {"scale": torch.ones(shape, device=dev, dtype=dt)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros(shape, device=dev, dtype=dt)
    return _Params(**p)


def _block(cfg, kind: str, lead: tuple, dev, dt) -> _Params:
    """One block's parameters of ``kind``, each with the leading dims
    ``lead`` (the layer axis when stacked)."""
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    e = lambda *s: torch.empty(lead + s, device=dev, dtype=dt)
    norm = lambda: _norm(lead + (d,), cfg.norm_type, dev, dt)

    def mlp():
        f = cfg.d_ff
        p = dict(w_in=e(d, f), w_out=e(f, d))
        if cfg.gated_mlp:
            p["w_gate"] = e(d, f)
        return _Params(**p)

    if kind == "rglru":
        p = {"norm1": norm(), "rec": _Params(
            **recurrent.init_rglru_block(cfg, lead, dev, dt))}
        if cfg.d_ff:
            p.update(norm2=norm(), mlp=mlp())
        return _Params(**p)
    if kind in ("mlstm", "slstm"):
        init = xlstm.init_mlstm_block if kind == "mlstm" else \
            xlstm.init_slstm_block
        return _Params(norm1=norm(), cell=_Params(**init(cfg, lead, dev,
                                                          dt)))
    if kind != "attn":
        raise ConfigError(f"unknown block kind {kind!r}")
    attn = dict(wq=e(d, H * Dh), wk=e(d, KV * Dh), wv=e(d, KV * Dh),
                wo=e(H * Dh, d))
    if cfg.qkv_bias:
        z = lambda n: torch.zeros(lead + (n,), device=dev, dtype=dt)
        attn.update(bq=z(H * Dh), bk=z(KV * Dh), bv=z(KV * Dh))
    p = {"norm1": norm(), "attn": _Params(**attn)}
    if cfg.is_moe:
        E, f = cfg.n_experts, cfg.moe_dff or cfg.d_ff
        p["moe"] = _Params(router=e(d, E), w_gate=e(E, d, f),
                           w_in=e(E, d, f), w_out=e(E, f, d))
    else:
        p["mlp"] = mlp()
    if not cfg.parallel_block:
        p["norm2"] = norm()
    return _Params(**p)


def _rem_kind(cfg, i: int) -> str:
    """The block kind of remainder layer ``i``."""
    return cfg.block_pattern[i % len(cfg.block_pattern)]


class Model(nn.Module):
    """The LM's parameter tree and train forward.  ``named_parameters()``
    yields 'embed.table', 'blocks.b0_attn.attn.wq', ..., 'head.w'."""

    def __init__(self, cfg, *, device="cuda"):
        super().__init__()
        dev = device_lib.resolve(device)
        self.cfg = cfg
        dt = getattr(torch, cfg.param_dtype)
        d, V = cfg.d_model, cfg.vocab_size
        embed = {"table": torch.empty(V, d, device=dev, dtype=dt)}
        if cfg.stable_embedding:
            embed["norm"] = _norm((d,), "layernorm", dev, dt)
        self.embed = _Params(**embed)
        if cfg.frontend != "none" and cfg.frontend_tokens:
            self.frontend = _Params(proj=torch.empty(d, d, device=dev,
                                                     dtype=dt))
        n_super = cfg.n_superblocks
        names = _block_names(cfg)
        if cfg.scan_layers and n_super > 0:
            self.blocks = _Params(**{n: _block(cfg, kind, (n_super,), dev, dt)
                                     for n, kind in names})
        elif n_super > 0:
            self.blocks_list = nn.ModuleList(
                _Params(**{n: _block(cfg, kind, (), dev, dt)
                           for n, kind in names})
                for _ in range(n_super))
        if cfg.n_remainder_layers:
            # keyed by their kind, as the JAX tree's {kind: block}
            self.rem_blocks = nn.ModuleList(
                _Params(**{_rem_kind(cfg, i): _block(cfg, _rem_kind(cfg, i),
                                                     (), dev, dt)})
                for i in range(cfg.n_remainder_layers))
        self.final_norm = _norm((d,), cfg.norm_type, dev, dt)
        if not cfg.tie_embeddings:
            self.head = _Params(w=torch.empty(d, V, device=dev, dtype=dt))

    def param_dict(self) -> dict:
        """Path string ('blocks/b0_attn/attn/wq') -> parameter."""
        return {n.replace(".", "/"): p for n, p in self.named_parameters()}

    def forward(self, tokens: torch.Tensor, embeds=None):
        """tokens (B, S) int, embeds (B, frontend_tokens, d) or None ->
        (logits (B, S', V) f32, metrics); S' counts the frontend's
        prefix."""
        x = self._embed(tokens, embeds)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, metrics = _run_blocks(self, x, positions)
        return _logits(self, x), metrics

    def _embed(self, tokens, embeds=None):
        x = emb.apply_embedding(self.embed, tokens.long(), self.cfg)
        if embeds is not None and hasattr(self, "frontend"):
            fx = emb.apply_frontend(self.frontend.proj,
                                    torch.as_tensor(embeds).to(x.device),
                                    self.cfg)
            x = torch.cat([fx.to(x.dtype), x], dim=1)
        # the residual layout (the table is replicated: a local slice)
        return seq_scatter(x)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


def _block_leaf_axes(kind: str, container: str, leaf: str) -> tuple:
    """Logical axes of a block parameter: ``container`` is its node within
    the block ('norm1', 'attn', 'mlp', 'moe', 'rec', 'cell')."""
    if container in ("norm1", "norm2"):
        return layers.NORM_AXES[leaf]
    table = {"attn": layers.ATTN_AXES, "mlp": layers.MLP_AXES,
             "moe": moe.MOE_AXES, "rec": recurrent.RGLRU_AXES,
             "cell": xlstm.MLSTM_AXES if kind == "mlstm"
             else xlstm.SLSTM_AXES}[container]
    return table[leaf]


def logical_axes(cfg, model: Model) -> dict:
    """{path: logical axes} for every parameter of ``model`` (paths as
    ``param_dict`` names them): the JAX package's ``init_model`` specs,
    one tuple of logical axis names per parameter dim, with "layers"
    leading on the scan-stacked leaves."""
    if model.cfg != cfg:
        raise ConfigError("logical_axes: model was built for another config")
    top = {"embed": {**emb.EMBED_AXES, **layers.NORM_AXES},
           "frontend": emb.FRONTEND_AXES, "final_norm": layers.NORM_AXES,
           "head": emb.HEAD_AXES}
    out = {}
    for path in model.param_dict():
        parts = path.split("/")
        if parts[0] in top:
            out[path] = top[parts[0]][parts[-1]]
            continue
        container, leaf = parts[-2], parts[-1]
        if parts[0] == "blocks":                 # blocks/b0_attn/...
            kind = parts[1].split("_", 1)[1]
            out[path] = ("layers",) + _block_leaf_axes(kind, container, leaf)
        elif parts[0] == "blocks_list":          # blocks_list/<i>/b0_attn/...
            kind = parts[2].split("_", 1)[1]
            out[path] = _block_leaf_axes(kind, container, leaf)
        else:                                    # rem_blocks/<i>/<kind>/...
            out[path] = _block_leaf_axes(parts[2], container, leaf)
    return out


def _nested(module: nn.Module, n: Optional[int]):
    """A block's parameters as nested dicts keyed like the JAX tree
    ({"attn": {"wq": ...}, ...}): one dict, or with ``n`` (stacked) a list
    of n per-layer dicts, each stacked parameter unbound once (its
    backward then stacks the layer gradients in one op; indexing per layer
    would zero-fill and add a whole stacked gradient once per layer)."""
    out = [{} for _ in range(n or 1)]
    for name, t in module.named_parameters():
        parts = name.split(".")
        for i, piece in enumerate(t.unbind(0) if n else (t,)):
            node = out[i]
            for key in parts[:-1]:
                node = node.setdefault(key, {})
            node[parts[-1]] = piece
    return out if n else out[0]


def _pairs(a, b) -> list:
    """The matching tensors of two layer caches of one kind: a dict's by
    key, a recurrent block's state tuple's by position."""
    if isinstance(a, dict):
        return [(a[k], b[k]) for k in a]
    return list(zip(a, b))


def _store(state, new) -> None:
    """Write a recurrent block's new state into its cache views in place
    (the cache's counterpart of the JAX package's returned state)."""
    if state is not None:
        for dst, src in _pairs(state, new):
            dst.copy_(src)


def _apply_block(p, x, cfg, kind: str, *, positions, state=None,
                 cache_len=None, paged=None):
    """One block of ``kind``; returns (x_out, metrics).  ``state``: the
    layer's cache views (updated in place) or None.  ``paged``: the paged
    decode's context, which only attn blocks read; recurrent kinds keep
    their per-slot dense state.  Under activation sharding ``x`` is the
    residual, its sequence on the tp axis: each norm runs on the shard,
    its output is gathered whole before the branch (``seq_gather``) and
    the branch's output scattered back before the residual add
    (``seq_scatter``); the recurrent blocks' ``batch_local`` gathers the
    sequence itself."""
    norm = lambda q, h: layers.apply_norm(q["scale"], q.get("bias"), h,
                                          cfg.norm_type)

    def mlp(x):
        return seq_scatter(layers.apply_mlp(
            p["mlp"], seq_gather(norm(p["norm2"], x)), cfg))

    if kind == "rglru":
        r, new = batch_local(
            lambda q, h, s: recurrent.apply_rglru_block(q, h, cfg, state=s),
            p["rec"], norm(p["norm1"], x), state)
        _store(state, new)
        x = x + seq_scatter(r)
        if cfg.d_ff:
            x = x + mlp(x)
        return x, {}
    if kind in ("mlstm", "slstm"):
        fn = xlstm.apply_mlstm_block if kind == "mlstm" else \
            xlstm.apply_slstm_block
        c, new = batch_local(lambda q, h, s: fn(q, h, cfg, state=s),
                             p["cell"], norm(p["norm1"], x), state)
        _store(state, new)
        return x + seq_scatter(c), {}

    def ffn(h):
        if cfg.is_moe:
            return moe.apply_moe(p["moe"], h, cfg)
        return layers.apply_mlp(p["mlp"], h, cfg), {}

    h = seq_gather(norm(p["norm1"], x))
    a, _ = layers.apply_attention(p["attn"], h, cfg, positions=positions,
                                  cache=state, cache_len=cache_len,
                                  paged=paged)
    if cfg.parallel_block:
        # both branches take the one gathered h; their sum, still partial,
        # is reduce-scattered once
        f, metrics = ffn(h)
        return x + seq_scatter(a + f), metrics
    x = x + seq_scatter(a)
    f, metrics = ffn(seq_gather(norm(p["norm2"], x)))
    return x + seq_scatter(f), metrics


def _mean(values: list) -> torch.Tensor:
    return values[0] if len(values) == 1 else torch.stack(values).mean()


def _map_cache(layer, fn):
    """A layer cache (a dict, or a recurrent block's tuple) with ``fn``
    applied to every tensor."""
    if isinstance(layer, dict):
        return {k: fn(t) for k, t in layer.items()}
    return tuple(fn(t) for t in layer)


def _dots_policy(ctx, op, *args, **kwargs):
    """remat "dots": keep the 2-D products (``aten.mm`` / ``aten.addmm``,
    what ``x @ W`` folds to: the JAX package's dots with no batch dims),
    recompute everything else (the attention's and the experts' ``bmm``,
    norms, activations, rope)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, cfg):
    """``fn`` under the activation checkpoint ``cfg.remat`` names (the JAX
    package's ``_remat_wrap``): "none" keeps every activation, "dots" a
    selective checkpoint that keeps the 2-D products, anything else
    ("full") a checkpoint that keeps only ``fn``'s inputs.  Non-reentrant
    checkpoints keep the forward's autograd graph and recompute its saved
    tensors in the backward, so values and gradients are the unwrapped
    ones, bit for bit (the model draws no random numbers: no RNG state is
    kept for the recompute)."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    preserve_rng_state=False, **kw)


def _run_blocks(model: Model, x, positions, caches=None, cache_len=None,
                paged=None):
    """All layers over x (B, S, d).  ``caches``: None (no state io) or the
    cache pytree, whose per-layer views are updated in place.  Each
    scanned super-block of a train forward (no caches, gradients on) runs
    under ``cfg.remat``'s checkpoint, as the JAX package wraps its scan
    body; the ``blocks_list`` and remainder layers run unwrapped, as
    there.  Returns (x, metrics)."""
    cfg = model.cfg
    names = _block_names(cfg)
    kw = dict(positions=positions, cache_len=cache_len, paged=paged)
    scanned = hasattr(model, "blocks")

    def superblock(x, ps: dict, states=lambda name: None):
        """One super-block: (x, its blocks' metrics averaged: JAX's
        agg)."""
        ps = constrain_block_params(ps) if scanned else ps
        acc = []
        for name, kind in names:
            # sequence parallelism: the residual stream between TP regions
            # is sharded on (batch -> dp, sequence -> tp)
            x = seq_scatter(x)
            x, mt = _apply_block(ps[name], x, cfg, kind,
                                 state=states(name), **kw)
            if mt:
                acc.append(mt)
        return x, ({k: _mean([m[k] for m in acc]) for k in acc[0]} if acc
                   else {})

    metrics = {}
    if scanned:
        n = cfg.n_superblocks
        per_layer = {name: _nested(getattr(model.blocks, name), n)
                     for name, _ in names}
        wrapped = _remat_wrap(superblock, cfg) if caches is None and \
            torch.is_grad_enabled() else None
        layer_mts = []
        for i in range(n):
            ps = {nm: per_layer[nm][i] for nm, _ in names}
            if wrapped is not None:
                x, mt = wrapped(x, ps)
            else:
                x, mt = superblock(x, ps, lambda name: None if caches is None
                                   else _map_cache(caches["scan"][name],
                                                   lambda t: t[i]))
            if mt:
                layer_mts.append(mt)
        if layer_mts:
            metrics = {k: _mean([m[k] for m in layer_mts])
                       for k in layer_mts[0]}
    elif hasattr(model, "blocks_list"):
        for i, sb in enumerate(model.blocks_list):
            x, mt = superblock(
                x, {nm: _nested(getattr(sb, nm), None) for nm, _ in names},
                lambda name: None if caches is None else
                caches["scan"][i][name])
            metrics.update(mt)
    for i, rb in enumerate(getattr(model, "rem_blocks", ())):
        kind = _rem_kind(cfg, i)
        x, mt = _apply_block(_nested(getattr(rb, kind), None), x, cfg, kind,
                             state=None if caches is None
                             else caches["rem"][i], **kw)
        metrics.update(mt)
    return x, metrics


def _logits(model: Model, x):
    """The final norm on the residual's sequence shard, then the head on
    the sequence gathered whole."""
    fn = model.final_norm
    x = seq_gather(layers.apply_norm(fn.scale, getattr(fn, "bias", None), x,
                                     model.cfg.norm_type))
    head = getattr(model, "head", None)
    return emb.apply_head(None if head is None else head.w, x,
                          model.embed.table)


# The JAX package's N(0, scale^2) initializers of the attn block, its MLP,
# the frontend projection and the head, by leaf name within those modules
# (the recurrent blocks' own leaves are initialized by recurrent.py and
# xlstm.py, where the same names have other scales)
def _init_scale(cfg, name: str) -> float:
    d, f = cfg.d_model, cfg.d_ff
    if name in ("wq", "wk", "wv", "w_in", "w_gate", "proj", "w"):
        return 1.0 / math.sqrt(d)
    if name == "wo":
        return 1.0 / math.sqrt(cfg.n_heads * cfg.head_dim)
    if name == "w_out":
        return 1.0 / math.sqrt(f)
    raise KeyError(name)


def init_model(cfg, generator: Optional[torch.Generator] = None, *,
               device="cuda") -> Model:
    """A model with the JAX package's initializers, drawn from
    ``generator`` (a ``torch.Generator``; its device is where the numbers
    are drawn) in f32 and cast to ``cfg.param_dtype``.  The numbers differ
    from ``jax.random``'s: to start both packages from the same weights
    use ``repro_torch.convert``."""
    model = Model(cfg, device=device)
    gen_dev = generator.device if generator is not None else "cpu"
    draw = lambda shape: torch.randn(shape, generator=generator,
                                     device=gen_dev)

    uniform = lambda shape: torch.rand(shape, generator=generator,
                                       device=gen_dev)

    def normal(p, scale):
        p.copy_(draw(p.shape) * scale)

    def block(b, kind):
        if kind == "rglru":
            recurrent.init_rglru_values(b.rec, cfg, draw, uniform)
        elif kind == "mlstm":
            xlstm.init_mlstm_values(b.cell, cfg, draw)
        elif kind == "slstm":
            xlstm.init_slstm_values(b.cell, cfg, draw)
        else:
            for name in ("wq", "wk", "wv", "wo"):
                normal(getattr(b.attn, name), _init_scale(cfg, name))
        if hasattr(b, "mlp"):
            for name in ("w_gate", "w_in", "w_out"):
                if hasattr(b.mlp, name):
                    normal(getattr(b.mlp, name), _init_scale(cfg, name))
        if hasattr(b, "moe"):
            E, fe = cfg.n_experts, cfg.moe_dff or cfg.d_ff
            normal(b.moe.router, 0.02)
            # dense_init's default scale is 1/sqrt(shape[0]): E here
            normal(b.moe.w_gate, 1.0 / math.sqrt(E))
            normal(b.moe.w_in, 1.0 / math.sqrt(E))
            normal(b.moe.w_out, 1.0 / math.sqrt(fe))

    with torch.no_grad():
        t = model.embed.table
        if cfg.stable_embedding:                      # Xavier-uniform
            lim = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
            t.copy_(uniform(t.shape) * (2 * lim) - lim)
        else:                                         # N(0, 1) / sqrt(d)
            normal(t, 1.0 / math.sqrt(cfg.d_model))
        if hasattr(model, "frontend"):
            normal(model.frontend.proj, _init_scale(cfg, "proj"))
        names = _block_names(cfg)
        if hasattr(model, "blocks"):
            for name, kind in names:
                block(getattr(model.blocks, name), kind)
        for sb in getattr(model, "blocks_list", ()):
            for name, kind in names:
                block(getattr(sb, name), kind)
        for i, rb in enumerate(getattr(model, "rem_blocks", ())):
            kind = _rem_kind(cfg, i)
            block(getattr(rb, kind), kind)
        if hasattr(model, "head"):
            normal(model.head.w, _init_scale(cfg, "w"))
    return model


def forward(cfg, model: Model, tokens: torch.Tensor, embeds=None):
    """Training/eval forward (the JAX package's ``forward(cfg, params,
    tokens, embeds)``): (logits (B, S, V) f32, metrics)."""
    if model.cfg != cfg:
        raise ConfigError("forward: model was built for another config")
    return model(tokens, embeds)


# --------------------------------------------------------------- serving

def _check_model(cfg, model: Model) -> None:
    """``model`` was built for ``cfg`` up to the cache format (the serving
    engines prefill with a 16-bit copy of the config)."""
    if dataclasses.replace(cfg, kv_cache_bits=model.cfg.kv_cache_bits) \
            != model.cfg:
        raise ConfigError("model was built for another config")


def _recurrent_cache(cfg, kind: str, lead: tuple, batch: int, dev):
    """A recurrent layer's f32 state for ``batch`` rows (the JAX package's
    ``_init_layer_cache``): RG-LRU ``{h, conv}``, mLSTM ``(C, n, m)``,
    sLSTM ``(c, n, h, m)`` with m at -inf.  Every tensor is its own (they
    are updated in place)."""
    z = lambda *s: torch.zeros(lead + (batch,) + s, dtype=torch.float32,
                               device=dev)
    if kind == "rglru":
        W = cfg.lru_width or cfg.d_model
        return {"h": z(W), "conv": z(cfg.conv_width - 1, W)}
    if kind == "mlstm":
        H = cfg.n_heads
        D = int(cfg.d_model * cfg.mlstm_proj_factor) // H
        return (z(H, D, D), z(H, D), z(H))
    if kind == "slstm":
        d = cfg.d_model
        return (z(d), z(d), z(d), torch.full(lead + (batch, d), -math.inf,
                                             dtype=torch.float32, device=dev))
    raise ConfigError(f"unknown block kind {kind!r}")


def _cache_tree(cfg, attn_cache, batch: int, dev) -> dict:
    """The {"scan", "rem"} pytree of the layer caches: ``attn_cache(lead)``
    per attn layer, the recurrent state of ``batch`` rows per recurrent
    layer; ``lead`` the stacked layer axis, or () per layer without
    ``scan_layers``."""
    def layer(kind, lead):
        if kind == "attn":
            return attn_cache(lead)
        return _recurrent_cache(cfg, kind, lead, batch, dev)

    names, n = _block_names(cfg), cfg.n_superblocks
    if cfg.scan_layers and n > 0:
        scan = {name: layer(kind, (n,)) for name, kind in names}
    else:
        scan = [{name: layer(kind, ()) for name, kind in names}
                for _ in range(n)]
    return {"scan": scan,
            "rem": [layer(_rem_kind(cfg, i), ())
                    for i in range(cfg.n_remainder_layers)]}


def init_cache(cfg, batch: int, max_len: int, *, device="cuda") -> dict:
    """Contiguous decode cache: per attn layer k/v rows in the compute
    dtype, or block-wise int8 rows when ``cfg.kv_cache_bits == 8``; a ring
    of ``min(max_len, window)`` rows under sliding-window attention; per
    recurrent layer its f32 state."""
    dev = device_lib.resolve(device)
    KV, Dh = cfg.n_kv_heads, cfg.head_dim
    eff = min(max_len, cfg.window) if cfg.attn_type == "swa" and \
        cfg.window else max_len
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)

    def layer(lead):
        rows = lead + (batch, eff, KV)
        if cfg.kv_cache_bits == 8:
            return {"k_codes": z(rows + (Dh,), torch.uint8),
                    "k_absmax": z(rows, torch.float32),
                    "v_codes": z(rows + (Dh,), torch.uint8),
                    "v_absmax": z(rows, torch.float32)}
        dt = getattr(torch, cfg.compute_dtype)
        return {"k": z(rows + (Dh,), dt), "v": z(rows + (Dh,), dt)}

    return _cache_tree(cfg, layer, batch, dev)


@torch.no_grad()
def prefill(cfg, model: Model, tokens: torch.Tensor, max_len: int,
            embeds=None, caches=None):
    """Run the whole prompt (B, S) (after the frontend's prefix when
    ``embeds`` is given); returns (logits (B, S', V), a cache ready for
    decode at pos = S').  ``caches``: an ``init_cache(cfg, B, max_len)``
    to fill in place (placed by the caller, as the dry run places it),
    else a new one."""
    _check_model(cfg, model)
    x = model._embed(tokens, embeds)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    if caches is None:
        caches = init_cache(cfg, x.shape[0], max_len, device=x.device)
    x, _ = _run_blocks(model, x, positions, caches=caches, cache_len=S)
    return _logits(model, x), caches


@torch.no_grad()
def decode_step(cfg, model: Model, token: torch.Tensor, caches: dict,
                pos: int):
    """token: (B, 1) int; pos: 0-based index of this token.  Returns
    (logits (B, 1, V), caches), the caches updated in place."""
    _check_model(cfg, model)
    x = model._embed(token)
    positions = torch.full((1, 1), int(pos), device=x.device)
    x, _ = _run_blocks(model, x, positions, caches=caches,
                       cache_len=int(pos) + 1)
    return _logits(model, x), caches


# ------------------------------------------------ paged serving

def init_paged_cache(cfg, n_slots: int, n_pages: int, page_size: int,
                     kv_bits: int = 8, *, device="cuda") -> dict:
    """Paged serving cache (the ``init_cache`` layout): per attn layer one
    pool of ``n_pages`` pages of ``page_size`` positions, block-wise
    quantized to ``kv_bits`` (8-bit codes or packed 4-bit).  The pool has
    no slot axis: page tables map slots to pages.  Recurrent layers keep
    their dense state per slot (``n_slots`` rows), as the contiguous cache
    does."""
    dev = device_lib.resolve(device)
    KV = cfg.n_kv_heads
    W = paged_kv.packed_row_width(cfg.head_dim, kv_bits)
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)

    def layer(lead):
        rows = lead + (n_pages, page_size, KV)
        return {"k_codes": z(rows + (W,), torch.uint8),
                "k_absmax": z(rows, torch.float32),
                "v_codes": z(rows + (W,), torch.uint8),
                "v_absmax": z(rows, torch.float32)}

    return _cache_tree(cfg, layer, n_slots, dev)


@torch.no_grad()
def paged_decode_step(cfg, model: Model, token: torch.Tensor, caches: dict,
                      paged: layers.PagedContext):
    """One continuous-batching decode step over every slot.

    token: (n_slots, 1) int (the last sampled token per slot; inactive
    slots carry a dummy).  ``paged``: per-slot positions and the page
    table.  Returns (logits (n_slots, 1, V), caches); the pages are
    appended in place."""
    _check_model(cfg, model)
    x = model._embed(token)
    positions = paged.positions.clamp_min(0)[:, None]        # (B, 1)
    x, _ = _run_blocks(model, x, positions, caches=caches, paged=paged)
    return _logits(model, x), caches


def _commit_attn_pages(paged_layer: dict, dense_layer: dict,
                       table_row: torch.Tensor, prompt_len: int,
                       kv_bits: int) -> None:
    """Quantize a batch-1 dense prefill cache's k/v rows (layer-stacked,
    (L, 1, eff, KV, Dh)) into the slot's allocated pages of the stacked
    pools, in place.  A sliding-window cache is a ring holding only the
    last ``eff`` positions: exactly those rows are committed (older
    positions are outside every future window; their pages stay zero and
    masked)."""
    if "k" not in dense_layer:
        raise ValueError("paged commit needs a 16-bit dense prefill cache "
                         "(cfg.kv_cache_bits == 16 for the prefill config)")
    page = paged_layer["k_codes"].shape[2]
    eff = dense_layer["k"].shape[2]
    pos = np.arange(prompt_len - min(prompt_len, eff), prompt_len)
    upload = lambda a: device_lib.to_device(torch.from_numpy(a),
                                            table_row.device)
    ring_idx, offs = upload(pos % eff), upload(pos % page)
    pids = table_row.long()[upload(pos // page)]
    for name in ("k", "v"):
        rows = dense_layer[name][:, 0][:, ring_idx]      # (L, n, KV, Dh)
        codes, absmax = paged_kv.quantize_rows(rows, kv_bits)
        paged_layer[f"{name}_codes"][:, pids, offs] = codes
        paged_layer[f"{name}_absmax"][:, pids, offs] = absmax


@torch.no_grad()
def commit_prefill_to_paged(cfg, paged_caches: dict, dense_caches: dict,
                            slot: int, table_row: torch.Tensor,
                            prompt_len: int, kv_bits: int = 8) -> dict:
    """Admit one prefilled request into the paged cache.

    ``dense_caches`` is a batch-1 ``prefill`` cache built with a 16-bit
    config (max_len == prompt_len); its attn k/v rows are quantized into
    the pages named by ``table_row`` ((max_pages_per_seq,) integer tensor
    on the cache's device) with the row quantizer the decode append uses,
    and every recurrent layer's state is inserted at batch row ``slot``.
    Returns ``paged_caches``, updated in place."""
    stacked = lambda layer: _map_cache(layer, lambda t: t[None])
    kind = lambda name: name.split("_", 1)[1]
    triples = []                  # (kind, paged layer, dense layer), stacked
    if isinstance(paged_caches["scan"], dict):
        triples += [(kind(n), paged_caches["scan"][n],
                     dense_caches["scan"][n]) for n in paged_caches["scan"]]
    else:
        triples += [(kind(n), stacked(sb[n]),
                     stacked(dense_caches["scan"][i][n]))
                    for i, sb in enumerate(paged_caches["scan"]) for n in sb]
    triples += [(_rem_kind(cfg, i), stacked(pg), stacked(dn)) for i, (pg, dn)
                in enumerate(zip(paged_caches["rem"], dense_caches["rem"]))]
    for k, paged_layer, dense_layer in triples:
        if k == "attn":
            _commit_attn_pages(paged_layer, dense_layer, table_row,
                               prompt_len, kv_bits)
            continue
        for pg, dn in _pairs(paged_layer, dense_layer):
            pg[:, slot] = dn[:, 0]
    return paged_caches
