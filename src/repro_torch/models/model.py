"""Decoder LM (mirrors ``repro.models.model`` for dense ``("attn",)``
blocks): the train forward and the serving path (caches, prefill, decode,
paged decode).

Parameters keep the JAX package's **stacked layer layout**: one parameter
per weight kind with a leading layer axis (``blocks/b0_attn/attn/wq`` is
``(n_layers, d_model, H*Dh)``), named with the path strings the JAX
package's ``path_str`` gives, once '.' is read as '/'.  The layout is not
cosmetic: the optimizer picks 8-bit or 32-bit state per leaf by its size
(a stacked norm scale is quantized, a per-layer one would not be) and cuts
blocks per leaf.

    model = init_model(cfg, generator, device="cuda")
    logits, metrics = forward(cfg, model, tokens)
    logits, cache = prefill(cfg, model, tokens, max_len)
    logits, cache = decode_step(cfg, model, token, cache, pos)

Caches keep the JAX package's pytree layout, ``{"scan": {"b0_attn":
{"k": (n_layers, B, max_len, KV, Dh), ...}}, "rem": []}`` (a leading layer
axis, as the parameters have), so the two packages' caches compare leaf by
leaf.  They are updated in place: a decode step copies no cache and no
page pool (the JAX package donates them instead).

The port builds the paper LM's flavour: stable embedding, LayerNorm or
RMSNorm, plain GELU MLP.  Not ported yet (ROADMAP A14): gated MLPs, the
baseline embedding, MoE, recurrent and xLSTM blocks, frontends,
sliding-window attention, parallel blocks, biases, tied embeddings,
rematerialization.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch import device as device_lib
from repro_torch.errors import ConfigError
from repro_torch.kernels import paged_kv
from repro_torch.models import embedding as emb
from repro_torch.models import layers

BLOCK = "b0_attn"


def _check_supported(cfg) -> None:
    """Raise ConfigError for config features the port's model lacks."""
    unsupported = {
        "block_pattern != ('attn',)": tuple(cfg.block_pattern) != ("attn",),
        "MoE": cfg.n_experts > 0,
        "parallel_block": cfg.parallel_block,
        "qkv_bias": cfg.qkv_bias,
        "tie_embeddings": cfg.tie_embeddings,
        "frontend": cfg.frontend != "none",
        "sliding-window attention": cfg.attn_type != "full",
        "scan_layers=False": not cfg.scan_layers,
        "gated MLP": cfg.gated_mlp,
        "baseline (non-stable) embedding": not cfg.stable_embedding,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ConfigError(f"{cfg.arch_id}: {', '.join(bad)} not ported yet "
                          f"(ROADMAP A14)")


class _Params(nn.Module):
    """A node of the parameter tree: named tensors and child nodes."""

    def __init__(self, **params):
        super().__init__()
        for name, value in params.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(name, nn.Parameter(value))


def _norm(shape, norm_type, device):
    p = {"scale": torch.ones(shape, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros(shape, device=device)
    return _Params(**p)


class Model(nn.Module):
    """The LM's parameter tree and train forward.  ``named_parameters()``
    yields 'embed.table', 'blocks.b0_attn.attn.wq', ..., 'head.w'."""

    def __init__(self, cfg, *, device="cuda"):
        super().__init__()
        _check_supported(cfg)
        dev = device_lib.resolve(device)
        self.cfg = cfg
        d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        L, f, V = cfg.n_layers, cfg.d_ff, cfg.vocab_size
        e = lambda *s: torch.empty(s, device=dev)
        self.embed = _Params(table=e(V, d),
                             norm=_norm((d,), "layernorm", dev))
        self.blocks = _Params(**{BLOCK: _Params(
            norm1=_norm((L, d), cfg.norm_type, dev),
            attn=_Params(wq=e(L, d, H * Dh), wk=e(L, d, KV * Dh),
                         wv=e(L, d, KV * Dh), wo=e(L, H * Dh, d)),
            mlp=_Params(w_in=e(L, d, f), w_out=e(L, f, d)),
            norm2=_norm((L, d), cfg.norm_type, dev))})
        self.final_norm = _norm((d,), cfg.norm_type, dev)
        self.head = _Params(w=e(d, V))

    def param_dict(self) -> dict:
        """Path string ('blocks/b0_attn/attn/wq') -> parameter."""
        return {n.replace(".", "/"): p for n, p in self.named_parameters()}

    def forward(self, tokens: torch.Tensor):
        """tokens (B, S) int -> (logits (B, S, V) f32, metrics {})."""
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device)[None, :]
        return _logits(self, _run_blocks(self, self._embed(tokens),
                                         positions)), {}

    def _embed(self, tokens):
        return emb.apply_embedding(self.embed.table, self.embed.norm,
                                   tokens.long(), self.cfg)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


def _run_blocks(model: Model, x, positions, caches=None, cache_len=None,
                paged=None):
    """All layers over x (B, S, d).  ``caches``: None (no state io) or the
    cache pytree, whose per-layer views are updated in place."""
    cfg = model.cfg
    blk = getattr(model.blocks, BLOCK)
    # One unbind per stacked parameter: its backward stacks the layer
    # gradients in one op (indexing per layer would zero-fill and add a
    # whole stacked gradient once per layer).
    none = (None,) * cfg.n_layers            # RMSNorm has no bias
    n1s, n1b, n2s, n2b, wq, wk, wv, wo, w_in, w_out = (
        none if t is None else t.unbind(0) for t in (
            blk.norm1.scale, getattr(blk.norm1, "bias", None),
            blk.norm2.scale, getattr(blk.norm2, "bias", None),
            blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo,
            blk.mlp.w_in, blk.mlp.w_out))
    stacked = None if caches is None else caches["scan"][BLOCK]
    for i in range(cfg.n_layers):
        state = None if stacked is None else {
            name: t[i] for name, t in stacked.items()}
        h = layers.apply_norm(n1s[i], n1b[i], x, cfg.norm_type)
        a, _ = layers.apply_attention(wq[i], wk[i], wv[i], wo[i], h, cfg,
                                      positions=positions, cache=state,
                                      cache_len=cache_len, paged=paged)
        x = x + a
        h2 = layers.apply_norm(n2s[i], n2b[i], x, cfg.norm_type)
        x = x + layers.apply_mlp(w_in[i], w_out[i], h2)
    return x


def _logits(model: Model, x):
    fn = model.final_norm
    x = layers.apply_norm(fn.scale, getattr(fn, "bias", None), x,
                          model.cfg.norm_type)
    return emb.apply_head(model.head.w, x)


def init_model(cfg, generator: Optional[torch.Generator] = None, *,
               device="cuda") -> Model:
    """A model with the JAX package's initializers, drawn from
    ``generator`` (a ``torch.Generator``; its device is where the numbers
    are drawn).  The numbers differ from ``jax.random``'s: to start both
    packages from the same weights use ``repro_torch.convert``."""
    model = Model(cfg, device=device)
    gen_dev = generator.device if generator is not None else "cpu"

    def normal(p, scale):
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=generator, device=gen_dev)
                    * scale)

    d, f = cfg.d_model, cfg.d_ff
    blk = getattr(model.blocks, BLOCK)
    with torch.no_grad():
        t = model.embed.table                     # Xavier-uniform
        lim = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
        t.copy_(torch.rand(t.shape, generator=generator, device=gen_dev)
                * (2 * lim) - lim)
        for name in ("wq", "wk", "wv"):
            normal(getattr(blk.attn, name), 1.0 / math.sqrt(d))
        normal(blk.attn.wo, 1.0 / math.sqrt(cfg.n_heads * cfg.head_dim))
        normal(blk.mlp.w_in, 1.0 / math.sqrt(d))
        normal(blk.mlp.w_out, 1.0 / math.sqrt(f))
        normal(model.head.w, 1.0 / math.sqrt(d))
    return model


def forward(cfg, model: Model, tokens: torch.Tensor):
    """Training/eval forward (the JAX package's ``forward(cfg, params,
    tokens)``): (logits (B, S, V) f32, metrics)."""
    if model.cfg != cfg:
        raise ConfigError("forward: model was built for another config")
    return model(tokens)


# --------------------------------------------------------------- serving

def _check_model(cfg, model: Model) -> None:
    """``model`` was built for ``cfg`` up to the cache format (the serving
    engines prefill with a 16-bit copy of the config)."""
    if dataclasses.replace(cfg, kv_cache_bits=model.cfg.kv_cache_bits) \
            != model.cfg:
        raise ConfigError("model was built for another config")


def _cache_tree(layer: dict) -> dict:
    return {"scan": {BLOCK: layer}, "rem": []}


def init_cache(cfg, batch: int, max_len: int, *, device="cuda") -> dict:
    """Contiguous decode cache: per layer k/v rows in the compute dtype, or
    block-wise int8 rows when ``cfg.kv_cache_bits == 8``."""
    _check_supported(cfg)
    dev = device_lib.resolve(device)
    L, KV, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    lead = (L, batch, max_len, KV)
    if cfg.kv_cache_bits == 8:
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
        return _cache_tree({
            "k_codes": z(lead + (Dh,), torch.uint8),
            "k_absmax": z(lead, torch.float32),
            "v_codes": z(lead + (Dh,), torch.uint8),
            "v_absmax": z(lead, torch.float32)})
    dt = getattr(torch, cfg.compute_dtype)
    return _cache_tree({"k": torch.zeros(lead + (Dh,), dtype=dt, device=dev),
                        "v": torch.zeros(lead + (Dh,), dtype=dt, device=dev)})


@torch.no_grad()
def prefill(cfg, model: Model, tokens: torch.Tensor, max_len: int):
    """Run the whole prompt (B, S); returns (logits (B, S, V), a cache
    ready for decode at pos = S)."""
    _check_model(cfg, model)
    x = model._embed(tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    caches = init_cache(cfg, x.shape[0], max_len, device=x.device)
    x = _run_blocks(model, x, positions, caches=caches, cache_len=S)
    return _logits(model, x), caches


@torch.no_grad()
def decode_step(cfg, model: Model, token: torch.Tensor, caches: dict,
                pos: int):
    """token: (B, 1) int; pos: 0-based index of this token.  Returns
    (logits (B, 1, V), caches), the caches updated in place."""
    _check_model(cfg, model)
    x = model._embed(token)
    positions = torch.full((1, 1), int(pos), device=x.device)
    x = _run_blocks(model, x, positions, caches=caches,
                    cache_len=int(pos) + 1)
    return _logits(model, x), caches


# ------------------------------------------------ paged serving

def init_paged_cache(cfg, n_slots: int, n_pages: int, page_size: int,
                     kv_bits: int = 8, *, device="cuda") -> dict:
    """Paged serving cache (the ``init_cache`` layout): per layer one pool
    of ``n_pages`` pages of ``page_size`` positions, block-wise quantized to
    ``kv_bits`` (8-bit codes or packed 4-bit).  The pool has no slot axis:
    page tables map slots to pages."""
    _check_supported(cfg)
    del n_slots           # only recurrent layers keep per-slot state (A14)
    dev = device_lib.resolve(device)
    L, KV = cfg.n_layers, cfg.n_kv_heads
    W = paged_kv.packed_row_width(cfg.head_dim, kv_bits)
    lead = (L, n_pages, page_size, KV)
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
    return _cache_tree({"k_codes": z(lead + (W,), torch.uint8),
                        "k_absmax": z(lead, torch.float32),
                        "v_codes": z(lead + (W,), torch.uint8),
                        "v_absmax": z(lead, torch.float32)})


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
    x = _run_blocks(model, x, positions, caches=caches, paged=paged)
    return _logits(model, x), caches


def _commit_attn_pages(paged_layer: dict, dense_layer: dict,
                       table_row: torch.Tensor, prompt_len: int,
                       kv_bits: int) -> None:
    """Quantize a batch-1 dense prefill cache's k/v rows (layer-stacked,
    (L, 1, eff, KV, Dh)) into the slot's allocated pages of the stacked
    pools, in place (the last ``eff`` positions when the dense cache is
    shorter than the prompt)."""
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
    config (max_len == prompt_len); its k/v rows are quantized into the
    pages named by ``table_row`` ((max_pages_per_seq,) integer tensor on
    the cache's device) with the row quantizer the decode append uses.
    Returns ``paged_caches``, updated in place.  ``slot`` would place
    recurrent layers' state, which the port does not have yet (A14)."""
    _check_supported(cfg)
    del slot
    _commit_attn_pages(paged_caches["scan"][BLOCK],
                       dense_caches["scan"][BLOCK], table_row, prompt_len,
                       kv_bits)
    return paged_caches
