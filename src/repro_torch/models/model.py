"""Decoder LM (mirrors ``repro.models.model`` for dense ``("attn",)``
blocks, the train forward).

Parameters keep the JAX package's **stacked layer layout**: one parameter
per weight kind with a leading layer axis (``blocks/b0_attn/attn/wq`` is
``(n_layers, d_model, H*Dh)``), named with the path strings the JAX
package's ``path_str`` gives, once '.' is read as '/'.  The layout is not
cosmetic: the optimizer picks 8-bit or 32-bit state per leaf by its size
(a stacked norm scale is quantized, a per-layer one would not be) and cuts
blocks per leaf.

    model = init_model(cfg, generator, device="cuda")
    logits, metrics = forward(cfg, model, tokens)

The port builds the paper LM's flavour: stable embedding, LayerNorm or
RMSNorm, plain GELU MLP.  Not ported yet (ROADMAP A12, A14): the serving
path (caches, prefill, decode), gated MLPs, the baseline embedding, MoE,
recurrent and xLSTM blocks, frontends, sliding-window attention, parallel
blocks, biases, tied embeddings, rematerialization.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch import device as device_lib
from repro_torch.errors import ConfigError
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
        cfg = self.cfg
        x = emb.apply_embedding(self.embed.table, self.embed.norm, tokens,
                                cfg)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        blk = getattr(self.blocks, BLOCK)
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
        for i in range(cfg.n_layers):
            h = layers.apply_norm(n1s[i], n1b[i], x, cfg.norm_type)
            x = x + layers.apply_attention(wq[i], wk[i], wv[i], wo[i], h, cfg,
                                           positions=positions)
            h2 = layers.apply_norm(n2s[i], n2b[i], x, cfg.norm_type)
            x = x + layers.apply_mlp(w_in[i], w_out[i], h2)
        fn = self.final_norm
        x = layers.apply_norm(fn.scale, getattr(fn, "bias", None), x,
                              cfg.norm_type)
        return emb.apply_head(self.head.w, x), {}


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
