"""Embedding and output head (mirrors ``repro.models.embedding``): the
paper's Stable Embedding Layer (§2.3) — Xavier-uniform init and a LayerNorm
after the lookup, with 32-bit optimizer states through the optimizer's
override on 'embed' paths.  The baseline scaled embedding is ROADMAP A14."""
from __future__ import annotations

import torch

from repro_torch.models import layers


def apply_embedding(table, norm, tokens, cfg):
    """tokens (B, S) int -> (B, S, d) in the compute dtype.  The table is
    cast to the compute dtype before the gather, as in the JAX package;
    ``norm`` (with ``scale``/``bias``) is the stable embedding's
    LayerNorm."""
    dt = getattr(torch, cfg.compute_dtype)
    x = table.to(dt)[tokens]
    return layers.apply_norm(norm.scale, norm.bias, x, "layernorm").to(dt)


def apply_head(w, x):
    """Logits in f32 from compute-dtype operands: the product of two bf16
    values is exact in f32, so upcasting the rounded operands and
    multiplying in f32 is the JAX package's bf16 x bf16 -> f32 contraction
    (``preferred_element_type=f32``)."""
    return x.to(torch.float32) @ w.to(x.dtype).to(torch.float32)
