"""Embedding layers and the output head (mirrors ``repro.models.embedding``):
the paper's Stable Embedding Layer (§2.3) — Xavier-uniform init and a
LayerNorm after the lookup, with 32-bit optimizer states through the
optimizer's override on 'embed' paths — and the fairseq-style baseline
(N(0, 1/sqrt(d)) init, outputs scaled by sqrt(d), no norm; App C), the
untied or tied head, and the modality-frontend stubs (precomputed patch or
frame embeddings, projected and prepended to the token embeddings)."""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers
from repro_torch.models import constrain as constrain_lib
from repro_torch.models.constrain import constrain

# logical axes of each parameter (the JAX package's init specs)
EMBED_AXES = {"table": ("vocab", "embed")}
HEAD_AXES = {"w": ("embed", "vocab")}
FRONTEND_AXES = {"proj": ("embed", "embed_out")}


def apply_embedding(embed, tokens, cfg):
    """tokens (B, S) int -> (B, S, d) in the compute dtype.  ``embed``: the
    ``table`` and, for the stable embedding, its LayerNorm ``norm`` (with
    ``scale``/``bias``).  The table is cast to the compute dtype before the
    gather, as in the JAX package; the baseline embedding scales by
    sqrt(d_model) in f32 (the JAX package's product with an f32 numpy
    scalar) before the cast back."""
    dt = getattr(torch, cfg.compute_dtype)
    table = embed.table.to(dt)
    if constrain_lib.active() and constrain_lib.is_dtensor(table):
        # the table gathered whole (its vocab-parallel form, a masked
        # partial sum, fails in some DTensor versions), then the same
        # rows by the embedding op, whose backward DTensor can place
        table = constrain_lib.replicated(table)
        x = torch.nn.functional.embedding(tokens, table)
    else:
        x = table[tokens]
    if cfg.stable_embedding:
        x = layers.apply_norm(embed.norm.scale, embed.norm.bias, x,
                              "layernorm")
    else:
        x = x.to(torch.float32) * math.sqrt(cfg.d_model)
    return x.to(dt)


def apply_head(w, x, table=None):
    """Logits in f32 from compute-dtype operands: the product of two bf16
    values is exact in f32, so upcasting the rounded operands and
    multiplying in f32 is the JAX package's bf16 x bf16 -> f32 contraction
    (``preferred_element_type=f32``).  ``w`` is the head's (d, V) weight;
    with tied embeddings it is None and the embedding ``table`` (V, d),
    transposed, takes its place."""
    w = table.to(x.dtype).T if w is None else w.to(x.dtype)
    return constrain(x.to(torch.float32) @ w.to(torch.float32), "dp", None,
                     "tp")


def apply_frontend(proj, embeds, cfg):
    """embeds: (B, frontend_tokens, d_model) precomputed stub features ->
    their projection in the compute dtype."""
    dt = getattr(torch, cfg.compute_dtype)
    return embeds.to(dt) @ proj.to(dt)
