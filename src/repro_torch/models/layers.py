"""Transformer building blocks (mirrors ``repro.models.layers`` for the
dense train forward): norms, rotary embedding, causal attention, MLP.

Each function takes the parameters of one layer as tensors and keeps the
JAX package's casts: norms work in f32 and cast back, attention scores and
softmax are f32, projections run in the compute dtype.  The JAX package has
no Pallas kernel in its model, so plain PyTorch ops are its counterpart.
Attention is a plain masked softmax over the whole sequence (the JAX
package's chunked online softmax computes the same function; only the f32
summation order differs).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def apply_norm(scale, bias, x, norm_type: str, eps: float = 1e-6):
    """RMSNorm or LayerNorm in f32, cast back to x's dtype.  ``bias`` is
    None for RMSNorm."""
    x32 = x.to(torch.float32)
    if norm_type == "rmsnorm":
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(var + eps) * scale
    else:
        mu = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        out = (x32 - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq     # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_attention(q, k, v):
    """q: (B, S, H, D), k/v: (B, S, KV, D) with KV | H (GQA); f32 scores and
    softmax.  Returns (B, S, H, D) f32."""
    B, S, H, D = q.shape
    G = H // k.shape[2]                       # query heads per kv head
    qh = (q * (D ** -0.5)).to(torch.float32).transpose(1, 2)   # (B,H,S,D)
    kh, vh = k.to(torch.float32), v.to(torch.float32)
    if G > 1:
        kh, vh = kh.repeat_interleave(G, 2), vh.repeat_interleave(G, 2)
    kh, vh = kh.transpose(1, 2), vh.transpose(1, 2)
    scores = qh @ kh.transpose(-1, -2)                         # (B,H,S,S)
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ vh
    return out.transpose(1, 2)


def apply_attention(wq, wk, wv, wo, x, cfg, *, positions):
    """x: (B, S, d) in the compute dtype -> (B, S, d).  Train forward (no
    cache)."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ wq.to(dt)).reshape(B, S, H, Dh)
    k = (x @ wk.to(dt)).reshape(B, S, KV, Dh)
    v = (x @ wv.to(dt)).reshape(B, S, KV, Dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = causal_attention(q, k, v)
    return out.reshape(B, S, H * Dh).to(dt) @ wo.to(dt)


def apply_mlp(w_in, w_out, x):
    """The non-gated GELU MLP; ``jax.nn.gelu`` is the tanh approximation."""
    dt = x.dtype
    h = F.gelu(x @ w_in.to(dt), approximate="tanh")
    return h @ w_out.to(dt)
