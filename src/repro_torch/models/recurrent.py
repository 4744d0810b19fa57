"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427;
mirrors ``repro.models.recurrent``).

Block: x -> [linear -> causal depthwise conv1d -> RG-LRU] * gelu(linear) ->
linear.  The RG-LRU recurrence:

    r_t = sigmoid(W_a u_t + b_a)        (recurrence gate)
    i_t = sigmoid(W_x u_t + b_x)        (input gate)
    a_t = exp(-c * softplus(lam) * r_t) (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Decode state is O(1): the dict ``{"h": (B, W) f32, "conv": (B, cw-1, W)
f32}`` (the conv's last cw-1 inputs).  As in the JAX package, the gate
projections are full matrices (Griffin's are block-diagonal).  The scan is
``scan_utils.checkpointed_scan``, plain PyTorch like the JAX package's
``lax.scan``: no kernel of the TPU package computes it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.scan_utils import checkpointed_scan

_C = 8.0

# logical axes of each parameter (the JAX package's init specs)
RGLRU_AXES = {"w_rec_in": ("embed", "lru"), "w_gate_in": ("embed", "lru"),
              "conv_w": ("unsharded", "lru"), "w_a": ("lru", "lru_out"),
              "b_a": ("lru",), "w_x": ("lru", "lru_out"), "b_x": ("lru",),
              "lam": ("lru",), "w_out": ("lru", "embed")}


def init_rglru_block(cfg, lead: tuple, dev, dt) -> dict:
    """The block's parameters, uninitialized, each with the leading dims
    ``lead``; ``init_rglru_values`` fills them."""
    d, W, cw = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.conv_width
    e = lambda *s: torch.empty(lead + s, device=dev, dtype=dt)
    return dict(w_rec_in=e(d, W), w_gate_in=e(d, W), conv_w=e(cw, W),
                w_a=e(W, W), b_a=e(W), w_x=e(W, W), b_x=e(W), lam=e(W),
                w_out=e(W, d))


def init_rglru_values(p, cfg, draw, uniform) -> None:
    """Fill the parameters of ``init_rglru_block`` with the JAX package's
    initializers: N(0, 1/fan_in) matrices (the conv 1/sqrt(cw), w_out
    1/sqrt(W)), zero biases, and ``lam`` = softplus^-1(-log(a0) / 8) with
    a0 ~ U[0.9, 0.999], so that a = exp(-8 softplus(lam)) starts in
    [0.9, 0.999].  ``draw(shape)``: standard normal; ``uniform(shape)``:
    U[0, 1)."""
    d, W, cw = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.conv_width
    scales = dict(w_rec_in=d, w_gate_in=d, conv_w=cw, w_a=W, w_x=W, w_out=W)
    for name, fan in scales.items():
        t = getattr(p, name)
        t.copy_(draw(t.shape) / math.sqrt(fan))
    p.b_a.zero_()
    p.b_x.zero_()
    a0 = 0.9 + 0.099 * uniform(p.lam.shape)
    p.lam.copy_(torch.log(torch.expm1(-torch.log(a0) / _C)))


def _conv1d_causal(u, w, tail=None):
    """Depthwise causal conv. u: (B, S, W), w: (cw, W).  ``tail``: (B,
    cw-1, W) previous inputs for decode.  Returns (out, new_tail)."""
    cw = w.shape[0]
    if tail is None:
        tail = u.new_zeros((u.shape[0], cw - 1, u.shape[2]))
    ext = torch.cat([tail, u], dim=1)                  # (B, S+cw-1, W)
    S = u.shape[1]
    out = ext[:, 0:S] * w[0]
    for i in range(1, cw):                             # JAX's sum() order
        out = out + ext[:, i:i + S] * w[i]
    new_tail = ext[:, -(cw - 1):] if cw > 1 else tail
    return out, new_tail


def _rglru_scan(p, u, h0):
    """u: (B, S, W) f32; h0: (B, W).  Returns (y (B, S, W), h_final)."""
    f32 = lambda name: p[name].to(torch.float32)       # JAX's promotion
    log_a_coef = -_C * F.softplus(f32("lam"))          # (W,), negative
    r = torch.sigmoid(u @ f32("w_a") + f32("b_a"))     # (B, S, W)
    i = torch.sigmoid(u @ f32("w_x") + f32("b_x"))
    a = torch.exp(log_a_coef * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u)

    def step(h, inp):
        a_t, x_t = inp
        h = a_t * h + x_t
        return h, h

    tm = lambda x: x.transpose(0, 1).contiguous()      # time-major
    hT, ys = checkpointed_scan(step, h0, (tm(a), tm(gated)))
    return ys.transpose(0, 1), hT


def apply_rglru_block(p, x, cfg, *, state=None):
    """x: (B, S, d).  state: None (train / prefill from scratch) or the
    dict {h: (B, W), conv: (B, cw-1, W)}.  Returns (out, new_state)."""
    dt = x.dtype
    B = x.shape[0]
    W = cfg.lru_width or cfg.d_model
    u = (x @ p["w_rec_in"].to(dt)).to(torch.float32)
    gate = x @ p["w_gate_in"].to(dt)
    tail = state["conv"] if state is not None else None
    u, new_tail = _conv1d_causal(u, p["conv_w"].to(torch.float32), tail)
    h0 = state["h"] if state is not None else \
        torch.zeros((B, W), dtype=torch.float32, device=x.device)
    y, hT = _rglru_scan(p, u, h0)
    out = (F.gelu(gate.to(torch.float32), approximate="tanh") * y).to(dt)
    out = out @ p["w_out"].to(dt)
    return out, {"h": hT, "conv": new_tail}
