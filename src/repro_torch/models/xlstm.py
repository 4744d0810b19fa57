"""xLSTM blocks (arXiv:2405.04517; mirrors ``repro.models.xlstm``): mLSTM
(matrix memory, exponential gating) and sLSTM (scalar memory, recurrent
gates), both with the paper's stabilizer state m that keeps the
exponential gates bounded.

Decode state is O(1) per layer, the JAX package's tuples: mLSTM ``(C (B,
H, D, D), n (B, H, D), m (B, H))``, sLSTM ``(c, n, h, m)``, each (B, d).
sLSTM's m starts at -inf.  The blocks carry their own up and down
projections (``d_ff`` is 0 in xlstm-350m): mLSTM a proj factor 2 with a
SiLU gate branch, sLSTM a GELU MLP of factor 4/3.  The per-head
block-diagonal projections (mLSTM's wq/wk/wv/wo_gate (H, D, D), sLSTM's
recurrent r_zifo (H, 4, Dh, Dh)) run as batched matmuls over the heads.
The scans are ``scan_utils.checkpointed_scan`` in plain PyTorch, as the
JAX package's are ``lax.scan``: no kernel of the TPU package computes
them.  A time step is a few small launches, so the loops are host-bound:
what does not depend on the recurrent state is computed for every step
at once, before or after the loop.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.scan_utils import checkpointed_scan

# logical axes of each parameter (the JAX package's init specs); the two
# cells share the names w_up and w_down with the same axes
_HEAD_MAT = ("heads", "unsharded", "head_out")
MLSTM_AXES = {"w_up": ("embed", "mlp"), "w_gate": ("embed", "mlp"),
              "wq": _HEAD_MAT, "wk": _HEAD_MAT, "wv": _HEAD_MAT,
              "w_if": ("mlp", "unsharded"), "b_i": ("unsharded",),
              "b_f": ("unsharded",), "wo_gate": _HEAD_MAT,
              "w_down": ("mlp", "embed")}
SLSTM_AXES = {"w_zifo": ("embed", "mlp"),
              "r_zifo": ("heads", "unsharded", "unsharded", "unsharded"),
              "b_zifo": ("mlp",), "w_up": ("embed", "mlp"),
              "w_down": ("mlp", "embed")}


# ------------------------------------------------------------------- mLSTM

def init_mlstm_block(cfg, lead: tuple, dev, dt) -> dict:
    """The mLSTM block's parameters, uninitialized, with leading dims
    ``lead``; ``init_mlstm_values`` fills them."""
    d, H = cfg.d_model, cfg.n_heads
    W = int(d * cfg.mlstm_proj_factor)
    D = W // H
    e = lambda *s: torch.empty(lead + s, device=dev, dtype=dt)
    return dict(w_up=e(d, W), w_gate=e(d, W), wq=e(H, D, D), wk=e(H, D, D),
                wv=e(H, D, D), w_if=e(W, 2 * H), b_i=e(H), b_f=e(H),
                wo_gate=e(H, D, D), w_down=e(W, d))


def init_mlstm_values(p, cfg, draw) -> None:
    """The JAX package's initializers: w_up / w_gate N(0, 1/d), the
    per-head projections N(0, 1/D), w_if N(0, 0.02^2), w_down N(0, 1/W);
    the input gate's bias -10 (closed), the forget gate's 3 (open)."""
    d, H = cfg.d_model, cfg.n_heads
    W = int(d * cfg.mlstm_proj_factor)
    D = W // H
    scales = dict(w_up=1 / math.sqrt(d), w_gate=1 / math.sqrt(d),
                  wq=1 / math.sqrt(D), wk=1 / math.sqrt(D),
                  wv=1 / math.sqrt(D), w_if=0.02, wo_gate=1 / math.sqrt(D),
                  w_down=1 / math.sqrt(W))
    for name, scale in scales.items():
        t = getattr(p, name)
        t.copy_(draw(t.shape) * scale)
    p.b_i.fill_(-10.0)
    p.b_f.fill_(3.0)


def _heads(uh, w):
    """einsum('bshd,hde->bshe', uh, w) as a matmul batched over heads."""
    return (uh.transpose(1, 2) @ w).transpose(1, 2)


class _RunningMax(torch.autograd.Function):
    """``torch.cummax(g, 0).values`` with a backward of its own.
    ``cummax``'s gradient is a scatter-add, whose atomics add in a varying
    order on the card, so two runs' gradients would differ.  Here each
    step s that holds the running max gets the sum of the output's
    gradient over the steps whose max it is: those form one run, from s
    to the last t with argmax s (the argmax never decreases), summed by a
    segmented suffix scan in log2(T) element-wise passes, in a fixed
    order.  No tensor is larger than the input: memory O(T), time
    O(T log T)."""

    @staticmethod
    def forward(ctx, g):
        values, arg = torch.cummax(g, dim=0)
        ctx.save_for_backward(arg)
        return values

    @staticmethod
    def backward(ctx, grad):
        arg, = ctx.saved_tensors
        T = arg.shape[0]
        acc, d = grad, 1
        while d < T:    # after the pass, acc[t] sums the run over [t, t+2d)
            same = arg[d:] == arg[:-d]
            acc = torch.cat([acc[:-d] + torch.where(same, acc[d:], 0.0),
                             acc[-d:]])
            d *= 2
        steps = torch.arange(T, device=arg.device).view(
            (T,) + (1,) * (arg.dim() - 1))
        return torch.where(arg == steps, acc, 0.0)


def _stabilizer(log_i, log_f, m0):
    """The stabilizer of every step at once, (T, B, H): the recurrence
    ``m_t = max(log_f_t + m_{t-1}, log_i_t)`` from ``m0`` unrolls to
    ``m_t = F_t + max(m0, max_{s<=t}(log_i_s - F_s))`` with ``F_t`` the
    cumulative sum of log_f (the running max by :class:`_RunningMax`)."""
    F = torch.cumsum(log_f, dim=0)
    return F + torch.maximum(_RunningMax.apply(log_i - F), m0)


def _mlstm_scan(q, k, v, log_i, log_f, state):
    """q/k/v: (B, S, H, D) f32; log_i/log_f: (B, S, H).  state: (C (B, H,
    D, D), n (B, H, D), m (B, H)).  Returns (h (B, S, H, D), state).

    Per step, as the JAX package's scan: m_t = max(log_f_t + m_{t-1},
    log_i_t), i' = exp(log_i_t - m_t), f' = exp(log_f_t + m_{t-1} - m_t),
    C_t = f' C_{t-1} + i' v_t k_t^T, n_t = f' n_{t-1} + i' k_t, h_t = C_t
    q_t / max(|n_t . q_t|, 1).  Only C and n are recurrent: m (a
    running max of the inputs, :func:`_stabilizer`), the gates, i' v_t and
    i' k_t are computed for every step at once, and the normalization of
    h after the loop, so a step is 5 ops (the loop is host-bound).  The
    stabilizer cancels from C_t = sum_s exp(log_i_s + sum_{s<r<=t} log_f_r
    - m_t) v_s k_s^T whatever the m_s, so the other summation order only
    moves rounding."""
    D = q.shape[-1]
    k = k / math.sqrt(D)
    C, n, m0 = state
    tm = lambda x: x.transpose(0, 1).contiguous()      # time-major
    q, k, v, log_i, log_f = (tm(x) for x in (q, k, v, log_i, log_f))
    m = _stabilizer(log_i, log_f, m0)
    m_prev = torch.cat([m0[None], m[:-1]])
    T, B, H = log_i.shape
    i_p = torch.exp(log_i - m)[..., None]              # (T, B, H, 1)
    f_p = torch.exp(log_f + m_prev - m).reshape(T, B * H, 1, 1)
    # columns (T, B*H, D, 1) and rows (T, B*H, 1, D): one batch of B*H heads
    iv = (i_p * v).reshape(T, B * H, D, 1)
    ik = (i_p * k).reshape(T, B * H, 1, D)
    k_row, q_col = k.reshape(T, B * H, 1, D), q.reshape(T, B * H, D, 1)

    def step(carry, inp):
        C, n = carry
        f_t, iv_t, ik_t, k_t, q_t = inp
        C = torch.mul(f_t, C).baddbmm_(iv_t, k_t)      # f C + (i v) k^T
        n = f_t * n + ik_t
        return (C, n), (torch.bmm(C, q_t), n)          # bhvk,bhk->bhv

    (C, n), (Cq, ns) = checkpointed_scan(
        step, (C.reshape(B * H, D, D), n.reshape(B * H, 1, D)),
        (f_p, iv, ik, k_row, q_col))
    denom = torch.clamp(torch.matmul(ns, q_col).abs(), min=1.0)
    h = (Cq / denom).reshape(T, B, H, D).transpose(0, 1)
    return h, (C.reshape(B, H, D, D), n.reshape(B, H, D), m[-1])


def apply_mlstm_block(p, x, cfg, *, state=None):
    """x: (B, S, d).  state: None or (C, n, m).  Returns (out, state)."""
    dt = x.dtype
    B, S, _ = x.shape
    H = cfg.n_heads
    W = p["w_up"].shape[1]
    D = W // H
    f32 = lambda name: p[name].to(torch.float32)       # JAX's promotion
    u = (x @ p["w_up"].to(dt)).to(torch.float32)
    gate = F.silu((x @ p["w_gate"].to(dt)).to(torch.float32))
    uh = u.reshape(B, S, H, D)
    q, k, v = (_heads(uh, f32(n)) for n in ("wq", "wk", "wv"))
    if_ = u @ f32("w_if")                              # (B, S, 2H)
    log_i = F.logsigmoid(if_[..., :H] + f32("b_i"))
    log_f = F.logsigmoid(if_[..., H:] + f32("b_f"))
    if state is None:
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=x.device)
        state = (z(B, H, D, D), z(B, H, D), z(B, H))
    h, state = _mlstm_scan(q, k, v, log_i, log_f, state)
    o = torch.sigmoid(_heads(uh, f32("wo_gate")))
    out = (o * h).reshape(B, S, W) * gate
    return out.to(dt) @ p["w_down"].to(dt), state


# ------------------------------------------------------------------- sLSTM

def init_slstm_block(cfg, lead: tuple, dev, dt) -> dict:
    """The sLSTM block's parameters, uninitialized, with leading dims
    ``lead``; ``init_slstm_values`` fills them."""
    d, H = cfg.d_model, cfg.n_heads
    f = int(d * cfg.slstm_proj_factor)
    e = lambda *s: torch.empty(lead + s, device=dev, dtype=dt)
    return dict(w_zifo=e(d, 4 * d), r_zifo=e(H, 4, d // H, d // H),
                b_zifo=e(4 * d), w_up=e(d, f), w_down=e(f, d))


def init_slstm_values(p, cfg, draw) -> None:
    """The JAX package's initializers: w_zifo / w_up N(0, 1/d), r_zifo
    N(0, H/d), w_down N(0, 1/f); b_zifo is 0 for z and o, -5 for i
    (mostly closed), 3 for f."""
    d, H = cfg.d_model, cfg.n_heads
    f = int(d * cfg.slstm_proj_factor)
    scales = dict(w_zifo=1 / math.sqrt(d), r_zifo=1 / math.sqrt(d // H),
                  w_up=1 / math.sqrt(d), w_down=1 / math.sqrt(f))
    for name, scale in scales.items():
        t = getattr(p, name)
        t.copy_(draw(t.shape) * scale)
    b = p.b_zifo.view(p.b_zifo.shape[:-1] + (4, d))
    for g, value in enumerate((0.0, -5.0, 3.0, 0.0)):
        b[..., g, :].fill_(value)


def apply_slstm_block(p, x, cfg, *, state=None):
    """sLSTM with the exponential input gate and the stabilizer (xLSTM
    eqs. 18-27).  x: (B, S, d); state: None or (c, n, h, m), each (B, d).
    Returns (out, state).

    The step runs head-major, (H, B, Dh) per state, so that one batched
    matmul of h with r_zifo ((H, Dh, 4 Dh): einsum 'bhk,hgkj->bghj') gives
    the four gates' recurrent inputs in the layout of the inputs' slice
    (the projected inputs are rearranged once, before the loop)."""
    dt = x.dtype
    B, S, d = x.shape
    H = cfg.n_heads
    Dh = d // H
    f32 = torch.float32
    zifo_in = (x @ p["w_zifo"].to(dt)).to(f32) + p["b_zifo"].to(f32)
    pre = zifo_in.reshape(B, S, 4, H, Dh).permute(1, 3, 0, 2, 4).reshape(
        S, H, B, 4 * Dh)                               # (S, H, B, 4 Dh)
    r = p["r_zifo"].to(f32).permute(0, 2, 1, 3).reshape(H, Dh, 4 * Dh)
    heads = lambda t: t.reshape(B, H, Dh).transpose(0, 1)
    zero = torch.zeros((), dtype=f32, device=x.device)
    if state is None:
        z0 = lambda: torch.zeros((H, B, Dh), dtype=f32, device=x.device)
        state = (z0(), z0(), z0(), torch.full((H, B, Dh), -math.inf,
                                              dtype=f32, device=x.device))
    else:
        state = tuple(heads(t) for t in state)

    def step(carry, pre_t):
        c, n, h, m = carry
        z_t, log_i, log_f, o_t = torch.baddbmm(pre_t, h, r).view(
            H, B, 4, Dh).unbind(2)                     # log_i: exponential
        z_t = torch.tanh(z_t)
        log_f = F.logsigmoid(log_f)
        o_t = torch.sigmoid(o_t)
        m_new = torch.maximum(log_f + m, log_i)
        # the JAX package's isinf guards: m_safe as there; where m is -inf
        # (the first step) exp(log_f + m - m_safe) is the guard's 0 itself,
        # with a zero gradient, so no operand of a torch.where carries an
        # inf or NaN into the gradient
        m_safe = torch.where(torch.isinf(m_new), zero, m_new)
        i_p = torch.exp(log_i - m_safe)
        f_p = torch.exp(log_f + m - m_safe)
        c = f_p * c + i_p * z_t
        n = f_p * n + i_p
        h = o_t * c / torch.clamp(n, min=1.0)
        return (c, n, h, m_new), h

    state, hs = checkpointed_scan(step, tuple(state), pre)
    y = hs.permute(2, 0, 1, 3).reshape(B, S, d).to(dt)    # (B, S, d)
    out = F.gelu(y @ p["w_up"].to(dt), approximate="tanh") \
        @ p["w_down"].to(dt)
    return out, tuple(t.transpose(0, 1).reshape(B, d) for t in state)
