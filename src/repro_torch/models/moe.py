"""Mixture-of-Experts FFN (mirrors ``repro.models.moe``): token-choice top-k
routing with a sort-and-scatter dispatch under a per-expert capacity, a
grouped expert FFN and an f32 combine.

The router runs in f32: softmax, top-k, gates renormalised over the chosen
k; the Switch load-balancing loss ``E * sum_e(mean_prob_e *
top1_frac_e)`` and the router z-loss ``mean(logsumexp(logits)^2)`` come
back as metrics with the dropped fraction.  The T*k assignments are
sorted by expert with a **stable** sort (token order kept within an
expert, as ``jnp.argsort(stable=True)``), so the tokens past ``capacity =
max(1, T*k*capacity_factor // E)`` that an expert drops are the JAX
package's, at training and at decode (where T is the slot count).  The
dispatch buffer is (E, capacity, d): no (T, E, C) one-hot.  Plain PyTorch
ops, as the JAX package has no kernel here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.analysis import contracts as _contracts
from repro_torch.models.constrain import constrain, replicated

# logical axes of each parameter (the JAX package's init specs)
MOE_AXES = {"router": ("embed", "unsharded"),
            "w_gate": ("expert", "embed", "mlp"),
            "w_in": ("expert", "embed", "mlp"),
            "w_out": ("expert", "mlp", "embed")}


def apply_moe(p, x, cfg):
    """x: (B, S, d); ``p``: {router (d, E), w_gate, w_in (E, d, f), w_out
    (E, f, d)}.  Returns (out (B, S, d) in x's dtype, metrics) with the
    metrics ``moe_aux_loss``, ``moe_z_loss``, ``moe_drop_frac`` (0-d f32)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    dt = x.dtype
    T = B * S
    # the routing and the sort-and-scatter dispatch have no sharded form:
    # under activation sharding they run on every token, replicated
    xf = replicated(x.reshape(T, d))

    # ---- routing (f32) ----
    logits = xf.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                        # (T, E)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)         # (T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    me = probs.mean(dim=0)
    ce = F.one_hot(expert_ids[:, 0], E).to(torch.float32).mean(dim=0)
    aux_loss = E * (me * ce).sum()
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()

    # ---- sort/scatter dispatch with capacity ----
    capacity = int(max(1, int(T * k * cfg.capacity_factor // E)))
    flat_expert = expert_ids.reshape(-1)                         # (T*k,)
    flat_gate = gate_vals.reshape(-1)
    flat_tok = torch.arange(T, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)
    se, st, sg = flat_expert[order], flat_tok[order], flat_gate[order]
    # bincount(minlength=E) with its shape known before the data: the
    # same counts, and a trace on shapes alone can follow it
    counts = torch.zeros(E, dtype=torch.long, device=x.device).index_add(
        0, flat_expert, torch.ones_like(flat_expert))            # (E,)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=x.device) - starts[se]      # slot
    keep = pos < capacity
    pos_c = torch.where(keep, pos, 0)
    src = torch.where(keep[:, None], xf[st], 0).to(dt)
    buf = torch.zeros(E, capacity, d, dtype=dt, device=x.device) \
        .index_put((se, pos_c), src, accumulate=True)
    # experts on 'tp' when divisible (kimi), else capacity rows on 'dp'
    buf = constrain(buf, "tp", "dp", None)

    # ---- expert FFN (grouped products) ----
    if cfg.gated_mlp:
        h = F.silu(torch.bmm(buf, p["w_gate"].to(dt))) \
            * torch.bmm(buf, p["w_in"].to(dt))
    else:
        h = F.gelu(torch.bmm(buf, p["w_in"].to(dt)), approximate="tanh")
    h = constrain(h, "tp", "dp", None)
    out_buf = constrain(torch.bmm(h, p["w_out"].to(dt)),         # (E, C, d)
                        "tp", "dp", None)

    # ---- combine (f32) ----
    gathered = torch.where(keep[:, None], out_buf[se, pos_c], 0)
    contrib = gathered.to(torch.float32) * sg[:, None]
    out = torch.zeros(T, d, dtype=torch.float32, device=x.device) \
        .index_add(0, st, replicated(contrib))
    # 1 - kept / (T*k) as XLA evaluates the JAX package's 1 - mean(keep):
    # the kept count times the f32 reciprocal of T*k, subtracted from 1
    # with one rounding (a fused multiply-add; exact in f64, then rounded;
    # the float64 stays inside the no_f64 contracts' named exempt scope)
    inv = torch.tensor(1.0 / keep.numel(), dtype=torch.float32)
    with _contracts.exempt("f64", "moe_drop_frac"):
        drop = (1.0 - keep.sum().double() * inv.double()).float()
    metrics = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
               "moe_drop_frac": drop}
    return out.reshape(B, S, d).to(dt), metrics
