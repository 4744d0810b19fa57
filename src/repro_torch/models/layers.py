"""Transformer building blocks (mirrors ``repro.models.layers`` for the
attention family): norms, rotary embedding, GQA attention with optional
q/k/v biases and a sliding window, the plain GELU and the gated SiLU MLP,
and the serving caches' attention: prefill into a dense cache (a ring of
``min(max_len, window)`` rows under sliding-window attention), contiguous
decode (16-bit or block-wise int8 rows) and paged decode over the
quantized page pool.

Each function takes the parameters of one layer as a dict of tensors (the
JAX package's leaf names) and keeps the JAX package's casts: norms work in
f32 and cast back, attention scores and softmax are f32, projections run
in the compute dtype.  The JAX package has no Pallas kernel in its model,
so plain PyTorch ops are its counterpart; the paged decode's
gather-dequant is kernel B7 (``kernels/paged_kv.py``).  Train and
prefill attention is the JAX package's online softmax over KV chunks of
``cfg.attn_chunk`` keys, in its chunk order and with its ``-inf`` guards
(when one chunk holds every key, the softmax, the same function), each
chunk recomputed in the backward (``torch.utils.checkpoint``, the
counterpart of its ``jax.checkpoint``): no score tensor outlives its
chunk.  The model draws no random numbers, so its checkpoints do not
save and restore the RNG state (which costs more host time than a small
chunk's ops).  Caches are dicts of tensors, updated in place: the counterpart
of the JAX package's donated caches.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import paged_kv
from repro_torch.models import constrain as constrain_lib
from repro_torch.models.constrain import constrain, head_split

# logical axes of each parameter (the JAX package's init specs), by leaf name
NORM_AXES = {"scale": ("embed",), "bias": ("embed",)}
ATTN_AXES = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
             "wv": ("embed", "kv_heads"), "wo": ("heads", "embed"),
             "bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",)}
MLP_AXES = {"w_gate": ("embed", "mlp"), "w_in": ("embed", "mlp"),
            "w_out": ("mlp", "embed")}


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


def _chunk_scores(qh, k_c, q_pos, kv0: int, window: int):
    """(masked f32 scores (B, KV, G, S, C), mask (S, C)) of queries ``qh``
    (B, KV, G, S, D) at ``q_pos`` against the chunk ``k_c`` (B, C, KV, D)
    of keys from position ``kv0``: causal, and within ``window`` keys
    when it is > 0."""
    kv_pos = kv0 + torch.arange(k_c.shape[1], device=qh.device)
    scores = torch.einsum("bkgsd,bckd->bkgsc", qh, k_c.to(torch.float32))
    mask = q_pos[:, None] >= kv_pos[None, :]                     # causal
    if window > 0:
        mask &= (q_pos[:, None] - kv_pos[None, :]) < window      # SWA
    return scores.masked_fill(~mask, float("-inf")), mask


def _online_attention(qh, k, v, q_pos, window: int, chunk: int):
    """The online softmax over the KV chunks of ``chunk`` keys (k/v
    padded to a multiple): f32 running max, denominator and accumulator
    with the JAX package's two ``-inf`` guards, each chunk under a
    non-reentrant checkpoint when gradients are on.  Returns (B, KV, G, S,
    D)."""
    def body(m_run, d_run, acc, k_c, v_c, kv0: int):
        scores, mask = _chunk_scores(qh, k_c, q_pos, kv0, window)
        m_new = torch.maximum(m_run, scores.amax(dim=-1))
        # rows with no valid key yet keep m = -inf: exp(-inf - -inf) guard
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(scores - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.where(torch.isinf(m_run), 0.0,
                           torch.exp(m_run - m_safe))
        d_new = d_run * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgsc,bckd->bkgsd", p, v_c.to(torch.float32))
        return m_new, d_new, acc * corr[..., None] + pv

    f32 = dict(dtype=torch.float32, device=qh.device)
    carry = (torch.full(qh.shape[:4], float("-inf"), **f32),
             torch.zeros(qh.shape[:4], **f32), torch.zeros(qh.shape, **f32))
    for kv0 in range(0, k.shape[1], chunk):
        piece = (k[:, kv0:kv0 + chunk], v[:, kv0:kv0 + chunk], kv0)
        if torch.is_grad_enabled():
            carry = checkpoint(body, *carry, *piece, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            carry = body(*carry, *piece)
    _, d_f, acc = carry
    return acc / d_f[..., None].clamp_min(1e-30)


def _softmax_attention(qh, k, v, q_pos, window: int):
    """One chunk holding every key: the online softmax's single step is
    the softmax (every causal row holds its own key, so no row is wholly
    masked), computed by ``torch.softmax``'s fused forward and backward in
    fewer launches than that step's (``scripts/attn_turns.py`` times the
    two), under a non-reentrant checkpoint when gradients are on.
    Returns (B, KV, G, S, D)."""
    def body(k, v):
        scores, _ = _chunk_scores(qh, k, q_pos, 0, window)
        return torch.einsum("bkgsc,bckd->bkgsd", torch.softmax(scores, -1),
                            v.to(torch.float32))

    if torch.is_grad_enabled():
        return checkpoint(body, k, v, use_reentrant=False,
                          preserve_rng_state=False)
    return body(k, v)


def causal_attention(q, k, v, window: int = 0, q_offset: int = 0,
                     chunk: int = 1024):
    """Causal attention over KV chunks of ``chunk`` keys (the JAX
    package's ``_chunked_causal_attention``).  q: (B, S, H, D), k/v: (B,
    Sk, KV, D) with KV | H (GQA), grouped as (B, KV, G, S, D) without
    copying k or v; f32 scores and softmax.  Query i sits at position
    ``q_offset + i`` (a query-row split's rows; ``q_offset + S <= Sk``),
    key j at j.  ``window > 0`` also masks keys ``window`` or more
    positions back (sliding-window attention).  The keys are padded to a
    multiple of ``min(chunk, Sk)`` (the padded keys lie after every query
    and are masked as causal) and attended by the online softmax
    (:func:`_online_attention`), or by the softmax when one chunk holds
    them all (:func:`_softmax_attention`: the same function).  No
    (S, Sk) score tensor outlives its chunk: with gradients on, each
    chunk's scores are recomputed in the backward.  Returns (B, S, H, D)
    f32."""
    B, S, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV                               # query heads per kv head
    chunk = int(min(chunk, Sk))
    pad = -Sk % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qh = (q.reshape(B, S, KV, G, D) * (D ** -0.5)).to(torch.float32)
    qh = qh.permute(0, 2, 3, 1, 4)                        # (B, KV, G, S, D)
    q_pos = q_offset + torch.arange(S, device=q.device)
    if chunk == Sk:
        out = _softmax_attention(qh, k, v, q_pos, window)
    else:
        out = _online_attention(qh, k, v, q_pos, window, chunk)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


def attention(q, k, v, window: int = 0, chunk: int = 1024):
    """:func:`causal_attention` over KV chunks of ``chunk`` keys; under
    activation sharding (DTensor inputs) each device runs it on its own
    share, as the JAX package's
    score constraints (``constrain.attention_dims``) lay it out: its batch
    rows and heads, or its batch rows and query rows against every key.
    The keys' gradient is then a partial sum over the devices that share
    them, summed where DTensor needs it."""
    if not (constrain_lib.active() and constrain_lib.is_dtensor(q)):
        return causal_attention(q, k, v, window, chunk=chunk)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    qd, kd = constrain_lib.attention_dims(k.shape[2], q.shape[2] // k.shape[2],
                                          q.shape[1])
    q = constrain_lib.place(q, *qd)
    k, v = constrain_lib.place(k, *kd), constrain_lib.place(v, *kd)
    grad = [Partial() if isinstance(pk, Replicate) and
            not isinstance(pq, Replicate) else pk
            for pq, pk in zip(q.placements, k.placements)]
    out = causal_attention(q.to_local(), k.to_local(grad_placements=grad),
                           v.to_local(grad_placements=grad), window,
                           q_offset=constrain_lib.shard_offset(q, 1),
                           chunk=chunk)
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False)


# ------------------------------------------------- int8 KV cache (extension)
# The paper's block-wise quantizer applied to the contiguous KV cache (block
# = one head row of Dh values, absmax per (position, head)); enabled by
# cfg.kv_cache_bits == 8.  The k-bit row quantizer lives in
# kernels/paged_kv.py, shared with the paged serving cache.

def kv_quantize(x, bits: int = 8):
    """x: (..., Dh) -> (codes uint8 (..., Dh*bits/8), absmax f32 (...,))."""
    return paged_kv.quantize_rows(x, bits)


def kv_dequantize(codes, absmax, dtype, bits: int = 8):
    return paged_kv.dequantize_rows(codes, absmax, dtype, bits)


# ------------------------------------------------ paged KV serving context

@dataclasses.dataclass
class PagedContext:
    """Per-decode-step paged-cache context.

    page_table: (n_slots, max_pages_per_seq) int32 — physical page per
                logical page; -1 = unallocated (gathered, then masked).
    positions : (n_slots,) int32 — index of the token decoded this step
                per slot; -1 = inactive slot (its append is dropped and its
                attention masks every key).
    impl      : gather-dequant implementation ("cuda" the kernel B7,
                "torch" its plain version).
    """

    page_table: torch.Tensor
    positions: torch.Tensor
    impl: str = "cuda"


# ----------------------------------------------------------------- attention

def _decode_attention(q, k_cache, v_cache, cache_len: int):
    """Single-position attention over a contiguous cache.

    q: (B, 1, H, D); k/v_cache: (B, eff, KV, D).  Slots [0, min(cache_len,
    eff)) are valid (the current token's kv is already written).  Under
    activation sharding with the kv heads on the tp axis, each device
    attends with its own batch rows and heads; otherwise (a cache sharded
    on its sequence) DTensor distributes the products and the softmax."""
    KV = k_cache.shape[2]
    if constrain_lib.active() and constrain_lib.is_dtensor(q) and \
            constrain_lib.kv_groups_local(KV):
        from torch.distributed.tensor import DTensor
        dims = ("dp", None, "tp", None)
        q, k_cache, v_cache = (constrain_lib.place(t, *dims)
                               for t in (q, k_cache, v_cache))
        out = _decode_attention(q.to_local(), k_cache.to_local(),
                                v_cache.to_local(), cache_len)
        return DTensor.from_local(out, q.device_mesh, q.placements,
                                  run_check=False)
    B, _, H, D = q.shape
    G = H // KV
    eff = k_cache.shape[1]
    q = constrain_lib.kv_groups(q, KV)
    qh = (q.reshape(B, KV, G, D) * (D ** -0.5)).to(torch.float32)
    scores = torch.einsum("bkgd,bckd->bkgc", qh, k_cache.to(torch.float32))
    mask = torch.arange(eff, device=q.device) < min(cache_len, eff)
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, D)


def _masked_decode_attention(q, k, v, valid):
    """Single-position attention with a per-slot validity mask.

    q: (B, 1, H, D); k/v: (B, L, KV, D); valid: (B, L) bool.  Masked
    scores are the f32 minimum (not -inf), the denominator is clamped at
    1e-30, and an all-False row (inactive slot) gives zeros, not NaN."""
    B, _, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    q = constrain_lib.kv_groups(q, KV)
    qh = (q.reshape(B, KV, G, D) * (D ** -0.5)).to(torch.float32)
    scores = torch.einsum("bkgd,bckd->bkgc", qh, k.to(torch.float32))
    m = valid[:, None, None, :]
    scores = torch.where(m, scores, torch.finfo(torch.float32).min)
    smax = scores.amax(dim=-1, keepdim=True)
    p = torch.where(m, torch.exp(scores - smax), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgc,bckd->bkgd", p / denom, v.to(torch.float32))
    return out.reshape(B, 1, H, D)


def _paged_decode_attention(q, k, v, cfg, cache, paged: PagedContext):
    """Paged-KV decode: quantize-on-append the new k/v rows into each
    slot's current page (in place), then gather-dequant every table page
    and attend under the per-slot length (and sliding-window) mask.

    cache: {"k_codes": (n_pages, page, KV, W), "k_absmax": (n_pages, page,
    KV), "v_codes", "v_absmax"}; q/k/v: (B, 1, {H|KV}, Dh).
    Returns (out (B, 1, H, Dh), cache)."""
    n_pages, page = cache["k_codes"].shape[:2]
    bits = paged_kv.bits_of(cfg.head_dim, cache["k_codes"].shape[-1])
    pos = paged.positions
    active = pos >= 0
    pos_c = pos.clamp_min(0).long()
    B = pos.shape[0]
    # destination (physical page, offset) of this step's row per slot;
    # inactive slots point out of range, so the append drops them
    ppage = paged.page_table[torch.arange(B, device=pos.device),
                             pos_c // page].long()
    ppage = torch.where(active & (ppage >= 0), ppage, n_pages)
    off = pos_c % page
    for name, row in (("k", k), ("v", v)):
        paged_kv.append_rows(cache[f"{name}_codes"], cache[f"{name}_absmax"],
                             row[:, 0], ppage, off, bits)
    k_all, v_all = (paged_kv.gather_pages(
        cache[f"{name}_codes"], cache[f"{name}_absmax"], paged.page_table,
        bits=bits, dtype=q.dtype, impl=paged.impl) for name in ("k", "v"))
    idx = torch.arange(k_all.shape[1], device=pos.device)[None, :]
    valid = active[:, None] & (idx <= pos_c[:, None])
    if cfg.attn_type == "swa" and cfg.window:
        valid &= idx > (pos_c[:, None] - cfg.window)
    return _masked_decode_attention(q, k_all, v_all, valid), cache


def _write_prefill_cache(buf, new):
    """Store S new rows into a cache buffer of physical size eff in place,
    position p at slot p % eff (full attention: eff >= S unless the caller
    asked for a shorter cache, which keeps the last eff rows)."""
    S, eff = new.shape[1], buf.shape[1]
    new = new.to(buf.dtype)
    if S >= eff:
        last, shift = new[:, S - eff:], (S - eff) % eff
        # (a roll by 0 is the rows themselves; DTensor has no rule for it)
        buf.copy_(torch.roll(last, shift, dims=1) if shift else last)
    else:
        constrain_lib.write_rows(buf, 0, new)


def apply_attention(p, x, cfg, *, positions, cache=None, cache_len=None,
                    paged=None):
    """x: (B, S, d) in the compute dtype; ``p``: {wq, wk, wv, wo} and, with
    ``cfg.qkv_bias``, {bq, bk, bv}.

    cache=None           -> train forward, no state io.
    cache given, S == 1  -> decode: write kv at slot (cache_len - 1) % eff
                            (16-bit or int8 rows); with ``paged`` (a
                            PagedContext) the cache is the shared quantized
                            page pool and per-slot positions and page
                            tables drive append + attend.
    cache given, S > 1   -> prefill: causal attention + bulk cache fill.
    Train and prefill attend in KV chunks of ``cfg.attn_chunk`` (the
    online softmax of :func:`causal_attention`), as the JAX package does.
    Caches are updated in place.  Returns (out (B, S, d), cache)."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q, k, v = (x @ p[f"w{n}"].to(dt) for n in "qkv")
    if cfg.qkv_bias:
        q, k, v = (t + p[f"b{n}"].to(dt) for t, n in zip((q, k, v), "qkv"))
    q = head_split(q, H)
    k, v = head_split(k, KV), head_split(v, KV)
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, KV, Dh)
    v = v.reshape(B, S, KV, Dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    window = cfg.window if cfg.attn_type == "swa" else 0
    quant_cache = cache is not None and "k_codes" in cache
    if paged is not None and cache is not None and S == 1:
        out, cache = _paged_decode_attention(q, k, v, cfg, cache, paged)
    elif cache is None or S > 1:
        out = attention(q, k, v, window=window, chunk=cfg.attn_chunk)
        if quant_cache:
            for name, rows in (("k", k), ("v", v)):
                codes, absmax = kv_quantize(rows)
                _write_prefill_cache(cache[f"{name}_codes"], codes)
                _write_prefill_cache(cache[f"{name}_absmax"], absmax)
        elif cache is not None:
            _write_prefill_cache(cache["k"], k)
            _write_prefill_cache(cache["v"], v)
    else:
        name0 = "k_codes" if quant_cache else "k"
        idx = (cache_len - 1) % cache[name0].shape[1]
        if quant_cache:
            for name, row in (("k", k), ("v", v)):
                codes, absmax = kv_quantize(row)     # (B,1,KV,D)/(B,1,KV)
                constrain_lib.write_rows(cache[f"{name}_codes"], idx, codes)
                constrain_lib.write_rows(cache[f"{name}_absmax"], idx, absmax)
            k_cache, v_cache = (kv_dequantize(
                cache[f"{name}_codes"], cache[f"{name}_absmax"], dt)
                for name in ("k", "v"))
        else:
            constrain_lib.write_rows(cache["k"], idx, k.to(cache["k"].dtype))
            constrain_lib.write_rows(cache["v"], idx, v.to(cache["v"].dtype))
            k_cache, v_cache = cache["k"], cache["v"]
        out = _decode_attention(q, k_cache, v_cache, cache_len)
    out = constrain(out.reshape(B, S, H * Dh).to(dt), "dp", None, "tp")
    return out @ p["wo"].to(dt), cache


def apply_mlp(p, x, cfg):
    """The gated SiLU MLP ``silu(x @ w_gate) * (x @ w_in)`` with
    ``cfg.gated_mlp``, else the GELU MLP (``jax.nn.gelu`` is the tanh
    approximation); then ``@ w_out``."""
    dt = x.dtype
    if cfg.gated_mlp:
        h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_in"].to(dt))
    else:
        h = F.gelu(x @ p["w_in"].to(dt), approximate="tanh")
    h = constrain(h, "dp", None, "tp")
    return h @ p["w_out"].to(dt)
