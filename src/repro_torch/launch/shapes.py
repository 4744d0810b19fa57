"""The assigned input-shape set and its stand-in inputs (mirrors
``repro.launch.shapes``): no data is made.

LM shapes are seq_len x global_batch; decode_* / long_* run ``decode_step``
(one token against a seq_len cache), prefill_* run ``prefill``, train_*
one train step.  long_500k runs only for sub-quadratic archs
(cfg.subquadratic).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import model as M


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCase("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg, case: ShapeCase) -> tuple[bool, str]:
    if case.name == "long_500k" and not cfg.subquadratic:
        return False, "skipped(full-attention)"
    return True, ""


def input_specs(cfg, case: ShapeCase, device="meta") -> dict:
    """Stand-ins (tensors on ``device``, "meta" by default: shapes and
    dtypes only) for every model input of this cell: train {"tokens" (B,
    S - frontend + 1) int32, "embeds"}, prefill {"tokens", "embeds"},
    decode {"token" (B, 1) int32, "caches" (``init_cache``), "pos" 0-d
    int32}; "embeds" (B, frontend_tokens, d) in the compute dtype for a
    frontend stub."""
    B, S = case.global_batch, case.seq_len
    ft = cfg.frontend_tokens
    empty = lambda shape, dt: torch.empty(shape, dtype=dt, device=device)
    cdt = getattr(torch, cfg.compute_dtype)
    if case.kind in ("train", "prefill"):
        extra = 1 if case.kind == "train" else 0
        specs = {"tokens": empty((B, S - ft + extra), torch.int32)}
        if ft:
            specs["embeds"] = empty((B, ft, cfg.d_model), cdt)
        return specs
    if case.kind == "decode":
        return {"token": empty((B, 1), torch.int32),
                "caches": M.init_cache(cfg, B, S, device=device),
                "pos": empty((), torch.int32)}
    raise ValueError(case.kind)
