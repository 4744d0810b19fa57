"""Quantization-health probes (mirrors ``repro.telemetry.qhealth`` on the
per-leaf layout).

The paper's central risk is *silent* quantization failure: saturated
absmax blocks, dead codebook regions, state dynamics drifting outside the
dynamic map's precise range.  :class:`QHealthProbe` measures them from the
optimizer state on the host's probe schedule (``--telemetry-every``),
never inside the train step, so the step is unchanged with probing on or
off.

For every quantized leaf (``Quant8Leaf``: the element-wise leaves and Muon's
matrix leaves, 8-bit or bit-packed) and state slot (``m``/``r``):

  * ``saturation_fraction`` — fraction of the leaf's live blocks with at
    least one code on the codebook's edge, ``|qmap[c]| >= max|qmap|`` (the
    JAX package's definition; on the signed map that is the top code only,
    not the sentinel's ``c in {0, 2^bits - 1}``).
  * ``edge_code_fraction`` — the same at element granularity.
  * ``util_hist`` — codebook-utilization histogram (``2^bits`` bins),
    binned on the host with ``np.bincount`` from the unpacked codes;
    ``util_fraction`` = fraction of levels with a nonzero count.
  * ``absmax_mean`` and ``absmax_drift`` — mean block absmax and its ratio
    to a host-side EMA baseline (decay ``ema_decay``).
  * ``rms_error`` (slot m) — relative RMS error of one quantize ->
    dequantize round trip of the first ``sample_blocks`` blocks of the
    leaf's f32 master in the slot's format, through the kernel layer
    (``ops.quantize_blockwise`` / ``dequantize_blockwise``: kernels B1/B2
    on the card).

Elements past a leaf's ``n`` (the block tail's padding) are masked out of
every fraction and histogram.  The pooled arena's segments are ROADMAP A9:
a state that holds an arena raises :class:`ConfigError`.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.lowbit import unwrap_codes
from repro_torch.core.lowbit.packing import unpack_codes
from repro_torch.core.optim.base import Quant8Leaf, flatten_to_blocks
from repro_torch.core.optim.blockopt import leaf_order
from repro_torch.errors import ConfigError
from repro_torch.kernels import ops

DEFAULT_SAMPLE_BLOCKS = 32


def _fraction(count: int, total: int) -> float:
    """count / total divided in f32, as the JAX package's int32 / int
    quotient is."""
    return float(np.float32(count) / np.float32(total))


class QHealthProbe:
    """Scheduled quantization-health probe over one optimizer's state.

    One instance per run (it owns the absmax EMA baselines).
    ``probe(state, step)`` returns a list of "qhealth" event dicts ready
    for the telemetry sinks."""

    def __init__(self, opt, sample_blocks: int = DEFAULT_SAMPLE_BLOCKS,
                 ema_decay: float = 0.9):
        self.opt = opt
        self.sample_blocks = int(sample_blocks)
        self.ema_decay = float(ema_decay)
        self._ema: Dict[tuple, float] = {}
        self._qmaps = {"m": opt._qmap1, "r": opt._qmap2}
        self._bits = dict(zip(("m", "r"), opt.cfg.state_bits_pair))

    def _drift(self, key: tuple, mean: float) -> float:
        """Current/EMA absmax ratio; the EMA updates after the read, so the
        first probe reports drift 1.0."""
        ema = self._ema.get(key)
        drift = 1.0 if not ema else mean / ema
        d = self.ema_decay
        self._ema[key] = mean if ema is None else d * ema + (1 - d) * mean
        return drift

    def _roundtrip_rms(self, blocks: torch.Tensor, qmap: torch.Tensor,
                       bits: int) -> float:
        """Relative RMS error of one quantize -> dequantize round trip of
        f32 blocks in the codebook's format, through the kernel layer."""
        codes, absmax = ops.quantize_blockwise(blocks, qmap, bits=bits)
        deq = ops.dequantize_blockwise(codes, absmax, qmap, bits=bits)
        num = torch.sqrt(torch.mean(torch.square(blocks - deq)))
        den = torch.sqrt(torch.mean(torch.square(blocks)))
        return float(num / (den + 1e-12))

    def _slot_event(self, path: str, slot: str, codes, absmax, n: int,
                    step: int, master=None) -> dict:
        qmap = self._qmaps[slot]
        raw, rbits, _ = unwrap_codes(codes)
        bits = rbits if rbits is not None else self._bits[slot]
        n_bins = int(qmap.shape[-1])
        c = unpack_codes(raw, bits).to(torch.uint8)       # (nb, B)
        nb, bsz = c.shape
        nvb = max(min(-(-n // bsz), nb), 1)               # live blocks
        q = qmap.abs()
        # the live elements are the first n of the leaf's blocks
        e = (q >= q.max())[c[:nvb].long()].reshape(-1)
        e[n:] = False
        counts = torch.stack([e.reshape(nvb, bsz).any(dim=1).sum(),
                              e.sum()]).cpu().tolist()
        amean = float(absmax[:nvb].mean())
        codes_h = c.reshape(-1)[:n].cpu().numpy()
        hist = np.bincount(codes_h, minlength=n_bins)[:n_bins] \
            .astype(np.int64)
        ev = {
            "kind": "qhealth", "step": int(step), "target": "leaf",
            "segment": path, "slot": slot, "bits": int(bits),
            "n_bins": n_bins, "n_blocks": int(nb),
            "saturation_fraction": _fraction(counts[0], nvb),
            "edge_code_fraction": _fraction(counts[1], max(n, 1)),
            "util_hist": hist.tolist(),
            "util_fraction": float(np.mean(hist > 0)),
            "absmax_mean": amean,
            "absmax_drift": self._drift(("leaf", path, slot), amean),
        }
        if master is not None:
            cfg = self.opt.cfg
            blocks = flatten_to_blocks(master.to(torch.float32),
                                       cfg.block_size, cfg.shard_multiple)
            blocks = blocks[:self.sample_blocks].contiguous()
            ev["rms_error"] = self._roundtrip_rms(blocks, qmap, bits)
            ev["rms_sample_blocks"] = int(blocks.shape[0])
        return ev

    def probe(self, state, step: int = -1) -> List[dict]:
        """Health events for every quantized leaf of ``state`` (an
        ``OptState`` of the per-leaf engine), in the parameter tree's
        order: slot m, then slot r where the leaf has one."""
        if getattr(state, "arena", None) is not None:
            raise ConfigError("qhealth probes of the pooled arena are not "
                              "ported yet (ROADMAP A9)")
        events: List[dict] = []
        for path in leaf_order(state.leaves):
            leaf = state.leaves[path]
            if not isinstance(leaf, Quant8Leaf):
                continue
            events.append(self._slot_event(path, "m", leaf.codes_m,
                                           leaf.absmax_m, leaf.n, step,
                                           leaf.master))
            if leaf.codes_r is not None:
                events.append(self._slot_event(path, "r", leaf.codes_r,
                                               leaf.absmax_r, leaf.n, step))
        return events
