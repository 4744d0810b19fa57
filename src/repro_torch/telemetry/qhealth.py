"""Quantization-health probes (mirrors ``repro.telemetry.qhealth``).

The paper's central risk is *silent* quantization failure: saturated
absmax blocks, dead codebook regions, state dynamics drifting outside the
dynamic map's precise range.  :class:`QHealthProbe` measures them from the
optimizer state on the host's probe schedule (``--telemetry-every``),
never inside the train step, so the step is unchanged with probing on or
off.

For every quantized segment — each ``QuantSegment`` of the pooled
``QuantArena`` (target "arena") and each per-leaf ``Quant8Leaf`` (target
"leaf": the per-leaf layout's leaves, Muon's matrix leaves), 8-bit or
bit-packed — and state slot (``m``/``r``):

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
    on the card), one round trip per segment.

Events come in the JAX package's order: the arena's segments for slot m,
then for slot r, then each per-leaf leaf's m and r.  Elements past a
segment's ``n`` (the block tail's padding) are masked out of every
fraction and histogram.  A partitioned arena is probed on its statistics
gathered out of its pieces (all-gathered on a process group), so it gives
the same events as the unpartitioned arena.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.lowbit import unwrap_codes
from repro_torch.core.lowbit.packing import unpack_codes
from repro_torch.core.optim.base import Quant8Leaf, flatten_to_blocks
from repro_torch.core.optim.blockopt import gathered_arena, leaf_order
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

    def _slot_events(self, target: str, slot: str, codes, absmax, segs,
                     step: int, masters=None) -> List[dict]:
        """Events of one state slot of an arena or a leaf.  ``segs``:
        ((path, block offset, n_blocks, n), ...); ``masters``: {path: f32
        (n_blocks, B) master blocks} for the round-trip sample."""
        qmap = self._qmaps[slot]
        raw, rbits, _ = unwrap_codes(codes)
        bits = rbits if rbits is not None else self._bits[slot]
        n_bins = int(qmap.shape[-1])
        c = unpack_codes(raw, bits).to(torch.uint8)       # (nb, B)
        bsz = c.shape[1]
        q = qmap.abs()
        edge = q >= q.max()
        events = []
        for path, off, nb, n in segs:
            nvb = max(min(-(-n // bsz), nb), 1)           # live blocks
            cs = c[off:off + nvb]
            # the live elements are the first n of the segment's blocks
            e = edge[cs.long()].reshape(-1)
            e[n:] = False
            counts = torch.stack([e.reshape(nvb, bsz).any(dim=1).sum(),
                                  e.sum()]).cpu().tolist()
            amean = float(absmax[off:off + nvb].mean())
            hist = np.bincount(cs.reshape(-1)[:n].cpu().numpy(),
                               minlength=n_bins)[:n_bins].astype(np.int64)
            ev = {
                "kind": "qhealth", "step": int(step), "target": target,
                "segment": path, "slot": slot, "bits": int(bits),
                "n_bins": n_bins, "n_blocks": int(nb),
                "saturation_fraction": _fraction(counts[0], nvb),
                "edge_code_fraction": _fraction(counts[1], max(n, 1)),
                "util_hist": hist.tolist(),
                "util_fraction": float(np.mean(hist > 0)),
                "absmax_mean": amean,
                "absmax_drift": self._drift((target, path, slot), amean),
            }
            if masters is not None and path in masters:
                blocks = masters[path][:self.sample_blocks].contiguous()
                ev["rms_error"] = self._roundtrip_rms(blocks, qmap, bits)
                ev["rms_sample_blocks"] = int(blocks.shape[0])
            events.append(ev)
        return events

    def probe(self, state, step: int = -1) -> List[dict]:
        """Health events for every quantized segment of ``state`` (an
        ``OptState``): the pooled arena's segments, then every per-leaf
        ``Quant8Leaf`` in the parameter tree's order."""
        events: List[dict] = []
        # a partitioned arena is probed on its statistics gathered (on a
        # group, all-gathered: every rank probes, and sees every segment)
        arena = gathered_arena(getattr(state, "arena", None))
        if arena is not None:
            segs = tuple((sg.path, sg.offset, sg.n_blocks, sg.n)
                         for sg in arena.segments)
            masters = {sg.path: arena.master[sg.offset:sg.offset
                                             + sg.n_blocks]
                       for sg in arena.segments}
            events += self._slot_events("arena", "m", arena.codes_m,
                                        arena.absmax_m, segs, step, masters)
            if arena.codes_r is not None:
                events += self._slot_events("arena", "r", arena.codes_r,
                                            arena.absmax_r, segs, step)
        cfg = self.opt.cfg
        for path in leaf_order(state.leaves):
            leaf = state.leaves[path]
            if not isinstance(leaf, Quant8Leaf):
                continue
            segs = ((path, 0, int(leaf.absmax_m.shape[0]), leaf.n),)
            # the master cut into its quantization blocks
            masters = {path: flatten_to_blocks(leaf.master.to(torch.float32),
                                               cfg.block_size,
                                               cfg.shard_multiple)}
            events += self._slot_events("leaf", "m", leaf.codes_m,
                                        leaf.absmax_m, segs, step, masters)
            if leaf.codes_r is not None:
                events += self._slot_events("leaf", "r", leaf.codes_r,
                                            leaf.absmax_r, segs, step)
        return events
