"""Host-side anomaly detectors over the numerics sentinel (mirrors
``repro.telemetry.sentinel``).

The *device* half of the sentinel is in the fused-update kernel (B3(e)):
with ``OptimConfig.sentinel=True`` every fused update also writes an
``(n_blocks, N_HEALTH)`` tile of counts — nonfinite grad/update elements,
nonfinite or overflowing absmax, requantized codes on a codebook edge —
counted in the same pass as the update, summed into one ``(N_HEALTH,)``
vector per step, which ``train/loop.py`` reports as ``sent_*`` metrics.
The *host* half is :class:`AnomalyDetector`: a per-step scan of those
metrics (plus loss and grad-norm trends and the qhealth probes' events)
that turns threshold crossings into ``anomaly`` events
(``export.EVENT_FIELDS["anomaly"]``).

Detectors and their reasons:

  * ``nonfinite_loss``   (fatal) — loss is NaN/inf; the step is garbage.
  * ``sentinel_nonfinite`` (fatal) — the kernels counted nonfinite grad
    or update elements; names the first offending slot in ``detail``.
  * ``absmax_overflow``  (error) — a block absmax crossed
    ``ABSMAX_OVERFLOW_THRESHOLD``; dequantize will soon give inf.
  * ``loss_spike``       (warn/error) — loss z-score over a trailing
    window crossed ``loss_z``; zero-variance windows score 0 (as
    ``tracing.StepTimer``).
  * ``gnorm_spike``      (warn/error) — grad norm jumped against the
    trailing median.  When the step's ``pclip_scale`` shows percentile
    clipping engaged (< 1), the spike was absorbed and stays a warning.
  * ``qhealth_saturation`` (warn/error) — a probed segment's element-level
    ``edge_code_fraction`` or ``absmax_drift`` crossed its threshold.
    Block-level ``saturation_fraction`` is deliberately NOT escalated:
    under absmax scaling every nonzero block's largest element lands on the
    top code by construction, so it sits near 1.0 on healthy runs.

Everything here is plain Python/NumPy over host scalars.
"""
from __future__ import annotations

import collections
from typing import List, Optional

import numpy as np

from repro_torch.kernels.fused_update import (  # noqa: F401
    ABSMAX_OVERFLOW_THRESHOLD, HEALTH_SLOTS, N_HEALTH)
from repro_torch.telemetry.export import ANOMALY_SEVERITIES, SCHEMA

# sentinel metric keys as they appear in the step metrics dict
_NONFINITE_SLOTS = tuple(s for s in HEALTH_SLOTS if s.startswith("nonfinite"))
_OVERFLOW_SLOTS = tuple(s for s in HEALTH_SLOTS
                        if s.startswith("absmax_overflow"))
_EDGE_SLOTS = tuple(s for s in HEALTH_SLOTS if s.startswith("edge_hits"))


def anomaly_event(step: int, reason: str, severity: str, value: float,
                  **extra) -> dict:
    """One schema-valid ``anomaly`` event."""
    if severity not in ANOMALY_SEVERITIES:
        raise ValueError(f"severity {severity!r} not in {ANOMALY_SEVERITIES}")
    ev = {"kind": "anomaly", "schema": SCHEMA, "step": int(step),
          "reason": reason, "severity": severity, "value": float(value)}
    ev.update(extra)
    return ev


class AnomalyDetector:
    """Scans per-step metrics for numeric-health escalations.

        det = AnomalyDetector()
        for ev in det.observe_step(step, metrics):
            reg.emit_event(ev)

    ``metrics`` is the train-step output dict (host scalars or 0-d
    tensors); the detector reads ``loss``, ``grad_norm``, optional
    ``pclip_scale`` and the ``sent_*`` sentinel counters when present.
    State is a pair of trailing windows (loss, gnorm) — O(window) memory.
    """

    def __init__(self, window: int = 20, loss_z: float = 6.0,
                 gnorm_factor: float = 10.0,
                 qhealth_edge: float = 0.25,
                 qhealth_drift: float = 10.0):
        self.window = int(window)
        self.loss_z = float(loss_z)
        self.gnorm_factor = float(gnorm_factor)
        self.qhealth_edge = float(qhealth_edge)
        self.qhealth_drift = float(qhealth_drift)
        self._loss = collections.deque(maxlen=self.window)
        self._gnorm = collections.deque(maxlen=self.window)
        self.anomalies: List[dict] = []

    def _emit(self, ev: dict) -> dict:
        self.anomalies.append(ev)
        return ev

    # ------------------------------------------------------------- steps
    def observe_step(self, step: int, metrics: dict) -> List[dict]:
        """Anomaly events for one step's metrics (possibly empty)."""
        out: List[dict] = []
        loss = float(metrics.get("loss", 0.0))
        gnorm = float(metrics.get("grad_norm", 0.0))
        pclip = metrics.get("pclip_scale")

        if not np.isfinite(loss):
            out.append(self._emit(anomaly_event(
                step, "nonfinite_loss", "fatal", loss,
                detail="loss is not finite; the step output is unusable")))

        # kernel-counted nonfinite elements: any count > 0 is fatal —
        # the quantized state now stores garbage for those blocks.
        nf_total, nf_first = 0.0, None
        for slot in _NONFINITE_SLOTS:
            v = float(metrics.get(f"sent_{slot}", 0.0))
            if v > 0 and nf_first is None:
                nf_first = slot
            nf_total += v
        if nf_total > 0:
            out.append(self._emit(anomaly_event(
                step, "sentinel_nonfinite", "fatal", nf_total,
                detail=f"first offending slot: {nf_first}")))

        ov_total = sum(float(metrics.get(f"sent_{s}", 0.0))
                       for s in _OVERFLOW_SLOTS)
        if ov_total > 0:
            out.append(self._emit(anomaly_event(
                step, "absmax_overflow", "error", ov_total,
                detail=f"block absmax > {ABSMAX_OVERFLOW_THRESHOLD:g}")))

        # trend detectors need a full window BEFORE this step
        if np.isfinite(loss) and len(self._loss) >= self.window:
            w = np.array(self._loss)
            std = float(w.std())
            z = (loss - float(w.mean())) / std if std > 0.0 else 0.0
            if z > self.loss_z:
                sev = "error" if z > 2 * self.loss_z else "warn"
                out.append(self._emit(anomaly_event(
                    step, "loss_spike", sev, z,
                    detail=f"loss {loss:.4g} vs trailing mean "
                           f"{float(w.mean()):.4g}")))
        if np.isfinite(gnorm) and len(self._gnorm) >= self.window:
            med = float(np.median(np.array(self._gnorm)))
            if med > 0 and gnorm > self.gnorm_factor * med:
                # percentile clip already engaged => the optimizer
                # absorbed the spike; keep it a warning.
                clipped = pclip is not None and float(pclip) < 1.0
                out.append(self._emit(anomaly_event(
                    step, "gnorm_spike", "warn" if clipped else "error",
                    gnorm / med,
                    detail=f"gnorm {gnorm:.4g} vs trailing median "
                           f"{med:.4g}" + (" (pclip engaged)"
                                           if clipped else ""))))
        if np.isfinite(loss):
            self._loss.append(loss)
        if np.isfinite(gnorm):
            self._gnorm.append(gnorm)
        return out

    # ----------------------------------------------------------- qhealth
    def observe_qhealth(self, events: list) -> List[dict]:
        """Escalate qhealth probe events whose element-level edge-code
        fraction or absmax drift crossed the detector thresholds.

        Block-level ``saturation_fraction`` is read but never escalated
        (see module docstring: it is ~1.0 by construction when healthy).
        """
        out: List[dict] = []
        for ev in events:
            if not isinstance(ev, dict) or ev.get("kind") != "qhealth":
                continue
            step = int(ev.get("step", -1))
            tgt = f"{ev.get('target')}/{ev.get('segment')}/{ev.get('slot')}"
            edge = float(ev.get("edge_code_fraction", 0.0))
            if edge > self.qhealth_edge:
                sev = "error" if edge > 2 * self.qhealth_edge else "warn"
                out.append(self._emit(anomaly_event(
                    step, "qhealth_saturation", sev, edge,
                    detail=f"{tgt} edge_code_fraction")))
            drift = float(ev.get("absmax_drift", 1.0))
            if drift > self.qhealth_drift:
                out.append(self._emit(anomaly_event(
                    step, "qhealth_saturation", "warn", drift,
                    detail=f"{tgt} absmax_drift")))
        return out

    # ----------------------------------------------------------- summary
    def worst_severity(self) -> Optional[str]:
        """Highest severity seen so far (None if clean)."""
        seen = {ev["severity"] for ev in self.anomalies}
        for sev in reversed(ANOMALY_SEVERITIES):
            if sev in seen:
                return sev
        return None
