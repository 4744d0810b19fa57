"""Observability for the port's 8-bit stack (mirrors ``repro.telemetry``).

  * :mod:`~repro_torch.telemetry.qhealth` — scheduled quantization-health
    probes (saturation, codebook utilization, absmax drift, round-trip
    RMS);
  * :mod:`~repro_torch.telemetry.tracing` — step-phase annotations,
    dispatch accounting and the shared ``StepTimer`` (ms/step and
    compile_s);
  * :mod:`~repro_torch.telemetry.registry` /
    :mod:`~repro_torch.telemetry.export` — typed metrics and the JSONL /
    in-memory / trajectory sinks behind them, in the JAX package's schema;
  * :mod:`~repro_torch.telemetry.sentinel` /
    :mod:`~repro_torch.telemetry.flight` — the numerics sentinel's host
    detectors and the flight recorder's forensic dump, inspected with
    ``python -m repro_torch.telemetry.inspect``.

All of it is off by default and adds nothing to the train step when off.
"""
from repro_torch.telemetry.export import (ANOMALY_SEVERITIES, BenchJsonSink,
                                          InMemorySink, JsonlSink, SCHEMA,
                                          append_json_trajectory,
                                          validate_event, validate_jsonl)
from repro_torch.telemetry.flight import (FLIGHT_SCHEMA, FlightRecorder,
                                          config_hash, load_dump,
                                          restore_state)
from repro_torch.telemetry.qhealth import QHealthProbe
from repro_torch.telemetry.registry import MetricRegistry
from repro_torch.telemetry.sentinel import (AnomalyDetector, HEALTH_SLOTS,
                                            anomaly_event)
from repro_torch.telemetry.tracing import (StepTimer, annotate,
                                           drain_phase_events, host_phase,
                                           phase_tracing,
                                           phase_tracing_enabled,
                                           reset_trace_events,
                                           set_phase_tracing,
                                           trace_event_dict, trace_events)

__all__ = [
    "SCHEMA", "BenchJsonSink", "InMemorySink", "JsonlSink",
    "append_json_trajectory", "validate_event", "validate_jsonl",
    "ANOMALY_SEVERITIES", "AnomalyDetector", "HEALTH_SLOTS",
    "anomaly_event", "FLIGHT_SCHEMA", "FlightRecorder", "config_hash",
    "load_dump", "restore_state",
    "QHealthProbe", "MetricRegistry", "StepTimer", "annotate",
    "drain_phase_events", "host_phase", "phase_tracing",
    "phase_tracing_enabled", "reset_trace_events", "set_phase_tracing",
    "trace_event_dict", "trace_events",
]
