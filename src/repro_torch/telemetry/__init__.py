"""Telemetry (mirrors ``repro.telemetry``): so far the typed metric
registry the serving engines count into; export, tracing, quantization
health, the sentinel and the flight recorder are ROADMAP A11."""
from repro_torch.telemetry.registry import MetricRegistry

__all__ = ["MetricRegistry"]
