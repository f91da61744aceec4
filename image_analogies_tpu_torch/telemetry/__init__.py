"""Telemetry of the port: the reference's layer, as far as it is ported.

- `spans`   — hierarchical host span tracing (`Span`, `Tracer`), free
  when disabled, emitting the JSONL event stream as its view;
- `metrics` — counters, gauges and histograms with JSON and Prometheus
  text exposition (`MetricsRegistry`, `get_registry`);
- `flight`  — the bounded flight recorder flushed to flight.json on
  SIGTERM / SIGINT / exit / watchdog / give-up / violation;
- `sentinel` — the run sentinel: expected-vs-observed verdicts
  (health.json), its byte ledgers priced by the port's kernels;
- `slo`     — the serving SLO engine the sentinel's `check_slo` grades
  with;
- `live`    — the in-process HTTP exporter (/metrics, /metrics.json,
  /healthz, /progress);
- `report`  — host spans joined with the `torch.profiler` trace
  (report.json; the trace reader is `utils/torch_trace.py`).

- `timeseries` — the windowed ring of registry snapshots the serving
  daemon's `/obs/window` serves;
- `anomaly` — the live watches over that ring (`ia_anomaly_status`).

Still to port (ROADMAP Queue 1 step 13b): the telemetry archive.
"""

from .flight import FLIGHT_FILE, FlightRecorder
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    reset_registry,
    set_registry,
)
from .spans import NULL_TRACER, SCHEMA_VERSION, Span, Tracer, as_tracer

__all__ = [
    "Counter",
    "FLIGHT_FILE",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "SCHEMA_VERSION",
    "Span",
    "Tracer",
    "as_tracer",
    "get_registry",
    "reset_registry",
    "set_registry",
]
