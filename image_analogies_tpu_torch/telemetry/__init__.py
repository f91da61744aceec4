"""Telemetry of the port: the reference's layer, as far as it is ported.

- `spans`   — hierarchical host span tracing (`Span`, `Tracer`), free
  when disabled, emitting the JSONL event stream as its view;
- `metrics` — counters, gauges and histograms with JSON and Prometheus
  text exposition (`MetricsRegistry`, `get_registry`);
- `flight`  — the bounded flight recorder flushed to flight.json on
  SIGTERM / SIGINT / exit / watchdog / give-up.

Still to port (ROADMAP Queue 1): the run sentinel, the live exporter,
the report joiner and the device-trace reader.
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
