"""Device traces and the telemetry session.

`device_trace(dir)` wraps a region in `torch.profiler` (CPU activity,
and CUDA activity on a card run) and writes its Chrome/Perfetto trace,
`torch_trace.json`, into `dir`: every kernel launch of the region by
name, where the reference writes `jax.profiler` xplane files.  The
`tlm_*` ranges in such a trace come from `telemetry/spans.scope`, the
span primitive at every layer boundary (its rule 3): the reference's
`jax.named_scope` tags (`tlm_prologue`, `tlm_L{level}`, `tlm_em{em}`,
`tlm_assemble`, `tlm_match`, `tlm_render`, and below the match
`tlm_prep`, `tlm_sweep`, `tlm_merge`, `tlm_polish`, `tlm_kappa`,
`tlm_pixel`, `tlm_dist`) as `record_function` ranges.

`telemetry_session` is the CLI's wrapper: the device trace, a span
tracer with a fresh metrics registry, the flight recorder, the live
exporter (`--metrics-port`), and the end-of-run artifacts
(host_spans.json, metrics.json, metrics.prom, flight.json) in one
directory.  `utils/torch_trace.py` reads the trace back and
`telemetry/report.py` joins it with the host spans.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

from .torch_trace import TRACE_FILE


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str],
                 cuda: bool = False) -> Iterator[None]:
    """`torch.profiler` over the region when a directory is given (CUDA
    activity too when `cuda`), its trace written to
    `<trace_dir>/torch_trace.json` when the region ends; a no-op
    otherwise.  A CPU run passes cuda=False and never initialises
    CUDA."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


@contextlib.contextmanager
def telemetry_session(trace_dir: Optional[str], sink=None,
                      enabled: bool = True,
                      artifact_dir: Optional[str] = None,
                      cuda: bool = False,
                      metrics_port: Optional[int] = None,
                      flight_capacity: Optional[int] = None):
    """Device trace + span tracer + telemetry artifacts, as the
    reference's session.

    Yields a `telemetry.Tracer`, disabled when `enabled` is False (the
    run then pays nothing).  An enabled session owns a fresh metrics
    registry, installed as the process default for its duration, so
    `metrics.json` counts this run (the kernel wrappers book their
    launches and byte ledgers through `get_registry()`).  With an
    `artifact_dir` it also installs a flight recorder dumping to
    `<artifact_dir>/flight.json` (`flight_capacity` events, else
    IA_FLIGHT_RING, else 512).
    `metrics_port` (the CLI's `--metrics-port`; 0 = ephemeral) serves
    /metrics, /metrics.json, /healthz and /progress from the live
    exporter (telemetry/live.py) for the session, announced in
    `<artifact_dir>/live.json`.

    `trace_dir` takes the `torch.profiler` trace (`device_trace`); the
    CLI passes `--profile` there, so `--trace-dir` alone never takes
    one.  On exit (a crash included) it writes, each atomically, into
    `artifact_dir`:

      host_spans.json   the span tree (telemetry/spans.py schema)
      metrics.json      the registry's JSON exposition
      metrics.prom      the registry's Prometheus text exposition
      flight.json       the flight recorder's final dump
    """
    from ..telemetry import NULL_TRACER, MetricsRegistry, Tracer
    from ..telemetry.metrics import set_registry

    flight = live = None
    if enabled:
        reg = MetricsRegistry()
        tracer = Tracer(sink=sink, registry=reg)
        prev_reg = set_registry(reg)
    else:
        tracer = NULL_TRACER
        reg = prev_reg = None
    # The flight and live setup sit inside the try: a failed bind (a
    # fixed --metrics-port in use) unwinds the registry swap and the
    # recorder's handlers through the same finally as the run.
    try:
        if enabled and artifact_dir:
            from ..telemetry.flight import (
                install_for_session,
                resolve_ring_capacity,
            )

            flight = install_for_session(
                tracer, reg, artifact_dir,
                capacity=resolve_ring_capacity(flight_capacity))
            # The supervisor's handle for its watchdog and give-up
            # flushes, and the health epilogue's after teardown.
            tracer.flight_recorder = flight
        if enabled and metrics_port is not None:
            from ..telemetry.live import LiveTelemetryServer

            live = LiveTelemetryServer(tracer, reg, port=metrics_port,
                                       flight=flight).start()
            if artifact_dir:
                live.announce(artifact_dir)
        with device_trace(trace_dir, cuda=cuda):
            yield tracer
    finally:
        if live is not None:
            live.stop()
        if flight is not None:
            flight.uninstall()  # final flush, reason "session-end"
        if enabled:
            set_registry(prev_reg)
        if artifact_dir and tracer.enabled:
            from .io import atomic_write_json, atomic_write_text

            os.makedirs(artifact_dir, exist_ok=True)
            tracer.write(os.path.join(artifact_dir, "host_spans.json"))
            atomic_write_json(
                os.path.join(artifact_dir, "metrics.json"), reg.to_dict()
            )
            atomic_write_text(
                os.path.join(artifact_dir, "metrics.prom"),
                reg.to_prometheus(),
            )
