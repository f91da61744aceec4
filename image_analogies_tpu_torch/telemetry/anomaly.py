"""Live anomaly detection over the windowed time-series ring (with
telemetry/timeseries.py): the reference's module, copied over the
port's `MetricsRegistry` and `slo.py`, `fleet_watches` included.

The SLO engine (round 15) grades cumulative-since-boot traffic; these
watches grade the LAST FEW MINUTES, because the failure modes that
matter operationally are windowed by nature: a p99 regression right
now, an exec-cache miss storm (every request recompiling — the
amortization the persistent cache exists to provide has broken), a
queue pinned at its depth limit, runaway shape cardinality chewing
through compile budget.  Each watch grades `ok` / `firing` /
`no_data` — absence of traffic or of a committed baseline is stated,
never imputed — and the detector publishes one
`ia_anomaly_status{watch=...}` gauge per watch (1 firing, 0 ok,
-1 no_data) so the sentinel (`check_anomaly`) and `/healthz` see the
verdict without re-deriving it, and `/slo` attaches the full report.

Thresholds live in `AnomalyConfig`; the latency envelope is anchored
to a COMMITTED baseline (SERVE_r18.json `pipeline.p99_warm_ms`, wired
through `ia-synth serve --baseline`) rather than a self-referential
in-window mean, so a slow regression cannot drag its own threshold
along with it.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .metrics import MetricsRegistry, parse_label_str
from .slo import (REQUEST_DURATION_METRIC, _merge_cells,
                  quantile_from_cell)

ANOMALY_SCHEMA_VERSION = 1

ANOMALY_STATUS_GAUGE = "ia_anomaly_status"

# Gauge encoding (also the wire contract for sentinel.check_anomaly).
STATUS_VALUES = {"firing": 1.0, "ok": 0.0, "no_data": -1.0}


@dataclass(frozen=True)
class AnomalyConfig:
    """Watch thresholds.  `baseline_p99_ms` is the committed warm-path
    p99 (SERVE_r18 `pipeline.p99_warm_ms`); None disables the latency
    watch (it reports no_data, it does not invent an envelope)."""

    baseline_p99_ms: Optional[float] = None
    # Windowed p99 may exceed baseline x this multiple before firing.
    # Generous by design: the committed baseline is a steady-state
    # closed-loop number and a live window includes queueing.
    p99_envelope_mult: float = 10.0
    # Exec-cache miss fraction over the window above which we call a
    # compile storm, once at least `miss_min_dispatches` dispatches
    # are in-window (a cold daemon's first requests are all misses;
    # that is warmup, not an anomaly).
    miss_rate_max: float = 0.5
    miss_min_dispatches: int = 8
    # Queue depth as a fraction of max_queue_depth at/above which the
    # daemon is saturated (sustained, since the gauge is sampled at
    # ring ticks, not per-enqueue).
    queue_frac_max: float = 0.9
    # Distinct observed (shape, dtype, mesh) keys before cardinality
    # is a problem — matches the daemon's observed-shape LRU bound.
    shape_card_max: int = 24
    # Window the watches grade over (None = whole ring).
    window_s: Optional[float] = 300.0


def baseline_from_record(path: str) -> Optional[float]:
    """`pipeline.p99_warm_ms` out of a committed SERVE_r18-style
    record; None (never a guess) when the file or field is absent."""
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as fh:
            rec = json.load(fh)
        v = (rec.get("pipeline") or {}).get("p99_warm_ms")
        return float(v) if v is not None else None
    except (OSError, ValueError, TypeError):
        return None


class AnomalyDetector:
    """Grades the ring's current window against `AnomalyConfig`.

    `evaluate()` is cheap (one `ring.window()` + dict walks) and runs
    on every sampler tick via the ring's `on_tick` hook, then again on
    demand for `/slo`; both paths publish the status gauges."""

    WATCHES = ("latency_p99", "excache_miss_storm", "queue_saturation",
               "shape_cardinality")

    def __init__(self, ring, registry: MetricsRegistry,
                 config: Optional[AnomalyConfig] = None,
                 max_queue_depth: Optional[int] = None):
        self.ring = ring
        self.registry = registry
        self.config = config or AnomalyConfig()
        self.max_queue_depth = max_queue_depth
        self._g_status = registry.gauge(
            ANOMALY_STATUS_GAUGE,
            "live anomaly watch status (1 firing, 0 ok, -1 no_data)",
        )

    # -- individual watches -------------------------------------------
    def _watch_latency(self, window: Dict[str, Any]) -> Dict[str, Any]:
        cfg = self.config
        if cfg.baseline_p99_ms is None:
            return _watch("latency_p99", "no_data", None, None,
                          "no committed baseline (--baseline not set)")
        threshold = cfg.baseline_p99_ms * cfg.p99_envelope_mult
        if window.get("status") != "ok":
            return _watch("latency_p99", "no_data", None, threshold,
                          f"window status {window.get('status')}")
        cells = (window.get("histograms") or {}).get(
            REQUEST_DURATION_METRIC
        ) or {}
        merged = _merge_cells(cells, {"outcome": "ok"})
        p99 = quantile_from_cell(merged, 0.99)
        if p99 is None:
            return _watch("latency_p99", "no_data", None, threshold,
                          "no ok-outcome requests in window")
        status = "firing" if p99 > threshold else "ok"
        return _watch(
            "latency_p99", status, round(p99, 3), round(threshold, 3),
            f"windowed ok p99 {p99:.1f}ms vs envelope "
            f"{cfg.baseline_p99_ms:.1f}ms x {cfg.p99_envelope_mult:g}",
        )

    def _watch_miss_storm(self, window: Dict[str, Any]) -> Dict[str, Any]:
        cfg = self.config
        if window.get("status") != "ok":
            return _watch("excache_miss_storm", "no_data", None,
                          cfg.miss_rate_max,
                          f"window status {window.get('status')}")
        counters = window.get("counters") or {}

        def increase(name: str) -> float:
            # Client-kind dispatches only: a cold daemon's warmup
            # sweep is all misses by design, not a storm.
            total = 0.0
            for label_str, c in (counters.get(name) or {}).items():
                try:
                    labels = parse_label_str(label_str)
                except ValueError:
                    continue
                if labels.get("kind") not in (None, "client"):
                    continue
                total += float(c.get("increase") or 0.0)
            return total

        hits = increase("ia_serve_excache_hits_total")
        misses = increase("ia_serve_excache_misses_total")
        dispatches = hits + misses
        if dispatches < cfg.miss_min_dispatches:
            return _watch(
                "excache_miss_storm", "no_data", None, cfg.miss_rate_max,
                f"{dispatches:g} dispatches in window "
                f"(< {cfg.miss_min_dispatches} minimum)",
            )
        miss_rate = misses / dispatches
        status = "firing" if miss_rate > cfg.miss_rate_max else "ok"
        return _watch(
            "excache_miss_storm", status, round(miss_rate, 4),
            cfg.miss_rate_max,
            f"{misses:g}/{dispatches:g} dispatches missed the "
            f"executable cache in window",
        )

    def _watch_queue(self, window: Dict[str, Any]) -> Dict[str, Any]:
        cfg = self.config
        if not self.max_queue_depth:
            return _watch("queue_saturation", "no_data", None, None,
                          "max_queue_depth unknown")
        threshold = cfg.queue_frac_max * self.max_queue_depth
        if window.get("status") == "no_data":
            return _watch("queue_saturation", "no_data", None, threshold,
                          "window status no_data")
        cells = (window.get("gauges") or {}).get(
            "ia_serve_queue_depth"
        ) or {}
        if not cells:
            return _watch("queue_saturation", "no_data", None, threshold,
                          "queue-depth gauge not yet published")
        depth = max(float(c.get("value", 0.0)) for c in cells.values())
        status = "firing" if depth >= threshold else "ok"
        return _watch(
            "queue_saturation", status, depth, threshold,
            f"queue depth {depth:g} of {self.max_queue_depth} "
            f"(threshold {cfg.queue_frac_max:g} full)",
        )

    def _watch_shape_card(self, window: Dict[str, Any]) -> Dict[str, Any]:
        cfg = self.config
        if window.get("status") == "no_data":
            return _watch("shape_cardinality", "no_data", None,
                          cfg.shape_card_max, "window status no_data")
        cells = (window.get("gauges") or {}).get(
            "ia_serve_shape_cardinality"
        ) or {}
        if not cells:
            return _watch("shape_cardinality", "no_data", None,
                          cfg.shape_card_max,
                          "shape-cardinality gauge not yet published")
        # Round 20: the gauge splits into view=raw / view=bucketed
        # cells once the daemon publishes them.  The watch grades the
        # BUCKETED series — post-lattice cardinality is what actually
        # spends compile budget, and with the lattice off the daemon
        # keeps bucketed == raw, so the watch's round-19 meaning is
        # unchanged.  Older unlabeled-only registries fall back to the
        # first cell, exactly as before.
        cell = None
        for label_str, c in cells.items():
            try:
                labels = parse_label_str(label_str)
            except ValueError:
                continue
            if labels.get("view") == "bucketed":
                cell = c
                break
        view = "bucketed" if cell is not None else "observed"
        if cell is None:
            cell = next(iter(cells.values()))
        card = float(cell.get("value", 0.0))
        grew = cell.get("delta")
        status = "firing" if card >= cfg.shape_card_max else "ok"
        return _watch(
            "shape_cardinality", status, card, cfg.shape_card_max,
            f"{card:g} distinct {view} shapes"
            + (f" (+{grew:g} in window)" if grew else ""),
        )

    # -- evaluation ---------------------------------------------------
    def evaluate(self, window: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
        """One pass over every watch; publishes the status gauges and
        returns the `/slo`-attachable report."""
        if window is None:
            window = self.ring.window(self.config.window_s)
        watches: List[Dict[str, Any]] = [
            self._watch_latency(window),
            self._watch_miss_storm(window),
            self._watch_queue(window),
            self._watch_shape_card(window),
        ]
        for w in watches:
            self._g_status.set(
                STATUS_VALUES[w["status"]], labels={"watch": w["watch"]}
            )
        firing = [w["watch"] for w in watches if w["status"] == "firing"]
        return {
            "schema_version": ANOMALY_SCHEMA_VERSION,
            "kind": "anomaly",
            "window_s": self.config.window_s,
            "window_status": window.get("status"),
            "watches": watches,
            "firing": firing,
            "verdict": "firing" if firing else (
                "ok" if any(w["status"] == "ok" for w in watches)
                else "no_data"
            ),
        }


def _watch(name: str, status: str, observed, threshold,
           detail: str) -> Dict[str, Any]:
    return {"watch": name, "status": status, "observed": observed,
            "threshold": threshold, "detail": detail}


# Router-path thresholds (round 22).  Cumulative fractions, graded
# like the SLO's lifetime window: retries are a normal transient
# during drains, so the retry ceiling is generous; ANY sustained
# unrouted traffic is an incident; a drain migration that takes
# longer than the replica's own request timeout means sessions are
# repaying cold starts.
ROUTE_RETRY_RATE_MAX = 0.2
ROUTE_UNROUTED_FRAC_MAX = 0.05
ROUTE_MIGRATION_P99_MAX_MS = 30000.0


def _counter_sum(metrics: Dict[str, Any], name: str) -> float:
    vals = (metrics.get(name) or {}).get("values") or {}
    return float(sum(v for v in vals.values()
                     if isinstance(v, (int, float))))


def _histogram_merged(metrics: Dict[str, Any],
                      name: str) -> Optional[Dict[str, Any]]:
    """All of one histogram family's cells pooled bucket-by-bucket
    (same arithmetic the observatory uses), or None when silent."""
    vals = (metrics.get(name) or {}).get("values") or {}
    merged: Optional[Dict[str, Any]] = None
    for cell in vals.values():
        if not isinstance(cell, dict):
            continue
        if merged is None:
            merged = {"count": 0, "sum": 0.0,
                      "buckets": dict.fromkeys(
                          cell.get("buckets") or {}, 0)}
        merged["count"] += int(cell.get("count") or 0)
        merged["sum"] += float(cell.get("sum") or 0.0)
        for b, c in (cell.get("buckets") or {}).items():
            merged["buckets"][b] = merged["buckets"].get(b, 0) + c
    return merged


def _router_path_watches(metrics: Dict[str, Any]
                         ) -> List[Dict[str, Any]]:
    """Round-22 router-path watches over the router's own serialized
    registry: retry rate, unroutable 503s, and drain-migration
    latency.  Each grades `no_data` (never fires, never imputes) until
    its family has traffic."""
    from .slo import ROUTE_DURATION_METRIC, quantile_from_cell

    watches: List[Dict[str, Any]] = []
    dur = _histogram_merged(metrics, ROUTE_DURATION_METRIC)
    requests = float(dur["count"]) if dur else 0.0
    retries = _counter_sum(metrics, "ia_route_retries_total")
    if requests <= 0:
        watches.append(_watch(
            "route_retry_rate", "no_data", None, ROUTE_RETRY_RATE_MAX,
            "no routed requests yet"))
    else:
        rate = retries / requests
        watches.append(_watch(
            "route_retry_rate",
            "firing" if rate > ROUTE_RETRY_RATE_MAX else "ok",
            round(rate, 4), ROUTE_RETRY_RATE_MAX,
            f"{int(retries)} retries over {int(requests)} routed "
            "request(s)"))
    unrouted = _counter_sum(metrics, "ia_route_unrouted_total")
    if requests <= 0 and unrouted <= 0:
        watches.append(_watch(
            "route_unrouted", "no_data", None,
            ROUTE_UNROUTED_FRAC_MAX, "no routed requests yet"))
    else:
        frac = unrouted / max(1.0, requests + unrouted)
        watches.append(_watch(
            "route_unrouted",
            "firing" if (unrouted > 0
                         and frac > ROUTE_UNROUTED_FRAC_MAX)
            else "ok",
            round(frac, 4), ROUTE_UNROUTED_FRAC_MAX,
            f"{int(unrouted)} unrouted 503(s) against "
            f"{int(requests)} routed request(s)"))
    mig = _histogram_merged(metrics, "ia_route_migration_ms")
    if not mig or not mig["count"]:
        watches.append(_watch(
            "route_migration_latency", "no_data", None,
            ROUTE_MIGRATION_P99_MAX_MS, "no drain migrations yet"))
    else:
        p99 = quantile_from_cell(mig, 0.99)
        watches.append(_watch(
            "route_migration_latency",
            "firing" if (p99 is not None
                         and p99 > ROUTE_MIGRATION_P99_MAX_MS)
            else "ok",
            p99, ROUTE_MIGRATION_P99_MAX_MS,
            f"p99 over {mig['count']} drain migration(s)"))
    return watches


def fleet_watches(replicas: List[Dict[str, Any]],
                  registry: Optional[MetricsRegistry] = None
                  ) -> Dict[str, Any]:
    """Round 21 router-side watches, graded over the fleet router's
    replica table (ReplicaHandle snapshots) rather than a time-series
    ring — the router has no synthesis metrics of its own; what can go
    wrong AT the router is membership-shaped: a replica that stopped
    answering the poller without being drained (`replica_down`), and
    the terminal case of zero routable replicas (`fleet_unroutable`).
    Round 22 adds the router-PATH watches (retry rate, unroutable
    503s, migration latency) graded from the router's own registry
    when one is provided.  Same report shape as
    AnomalyDetector.evaluate, same status gauge, so `ia-synth obs`
    and the sentinel read router anomalies through the exact
    machinery that reads replica anomalies."""
    watches: List[Dict[str, Any]] = []
    if not replicas:
        watches.append(_watch("replica_down", "no_data", None, 0,
                              "no replicas registered"))
        watches.append(_watch("fleet_unroutable", "no_data", None, 1,
                              "no replicas registered"))
    else:
        down = [r["name"] for r in replicas
                if not r.get("alive") and not r.get("draining")]
        watches.append(_watch(
            "replica_down", "firing" if down else "ok", len(down), 0,
            ("replicas down without drain: " + ", ".join(down))
            if down else f"{len(replicas)} replica(s) answering",
        ))
        routable = sum(
            1 for r in replicas
            if r.get("alive") and not r.get("draining")
        )
        watches.append(_watch(
            "fleet_unroutable", "ok" if routable else "firing",
            routable, 1,
            f"{routable} live non-draining replica(s)",
        ))
    if registry is not None:
        watches.extend(_router_path_watches(registry.to_dict()))
        g = registry.gauge(
            ANOMALY_STATUS_GAUGE,
            "live anomaly watch status (1 firing, 0 ok, -1 no_data)",
        )
        for w in watches:
            g.set(STATUS_VALUES[w["status"]],
                  labels={"watch": w["watch"]})
    firing = [w["watch"] for w in watches if w["status"] == "firing"]
    return {
        "schema_version": ANOMALY_SCHEMA_VERSION,
        "kind": "anomaly",
        "window_s": None,
        "window_status": "ok" if replicas else "no_data",
        "watches": watches,
        "firing": firing,
        "verdict": "firing" if firing else (
            "ok" if replicas else "no_data"
        ),
    }
