"""Windowed time-series ring over a live metrics registry (with
telemetry/anomaly.py): the reference's module, copied over the port's
`MetricsRegistry` and `slo.py`.

Every number the registry exposes is cumulative-since-boot, which
cannot answer the operational questions a long-lived daemon gets asked
("did p99 regress in the last five minutes", "is a compile storm
happening NOW").  This module keeps a bounded ring of fixed-interval
registry snapshots and deltifies any requested window into RATES and
WINDOWED QUANTILES — the daemon serves it as `GET /obs/window?span=S`
and the multi-replica aggregator scrapes it per replica.

Semantics, stated once and tested (tests/test_observatory.py,
tests/test_torch_observatory.py):

  - Counter increase over a window is Prometheus `increase()`-shaped:
    `now - base` normally, and `now` when the cumulative value went
    BACKWARDS (a counter reset — journal replay, takeover, or a
    registry swap restarted the series; the post-reset cumulative
    value is the best lower bound on the window's true increase).
    Rates are therefore NEVER negative.
  - Histogram cells deltify per bucket with the same reset rule
    (detected on the cell's `count`); windowed quantiles come from
    `slo.quantile_from_cell` over the delta cell — byte-identical
    estimator to the cumulative path, applied to window traffic only.
  - Gauges are last-write-wins by nature: the window reports the
    newest snapshot's value plus the in-window delta (for growth
    watches), never a rate.
  - An EMPTY window (no snapshots yet, or none inside the span) is
    `status: "no_data"` with every section empty — absence is stated,
    never imputed.  A SINGLE-snapshot window has no base to delta
    against: `status: "single_snapshot"`, gauges report, counter/
    histogram increases and rates are null.

Memory bound: `capacity` snapshots x one `MetricsRegistry.to_dict()`
each.  A serving registry runs a few KB serialized, so the default
(120 snapshots @ 5 s interval = a 10-minute window) stays under ~1 MB;
the ring drops oldest-first beyond capacity.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .metrics import MetricsRegistry
from .slo import quantile_from_cell

OBS_WINDOW_SCHEMA_VERSION = 1

# Histogram quantiles the window view derives per delta cell — the
# same pair the registry's `_quantile` exposition families carry.
WINDOW_QUANTILES = (0.5, 0.99)


def counter_increase(now: float, base: float) -> Tuple[float, bool]:
    """(windowed increase, reset_detected) for one cumulative counter
    value pair — the Prometheus `increase()` rule: a cumulative value
    that moved backwards means the series restarted, and the current
    cumulative value IS the increase observed since (a lower bound;
    whatever the pre-reset process counted in-window is lost with it).
    Never negative."""
    now = float(now)
    base = float(base)
    if now < base:
        return max(0.0, now), True
    return now - base, False


def _subtract_hist_cell(now: Dict[str, Any],
                        base: Optional[Dict[str, Any]]
                        ) -> Tuple[Dict[str, Any], bool]:
    """Windowed delta of one serialized histogram cell
    (`{"count", "sum", "buckets": {bound: cum}}`), reset-aware on the
    cell's count: a count that went backwards deltifies against zero
    (the whole post-reset cell is the window's traffic)."""
    n_count = int(now.get("count", 0))
    b_count = int((base or {}).get("count", 0))
    reset = n_count < b_count
    if base is None or reset:
        cell = {
            "count": n_count,
            "sum": max(0.0, float(now.get("sum", 0.0))),
            "buckets": {
                b: int(c) for b, c in (now.get("buckets") or {}).items()
            },
        }
        return cell, reset
    pb = base.get("buckets") or {}
    return {
        "count": n_count - b_count,
        "sum": max(0.0, float(now.get("sum", 0.0))
                   - float(base.get("sum", 0.0))),
        "buckets": {
            b: max(0, int(c) - int(pb.get(b, 0)))
            for b, c in (now.get("buckets") or {}).items()
        },
    }, False


def compute_window(snapshots: List[Tuple[float, Dict[str, Any]]],
                   span_s: Optional[float] = None) -> Dict[str, Any]:
    """Deltify a list of (monotonic t, MetricsRegistry.to_dict())
    snapshots into one windowed view.

    The window is [base, newest] where base is the OLDEST snapshot no
    older than `span_s` before the newest (None = the whole ring).
    Pure function — the ring calls it under its lock with a copied
    list, and the edge-case tests drive it with hand-built snapshots
    (counter resets, empty, single-snapshot)."""
    out: Dict[str, Any] = {
        "schema_version": OBS_WINDOW_SCHEMA_VERSION,
        "kind": "obs_window",
        "requested_span_s": span_s,
        "snapshots": len(snapshots),
        "counters": {},
        "gauges": {},
        "histograms": {},
        "resets": 0,
    }
    if not snapshots:
        out.update(status="no_data", window_s=None)
        return out
    now_t, now = snapshots[-1]
    in_span = [
        (t, snap) for t, snap in snapshots
        if span_s is None or now_t - t <= span_s + 1e-9
    ]
    out["snapshots"] = len(in_span)
    base_t, base = in_span[0]
    window_s = now_t - base_t
    single = len(in_span) < 2 or window_s <= 0.0
    out.update(
        status="single_snapshot" if single else "ok",
        window_s=None if single else round(window_s, 3),
    )
    resets = 0
    for name, fam in sorted(now.items()):
        kind = fam.get("kind")
        values = fam.get("values") or {}
        base_vals = ((base.get(name) or {}).get("values") or {}) \
            if not single else {}
        if kind == "counter":
            cells = {}
            for label_str, v in sorted(values.items()):
                if single:
                    cells[label_str] = {
                        "cumulative": v, "increase": None,
                        "rate_per_s": None,
                    }
                    continue
                inc, reset = counter_increase(
                    v, base_vals.get(label_str, 0.0)
                )
                resets += int(reset)
                cells[label_str] = {
                    "cumulative": v,
                    "increase": round(inc, 6),
                    "rate_per_s": round(inc / window_s, 6),
                }
            out["counters"][name] = cells
        elif kind == "gauge":
            cells = {}
            for label_str, v in sorted(values.items()):
                prev = base_vals.get(label_str)
                cells[label_str] = {
                    "value": v,
                    "delta": (
                        None if single or prev is None
                        else round(float(v) - float(prev), 6)
                    ),
                }
            out["gauges"][name] = cells
        elif kind == "histogram":
            cells = {}
            for label_str, cell in sorted(values.items()):
                if single:
                    cells[label_str] = {
                        "count": None, "rate_per_s": None,
                        "sum": None, "buckets": None,
                        "p50": None, "p99": None,
                        "cumulative_count": int(cell.get("count", 0)),
                    }
                    continue
                delta, reset = _subtract_hist_cell(
                    cell, base_vals.get(label_str)
                )
                resets += int(reset)
                qs = {
                    f"p{int(q * 100)}": quantile_from_cell(delta, q)
                    for q in WINDOW_QUANTILES
                }
                cells[label_str] = {
                    "count": delta["count"],
                    "rate_per_s": round(
                        delta["count"] / window_s, 6
                    ),
                    "sum": round(delta["sum"], 6),
                    "buckets": delta["buckets"],
                    "cumulative_count": int(cell.get("count", 0)),
                    **qs,
                }
            out["histograms"][name] = cells
    out["resets"] = resets
    return out


class TimeSeriesRing:
    """Bounded ring of fixed-interval registry snapshots + the window
    view over them.

    `tick()` appends one (monotonic t, registry.to_dict()) pair —
    called by the daemon's sampler thread every `interval_s`, or
    directly by tests with an explicit `now`.  `window(span_s)` copies
    the ring under the lock and hands it to `compute_window`.  The
    sampler is a daemon thread owned by this object (`start_sampler`/
    `stop_sampler`); each tick optionally invokes `on_tick` (the
    serving daemon hangs its anomaly evaluation there so `/healthz`
    sees fresh watch gauges without a scrape-ordering dependency)."""

    def __init__(self, registry: MetricsRegistry,
                 interval_s: float = 5.0, capacity: int = 120,
                 generation: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1 ({capacity})")
        self.registry = registry
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        # Round-23 monotonic epoch stamp: every window view (and hence
        # every archived snapshot) carries the generation the ring was
        # in when it was cut.  `reset()` increments it, and a daemon
        # restarted with `--archive-dir` seeds PAST the archived value
        # (`seed_generation`), so an archive reader can tell an
        # in-process counter reset (same boot, generation bump) from a
        # restart (new boot id) — and generations never run backwards
        # across either.
        self.generation = int(generation)
        self._snaps: "deque[Tuple[float, Dict]]" = deque(
            maxlen=self.capacity
        )
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ticks_total = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._snaps)

    def tick(self, now: Optional[float] = None) -> None:
        snap = self.registry.to_dict()
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            self._snaps.append((t, snap))
            self._ticks_total += 1

    def reset(self, rebase: bool = True,
              now: Optional[float] = None) -> None:
        """Drop the snapshot history (ticks_total survives — it counts
        lifetime samples, not retained ones).  For window-epoch
        boundaries where pre-boundary deltas would mislead: a daemon
        that just finished its warmup sweep, or just took over a
        journal, resets so the first served window deltifies against
        post-boundary state instead of averaging the cold spike in.

        `rebase` (default) immediately snapshots the current registry
        as the new epoch's base — without it, traffic arriving before
        the sampler's next tick would be absorbed INTO the base and
        vanish from every window's delta.

        Each reset advances `generation`: the dropped history is
        STATED on every subsequent window view, never silent."""
        with self._lock:
            self._snaps.clear()
            self.generation += 1
        if rebase:
            self.tick(now=now)

    def seed_generation(self, generation: int) -> None:
        """Raise the epoch stamp to at least `generation` (monotonic —
        never lowers it): the archive-reload path calls this with
        `archived generation + 1` so post-restart windows are stamped
        strictly after every pre-restart one."""
        with self._lock:
            self.generation = max(self.generation, int(generation))

    def window(self, span_s: Optional[float] = None) -> Dict[str, Any]:
        with self._lock:
            snaps = list(self._snaps)
        view = compute_window(snaps, span_s)
        view["interval_s"] = self.interval_s
        view["capacity"] = self.capacity
        view["ticks_total"] = self._ticks_total
        view["generation"] = self.generation
        return view

    # -- sampler ------------------------------------------------------
    def start_sampler(self, on_tick: Optional[Callable[[], Any]] = None
                      ) -> "TimeSeriesRing":
        """Fixed-interval sampling on a daemon thread, first tick
        immediately — so the first client-visible window already has a
        boot-time base and a post-takeover replay burst deltifies
        against the pre-burst state instead of against nothing."""
        if self._thread is not None:
            return self

        def loop():
            while not self._stop.is_set():
                try:
                    self.tick()
                    if on_tick is not None:
                        on_tick()
                except Exception:  # noqa: BLE001 - observer never kills
                    import logging

                    logging.getLogger("image_analogies_tpu_torch").exception(
                        "timeseries sampler tick failed"
                    )
                if self._stop.wait(self.interval_s):
                    return

        self._stop.clear()
        self._thread = threading.Thread(
            target=loop, name="ia-obs-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop_sampler(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
