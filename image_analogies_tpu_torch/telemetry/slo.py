"""SLO engine of the serving tier: a copy of the reference's
`telemetry/slo.py`, ported ahead of the serving daemon because the run
sentinel grades `check_slo` with it.

Declarative latency/availability/shed objectives evaluated from the
request-duration histogram family — `ia_request_duration_ms
{route,outcome,cache}` with explicit buckets, observed once per request
at response time — not from the derived quantile gauges, so the same
arithmetic works live (over a sliding window of registry snapshots,
`SloEngine`) and offline (over a serialized metrics dict,
`evaluate_slo`, which the sentinel's `check_slo` reuses).  Until the
serving slice lands no run of the port observes the family, and every
objective grades `no_data` (the sentinel: skipped).

Error-budget semantics, uniform across objective kinds: every
objective reduces to a BAD-EVENT FRACTION and an ALLOWED fraction
(the error budget).

  - latency:       bad = warm ok-requests slower than `threshold_ms`
                    (threshold placed ON a bucket bound, so the count
                    is exact, not interpolated); allowed = 1 - target
                    (target 0.99 == "p99 warm latency <= threshold").
  - availability:  bad = failed + timeout outcomes over ADMITTED
                    requests (ok + failed + timeout — shed/rejected
                    never entered the backend); allowed = 1 - target.
  - shed_rate:     bad = shed outcomes over all requests reaching
                    admission (admitted + shed); allowed = target
                    itself (the ceiling IS the budget).

  burn_rate        = bad_frac / allowed      (1.0 == budget exactly
                                              consumed over the window)
  budget_remaining = 1 - burn_rate           (negative when exhausted)

Grading (mirrored by sentinel.check_slo): an objective is `exhausted`
(-> violated) only when its budget is spent (burn >= 1), `fast_burn`
(-> degraded) when burn >= FAST_BURN_THRESHOLD, `ok` below that, and
`no_data` (-> skipped) when its denominator is silent — so a metrics
dump from a non-serving run never fails the sentinel.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .metrics import parse_label_str

SCHEMA_VERSION = 1

REQUEST_DURATION_METRIC = "ia_request_duration_ms"

# The fleet router's own duration family (round 22): same bucket
# ladder, same outcome vocabulary, graded by the same engine — pass it
# as `metric=` to SloEngine/evaluate_slo.  Kept separate from the
# replica family so pooling router + replica burn rates never double-
# counts a request (every routed request also lands in exactly one
# replica's ia_request_duration_ms).
ROUTE_DURATION_METRIC = "ia_route_duration_ms"

# Explicit bucket ladder for ia_request_duration_ms: denser than the
# registry default in the 5 ms - 5 s band where a warm CPU-proxy serve
# lands, and containing EVERY DEFAULT_OBJECTIVES latency threshold as
# an exact bound (30000.0) so budget arithmetic never interpolates.
REQUEST_DURATION_BUCKETS = (
    5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
    5000.0, 10000.0, 30000.0, 60000.0, 120000.0, 300000.0, 600000.0,
)

# burn_rate at/above which an objective grades `fast_burn` (sentinel:
# degraded): half the budget consumed within one evaluation window is
# an early-warning signal, not yet an SLO breach.
FAST_BURN_THRESHOLD = 0.5

_OBJECTIVE_KINDS = ("latency", "availability", "shed_rate")

# Outcomes that passed admission (denominator of availability).
# "cancelled" (round 16: the client hung up before dispatch) and
# "unavailable" (a draining daemon's 503) are EXCLUDED like "shed":
# the backend never owed those requests a response, so they must not
# dilute — or spuriously burn — the availability budget.
_ADMITTED_OUTCOMES = ("ok", "failed", "timeout")
_BAD_OUTCOMES = ("failed", "timeout")


@dataclass(frozen=True)
class Objective:
    """One declarative objective over the request-duration family.

    `target` is the GOOD fraction for latency/availability (e.g. 0.99)
    and the bad-fraction CEILING for shed_rate (e.g. 0.9) — see the
    module docstring's budget table.  `threshold_ms` applies to
    latency objectives only and should sit on a
    REQUEST_DURATION_BUCKETS bound (exact counting); a threshold
    between bounds is rounded DOWN to the nearest bound (conservative:
    more requests count as slow, never fewer)."""

    name: str
    kind: str
    target: float
    threshold_ms: float = 0.0
    labels: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in _OBJECTIVE_KINDS:
            raise ValueError(
                f"objective kind {self.kind!r} not in {_OBJECTIVE_KINDS}"
            )
        if not 0.0 < self.target <= 1.0:
            raise ValueError(
                f"objective target must be in (0, 1] ({self.target})"
            )
        if self.kind == "latency" and self.threshold_ms <= 0.0:
            raise ValueError("latency objective needs threshold_ms > 0")

    def allowed_frac(self) -> float:
        if self.kind == "shed_rate":
            return self.target
        return max(1e-9, 1.0 - self.target)


# CPU-proxy-generous defaults: the committed load sweep runs the 32^2
# proxy under pytest on shared CPU, so the warm threshold (30 s) bounds
# pathology, not polish; availability is the real objective (the
# supervised retry ladder should absorb injected faults); the shed
# ceiling is high because serve_load's burst arm sheds ~60% BY DESIGN
# (clients deliberately exceed max_queue_depth to exercise 429s).
DEFAULT_OBJECTIVES: Tuple[Objective, ...] = (
    Objective(name="warm_p99_latency_ms", kind="latency", target=0.99,
              threshold_ms=30000.0,
              labels={"outcome": "ok", "cache": "hit"}),
    Objective(name="availability", kind="availability", target=0.99),
    Objective(name="shed_rate", kind="shed_rate", target=0.9),
)

# Objectives for the router hop (ia_route_duration_ms{outcome,
# replica}): no cache label exists at the router — it never knows a
# replica's cache verdict — so the latency objective filters on
# outcome alone.  Availability/shed arithmetic is label-free and
# shared verbatim.
ROUTE_OBJECTIVES: Tuple[Objective, ...] = (
    Objective(name="route_p99_latency_ms", kind="latency", target=0.99,
              threshold_ms=30000.0, labels={"outcome": "ok"}),
    Objective(name="availability", kind="availability", target=0.99),
    Objective(name="shed_rate", kind="shed_rate", target=0.9),
)


# -- serialized-histogram arithmetic ----------------------------------
def _family_values(metrics: Dict[str, Any],
                   name: str = REQUEST_DURATION_METRIC
                   ) -> Dict[str, Dict[str, Any]]:
    fam = metrics.get(name) or {}
    vals = fam.get("values") or {}
    return vals if isinstance(vals, dict) else {}


def _match(labels: Dict[str, str], want: Dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in want.items())


def _merge_cells(values: Dict[str, Dict[str, Any]],
                 want: Dict[str, str]) -> Dict[str, Any]:
    """Sum count/sum/cumulative-buckets across every label set
    matching `want` (subset match) — the serialized-form analogue of
    scraping one PromQL selector."""
    total, wsum = 0, 0.0
    buckets: Dict[float, int] = {}
    for label_str, cell in values.items():
        try:
            labels = parse_label_str(label_str)
        except ValueError:
            continue
        if not _match(labels, want):
            continue
        total += int(cell.get("count", 0))
        wsum += float(cell.get("sum", 0.0))
        for b, c in (cell.get("buckets") or {}).items():
            buckets[float(b)] = buckets.get(float(b), 0) + int(c)
    return {"count": total, "sum": wsum, "buckets": buckets}


def _count_at_or_under(merged: Dict[str, Any],
                       threshold_ms: float) -> Tuple[int, float]:
    """(cumulative count at the nearest bucket bound <= threshold,
    the bound actually used).  Rounds DOWN between bounds — the
    conservative direction for a latency budget."""
    bounds = sorted(merged["buckets"])
    used, cum = 0.0, 0
    for b in bounds:
        if b <= threshold_ms + 1e-9:
            used, cum = b, merged["buckets"][b]
        else:
            break
    return cum, used


def quantile_from_cell(cell: Dict[str, Any], q: float):
    """PromQL-style linear interpolation over ONE serialized histogram
    cell (`{"count", "sum", "buckets": {bound: cum}}`) — the offline
    mirror of metrics.Histogram.quantile, byte-identical estimator:
    first bucket interpolates from 0, +Inf ranks clamp to the highest
    finite bound.  None when empty."""
    if not 0.0 < q <= 1.0:
        raise ValueError(f"quantile {q} outside (0, 1]")
    total = int(cell.get("count", 0))
    if not total:
        return None
    bounds = sorted(float(b) for b in cell.get("buckets", {}))
    if not bounds:
        return None
    rank = q * total
    prev_bound, prev_cum = 0.0, 0
    norm = {float(b): int(c) for b, c in cell["buckets"].items()}
    for bound in bounds:
        cum = norm[bound]
        if cum >= rank:
            if cum == prev_cum:
                return bound
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_bound + (bound - prev_bound) * frac
        prev_bound, prev_cum = bound, cum
    return bounds[-1]


def _subtract_cells(now: Dict[str, Dict[str, Any]],
                    base: Dict[str, Dict[str, Any]]
                    ) -> Dict[str, Dict[str, Any]]:
    """Per-label-set cumulative delta (now - base), clamped at zero —
    turns two registry snapshots into a sliding-window view."""
    out: Dict[str, Dict[str, Any]] = {}
    for key, cell in now.items():
        prev = base.get(key) or {}
        pb = prev.get("buckets") or {}
        out[key] = {
            "count": max(0, int(cell.get("count", 0))
                         - int(prev.get("count", 0))),
            "sum": max(0.0, float(cell.get("sum", 0.0))
                       - float(prev.get("sum", 0.0))),
            "buckets": {
                b: max(0, int(c) - int(pb.get(b, 0)))
                for b, c in (cell.get("buckets") or {}).items()
            },
        }
    return out


# -- evaluation -------------------------------------------------------
def _grade(objective: Objective, bad: int, denom: int,
           extra: Dict[str, Any]) -> Dict[str, Any]:
    allowed = objective.allowed_frac()
    rec: Dict[str, Any] = {
        "name": objective.name,
        "kind": objective.kind,
        "target": objective.target,
        "allowed_frac": round(allowed, 6),
        "denominator": denom,
        "bad_count": bad,
    }
    if objective.kind == "latency":
        rec["threshold_ms"] = objective.threshold_ms
    rec.update(extra)
    if denom <= 0:
        rec.update(bad_frac=None, burn_rate=None,
                   budget_remaining=None, status="no_data")
        return rec
    bad_frac = bad / denom
    burn = bad_frac / allowed
    rec["bad_frac"] = round(bad_frac, 6)
    rec["burn_rate"] = round(burn, 4)
    rec["budget_remaining"] = round(1.0 - burn, 4)
    if burn >= 1.0:
        rec["status"] = "exhausted"
    elif burn >= FAST_BURN_THRESHOLD:
        rec["status"] = "fast_burn"
    else:
        rec["status"] = "ok"
    return rec


def _outcome_counts(values: Dict[str, Dict[str, Any]]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for label_str, cell in values.items():
        try:
            labels = parse_label_str(label_str)
        except ValueError:
            continue
        oc = labels.get("outcome", "unknown")
        out[oc] = out.get(oc, 0) + int(cell.get("count", 0))
    return out


_STATUS_VERDICT = {
    "no_data": "skipped", "ok": "ok",
    "fast_burn": "degraded", "exhausted": "violated",
}


def evaluate_slo(metrics: Dict[str, Any],
                 objectives: Sequence[Objective] = DEFAULT_OBJECTIVES,
                 window_s: Optional[float] = None,
                 metric: str = REQUEST_DURATION_METRIC
                 ) -> Dict[str, Any]:
    """Grade `objectives` against a serialized metrics dict
    (MetricsRegistry.to_dict()) — the whole record when offline, a
    snapshot delta when the SloEngine calls it.  `metric` names the
    duration family to grade (the replica family by default; pass
    ROUTE_DURATION_METRIC for the router hop).  Returns the versioned
    slo report; never raises on silent/missing families (objectives
    grade `no_data`)."""
    values = _family_values(metrics, name=metric)
    by_outcome = _outcome_counts(values)
    graded: List[Dict[str, Any]] = []
    for obj in objectives:
        if obj.kind == "latency":
            merged = _merge_cells(values, obj.labels)
            denom = merged["count"]
            under, used_bound = _count_at_or_under(merged,
                                                   obj.threshold_ms)
            bad = denom - under
            extra = {
                "bucket_bound_ms": used_bound,
                "observed_p99_ms": quantile_from_cell(merged, 0.99),
                "observed_p50_ms": quantile_from_cell(merged, 0.5),
            }
        elif obj.kind == "availability":
            denom = sum(by_outcome.get(o, 0) for o in _ADMITTED_OUTCOMES)
            bad = sum(by_outcome.get(o, 0) for o in _BAD_OUTCOMES)
            extra = {"availability": (
                round(1.0 - bad / denom, 6) if denom else None
            )}
        else:  # shed_rate
            admitted = sum(
                by_outcome.get(o, 0) for o in _ADMITTED_OUTCOMES
            )
            shed = by_outcome.get("shed", 0)
            denom = admitted + shed
            bad = shed
            extra = {}
        graded.append(_grade(obj, bad, denom, extra))
    verdicts = [_STATUS_VERDICT[g["status"]] for g in graded]
    if "violated" in verdicts:
        verdict = "violated"
    elif "degraded" in verdicts:
        verdict = "degraded"
    elif "ok" in verdicts:
        verdict = "ok"
    else:
        verdict = "skipped"
    report: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "kind": "slo",
        "metric": metric,
        "window_s": window_s,
        "outcomes": by_outcome,
        "objectives": graded,
        "verdict": verdict,
    }
    return report


def publish_slo_gauges(report: Dict[str, Any], registry) -> None:
    """Export each graded objective's burn rate / budget as gauges —
    called on evaluation only (the /slo scrape), so the request hot
    path never pays for SLO math."""
    g_burn = registry.gauge(
        "ia_slo_burn_rate",
        "error-budget burn rate per objective (1.0 = budget consumed)",
    )
    g_budget = registry.gauge(
        "ia_slo_budget_remaining",
        "error-budget remaining per objective (negative = exhausted)",
    )
    for obj in report.get("objectives", ()):
        labels = {"objective": obj["name"]}
        if obj.get("burn_rate") is not None:
            g_burn.set(obj["burn_rate"], labels=labels)
        if obj.get("budget_remaining") is not None:
            g_budget.set(obj["budget_remaining"], labels=labels)


class SloEngine:
    """Sliding-window objective evaluation over a live registry.

    Keeps a bounded deque of (monotonic t, duration-family snapshot);
    each `evaluate()` drops snapshots older than `window_s`, subtracts
    the oldest survivor from the current snapshot (cumulative-counter
    delta = the window's traffic), grades the objectives, and
    publishes the burn-rate gauges.  With no prior snapshot in range
    the window is 'since start' — stated in the report."""

    def __init__(self, registry, objectives: Optional[
                     Sequence[Objective]] = None,
                 window_s: float = 300.0,
                 max_snapshots: int = 64,
                 metric: str = REQUEST_DURATION_METRIC):
        self.registry = registry
        self.metric = metric
        if objectives is None:
            objectives = (ROUTE_OBJECTIVES
                          if metric == ROUTE_DURATION_METRIC
                          else DEFAULT_OBJECTIVES)
        self.objectives = tuple(objectives)
        self.window_s = float(window_s)
        self._snaps: "deque[Tuple[float, Dict]]" = deque(
            maxlen=max_snapshots
        )

    def evaluate(self) -> Dict[str, Any]:
        now = time.monotonic()
        current = _family_values(self.registry.to_dict(),
                                 name=self.metric)
        while self._snaps and now - self._snaps[0][0] > self.window_s:
            self._snaps.popleft()
        if self._snaps:
            base_t, base = self._snaps[0]
            window = round(now - base_t, 3)
            values = _subtract_cells(current, base)
        else:
            window = None  # whole process lifetime so far
            values = current
        self._snaps.append((now, current))
        report = evaluate_slo(
            {self.metric: {"kind": "histogram", "values": values}},
            self.objectives, window_s=window, metric=self.metric,
        )
        publish_slo_gauges(report, self.registry)
        return report
