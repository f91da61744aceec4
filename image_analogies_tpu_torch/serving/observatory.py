"""Multi-replica scrape + aggregation — the fleet-facing half of the
observatory (in-daemon half: telemetry/timeseries.py +
telemetry/anomaly.py): the reference's module, copied, with one
repair.  A fleet router's discovery file lists the router among its
targets; the reference pooled it as one more replica, whose registry
has no `ia_request_duration_ms`, so every OBS record taken over a
discovery file failed tools/check_obs.py.  Here `aggregate` files a
target that serves the router's duration family under `routers`:
its families still join the pooled merge (the router hop's SLO
grades from them), and `replicas` holds the daemons.  `ia-synth`
below is the reference's CLI name; the port's is `python -m
image_analogies_tpu_torch.cli obs`.  Round 19 (the reference):

One daemon answers `/metrics.json`, `/slo` and `/obs/window` for
itself; a fleet of N replicas has N disjoint registries and NO
process that can answer "what is the fleet's p99" or "is the error
budget burning ACROSS replicas".  This module is that process:
`aggregate(targets)` scrapes every replica, merges the serialized
registries (sum counters, pool histogram cells bucket-by-bucket —
gauges are deliberately per-replica: summing queue depths across
replicas is meaningful, summing overhead fractions is not, so gauges
stay in the per-replica sections and never merge), grades the
round-15 `Objective`s over the POOLED duration family, and returns
the OBS record `tools/check_obs.py` validates.

The arithmetic contract (acceptance-tested end to end): fleet burn
rates are computed by `evaluate_slo` over the merged histogram cells
— POOLED, never averaged.  Averaging per-replica burn rates weights a
10-request replica equally with a 10000-request one; pooling the
buckets weights every request once.  Because bucket counts are
integers and the merge is plain addition, an independent re-merge of
the same per-replica payloads reproduces the fleet numbers BIT-EQUAL,
which is exactly what check_obs re-derives.

`ia-synth obs --targets host:p1,host:p2` drives `aggregate` +
`render_dashboard`; `tools/serve_load.py --obs-out` drives it against
two live in-process replicas under a load burst and measures the
observatory's request-path overhead into the committed artifact.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence

from ..telemetry.slo import (
    ROUTE_DURATION_METRIC,
    ROUTE_OBJECTIVES,
    REQUEST_DURATION_METRIC,
    evaluate_slo,
)

OBS_SCHEMA_VERSION = 1
OBS_ROUND = 19

# Families the OBS record keeps per replica: everything the fleet
# merge and the checker's re-derivation read, nothing else (a full
# registry dump per replica would swamp the artifact with engine
# counters that have per-replica meaning only).
KEEP_PREFIXES = ("ia_serve_", "ia_request_", "ia_slo_", "ia_anomaly_",
                 "ia_excache_", "ia_observatory_", "ia_route_")


def parse_targets(spec: str) -> List[str]:
    """"host:p1,host:p2" (or full http:// URLs) -> base URLs.

    Round 21: the spec may instead name the fleet router's replica-
    discovery file (written and kept current by `ia-synth route
    --discovery-out`) — either as a bare path that exists on disk or
    explicitly as `@PATH`.  Its `targets` list (replicas + the router
    itself) becomes the scrape set, so fleet scrapes track membership
    changes (adds, drains, rolling restarts) without a hand-maintained
    target list."""
    spec = str(spec)
    path = None
    if spec.startswith("@"):
        path = spec[1:]
    elif "," not in spec and os.path.isfile(spec):
        path = spec
    if path is not None:
        from .router import load_discovery

        try:
            doc = load_discovery(path)
        except (OSError, ValueError) as e:
            raise ValueError(f"discovery file {path}: {e}")
        targets = [str(t).rstrip("/") for t in doc.get("targets") or []]
        if not targets:
            raise ValueError(f"discovery file {path}: no targets")
        return targets
    out = []
    for part in spec.split(","):
        part = part.strip().rstrip("/")
        if not part:
            continue
        if not part.startswith(("http://", "https://")):
            part = f"http://{part}"
        out.append(part)
    if not out:
        raise ValueError(f"no targets in {spec!r}")
    return out


def _get_json(url: str, timeout: float) -> Any:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def scrape_replica(base_url: str, span_s: Optional[float] = None,
                   timeout: float = 10.0) -> Dict[str, Any]:
    """One replica's observatory surface: the JSON registry
    exposition, the SLO report (anomalies ride inside it when the
    replica's detector is on), and the windowed view.  A replica that
    answers /metrics.json but lacks /obs/window (an older daemon)
    still aggregates — `window` is None, stated per replica."""
    base_url = base_url.rstrip("/")
    rec: Dict[str, Any] = {"url": base_url, "error": None}
    try:
        metrics = _get_json(f"{base_url}/metrics.json", timeout)
        rec["metrics"] = {
            name: fam for name, fam in metrics.items()
            if name.startswith(KEEP_PREFIXES)
        }
        rec["slo"] = _get_json(f"{base_url}/slo", timeout)
        try:
            q = f"?span={span_s:g}" if span_s is not None else ""
            rec["window"] = _get_json(
                f"{base_url}/obs/window{q}", timeout
            )
        except (urllib.error.URLError, OSError, ValueError):
            rec["window"] = None
    except (urllib.error.URLError, OSError, ValueError) as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec.setdefault("metrics", None)
        rec.setdefault("slo", None)
        rec.setdefault("window", None)
    return rec


def merge_registries(metrics_list: Sequence[Dict[str, Any]]
                     ) -> Dict[str, Any]:
    """Pool serialized registries (MetricsRegistry.to_dict form):
    counters sum per label set, histogram cells sum count/sum and
    bucket-by-bucket (replicas share bucket layouts per family — same
    binary — so bucket union is exact, and a label set present on one
    replica only carries through unchanged).  Gauges are SKIPPED:
    last-write-wins values have no fleet-sum semantics; read them in
    the per-replica sections."""
    merged: Dict[str, Any] = {}
    for metrics in metrics_list:
        for name, fam in (metrics or {}).items():
            kind = fam.get("kind")
            if kind == "gauge":
                continue
            values = fam.get("values") or {}
            tgt = merged.setdefault(name, {
                "kind": kind, "help": fam.get("help", ""), "values": {},
            })
            if tgt["kind"] != kind:
                raise ValueError(
                    f"metric {name!r}: kind mismatch across replicas "
                    f"({tgt['kind']} vs {kind})"
                )
            for label_str, cell in values.items():
                if kind == "counter":
                    tgt["values"][label_str] = (
                        tgt["values"].get(label_str, 0) + cell
                    )
                elif kind == "histogram":
                    cur = tgt["values"].get(label_str)
                    if cur is None:
                        tgt["values"][label_str] = {
                            "count": int(cell.get("count", 0)),
                            "sum": float(cell.get("sum", 0.0)),
                            "buckets": {
                                b: int(c) for b, c in
                                (cell.get("buckets") or {}).items()
                            },
                        }
                    else:
                        cur["count"] += int(cell.get("count", 0))
                        cur["sum"] += float(cell.get("sum", 0.0))
                        for b, c in (cell.get("buckets") or {}).items():
                            cur["buckets"][b] = (
                                cur["buckets"].get(b, 0) + int(c)
                            )
    return merged


def fleet_slo(merged: Dict[str, Any]) -> Dict[str, Any]:
    """The round-15 objectives graded over the POOLED duration family
    — the `Objective` semantics applied fleet-wide, so burn rates are
    request-weighted across replicas, never replica-averaged."""
    return evaluate_slo(merged)


def fleet_route_slo(merged: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Round 22: the router hop graded with the SAME engine over the
    pooled `ia_route_duration_ms` family — router and replica burn
    rates sit side by side in one report WITHOUT double-counting: a
    request contributes to `ia_request_duration_ms` on the replica
    that served it and to `ia_route_duration_ms` at the router that
    proxied it, and the two families are graded separately (router
    `unavailable`/`shed` outcomes are availability-excluded by the
    round-16 outcome taxonomy, same as on replicas).  None when no
    router was in the scrape set — absent, never imputed."""
    fam = merged.get(ROUTE_DURATION_METRIC)
    if not fam or not (fam.get("values") or {}):
        return None
    return evaluate_slo(merged, ROUTE_OBJECTIVES,
                        metric=ROUTE_DURATION_METRIC)


def aggregate(targets: Sequence[str], span_s: Optional[float] = None,
              timeout: float = 10.0) -> Dict[str, Any]:
    """Scrape every target and assemble the OBS record.

    Round 22 honesty rule: a target that is in the scrape set but
    unreachable mid-scrape DEGRADES the fleet verdict — its traffic is
    missing from the pooled families, so the fleet numbers are a
    floor, not the truth.  The record says so (`degraded` +
    `warnings`) instead of silently grading the survivors."""
    scraped = [scrape_replica(t, span_s, timeout) for t in targets]
    routers = [r for r in scraped if r["error"] is None
               and ROUTE_DURATION_METRIC in (r["metrics"] or {})]
    replicas = [r for r in scraped if r not in routers]
    live = [r for r in replicas if r["error"] is None]
    unreachable = [r for r in replicas if r["error"] is not None]
    merged = merge_registries([r["metrics"] for r in live + routers])
    fleet: Dict[str, Any] = {
        "replicas_total": len(replicas),
        "replicas_live": len(live),
        "degraded": bool(unreachable),
        "warnings": [
            f"target {r['url']} unreachable mid-scrape "
            f"({r['error']}); pooled numbers exclude its traffic"
            for r in unreachable
        ],
        "slo": fleet_slo(merged),
        "route_slo": fleet_route_slo(merged),
        "merged_metrics": merged,
        "anomalies_firing": sorted({
            f"{r['url']}:{w}"
            for r in live
            for w in ((r["slo"] or {}).get("anomalies") or {})
            .get("firing", [])
        }),
    }
    return {
        "schema_version": OBS_SCHEMA_VERSION,
        "kind": "obs",
        "round": OBS_ROUND,
        "targets": list(targets),
        "span_s": span_s,
        "replicas": replicas,
        "routers": routers,
        "fleet": fleet,
    }


# ------------------------------------------------------------ rendering
def _fmt_ms(v) -> str:
    return "-" if v is None else f"{float(v):.1f}"


def render_dashboard(record: Dict[str, Any]) -> str:
    """Terminal dashboard over one OBS record: per-replica health
    lines, the pooled fleet objectives, and any firing anomaly."""
    lines: List[str] = []
    fleet = record.get("fleet") or {}
    lines.append(
        f"serving observatory — {fleet.get('replicas_live', 0)}/"
        f"{fleet.get('replicas_total', 0)} replicas live"
        + (f", window {record['span_s']:g}s"
           if record.get("span_s") else "")
    )
    lines.append("")
    lines.append(f"{'replica':<28} {'verdict':<9} {'p50ms':>8} "
                 f"{'p99ms':>8} {'req/s':>8} {'anomaly':<10}")
    for rep in record.get("replicas") or []:
        url = rep["url"]
        if rep.get("error"):
            lines.append(f"{url:<28} {'DOWN':<9} {'-':>8} {'-':>8} "
                         f"{'-':>8} {rep['error']}")
            continue
        slo = rep.get("slo") or {}
        lat = next(
            (o for o in slo.get("objectives", [])
             if o.get("kind") == "latency"), {},
        )
        window = rep.get("window") or {}
        rate = None
        cells = (window.get("histograms") or {}).get(
            REQUEST_DURATION_METRIC
        ) or {}
        if window.get("status") == "ok" and cells:
            rate = sum(
                c.get("rate_per_s") or 0.0 for c in cells.values()
            )
        anomalies = (slo.get("anomalies") or {})
        lines.append(
            f"{url:<28} {slo.get('verdict', '-'):<9} "
            f"{_fmt_ms(lat.get('observed_p50_ms')):>8} "
            f"{_fmt_ms(lat.get('observed_p99_ms')):>8} "
            f"{(f'{rate:.2f}' if rate is not None else '-'):>8} "
            f"{anomalies.get('verdict', '-'):<10}"
        )
    for rep in record.get("routers") or []:
        slo = rep.get("slo") or {}
        lines.append(f"{rep['url']:<28} {slo.get('verdict', '-'):<9} "
                     "(router)")
    lines.append("")
    lines.append("fleet objectives (pooled, request-weighted):")
    for o in (fleet.get("slo") or {}).get("objectives", []):
        burn = o.get("burn_rate")
        lines.append(
            f"  {o['name']:<24} {o['status']:<10} "
            f"burn={'-' if burn is None else f'{burn:.4f}'} "
            f"bad={o.get('bad_count', 0)}/{o.get('denominator', 0)}"
            + (f" p99={_fmt_ms(o.get('observed_p99_ms'))}ms"
               if o.get("kind") == "latency" else "")
        )
    route = fleet.get("route_slo")
    if route:
        lines.append("")
        lines.append("router hop objectives (pooled):")
        for o in route.get("objectives", []):
            burn = o.get("burn_rate")
            lines.append(
                f"  {o['name']:<24} {o['status']:<10} "
                f"burn={'-' if burn is None else f'{burn:.4f}'} "
                f"bad={o.get('bad_count', 0)}/{o.get('denominator', 0)}"
                + (f" p99={_fmt_ms(o.get('observed_p99_ms'))}ms"
                   if o.get("kind") == "latency" else "")
            )
    firing = fleet.get("anomalies_firing") or []
    lines.append("")
    lines.append(
        "anomalies firing: " + (", ".join(firing) if firing else "none")
    )
    for warn in fleet.get("warnings") or []:
        lines.append(f"WARNING (fleet degraded): {warn}")
    return "\n".join(lines) + "\n"


def write_obs(record: Dict[str, Any], path: str) -> None:
    from ..utils.io import atomic_write_json

    atomic_write_json(path, record)
