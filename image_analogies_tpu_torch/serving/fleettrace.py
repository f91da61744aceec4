"""Fleet trace fabric — the cross-process half of request tracing:
the reference's module, copied (urllib and the access-log grammar; no
tensor).  `python -m image_analogies_tpu_torch.cli trace ID --fleet
DISCOVERY` is its front door (`ia-synth` below is the reference's CLI
name).  Round 22 (the reference; the single-process half is round 15's
span trees + access log).

A routed request is a two-process story: the router's `route_request`
tree (received -> pick -> proxy_attempt per try -> respond) and one
replica's `serve_request` tree (queue -> compile|restore -> execute ->
demux).  This module joins them into ONE waterfall:

  - **Context propagation.**  The router forwards `X-Request-Id` (the
    join key), `X-Parent-Span` (its own per-request span id) and
    `X-Trace-Hop` downstream; the replica records them on its access
    entry and its `serve_request` root.  Header grammar: ids match
    `^[A-Za-z0-9._-]{1,64}$` (the round-15 request-id grammar), hops
    are 1-3 decimal digits.  Malformed values are REPLACED with
    generated ones, never rejected (`valid_token`/`parse_hop` are the
    shared validators both processes use).

  - **Join algorithm.**  Pull the router's access record + tree
    events and each replica's via `GET /request?id=` (the discovery
    file names every surface), then match: a replica record joins when
    its `parent_span` equals the router record's `span_id`, or —
    fallback for direct/untraced hops — when its `request_id` matches.

  - **Clock model.**  Each process stamps an ABSOLUTE wall anchor
    (`t0`, epoch seconds) next to its own monotonic walls.  Walls are
    never mixed across processes: replica phases nest inside the
    router's final proxy attempt using the replica's OWN relative
    offsets, so per-phase sums always stay within each process's own
    total.  The wall anchors are used only to bound clock skew:
    causality says the replica's handling happened inside the
    router's request window, so any excursion of
    [D.t0, D.t0 + D.total] outside [R.t0, R.t0 + R.total] is a LOWER
    bound on the clock offset — reported as `skew_bound_ms`, never
    corrected for (no imputation).

  - **Honest attribution.**  Named spans attribute: the router's
    pick/respond walls, every non-final proxy attempt's full wall
    (the retry cost IS a named span), and — inside the final attempt —
    the joined replica's phase sum, clipped to the attempt wall.  The
    remainder is `unattributed_ms` (network and HTTP framing): reported
    as a gap, never spread over neighbors.
    `critical_path_coverage` = attributed / router-observed total; the
    round-22 acceptance bar holds it >= 0.95 on the committed
    artifact (tools/check_fleet_trace.py).
"""

from __future__ import annotations

import json
import re
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

from .accesslog import phase_fields

FLEET_TRACE_SCHEMA_VERSION = 1

# Shared trace-token grammar: X-Request-Id AND X-Parent-Span values.
_TOKEN_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")
_HOP_RE = re.compile(r"^\d{1,3}$")


def valid_token(v: Any) -> bool:
    """True when `v` is a well-formed trace token (request id or span
    id) safe for logs, span attrs, and metric exemplars verbatim."""
    return isinstance(v, str) and bool(_TOKEN_RE.match(v))


def parse_hop(v: Optional[str]) -> Optional[int]:
    """The validated hop count, or None when absent/malformed (a
    malformed hop is treated as absent — replaced, never rejected)."""
    if isinstance(v, str) and _HOP_RE.match(v):
        return int(v)
    return None


def _get_json(url: str, timeout: float) -> Any:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def fetch_fleet_trace(discovery: Dict[str, Any], request_id: str,
                      timeout: float = 10.0) -> Dict[str, Any]:
    """Walk one discovery doc (serving/router.py `discovery()` /
    `load_discovery`) and pull every process's view of `request_id`:
    the router's `GET /request?id=` plus each replica's.  A 404 means
    "this process never saw the request" (normal: only one replica
    serves it) and an unreachable process is recorded under `errors`
    — fetched best-effort, joined honestly."""
    out: Dict[str, Any] = {
        "request_id": request_id, "router": None, "replicas": [],
        "errors": [],
    }
    router_url = discovery.get("router")
    if isinstance(router_url, str) and router_url:
        try:
            out["router"] = _get_json(
                router_url.rstrip("/")
                + f"/request?id={request_id}", timeout,
            )
        except urllib.error.HTTPError as e:
            if e.code != 404:
                out["errors"].append(f"router: HTTP {e.code}")
        except (urllib.error.URLError, OSError, ValueError) as e:
            out["errors"].append(f"router: {type(e).__name__}")
    for rep in discovery.get("replicas") or []:
        if not isinstance(rep, dict):
            continue
        url = rep.get("url")
        name = rep.get("name")
        if not isinstance(url, str) or not url:
            continue
        try:
            doc = _get_json(
                url.rstrip("/") + f"/request?id={request_id}", timeout,
            )
        except urllib.error.HTTPError as e:
            if e.code != 404:
                out["errors"].append(f"{name or url}: HTTP {e.code}")
            continue
        except (urllib.error.URLError, OSError, ValueError) as e:
            out["errors"].append(f"{name or url}: {type(e).__name__}")
            continue
        out["replicas"].append({"name": name, "url": url, "doc": doc})
    return out


def _num(v: Any) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) else None


def join_fleet_trace(router_rec: Optional[Dict[str, Any]],
                     replica_recs: List[Dict[str, Any]],
                     request_id: str,
                     router_events: Optional[List[Dict]] = None,
                     replica_events: Optional[Dict[str, List[Dict]]]
                     = None) -> Dict[str, Any]:
    """Join one router access record with the replica access records
    that claim the same request — PURE function over plain records
    (the clock-skew tests feed it synthetic processes), fetch lives in
    `fetch_fleet_trace`.  Returns the joined fleet-trace record
    (schema above: skew bound, attribution, waterfall rows)."""
    joined: Dict[str, Any] = {
        "schema_version": FLEET_TRACE_SCHEMA_VERSION,
        "kind": "fleet_trace",
        "request_id": request_id,
        "router": router_rec,
        "replicas": [],
        "rows": [],
        "skew_bound_ms": None,
        "anchor_delta_ms": None,
        "attributed_ms": None,
        "unattributed_ms": None,
        "retry_ms": 0.0,
        "retries": 0,
        "critical_path_coverage": None,
        "notes": [],
    }
    if router_events:
        joined["router_events"] = router_events
    if replica_events:
        joined["replica_events"] = replica_events
    if router_rec is None:
        joined["notes"].append(
            "no router record: request was not routed (or the router "
            "log rotated past it)"
        )
        for rec in replica_recs:
            joined["replicas"].append({"record": rec, "joined": False})
        return joined
    span_id = router_rec.get("span_id")
    r_t0 = _num(router_rec.get("t0"))
    r_total = _num(router_rec.get("total_ms")) or 0.0
    pick_ms = _num(router_rec.get("pick_ms")) or 0.0
    respond_ms = _num(router_rec.get("respond_ms")) or 0.0
    attempts = [a for a in (router_rec.get("attempts") or [])
                if isinstance(a, dict)]
    joined["retries"] = int(router_rec.get("retries") or 0)

    # -- join -----------------------------------------------------
    final_rep: Optional[Dict[str, Any]] = None
    for rec in replica_recs:
        is_join = (
            (span_id is not None
             and rec.get("parent_span") == span_id)
            or rec.get("request_id") == request_id
        )
        entry = {
            "record": rec, "joined": bool(is_join),
            "anchor_delta_ms": (
                round((_num(rec.get("t0")) - r_t0) * 1000.0, 3)
                if is_join and r_t0 is not None
                and _num(rec.get("t0")) is not None else None
            ),
        }
        joined["replicas"].append(entry)
        if is_join and final_rep is None:
            final_rep = rec

    # -- skew bound (wall anchors only; never corrected for) ------
    skew = 0.0
    if final_rep is not None and r_t0 is not None:
        d_t0 = _num(final_rep.get("t0"))
        d_total = _num(final_rep.get("total_ms")) or 0.0
        if d_t0 is not None:
            early = (r_t0 - d_t0) * 1000.0
            late = ((d_t0 + d_total / 1000.0)
                    - (r_t0 + r_total / 1000.0)) * 1000.0
            skew = max(0.0, early, late)
            joined["anchor_delta_ms"] = round((d_t0 - r_t0) * 1000.0,
                                              3)
    joined["skew_bound_ms"] = round(skew, 3)
    if skew > 0:
        joined["notes"].append(
            f"clock skew >= {skew:.1f} ms between router and replica "
            "wall anchors (replica window escapes the router window); "
            "rows are nested by each process's OWN offsets, not "
            "shifted"
        )

    # -- attribution + rows ---------------------------------------
    rows: List[Dict[str, Any]] = []
    off = 0.0
    attributed = 0.0
    rows.append({"process": "router", "phase": "pick",
                 "offset_ms": round(off, 3),
                 "wall_ms": round(pick_ms, 3)})
    attributed += pick_ms
    off += pick_ms
    retry_ms = 0.0
    for i, att in enumerate(attempts):
        wall = _num(att.get("wall_ms")) or 0.0
        last = i == len(attempts) - 1
        label = (f"proxy_attempt[{att.get('outcome')}"
                 f"->{att.get('replica')}]")
        rows.append({"process": "router", "phase": label,
                     "offset_ms": round(off, 3),
                     "wall_ms": round(wall, 3)})
        if not last:
            # A retried attempt's whole wall is named work: the
            # proxy_attempt span with its retry_reason IS the
            # attribution.
            retry_ms += wall
            attributed += wall
        elif final_rep is not None:
            # Nest the replica's phases inside the final attempt using
            # the REPLICA's own relative offsets — no cross-clock math.
            phases = phase_fields(final_rep)
            p_sum = sum(w for _, w in phases)
            inner = min(p_sum, wall)
            attributed += inner
            if p_sum > wall:
                joined["notes"].append(
                    f"replica phase sum {p_sum:.1f} ms exceeds the "
                    f"router's attempt wall {wall:.1f} ms (clock "
                    "granularity/skew); clipped in the coverage "
                    "arithmetic, replica rows untouched"
                )
            p_off = off
            # The replica record doesn't know its fleet name; the
            # router's record does (the chosen replica of the final
            # attempt).
            proc = str(att.get("replica")
                       or router_rec.get("replica") or "replica")
            for pname, wallp in phases:
                rows.append({"process": proc, "phase": pname,
                             "offset_ms": round(p_off, 3),
                             "wall_ms": round(wallp, 3)})
                p_off += wallp
        else:
            joined["notes"].append(
                "no replica record joined: the proxy window is "
                "unattributed below the router's own spans"
            )
        off += wall
    joined["retry_ms"] = round(retry_ms, 3)
    rows.append({"process": "router", "phase": "respond",
                 "offset_ms": round(off, 3),
                 "wall_ms": round(respond_ms, 3)})
    attributed += respond_ms
    joined["rows"] = rows
    attributed = min(attributed, r_total)
    joined["attributed_ms"] = round(attributed, 3)
    joined["unattributed_ms"] = round(max(0.0, r_total - attributed),
                                      3)
    joined["critical_path_coverage"] = (
        round(attributed / r_total, 4) if r_total > 0 else None
    )
    return joined


def render_fleet_waterfall(joined: Dict[str, Any],
                           width: int = 40) -> str:
    """The one-command waterfall `ia-synth trace <id> --fleet` prints:
    every row offset/wall as bars on the router's request timeline,
    the skew bound, and the honest unattributed gap."""
    out: List[str] = []
    rid = joined.get("request_id")
    router = joined.get("router") or {}
    total = _num(router.get("total_ms")) or 0.0
    out.append(f"fleet trace {rid}")
    out.append(
        f"  router: outcome={router.get('outcome')} "
        f"replica={router.get('replica')} "
        f"total={total:.1f} ms retries={joined.get('retries')}"
    )
    scale = (width / total) if total > 0 else 0.0
    for row in joined.get("rows") or []:
        offset = _num(row.get("offset_ms")) or 0.0
        wall = _num(row.get("wall_ms")) or 0.0
        lead = int(offset * scale)
        bar = max(1, int(wall * scale)) if wall > 0 else 0
        out.append(
            f"  {row.get('process', ''):>8s} "
            f"{row.get('phase', ''):<28s} "
            f"{' ' * lead}{'#' * bar}  {wall:9.1f} ms"
        )
    gap = joined.get("unattributed_ms")
    cov = joined.get("critical_path_coverage")
    if gap is not None:
        out.append(
            f"  unattributed gap {gap:.1f} ms "
            f"(coverage {cov if cov is not None else 'n/a'})"
        )
    skew = joined.get("skew_bound_ms")
    if skew is not None:
        out.append(f"  clock skew bound {skew:.1f} ms")
    for note in joined.get("notes") or []:
        out.append(f"  note: {note}")
    return "\n".join(out)
