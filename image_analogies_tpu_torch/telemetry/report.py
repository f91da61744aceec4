"""Merged run reports: host spans joined against device-trace totals.

`build_report` takes a trace directory produced by a traced run (`synth
--trace-dir DIR --profile DIR [--progress run.jsonl]`: the same directory
for both flags) and merges the two timing domains into one `report.json`,
as the reference's report does:

- **host side**: the span tree the tracer wrote (`host_spans.json`), or,
  for runs that kept only the JSONL stream, pseudo-spans reconstructed
  from its `prologue` / `level_done` events;
- **device side**: `utils.torch_trace` over the `torch_trace.json`
  `torch.profiler` left in the same directory, each device op attributed
  to levels / EM steps / phases by the `tlm_*` ranges open on the host
  thread that launched it.

Every level entry always carries `wall_ms` (host truth); the
`device_busy_ms` fields are null whenever the trace holds no device
events (a CPU run, or no `--profile`): the report states what it
measured and never imputes.  `device.total_busy_ms` is the union of the
device events' intervals.

Schema (validated by tools/check_report.py):

    {"schema_version": 1, "trace_dir": str, "host_spans": bool,
     "run": {"wall_ms": float|null, "ts": str|null} | null,
     "prologue": {"wall_ms": float, "device_busy_ms": float|null},
     "levels": [{"level": int, "shape": [h, w]|null, "wall_ms": float,
                 "nnf_energy": float|null,
                 "device_busy_ms": float|null,
                 "em_device_busy_ms": {"<em>": ms, ...}|null}, ...],
     "phases": {"assemble"|"match"|"render": device_ms, ...},
     "device": {"planes": [str], "total_busy_ms": float|null,
                "top_ops": [[name, ms], ...],
                "error": str  # only when the trace was unreadable
                },
     "metrics": {...}|null}
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from .spans import SCHEMA_VERSION

# Range names the instrumented code opens (models/analogy.py); the
# regexes that recover them from the scoped op keys
# (utils/torch_trace.py: "tlm_L<l>/tlm_em<i>/.../<op>"), so per-EM
# attribution captures the combined path and splits it here.
LEVEL_TAG_RE = r"tlm_L(\d+)"
LEVEL_EM_TAG_RE = r"(tlm_L\d+/tlm_em\d+)"
PHASE_TAG_RE = r"tlm_(assemble|match|render|prologue)"

HOST_SPANS_FILE = "host_spans.json"
METRICS_FILE = "metrics.json"
REPORT_FILE = "report.json"


def _load_json(path: str) -> Optional[dict]:
    """Best-effort JSON load: a corrupt file (disk-full mid-write on a
    pre-atomic layout) logs a warning and reads as absent, letting the
    report fall back to the next host-timing source."""
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except ValueError as e:
        import logging

        logging.getLogger("image_analogies_tpu_torch").warning(
            "telemetry: unreadable JSON %s (%s) — treating as absent",
            path, e,
        )
        return None


def spans_from_progress(path: str) -> Optional[dict]:
    """Reconstruct a minimal span tree from a legacy progress JSONL
    stream — enough for a report when only `--progress` was kept.
    Event `t`/`wall_ms` fields become span start/duration; the run
    span comes from the `done` event (`wall_s`) when present."""
    if not path or not os.path.isfile(path):
        return None
    run_attrs: Dict[str, Any] = {}
    children: List[dict] = []
    run_wall = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                # A killed run's final line is legitimately partial —
                # JSONL recovery means taking every complete record.
                continue
            ev = rec.get("event")
            common = {"ts": rec.get("ts"), "t": rec.get("t")}
            if ev == "start":
                run_attrs = {
                    k: v for k, v in rec.items()
                    if k not in ("event", "t", "ts")
                }
            elif ev == "done":
                run_wall = round(rec.get("wall_s", 0.0) * 1000, 3)
            elif ev == "prologue":
                children.append({
                    "name": "prologue", "wall_ms": rec.get("wall_ms"),
                    "attrs": {}, **common,
                })
            elif ev == "level_done":
                children.append({
                    "name": "level", "wall_ms": rec.get("wall_ms"),
                    "attrs": {
                        k: v for k, v in rec.items()
                        if k not in ("event", "t", "ts", "wall_ms")
                    },
                    **common,
                })
    if not children and run_wall is None:
        return None
    return {
        "schema_version": SCHEMA_VERSION,
        "t0": None,
        "spans": [{
            "name": "run", "wall_ms": run_wall, "attrs": run_attrs,
            "ts": None, "t": 0.0, "children": children,
        }],
    }


def _walk(spans: List[dict], name: str) -> List[dict]:
    out = []
    for s in spans or []:
        if s.get("name") == name:
            out.append(s)
        out.extend(_walk(s.get("children", []), name))
    return out


def build_report(
    trace_dir: Optional[str] = None,
    spans: Optional[dict] = None,
    progress_path: Optional[str] = None,
    metrics: Optional[dict] = None,
    top_ops: int = 15,
) -> Dict[str, Any]:
    """Assemble the merged report dict (see module docstring schema).

    Host spans resolve in priority order: explicit `spans` (a
    Tracer.to_dict()) > `<trace_dir>/host_spans.json` > reconstruction
    from `progress_path`.  Raises FileNotFoundError when none exists —
    a report with no host timings would validate nothing."""
    from ..utils import torch_trace

    host_spans = spans
    if host_spans is None and trace_dir:
        host_spans = _load_json(os.path.join(trace_dir, HOST_SPANS_FILE))
    from_file = spans is None and host_spans is not None
    if host_spans is None:
        host_spans = spans_from_progress(progress_path)
    if host_spans is None:
        raise FileNotFoundError(
            "no host timing source: pass spans=, or a trace dir with "
            f"{HOST_SPANS_FILE}, or a --progress JSONL path"
        )

    roots = host_spans.get("spans", [])
    runs = _walk(roots, "run")
    run_span = runs[-1] if runs else None
    prologues = _walk(roots, "prologue")
    prologue = prologues[-1] if prologues else None

    # Device-side totals, best-effort: the trace is read once
    # (torch_trace.summarize), and every scope grouping below is an
    # in-memory pass over its scoped op keys.
    level_dev: Dict[str, float] = {}
    em_dev: Dict[str, Dict[str, float]] = {}  # level -> {em: ms}
    phase_dev: Dict[str, float] = {}
    planes: List[str] = []
    total_busy = None
    ops_flat: Dict[str, float] = {}
    device_error = None
    trace_path = torch_trace.find_trace(trace_dir)
    if trace_path is not None:
        try:
            summary = torch_trace.summarize(
                torch_trace.load_events(trace_path))
            planes = sorted(summary["planes"])
            for plane_ops in summary["planes"].values():
                for name, ms in plane_ops.items():
                    ops_flat[name] = ops_flat.get(name, 0.0) + ms
            if summary["busy_ms"] is not None:
                total_busy = round(summary["busy_ms"], 3)
            scoped = summary["scoped_ops"]
            level_dev = torch_trace.scope_totals(scoped, LEVEL_TAG_RE)
            phase_dev = torch_trace.scope_totals(scoped, PHASE_TAG_RE)
            for tag, ms in torch_trace.scope_totals(
                scoped, LEVEL_EM_TAG_RE
            ).items():
                lvl_tag, em_tag = tag.split("/")
                em_dev.setdefault(lvl_tag[len("tlm_L"):], {})[
                    em_tag[len("tlm_em"):]
                ] = round(ms, 3)
        except (ValueError, KeyError) as e:
            # A truncated trace (a killed profiler: exactly the crash
            # telemetry_session still writes host spans for) must not
            # take the host-side report down with it: degrade to nulls
            # and state why.
            device_error = str(e)
            level_dev, em_dev, phase_dev = {}, {}, {}
            planes, total_busy, ops_flat = [], None, {}

    levels = []
    # Last occurrence wins per level index: a retried/resumed run may
    # record a level twice, and the final pass is the one that shaped
    # the output.
    by_level: Dict[int, dict] = {}
    for sp in _walk(roots, "level"):
        attrs = sp.get("attrs", {})
        if "level" in attrs:
            by_level[int(attrs["level"])] = sp
    for lvl in sorted(by_level, reverse=True):  # coarse -> fine run order
        sp = by_level[lvl]
        attrs = sp.get("attrs", {})
        dev = level_dev.get(str(lvl))
        levels.append({
            "level": lvl,
            "shape": attrs.get("shape"),
            "wall_ms": sp.get("wall_ms"),
            "nnf_energy": attrs.get("nnf_energy"),
            "device_busy_ms": round(dev, 3) if dev is not None else None,
            # Per-EM-iteration device attribution (the tlm_L<l>/tlm_em<i>
            # nested scopes) — null when the trace carries no tags (the
            # spans' own device intervals are in host_spans.json).
            "em_device_busy_ms": em_dev.get(str(lvl)) or None,
            "em_iters": len(
                [c for c in sp.get("children", [])
                 if c.get("name") == "em_iter"]
            ) or None,
        })

    if metrics is None and trace_dir:
        metrics = _load_json(os.path.join(trace_dir, METRICS_FILE))

    prologue_dev = phase_dev.get("prologue")
    return {
        "schema_version": SCHEMA_VERSION,
        "trace_dir": trace_dir,
        "host_spans": bool(from_file or spans is not None),
        "run": {
            "wall_ms": run_span.get("wall_ms"),
            "ts": run_span.get("ts"),
            "attrs": run_span.get("attrs", {}),
        } if run_span else None,
        "prologue": {
            "wall_ms": prologue.get("wall_ms"),
            "device_busy_ms": (
                round(prologue_dev, 3) if prologue_dev is not None else None
            ),
        } if prologue else None,
        "levels": levels,
        "phases": {
            k: round(v, 3) for k, v in sorted(phase_dev.items())
            if k != "prologue"
        },
        "device": {
            "planes": planes,
            "total_busy_ms": total_busy,
            "top_ops": sorted(
                ((n, round(ms, 3)) for n, ms in ops_flat.items()),
                key=lambda kv: -kv[1],
            )[:top_ops],
            **({"error": device_error} if device_error else {}),
        },
        "metrics": metrics,
    }


def write_report(report: Dict[str, Any], path: str) -> None:
    from ..utils.io import atomic_write_json

    atomic_write_json(path, report)


def _fmt_ms(v) -> str:
    return f"{v:10.1f}" if isinstance(v, (int, float)) else f"{'-':>10}"


def render_table(report: Dict[str, Any]) -> str:
    """Human-readable view: one row per level, host wall next to device
    busy time, with run/prologue/phase summary lines."""
    lines = []
    run = report.get("run") or {}
    dev = report.get("device") or {}
    lines.append(
        f"run wall {run.get('wall_ms') or '-'} ms"
        f" | device busy {dev.get('total_busy_ms') or '-'} ms"
        f" | planes: {', '.join(dev.get('planes') or []) or 'none'}"
    )
    header = f"{'level':>6} {'shape':>12} {'wall_ms':>10} {'device_ms':>10} {'nnf_energy':>12}"
    lines.append(header)
    lines.append("-" * len(header))
    pro = report.get("prologue")
    if pro:
        lines.append(
            f"{'prol.':>6} {'':>12} {_fmt_ms(pro.get('wall_ms'))} "
            f"{_fmt_ms(pro.get('device_busy_ms'))} {'':>12}"
        )
    for lv in report.get("levels", []):
        shape = lv.get("shape")
        shape_s = f"{shape[0]}x{shape[1]}" if shape else "-"
        e = lv.get("nnf_energy")
        e_s = f"{e:12.5f}" if isinstance(e, (int, float)) else f"{'-':>12}"
        lines.append(
            f"{lv['level']:>6} {shape_s:>12} {_fmt_ms(lv.get('wall_ms'))} "
            f"{_fmt_ms(lv.get('device_busy_ms'))} {e_s}"
        )
    phases = report.get("phases") or {}
    if phases:
        lines.append(
            "device by phase: "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in phases.items())
        )
    return "\n".join(lines)
