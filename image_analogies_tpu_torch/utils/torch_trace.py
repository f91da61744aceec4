"""Reader of the Chrome trace `torch.profiler` writes (`torch_trace.json`,
`utils/profiling.device_trace`): the port's counterpart of the
reference's `utils/xplane.py`, answering the same question, how long
the device ran each op, and under which `tlm_*` range it was launched.

Events read (Chrome trace format, times in microseconds):

  - device events: `ph` "X" with `cat` "kernel", "gpu_memcpy" or
    "gpu_memset", each carrying `args.correlation` and `args.device`;
  - launches: `cat` "cuda_runtime" or "cuda_driver" events (cudaLaunchKernel,
    cudaMemcpyAsync, ...) on the host thread that issued them, carrying
    the same `args.correlation` as the device event they started;
  - ranges: host `ph` "X" events named `tlm_*`, the `record_function`
    ranges `telemetry/spans.scope` opens (`tlm_prologue`, `tlm_L{level}`,
    `tlm_em{em}`, `tlm_assemble`, `tlm_match`, `tlm_render`, and under
    `tlm_match` `tlm_prep`, `tlm_sweep`, `tlm_merge`, `tlm_polish`,
    `tlm_kappa`, `tlm_pixel`, `tlm_dist`).

Attribution goes by the launch, not by the device timestamps: the host
runs ahead of the device, so a kernel often executes after the range
that launched it has closed.  A device event's correlation id names its
launch; the `tlm_*` ranges open on the launching thread at the launch's
start, outer to inner, are its scope path.  A device op is keyed
"<path>/<name>" (e.g. "tlm_L0/tlm_em1/tlm_match/void tile_sweep_kernel<...>"),
the shape of the reference's XLA op names, so the same tag regexes group
it (`scope_totals`).  The `gpu_user_annotation` events some torch builds
write on the device timeline are not used: they span from a range's first
to its last kernel, so they overlap when ranges' kernels interleave on
the device, and they are not written by every build.

A trace of a CPU run holds no device events: its totals are empty and
its busy time None, as the reference's forced-CPU backend gives.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Any, Dict, List, Optional

TRACE_FILE = "torch_trace.json"

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SCOPE_PREFIX = "tlm_"


def find_trace(trace_dir: Optional[str]) -> Optional[str]:
    """`<trace_dir>/torch_trace.json` when it exists, else None."""
    if not trace_dir:
        return None
    path = os.path.join(trace_dir, TRACE_FILE)
    return path if os.path.isfile(path) else None


def load_events(path: str) -> List[Dict[str, Any]]:
    """The trace's event list; raises ValueError on a file that is not a
    Chrome trace (a killed profiler can leave a truncated one)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents list")
    return events


def _corr(ev) -> Optional[int]:
    c = (ev.get("args") or {}).get("correlation")
    return c if isinstance(c, int) else None


def summarize(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One pass over a trace's events:

      planes      {"GPU <device>": {op name: device ms}}
      scoped_ops  {"<scope path>/<op name>" or "<op name>": device ms}
      busy_ms     the union of the device events' intervals, in ms
                  (None when the trace has no device event)
    """
    ranges = defaultdict(list)  # (pid, tid) -> [(start, end, name)]
    launches = {}  # correlation -> (pid, tid, ts)
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        if cat in DEVICE_CATS:
            device.append(ev)
        elif cat in LAUNCH_CATS:
            c = _corr(ev)
            if c is not None:
                launches[c] = (ev.get("pid"), ev.get("tid"), ev["ts"])
        elif cat != "gpu_user_annotation" and str(
                ev.get("name", "")).startswith(SCOPE_PREFIX):
            ranges[(ev.get("pid"), ev.get("tid"))].append(
                (ev["ts"], ev["ts"] + ev.get("dur", 0), ev["name"]))
    for spans in ranges.values():
        # Outer ranges first: earlier start, then the longer one.
        spans.sort(key=lambda r: (r[0], -r[1]))

    planes: Dict[str, Dict[str, float]] = {}
    scoped: Dict[str, float] = {}
    intervals = []
    for ev in device:
        name = ev.get("name", "?")
        dur = float(ev.get("dur", 0))
        ms = dur / 1e3
        plane = f"GPU {(ev.get('args') or {}).get('device', 0)}"
        ops = planes.setdefault(plane, {})
        ops[name] = ops.get(name, 0.0) + ms
        path = ""
        launch = launches.get(_corr(ev))
        if launch is not None:
            pid, tid, t = launch
            path = "/".join(
                n for s, e, n in ranges.get((pid, tid), ()) if s <= t <= e
            )
        key = f"{path}/{name}" if path else name
        scoped[key] = scoped.get(key, 0.0) + ms
        intervals.append((float(ev["ts"]), float(ev["ts"]) + dur))
    busy = None
    if intervals:
        intervals.sort()
        busy = 0.0
        lo, hi = intervals[0]
        for s, e in intervals[1:]:
            if s > hi:
                busy += hi - lo
                lo, hi = s, e
            else:
                hi = max(hi, e)
        busy = (busy + hi - lo) / 1e3
    return {"planes": planes, "scoped_ops": scoped, "busy_ms": busy}


def _summary(trace_dir: str) -> Dict[str, Any]:
    path = find_trace(trace_dir)
    if path is None:
        return {"planes": {}, "scoped_ops": {}, "busy_ms": None}
    return summarize(load_events(path))


def device_op_totals(trace_dir: str) -> Dict[str, Dict[str, float]]:
    """Device ms by op name, per device: {"GPU <n>": {name: ms}};
    {} for a CPU run's trace or no trace."""
    return _summary(trace_dir)["planes"]


def scope_totals(ops: Dict[str, float], tag_pattern: str
                 ) -> Dict[str, float]:
    """Group `{op key: ms}` by the first regex capture of `tag_pattern`
    over each key; keys that do not match are dropped (the reference's
    `xplane.scope_totals`)."""
    pat = re.compile(tag_pattern)
    out: Dict[str, float] = {}
    for name, ms in ops.items():
        m = pat.search(name)
        if m:
            tag = m.group(1)
            out[tag] = out.get(tag, 0.0) + ms
    return out


def device_scope_totals(trace_dir: str,
                        tag_pattern: Optional[str] = None
                        ) -> Dict[str, float]:
    """Device ms under each `tlm_*` range: every range on an op's scope
    path counts the op's time (a level's total holds its EM steps'), or,
    with `tag_pattern`, `scope_totals` of the scoped ops."""
    scoped = _summary(trace_dir)["scoped_ops"]
    if tag_pattern is not None:
        return scope_totals(scoped, tag_pattern)
    out: Dict[str, float] = {}
    for key, ms in scoped.items():
        for part in key.split("/")[:-1]:
            if part.startswith(SCOPE_PREFIX):
                out[part] = out.get(part, 0.0) + ms
    return out


def device_busy_ms(trace_dir: str) -> Optional[float]:
    """The union of the device events' intervals in ms (time the device
    ran anything), or None when the trace has no device event."""
    return _summary(trace_dir)["busy_ms"]
