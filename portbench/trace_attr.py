"""Reader of the Chrome trace `torch.profiler` exports: a frozen copy of
the port's `utils/torch_trace.py` attribution, with the counts and idle
gaps the benchmark reads.

Events read (Chrome trace format, times in microseconds):

  - device events: `ph` "X" with `cat` "kernel", "gpu_memcpy" or
    "gpu_memset", each carrying `args.correlation`;
  - launches: `cat` "cuda_runtime" or "cuda_driver" events on the host
    thread that issued them, carrying the same `args.correlation` as
    the device event they started;
  - ranges: host `ph` "X" events named `tlm_*` (the program's
    `record_function` ranges: `tlm_prologue`, `tlm_L{level}`,
    `tlm_em{em}`, `tlm_assemble`, `tlm_match`, `tlm_render`).

Attribution goes by the launch, not by the device timestamps: the host
runs ahead of the device, so a kernel often executes after the range that
launched it has closed.  A device op is keyed "<scope path>/<name>"
(e.g. "tlm_L0/tlm_em1/tlm_match/void tile_sweep_kernel<...>").
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SCOPE_PREFIX = "tlm_"


def load_events(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents list")
    return events


def _corr(ev) -> Optional[int]:
    c = (ev.get("args") or {}).get("correlation")
    return c if isinstance(c, int) else None


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class _Ranges:
    """Host ranges that nest (one thread's `tlm_*` ranges), indexed so
    that the ranges open at a time are found by bisection."""

    def __init__(self, host: List[Tuple[float, float, str]]):
        self.host = sorted(host, key=lambda r: (r[0], -r[1]))
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (s, _, _) in enumerate(self.host):
            while stack and self.host[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
        self.starts = [r[0] for r in self.host]

    def open_at(self, t: float) -> List[str]:
        """Names of the ranges open at t, outer to inner."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.host[i][1] < t:
            i = self.parent[i]
        out = []
        while i >= 0:
            out.append(self.host[i][2])
            i = self.parent[i]
        return out[::-1]


def summarize(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One pass over a trace's events:

      scoped_ops   {"<scope path>/<op name>" or "<op name>": device ms}
      ops          {op name: device ms}
      n_device     the number of device events
      busy_ms      the union of the device events' intervals, in ms (None
                   when the trace has no device event)
      span_ms      first device event's start to last one's end, in ms
      idle_ms      {label: ms} of the gaps between device work inside
                   span_ms, each labelled by the `tlm_*` ranges open on
                   the host at the gap's middle ("tlm_L0/tlm_em1/
                   tlm_match"; "host" if none)
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
    index = {k: _Ranges(v) for k, v in ranges.items()}

    ops: Dict[str, float] = {}
    scoped: Dict[str, float] = {}
    intervals = []
    for ev in device:
        name = ev.get("name", "?")
        dur = float(ev.get("dur", 0))
        ops[name] = ops.get(name, 0.0) + dur / 1e3
        path = ""
        launch = launches.get(_corr(ev))
        if launch is not None:
            pid, tid, t = launch
            if (pid, tid) in index:
                path = "/".join(index[(pid, tid)].open_at(t))
        key = f"{path}/{name}" if path else name
        scoped[key] = scoped.get(key, 0.0) + dur / 1e3
        intervals.append((float(ev["ts"]), float(ev["ts"]) + dur))
    busy = span = None
    idle: Dict[str, float] = {}
    if intervals:
        merged = _merge(intervals)
        busy = sum(e - s for s, e in merged) / 1e3
        span = (merged[-1][1] - merged[0][0]) / 1e3
        host = _Ranges([r for rs in ranges.values() for r in rs])
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            label = "/".join(host.open_at(0.5 * (e0 + s1))) or "host"
            idle[label] = idle.get(label, 0.0) + (s1 - e0) / 1e3
    return {"scoped_ops": scoped, "ops": ops, "n_device": len(device),
            "busy_ms": busy, "span_ms": span, "idle_ms": idle}


def short_name(key: str) -> str:
    """An op key with its kernel's template and argument lists cut:
    "tlm_L0/tlm_match/void at::native::reduce_kernel<512, ...>(...)" ->
    "tlm_L0/tlm_match/void at::native::reduce_kernel"."""
    path, _, name = key.rpartition("/tlm_")
    if path:
        scope, _, name = name.partition("/")
        path = f"{path}/tlm_{scope}"
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0),
              default=len(name))
    name = name[:cut].strip()
    return f"{path}/{name}" if path and name else path or name


def top(d: Dict[str, float], n: int = 10) -> List[List[Any]]:
    """The n largest entries of {name: ms}, names shortened
    (`short_name`) and summed, as [[name, seconds], ...]."""
    merged: Dict[str, float] = {}
    for k, v in d.items():
        merged[short_name(k)] = merged.get(short_name(k), 0.0) + v
    items = sorted(merged.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e3] for k, v in items]
