"""Metrics registry: counters, gauges and histograms with JSON and
Prometheus-text exposition.

Instrumented sites (the runners, the kernel wrappers, the supervisor)
update a registry; `to_dict()` feeds `metrics.json` and
`to_prometheus()` renders the text exposition format 0.0.4.  Stdlib
only and thread-safe (one lock per metric; host-side bookkeeping, never
on a device path).  A copy of the reference's registry.

The reference counts kernel launches at trace time (a counter bumped
inside a jitted function counts compilations, not executions).  The
port runs eagerly, so `count_kernel_launch` here counts real launches,
one per kernel the wrapper starts.  Left out until their slices: the
TPU DMA byte and row ledgers of the reference's candidate, polish and
coarse fetches (priced by its TPU kernels' byte models; they return with
the sentinel, priced by the port's kernels) and the collective-site
counters of the multi-device runners.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

# Default histogram buckets: wall-clock-ish exponential ms scale, wide
# enough for both a 64^2 CPU level (~10 ms) and a 4096^2 lean level
# (~minutes).
_DEFAULT_BUCKETS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0, 300000.0,
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


def escape_label_value(v: str) -> str:
    """Prometheus text-exposition label-value escaping (format 0.0.4):
    backslash, double quote, and line feed — in that order, so the
    escapes themselves are never re-escaped."""
    return (
        v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def unescape_label_value(v: str) -> str:
    """Inverse of `escape_label_value` — a real unescape pass (left to
    right, one escape consumed at a time), not chained str.replace,
    which would corrupt values like `\\\\n` (an escaped backslash
    followed by a literal n)."""
    out = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            n = v[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(n, c + n))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _label_str(key: _LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in key
    ) + "}"


def parse_label_str(s: str) -> Dict[str, str]:
    """Parse a `_label_str` rendering back to a label dict — the
    exposition round-trip the sentinel (telemetry/sentinel.py) relies
    on to recompute model expectations from a serialized metrics.json,
    and the hostile-label test's inverse.  Accepts "" and the JSON
    exposition's "total"/"value" placeholder keys as label-free."""
    if s in ("", "total", "value"):
        return {}
    if not (s.startswith("{") and s.endswith("}")):
        raise ValueError(f"not a label string: {s!r}")
    body = s[1:-1]
    labels: Dict[str, str] = {}
    i = 0
    try:
        while i < len(body):
            eq = body.index("=", i)
            name = body[i:eq]
            if body[eq + 1] != '"':
                raise ValueError(f"unquoted label value in {s!r}")
            j = eq + 2
            raw = []
            while body[j] != '"':
                if body[j] == "\\":
                    raw.append(body[j:j + 2])
                    j += 2
                else:
                    raw.append(body[j])
                    j += 1
            labels[name] = unescape_label_value("".join(raw))
            i = j + 1
            if i < len(body):
                if body[i] != ",":
                    raise ValueError(f"malformed label string: {s!r}")
                i += 1
    except IndexError:
        # An unterminated quote / truncated tail must surface as the
        # documented ValueError, not a raw IndexError traceback (the
        # offline sentinel parses hand-editable metrics.json files).
        raise ValueError(f"truncated label string: {s!r}") from None
    return labels


class Counter:
    """Monotonic counter (per label set)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: Dict[_LabelKey, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def to_dict(self):
        return {
            _label_str(k) or "total": v for k, v in sorted(self._values.items())
        }

    def expose(self) -> List[str]:
        return [
            f"{self.name}{_label_str(k)} {_fmt(v)}"
            for k, v in sorted(self._values.items())
        ] or [f"{self.name} 0"]


class Gauge:
    """Last-write-wins value (per label set)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: Dict[_LabelKey, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float,
            labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def value(self, labels: Optional[Dict[str, str]] = None):
        return self._values.get(_label_key(labels))

    def to_dict(self):
        return {
            _label_str(k) or "value": v
            for k, v in sorted(self._values.items())
        }

    def expose(self) -> List[str]:
        return [
            f"{self.name}{_label_str(k)} {_fmt(v)}"
            for k, v in sorted(self._values.items())
        ]


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each `le`
    bucket counts observations <= its bound, plus +Inf/count/sum)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = _DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[_LabelKey, List[int]] = {}
        self._sums: Dict[_LabelKey, float] = {}
        self._totals: Dict[_LabelKey, int] = {}
        # (label key, bucket index) -> most recent exemplar id; index
        # len(buckets) is the +Inf bucket.  Bounded: one slot per
        # existing (label set, bucket) pair, last-write-wins.
        self._exemplars: Dict[Tuple[_LabelKey, int], str] = {}
        self._lock = threading.Lock()

    def observe(self, value: float,
                labels: Optional[Dict[str, str]] = None,
                exemplar: Optional[str] = None) -> None:
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            lowest = len(self.buckets)  # +Inf unless a bound catches it
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
                    lowest = min(lowest, i)
            self._sums[key] = self._sums.get(key, 0.0) + float(value)
            self._totals[key] = self._totals.get(key, 0) + 1
            if exemplar is not None:
                # One exemplar per (label set, NARROWEST bucket the
                # observation landed in) — that is the bucket a
                # dashboard spike points at, and the id links straight
                # to `ia-synth trace <id>`.
                self._exemplars[(key, lowest)] = str(exemplar)

    # Quantiles derived for the Prometheus exposition (round 10): the
    # mid-run scrape story needs tail latencies (a straggling shard
    # shows up in p99 level-wall long before it shows in the mean), and
    # cumulative buckets alone push the interpolation onto every
    # consumer.
    QUANTILES = (0.5, 0.99)

    def quantile(self, q: float,
                 labels: Optional[Dict[str, str]] = None):
        """Estimated q-quantile (0 < q <= 1) of one label set's
        observations, by linear interpolation inside the cumulative
        buckets — the same estimator PromQL's histogram_quantile()
        applies, so a scraped family and this method answer alike.
        The first bucket interpolates from 0 (observations here are
        non-negative wall/byte figures); ranks landing in the +Inf
        bucket clamp to the highest finite bound (stated, not
        extrapolated).  None when the label set has no observations."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"quantile {q} outside (0, 1]")
        key = _label_key(labels)
        total = self._totals.get(key, 0)
        if not total:
            return None
        rank = q * total
        prev_bound, prev_cum = 0.0, 0
        for bound, cum in zip(self.buckets, self._counts[key]):
            if cum >= rank:
                if cum == prev_cum:
                    return bound
                frac = (rank - prev_cum) / (cum - prev_cum)
                return prev_bound + (bound - prev_bound) * frac
            prev_bound, prev_cum = bound, cum
        return self.buckets[-1]

    def expose_quantiles(self) -> List[str]:
        """Derived `<name>_quantile{quantile="q", ...}` gauge series,
        one per (label set, q) — rendered by the registry as its OWN
        family with its own single TYPE line, because the exposition
        format reserves a histogram family's children for
        _bucket/_sum/_count (adding quantile children under the
        histogram TYPE would break format-0.0.4 parsers)."""
        lines = []
        for key in sorted(self._totals):
            base = dict(key)
            for q in self.QUANTILES:
                v = self.quantile(q, base)
                if v is None:
                    continue
                lines.append(
                    f"{self.name}_quantile"
                    f"{_label_str(_label_key({**base, 'quantile': _fmt(q)}))}"
                    f" {_fmt(v)}"
                )
        return lines

    def count(self, labels: Optional[Dict[str, str]] = None) -> int:
        return self._totals.get(_label_key(labels), 0)

    def sum(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._sums.get(_label_key(labels), 0.0)

    def to_dict(self):
        out = {}
        for key in sorted(self._totals):
            out[_label_str(key) or "total"] = {
                "count": self._totals[key],
                "sum": round(self._sums[key], 6),
                "buckets": dict(
                    zip((str(b) for b in self.buckets), self._counts[key])
                ),
            }
        return out

    def expose(self) -> List[str]:
        lines = []
        for key in sorted(self._totals):
            base = dict(key)
            for bound, c in zip(self.buckets, self._counts[key]):
                lines.append(
                    f"{self.name}_bucket"
                    f"{_label_str(_label_key({**base, 'le': _fmt(bound)}))}"
                    f" {c}"
                )
            lines.append(
                f"{self.name}_bucket"
                f"{_label_str(_label_key({**base, 'le': '+Inf'}))}"
                f" {self._totals[key]}"
            )
            lines.append(
                f"{self.name}_sum{_label_str(key)} {_fmt(self._sums[key])}"
            )
            lines.append(
                f"{self.name}_count{_label_str(key)} {self._totals[key]}"
            )
        return lines

    def exemplars(self) -> Dict[str, Dict[str, str]]:
        """{label_str or "total": {le-bound: exemplar id}} — the JSON
        accessor (kept OUT of to_dict(): its cell schema is a wire
        contract for the sentinel/SLO/report consumers)."""
        out: Dict[str, Dict[str, str]] = {}
        with self._lock:
            items = sorted(self._exemplars.items())
        for (key, idx), ex in items:
            le = "+Inf" if idx >= len(self.buckets) \
                else _fmt(self.buckets[idx])
            out.setdefault(_label_str(key) or "total", {})[le] = ex
        return out

    def expose_exemplars(self) -> List[str]:
        """Comment-style exemplar lines: the exposition format 0.0.4
        has no exemplar syntax (that is OpenMetrics), so each rides as
        a `#`-prefixed comment — ignored by any compliant parser, one
        line per (label set, bucket) naming the most recent request id
        that landed there:

            # exemplar ia_request_duration_ms_bucket{le="100",...} request_id="r-42"
        """
        lines = []
        with self._lock:
            items = sorted(self._exemplars.items())
        for (key, idx), ex in items:
            le = "+Inf" if idx >= len(self.buckets) \
                else _fmt(self.buckets[idx])
            series = _label_str(_label_key({**dict(key), "le": le}))
            lines.append(
                f"# exemplar {self.name}_bucket{series} "
                f'request_id="{escape_label_value(ex)}"'
            )
        return lines


def _fmt(v: float) -> str:
    """Prometheus-friendly number: integral values without the '.0'."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class MetricsRegistry:
    """Named metric factory + exposition.  `counter`/`gauge`/
    `histogram` get-or-create (re-registration with a different kind
    is an error — silent aliasing would corrupt both series)."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = _DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def to_dict(self) -> Dict[str, Dict]:
        """JSON exposition: {name: {kind, help, values}}."""
        return {
            name: {"kind": m.kind, "help": m.help, "values": m.to_dict()}
            for name, m in sorted(self._metrics.items())
        }

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4.  Per family (one
        registry entry = one family): the `# HELP` line (backslash and
        line-feed escaped, per the format's HELP rules) and exactly ONE
        `# TYPE` line, followed by every labeled child series — a
        histogram's `_bucket`/`_sum`/`_count` children all sit under
        the single family TYPE line."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                help_text = m.help.replace("\\", "\\\\").replace(
                    "\n", "\\n"
                )
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.expose())
            if isinstance(m, Histogram):
                # Exemplar comment lines (round 19): most recent
                # request id per (label set, bucket), format-safe
                # because a format-0.0.4 parser skips every non-HELP/
                # TYPE `#` line.
                lines.extend(m.expose_exemplars())
                # Derived p50/p99 children as a SEPARATE gauge family
                # (round 10): the histogram family's TYPE line stays
                # alone over _bucket/_sum/_count, and the derived
                # `<name>_quantile` family gets exactly one TYPE line
                # of its own.  A real metric registered under the
                # derived name wins — emitting both would print two
                # TYPE lines for one family.
                qlines = (
                    m.expose_quantiles()
                    if f"{name}_quantile" not in self._metrics else []
                )
                if qlines:
                    lines.append(
                        f"# HELP {name}_quantile p50/p99 estimates "
                        f"interpolated from {name} buckets"
                    )
                    lines.append(f"# TYPE {name}_quantile gauge")
                    lines.extend(qlines)
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


# Process-default registry: instrumented sites that are not threaded a
# registry explicitly (kernels, parallel runners) record here.  A
# telemetry session (utils/profiling.telemetry_session) installs its
# own fresh registry for its duration so per-run expositions report
# per-run counts; tests snapshot/reset around runs.
_global_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _global_registry


def set_registry(reg: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Install `reg` as the process-default registry (None restores a
    fresh one) and return the previous default — the swap/restore pair
    a telemetry session brackets a run with."""
    global _global_registry
    prev = _global_registry
    _global_registry = reg if reg is not None else MetricsRegistry()
    return prev


def reset_registry() -> None:
    """Clear the default registry (test isolation)."""
    _global_registry.reset()



def count_kernel_launch(kernel: str) -> None:
    """Book one launch of a hand-written kernel in the process-default
    registry (the session's, under a telemetry session), as
    `ia_kernel_launches_total{kernel}`.  Called by the kernel wrappers
    where they launch (`kernels/patchmatch_tile.tile_sweep_kernel` as
    "tile_sweep", `kernels/nn_brute.nn_argmin_kernel` as "exact_nn"),
    beside their module launch counters.  A real launch count: the port
    runs eagerly, where the reference's counter counts trace-time
    sites."""
    get_registry().counter(
        "ia_kernel_launches_total",
        "hand-written kernel launches (one per launch)",
    ).inc(labels={"kernel": kernel})
