"""Metrics registry: counters, gauges and histograms with JSON and
Prometheus-text exposition.

Instrumented sites (the runners, the kernel wrappers, the supervisor)
update a registry; `to_dict()` feeds `metrics.json` and
`to_prometheus()` renders the text exposition format 0.0.4.  Stdlib
only and thread-safe (one lock per metric; host-side bookkeeping, never
on a device path).  A copy of the reference's registry.

The reference counts kernel launches and DMA bytes at trace time (a
counter bumped inside a jitted function counts compilations, not
executions).  The port runs eagerly, so its counters book real launches
and the bytes of each launch, where the wrapper starts its kernel.  A
byte series and its structural twin (`ia_candidate_dma_bytes_total` and
`ia_candidate_dma_fetches_total`, the polish and coarse pairs alike) are
booked as one unit (`MetricsRegistry.unit`), which the expositions wait
on: a live scrape never reads one without the other.  The collective
counters of the multi-device runners count executed collectives too,
on both sides of the sentinel's comms check (`count_collectives`,
`count_expected_collectives`).
"""

from __future__ import annotations

import contextlib
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
        # Held across the increments of one booking unit and by every
        # exposition, so a reader sees all of a unit or none of it.
        self._unit_lock = threading.RLock()

    @contextlib.contextmanager
    def unit(self):
        """Book several series as one unit: `to_dict` and
        `to_prometheus` wait until the block has ended."""
        with self._unit_lock:
            yield self

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
        with self._unit_lock:
            return self._to_dict()

    def _to_dict(self) -> Dict[str, Dict]:
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
        with self._unit_lock:
            return self._to_prometheus()

    def _to_prometheus(self) -> str:
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


def count_candidate_dma_bytes(useful: float, padded: float,
                              dtype: str = "bf16") -> None:
    """Book one K1 launch's candidate-window bytes: what the launch pulls
    from L2 through L1 into registers for its A windows, split into the
    bytes its distance consumes (`kind="useful"`) and those it loads
    beside them (`kind="padded"`).  The per-fetch math is
    `kernels.patchmatch_tile.candidate_window_bytes_per_fetch`, the model
    `chip_smoke.py`'s L2 floor uses too; `dtype` is the candidate-table
    mode ("bf16": float32 planes; "int8").  Booked by
    `kernels/patchmatch_tile.tile_sweep_kernel` where it launches, with
    `count_candidate_dma_fetches` in one `MetricsRegistry.unit`: a static
    bound per launch (every slot, or the prune's M, of every tile and
    strip), since the valid slots are never read back to the host."""
    c = get_registry().counter(
        "ia_candidate_dma_bytes_total",
        "candidate-window bytes K1 launches pull from L2, split useful vs "
        "padded, by candidate-table dtype (static bound per launch)",
    )
    c.inc(useful, labels={"kind": "useful", "dtype": dtype})
    c.inc(padded, labels={"kind": "padded", "dtype": dtype})


def count_polish_dma_bytes(useful: float, padded: float,
                           dtype: str = "bf16") -> None:
    """Book one polish row fetch's bytes read from device memory: the
    whole LANE-wide row K3 (`kernels/polish_stream.gather_rows`) copies,
    or `index_select` fetches on the int8 sequential polish, split into
    the feature width the distance consumes (`kind="useful"`) and the
    zero lanes beside it (`kind="padded"`); under "int8" both sides add
    the per-row float32 scale.  The per-row math is
    `kernels.polish_stream.polish_dma_bytes_per_fetch`; booked with
    `count_polish_dma_rows` in one `MetricsRegistry.unit`, one booking
    per gather call, on CUDA tensors only."""
    c = get_registry().counter(
        "ia_polish_dma_bytes_total",
        "polish candidate-row bytes read per gather call, split useful vs "
        "padded, by row-table dtype",
    )
    c.inc(useful, labels={"kind": "useful", "dtype": dtype})
    c.inc(padded, labels={"kind": "padded", "dtype": dtype})


def count_candidate_dma_fetches(
    n_fetch: int, n_chan: int, rows: int, halo: int, dtype: str = "bf16",
) -> None:
    """Book one K1 launch's candidate-window FETCH count, a fetch being
    one slot of one strip, with the {chan, rows, halo, dtype} labels that
    price it: the structural twin of `count_candidate_dma_bytes`, from
    which the run sentinel (telemetry/sentinel.py) recomputes the
    expected bytes by `candidate_window_bytes_per_fetch`."""
    get_registry().counter(
        "ia_candidate_dma_fetches_total",
        "candidate-window fetches per K1 launch (one slot of one strip), "
        "labeled by the {chan, rows, halo, dtype} geometry that prices one "
        "fetch (sentinel joins this against "
        "candidate_window_bytes_per_fetch)",
    ).inc(n_fetch, labels={
        "chan": str(n_chan), "rows": str(rows), "halo": str(halo),
        "dtype": dtype,
    })


def count_polish_dma_rows(
    n_rows: int, d_useful: int, itemsize: int, dtype: str = "bf16"
) -> None:
    """Book one polish gather's ROW count with the {d_useful, itemsize,
    dtype} labels that price a row: the structural twin of
    `count_polish_dma_bytes` (the sentinel prices it by
    `polish_dma_bytes_per_fetch`)."""
    get_registry().counter(
        "ia_polish_dma_rows_total",
        "candidate rows fetched per polish gather call, labeled by the "
        "{d_useful, itemsize, dtype} row pricing (sentinel joins this "
        "against polish_dma_bytes_per_fetch)",
    ).inc(n_rows, labels={
        "d_useful": str(d_useful), "itemsize": str(itemsize),
        "dtype": dtype,
    })


def count_coarse_dma_bytes(useful: float, padded: float) -> None:
    """Book one coarse pre-prune's projected-row gather bytes
    (`kernels.patchmatch_tile.prune_candidates`, an `index_select` of
    (Na, k) rows): each row moves in whole 32-byte sectors, the k dims
    the ranking consumes are `kind="useful"` and the rest of the last
    sector `kind="padded"`.  The per-row math is
    `kernels.patchmatch_tile.coarse_dma_bytes_per_row`; booked with
    `count_coarse_dma_rows` in one `MetricsRegistry.unit`, once per
    prune on CUDA tensors."""
    c = get_registry().counter(
        "ia_coarse_dma_bytes_total",
        "PCA coarse pre-prune projected-row gather bytes, split useful vs "
        "padded (32-byte sectors)",
    )
    c.inc(useful, labels={"kind": "useful"})
    c.inc(padded, labels={"kind": "padded"})


def count_coarse_dma_rows(n_rows: int, k: int, itemsize: int) -> None:
    """Structural twin of `count_coarse_dma_bytes`: the coarse row count
    with its {k, itemsize} pricing, which the sentinel prices by
    `coarse_dma_bytes_per_row`."""
    get_registry().counter(
        "ia_coarse_dma_rows_total",
        "PCA coarse pre-prune rows gathered, labeled by the {k, itemsize} "
        "row pricing (sentinel joins this against "
        "coarse_dma_bytes_per_row)",
    ).inc(n_rows, labels={"k": str(k), "itemsize": str(itemsize)})


def count_collectives(n: int, axis: str, kind: str = "all_reduce") -> None:
    """The OBSERVED side of the comms ledger: called where a runner
    issues its collectives (parallel/sharded_a.py `_band_merge` and
    `_sharded_dist`, parallel/spatial.py's re-slab exchange) with the
    number it issues there.  Executed calls: the port runs eagerly, so
    a site inside a loop counts every iteration (the reference counts
    traced sites)."""
    get_registry().counter(
        "ia_collectives_total",
        "cross-rank collectives executed in the runners' EM steps, by "
        "{axis, kind} (sentinel holds this to the parallel/comms.py "
        "model)",
    ).inc(n, labels={"axis": axis, "kind": kind})


def count_expected_collectives(n: int, axis: str) -> None:
    """The comms model's prediction for a sharded level or EM step,
    booked by the runner beside the work it predicts
    (`parallel.comms.sharded_a_allreduce_count` and friends).  The
    sentinel's comms check is observed == expected, per axis."""
    get_registry().counter(
        "ia_collectives_expected_total",
        "collectives the parallel/comms.py model predicts for the "
        "runners' EM steps, by {axis}",
    ).inc(n, labels={"axis": axis})


def count_kernel_launch(kernel: str) -> None:
    """Book one launch of a hand-written kernel in the process-default
    registry (the session's, under a telemetry session), as
    `ia_kernel_launches_total{kernel}`.  Called by the kernel wrappers
    where they launch (`kernels/patchmatch_tile.tile_sweep_kernel` as
    "tile_sweep", `kernels/nn_brute.nn_argmin_kernel` as "exact_nn",
    `kernels/pixel_cascade.cascade_sweep_kernel` as "pixel_cascade"),
    beside their module launch counters.  A real launch count: the port
    runs eagerly, where the reference's counter counts trace-time
    sites."""
    get_registry().counter(
        "ia_kernel_launches_total",
        "hand-written kernel launches (one per launch)",
    ).inc(labels={"kernel": kernel})


def count_eager_sweep(reason: str) -> None:
    """Book one sweep of the per-pixel cascade that ran eagerly on CUDA
    tensors instead of kernel K4 (`kernels/pixel_cascade.count_eager`),
    as `ia_eager_sweeps_total{reason}`: "plain" (pallas_mode
    "interpret"), "temporal" (video with tau > 0), "gather" (the stream
    and int8 polish fetches) or "dist_fn" (a caller's own distance)."""
    get_registry().counter(
        "ia_eager_sweeps_total",
        "per-pixel cascade sweeps run eagerly on CUDA tensors, by {reason}",
    ).inc(labels={"reason": reason})
