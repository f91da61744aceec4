"""Durable telemetry archive + black-box incident capture: the
reference's module, copied, with serving/daemon.py's `--archive-dir`
integration and the port's `runtime/faults.py` `archive_crash` point.
`ia-synth` below is the reference's CLI name; the port's is `python -m
image_analogies_tpu_torch.cli` (`history`, `incident`).  Round 23 (the
reference).

Every telemetry surface rounds 15-22 built — the SLO engine, the
observatory window ring, the anomaly watches, the flight recorder —
is in-memory: a SIGKILL erases exactly the baselines and windows an
operator needs to explain the kill.  The round-16 journal proves the
repo knows how to make serving STATE durable; this module applies the
same durability idiom to the telemetry that grades it:

  - **TelemetryArchive** — append-only segmented JSONL under one
    archive dir.  Each record is ONE `os.write` on an O_APPEND
    descriptor under a lock (accesslog/journal contract: atomic at
    this size, OSError counted on `.errors`, never raised).  When the
    live segment would exceed `max_bytes` — or its oldest record is
    older than `max_age_s` — it SEALS: the numbered generations shift
    `.{N-1}→.N … .1→.2`, the live file renames to `.1` (each step one
    atomic `os.replace`), and a fresh live segment opens.  Readers
    walk `.N … .1` then live, oldest-first, skipping unparseable
    lines — a crash mid-write loses at most the torn final line.
  - **Reload** — `load_resume_state(dir)` replays the segments and
    returns the newest snapshot's anomaly baseline, observatory
    generation stamp, and boot lineage, so a daemon restarted with
    the same `--archive-dir` resumes its watches against PRE-RESTART
    baselines instead of a cold no-data window, and its ring
    generation stays monotonic across the restart (the
    telemetry/timeseries.py round-23 satellite: same boot_id +
    generation bump = in-process counter reset; new boot_id =
    restart).
  - **IncidentStore** — the black box.  When an SLO objective enters
    fast_burn/exhausted or an anomaly watch fires, the daemon hands a
    self-contained bundle (flight dump, access-log tail, obs window,
    lattice/cache stats, config + backend fingerprint, trigger
    record) to `capture()`, which writes it atomically
    (utils/io.atomic_write_json), rate-limits per trigger kind so one
    burn episode yields ONE bundle, and runs a disk-budget janitor
    (oldest bundles deleted beyond `max_count`/`max_bytes`).  Served
    by `GET /incidents` on daemon and router; rendered by
    `ia-synth incident <id>`.

Write-path overhead self-measures into `ia_archive_overhead_frac`
(cumulative seconds inside `_write` over process wall), which the
sentinel's telemetry-overhead check pins under the same 2% budget as
the other observability surfaces, and tools/archive_drill.py
independently re-measures it as a paired on/off delta into
ARCHIVE_r23.json.

The `archive_crash` fault point (runtime/faults.py) fires INSIDE the
write, after half the line is on disk — the SIGKILL-mid-append chaos
arm (tools/chaos_serve.py) asserts reload never surfaces the torn
tail and the baselines still resume.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

ARCHIVE_SCHEMA_VERSION = 1
ARCHIVE_FILE = "archive.jsonl"
INCIDENTS_DIR = "incidents"
DEFAULT_MAX_BYTES = 2 * 1024 * 1024
DEFAULT_GENERATIONS = 4
DEFAULT_MAX_AGE_S = 3600.0
DEFAULT_INCIDENT_MIN_INTERVAL_S = 60.0
DEFAULT_INCIDENT_MAX_COUNT = 32
DEFAULT_INCIDENT_MAX_BYTES = 32 * 1024 * 1024

RECORD_KINDS = ("boot", "snapshot", "incident", "note")


def archive_path(archive_dir: str) -> str:
    return os.path.join(archive_dir, ARCHIVE_FILE)


def _segment_paths(path: str) -> List[str]:
    """Existing segment files oldest-first: `.N … .1` then live.  The
    shift chain keeps numbered generations contiguous from 1, so the
    scan stops at the first gap."""
    gens = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        gens.append(f"{path}.{i}")
        i += 1
    return list(reversed(gens)) + ([path] if os.path.exists(path)
                                   else [])


def read_archive_entries(archive_dir: str) -> Iterator[Dict[str, Any]]:
    """Yield archive records oldest-first across every sealed
    generation and the live segment, skipping unparseable lines (the
    torn-tail tolerance a SIGKILL mid-append relies on)."""
    for p in _segment_paths(archive_path(archive_dir)):
        try:
            fh = open(p, "r", encoding="utf-8")
        except OSError:
            continue
        with fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    yield rec


def load_resume_state(archive_dir: str) -> Dict[str, Any]:
    """Replay the archive into the state a restarting daemon resumes
    from.  Absence is stated, never imputed: a field the archive never
    recorded is None."""
    boot_ids: List[str] = []
    last_snapshot: Optional[Dict[str, Any]] = None
    generation: Optional[int] = None
    baseline: Optional[float] = None
    records = 0
    skipped = 0
    incidents = 0
    path = archive_path(archive_dir)
    for p in _segment_paths(path):
        try:
            fh = open(p, "r", encoding="utf-8")
        except OSError:
            continue
        with fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    skipped += 1
                    continue
                if not isinstance(rec, dict):
                    skipped += 1
                    continue
                records += 1
                bid = rec.get("boot_id")
                if isinstance(bid, str) and (
                    not boot_ids or boot_ids[-1] != bid
                ):
                    boot_ids.append(bid)
                if rec.get("kind") == "snapshot":
                    last_snapshot = rec
                    g = rec.get("obs_generation")
                    if isinstance(g, int):
                        generation = (g if generation is None
                                      else max(generation, g))
                    b = rec.get("anomaly_baseline_p99_ms")
                    if isinstance(b, (int, float)):
                        baseline = float(b)
                elif rec.get("kind") == "incident":
                    incidents += 1
    return {
        "records": records,
        "skipped_lines": skipped,
        "boots": len(boot_ids),
        "boot_ids": boot_ids,
        "generation": generation,
        "baseline_p99_ms": baseline,
        "incidents": incidents,
        "last_snapshot": last_snapshot,
    }


class TelemetryArchive:
    """Append-only segmented telemetry ledger for one archive dir.

    Construction replays whatever already exists (torn-tolerant) into
    `self.resumed`, then opens the live segment and appends a `boot`
    record — so the archive itself carries the restart lineage its
    readers diff (`ia-synth history`)."""

    def __init__(self, archive_dir: str, registry=None,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 generations: int = DEFAULT_GENERATIONS,
                 max_age_s: float = DEFAULT_MAX_AGE_S):
        if max_bytes < 1024:
            raise ValueError(f"max_bytes too small ({max_bytes})")
        if generations < 1:
            raise ValueError(
                f"generations must be >= 1 ({generations})"
            )
        self.archive_dir = str(archive_dir)
        self.path = archive_path(self.archive_dir)
        self.max_bytes = int(max_bytes)
        self.generations = int(generations)
        self.max_age_s = float(max_age_s)
        self.registry = registry
        self.errors = 0
        self.records = 0
        self.sealed = 0
        self._lock = threading.Lock()
        self._fd: Optional[int] = None
        self._size = 0
        self._oldest_t: Optional[float] = None
        self._t0 = time.monotonic()
        self._write_s = 0.0
        self._seq = 0
        os.makedirs(self.archive_dir, exist_ok=True)
        self.resumed = load_resume_state(self.archive_dir)
        self.boot_id = f"{int(time.time() * 1e6):x}-{os.getpid()}"
        self.append("boot", {
            "resumed": {
                k: self.resumed[k]
                for k in ("records", "skipped_lines", "boots",
                          "generation", "baseline_p99_ms", "incidents")
            },
        })

    # -- write path ---------------------------------------------------
    def _open(self) -> None:
        self._fd = os.open(
            self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
        )
        self._size = os.fstat(self._fd).st_size
        if self._size == 0:
            self._oldest_t = None

    def _seal_locked(self) -> None:
        """Shift-chain rotation: `.{N-1}→.N … .1→.2`, live→`.1` — each
        step one atomic `os.replace`, the oldest generation dropping
        off the end.  Same idiom the round-23 accesslog satellite
        gives the access log."""
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
        for i in range(self.generations - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, self.path + ".1")
        self.sealed += 1
        self._oldest_t = None

    def _write(self, record: Dict[str, Any]) -> bool:
        from ..runtime.faults import fire as _fault_fire

        line = (json.dumps(record, sort_keys=True,
                           separators=(",", ":")) + "\n").encode()
        t_in = time.monotonic()
        with self._lock:
            seq = self._seq
            self._seq += 1
            try:
                if self._fd is None:
                    self._open()
                now = time.time()
                overflow = (self._size + len(line) > self.max_bytes
                            and self._size)
                stale = (self._oldest_t is not None
                         and now - self._oldest_t > self.max_age_s)
                if overflow or stale:
                    self._seal_locked()
                    self._open()
                # archive_crash: half the line hits disk, then the
                # process dies — the SIGKILL-mid-append arm.  Reload
                # must skip exactly this torn tail.
                if _fault_fire("archive_crash", seq) == "fail":
                    os.write(self._fd, line[: max(1, len(line) // 2)])
                    os._exit(137)
                os.write(self._fd, line)
                self._size += len(line)
                if self._oldest_t is None:
                    self._oldest_t = now
                self.records += 1
                ok = True
            except OSError:
                self.errors += 1
                ok = False
            self._write_s += time.monotonic() - t_in
        self._publish()
        return ok

    def append(self, kind: str, payload: Dict[str, Any]) -> bool:
        """Append one self-stamped record; never raises."""
        rec = {
            "schema_version": ARCHIVE_SCHEMA_VERSION,
            "kind": kind,
            "boot_id": self.boot_id,
            "seq": self._seq,
            "ts": round(time.time(), 6),
        }
        rec.update(payload)
        return self._write(rec)

    def compact(self) -> int:
        """Rewrite the live segment down to the newest record per
        kind (tmp + `os.replace`, journal.compact idiom) — the drain
        path's parting gift to the successor: one small segment that
        still carries everything reload needs.  Returns records kept;
        OSError counted, never raised."""
        keep: Dict[str, Dict[str, Any]] = {}
        try:
            fh = open(self.path, "r", encoding="utf-8")
        except OSError:
            return 0
        with fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and isinstance(
                    rec.get("kind"), str
                ):
                    keep[rec["kind"]] = rec
        with self._lock:
            try:
                tmp = f"{self.path}.{os.getpid()}.tmp"
                size = 0
                with open(tmp, "wb") as out:
                    for rec in keep.values():
                        pline = (json.dumps(
                            rec, sort_keys=True,
                            separators=(",", ":"),
                        ) + "\n").encode()
                        out.write(pline)
                        size += len(pline)
                if self._fd is not None:
                    os.close(self._fd)
                    self._fd = None
                os.replace(tmp, self.path)
                self._size = size
                return len(keep)
            except OSError:
                self.errors += 1
                return 0

    # -- read side ----------------------------------------------------
    def overhead_frac(self) -> float:
        elapsed = time.monotonic() - self._t0
        return self._write_s / elapsed if elapsed > 0 else 0.0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            segs = _segment_paths(self.path)
            return {
                "archive_dir": self.archive_dir,
                "boot_id": self.boot_id,
                "records": self.records,
                "errors": self.errors,
                "sealed": self.sealed,
                "segments": len(segs),
                "live_bytes": self._size,
                "generations": self.generations,
                "max_bytes": self.max_bytes,
                "overhead_frac": round(self.overhead_frac(), 8),
                "resumed": {
                    k: v for k, v in self.resumed.items()
                    if k != "last_snapshot"
                },
            }

    def _publish(self) -> None:
        reg = self.registry
        if reg is None:
            return
        reg.gauge(
            "ia_archive_records",
            "telemetry-archive records appended this boot",
        ).set(float(self.records))
        reg.gauge(
            "ia_archive_errors",
            "archive write errors counted-not-raised",
        ).set(float(self.errors))
        reg.gauge(
            "ia_archive_overhead_frac",
            "fraction of process wall spent inside archive writes "
            "(sentinel-pinned under the shared 2% telemetry budget)",
        ).set(self.overhead_frac())

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None


# ---------------------------------------------------------- incidents
def incidents_dir(archive_dir: str) -> str:
    return os.path.join(archive_dir, INCIDENTS_DIR)


def list_incidents(archive_dir: str) -> List[Dict[str, Any]]:
    """Bundle summaries oldest-first (id, ts, trigger kind, bytes) —
    unreadable files are listed as errors, never silently dropped."""
    root = incidents_dir(archive_dir)
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(
            n for n in os.listdir(root) if n.endswith(".json")
        )
    except OSError:
        return out
    for name in names:
        p = os.path.join(root, name)
        summary: Dict[str, Any] = {"id": name[:-5], "path": p}
        try:
            summary["bytes"] = os.path.getsize(p)
            with open(p, "r", encoding="utf-8") as fh:
                doc = json.load(fh)
            trig = doc.get("trigger") or {}
            summary.update(
                ts=doc.get("ts"),
                trigger_kind=trig.get("kind"),
                watches=trig.get("watches"),
                objectives=[o.get("name")
                            for o in trig.get("objectives") or []],
            )
        except (OSError, ValueError) as e:
            summary["error"] = f"{type(e).__name__}: {e}"
        out.append(summary)
    return out


def load_incident(archive_dir: str,
                  incident_id: str) -> Optional[Dict[str, Any]]:
    safe = os.path.basename(str(incident_id))
    p = os.path.join(incidents_dir(archive_dir), f"{safe}.json")
    try:
        with open(p, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


# One sequence for every store of the process: two boots in one
# process that capture within one wall second would otherwise both
# number their first bundle 001, and the later would replace the
# earlier on disk.
_INCIDENT_SEQ_LOCK = threading.Lock()
_INCIDENT_SEQ = 0


def _next_incident_id(dirpath: str, ts: float) -> str:
    """`inc-<UTC second>-<pid>-<n>`, with `n` unique in the process
    and past any bundle of the same second and pid already in
    `dirpath` (a recycled pid)."""
    global _INCIDENT_SEQ
    stamp = time.strftime('%Y%m%dT%H%M%S', time.gmtime(ts))
    with _INCIDENT_SEQ_LOCK:
        while True:
            _INCIDENT_SEQ += 1
            inc_id = f"inc-{stamp}-{os.getpid()}-{_INCIDENT_SEQ:03d}"
            if not os.path.exists(os.path.join(dirpath,
                                               f"{inc_id}.json")):
                return inc_id


class IncidentStore:
    """Atomic incident-bundle writer with per-trigger rate limiting
    and a disk-budget janitor.

    `capture()` either writes one self-contained bundle (atomic tmp +
    replace — a reader never sees a half-written crime scene) and
    returns its id, or returns None when the same trigger kind fired
    within `min_interval_s` (one bundle per burn episode, not one per
    sampler tick).  The janitor keeps the newest bundles under both
    `max_count` and `max_bytes`, oldest deleted first."""

    def __init__(self, archive_dir: str, registry=None,
                 min_interval_s: float = DEFAULT_INCIDENT_MIN_INTERVAL_S,
                 max_count: int = DEFAULT_INCIDENT_MAX_COUNT,
                 max_bytes: int = DEFAULT_INCIDENT_MAX_BYTES):
        self.archive_dir = str(archive_dir)
        self.dir = incidents_dir(self.archive_dir)
        self.registry = registry
        self.min_interval_s = float(min_interval_s)
        self.max_count = int(max_count)
        self.max_bytes = int(max_bytes)
        self.captured = 0
        self.suppressed = 0
        self.reaped = 0
        self._last_by_kind: Dict[str, float] = {}
        self._lock = threading.Lock()
        os.makedirs(self.dir, exist_ok=True)

    def capture(self, trigger: Dict[str, Any],
                bundle: Dict[str, Any]) -> Optional[str]:
        from ..utils.io import atomic_write_json

        kind = str(trigger.get("kind") or "unknown")
        now = time.monotonic()
        with self._lock:
            last = self._last_by_kind.get(kind)
            if last is not None and now - last < self.min_interval_s:
                self.suppressed += 1
                self._publish()
                return None
            self._last_by_kind[kind] = now
            self.captured += 1
        ts = time.time()
        inc_id = _next_incident_id(self.dir, ts)
        doc = {
            "schema_version": ARCHIVE_SCHEMA_VERSION,
            "kind": "incident_bundle",
            "id": inc_id,
            "ts": round(ts, 6),
            "trigger": trigger,
        }
        doc.update(bundle)
        try:
            atomic_write_json(
                os.path.join(self.dir, f"{inc_id}.json"), doc
            )
        except OSError:
            return None
        self._janitor()
        self._publish()
        return inc_id

    def _janitor(self) -> None:
        """Delete oldest bundles beyond the count/byte budget — the
        black box must never be the thing that fills the disk."""
        try:
            names = sorted(
                n for n in os.listdir(self.dir) if n.endswith(".json")
            )
            sizes = {}
            for n in names:
                try:
                    sizes[n] = os.path.getsize(
                        os.path.join(self.dir, n)
                    )
                except OSError:
                    sizes[n] = 0
            total = sum(sizes.values())
            while names and (
                len(names) > self.max_count or total > self.max_bytes
            ):
                victim = names.pop(0)
                total -= sizes.get(victim, 0)
                try:
                    os.unlink(os.path.join(self.dir, victim))
                    self.reaped += 1
                except OSError:
                    pass
        except OSError:
            pass

    def _publish(self) -> None:
        reg = self.registry
        if reg is None:
            return
        g = reg.gauge(
            "ia_incidents",
            "black-box incident bundles (captured: written; "
            "suppressed: rate-limited duplicates of a live episode; "
            "reaped: janitor-deleted beyond the disk budget)",
        )
        g.set(float(self.captured), labels={"field": "captured"})
        g.set(float(self.suppressed), labels={"field": "suppressed"})
        g.set(float(self.reaped), labels={"field": "reaped"})

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "captured": self.captured,
                "suppressed": self.suppressed,
                "reaped": self.reaped,
                "min_interval_s": self.min_interval_s,
                "max_count": self.max_count,
                "max_bytes": self.max_bytes,
            }
