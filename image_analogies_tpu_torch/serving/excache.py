"""Executable-cache accounting for the serving daemon: the memory tier
of the reference's `serving/excache.py`, over the port's first-use costs.

The reference counts compiled XLA executables.  The port compiles no
graph per shape (the kernels are built once per process from their
sources, and the runners run eagerly), so the same key and counters
keep the reference's semantics over what a shape does cost the first
time it runs: a "miss" is the first dispatch of a key in this epoch of
this process, and it pays the key's first-use costs, which are the
caching allocator's growth to that shape's working set, the per-shape
window weights on the device (`kernels.patchmatch_tile._device_weights`),
the cuBLAS workspaces and, in a cold process, the kernel modules' load.
A "hit" is a later dispatch of a key still warm.

  - an ADMISSION-VISIBLE key: one record per (stacked input shape,
    config fingerprint, matcher, compression mode), so the daemon can
    answer "is this shape warm?" BEFORE dispatching, label the
    request's span `cache-hit` vs `compiled`, and expose
    hit/miss/evict counters a scraper can watch;
  - a WARMUP path: a manifest of expected shapes dispatched at daemon
    start, so the first paying request of each shape is a hit;
  - honest EVICTION at epoch grain: evicting one entry calls
    `kernels.patchmatch_tile.clear_first_use_caches()`, which drops
    what the port caches per shape (the device weights and the
    allocator's free blocks), and demotes every other resident entry
    to cold.  The next use of a demoted key pays its first use again
    and is counted as a miss.

The disk tier (`DiskExecCache`, below) keeps the reference's index of
sealed shapes under a warm directory that N replicas share, its `disk`
verdict and counters and its honest-miss rules, over what a first use
costs on an H100 (PERF.md): a new process's first dispatch pays 3.4-4.3
s over a hit at 1024^2, while a new shape in a warm process, or an
evicted key's next use, costs nothing measurable.  So no per-shape artifact is worth a
file, and the tier persists none: its warm set is the list of shapes
the fleet has served, which a new replica dispatches once each before
it announces (`restore_warm_set`).  The reference's blob store has no
counterpart (`_jax_cache_bypass`, `_enable_jax_cache`,
`release_jax_cache`, the persist hook's `call`, `begin_recording` /
`end_recording` and the blob reader and writer): the port compiles no
executable to serialize.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

WARMUP_SCHEMA_VERSION = 1

ExecKey = Tuple[tuple, str, str, str]


def config_fingerprint(cfg) -> str:
    """Stable digest of the COMPUTE-shaping config fields, the
    reference's identity: every field but the host-side checkpoint path
    (two configs differing only in `save_level_artifacts` share one
    entry) and the port's `device` (a daemon serves on one device), so
    a config hashes to the reference package's fingerprint."""
    import dataclasses

    values = tuple(
        None if f.name == "save_level_artifacts"
        else getattr(cfg, f.name)
        for f in dataclasses.fields(cfg) if f.name != "device"
    )
    return hashlib.sha1(repr(values).encode()).hexdigest()[:12]


def compression_mode() -> str:
    """The process-wide kernel-compression knobs as one label: these
    are engine modes, not config fields (config.EngineModes), but they
    shape every dispatch, so a mode flip (a supervisor ladder step, a
    `set_engine_modes` call) must change the key.  The reference's third
    field, the packed sublane layout, describes TPU sublanes and has no
    counterpart on the card."""
    from ..config import engine_modes
    from ..kernels.patchmatch_tile import parse_prune, resolve_cand_dtype

    modes = engine_modes()
    prune = parse_prune(modes.prune)
    return "|".join((
        resolve_cand_dtype(modes.cand_dtype),
        "full" if prune is None else f"prune{prune[0]}:{prune[1]}",
    ))


def exec_key(b_shape, cfg, batch_size: int = 1) -> ExecKey:
    """The executable identity of one dispatch: (stacked pyramid-input
    shape, config fingerprint, matcher, compression mode).  The
    leading `batch_size` is part of the shape because a dispatch's
    working set scales with the frame axis, which is why the daemon
    pads every dispatch to one static batch grain (serving/daemon.py)."""
    return (
        (int(batch_size),) + tuple(int(d) for d in b_shape),
        config_fingerprint(cfg),
        cfg.matcher,
        compression_mode(),
    )


def key_str(key: ExecKey) -> str:
    shape, fp, matcher, comp = key
    return f"{'x'.join(map(str, shape))}/{matcher}/{comp}/{fp}"


class _Entry:
    __slots__ = ("key", "warm", "hits", "compiles", "last_used_t",
                 "compile_ms", "last_request_id")

    def __init__(self, key: ExecKey):
        self.key = key
        self.warm = False
        self.hits = 0
        self.compiles = 0
        self.last_used_t = time.monotonic()
        self.compile_ms: Optional[float] = None
        # Last request to look this entry up (request tracing): the
        # /serving snapshot's breadcrumb from a cache line back to a
        # concrete request id the access log / trace CLI can expand.
        self.last_request_id: Optional[str] = None


class ExecutableCache:
    """LRU accounting cache over the dispatch shapes' first-use costs.

    `lookup(key)` returns "hit" (resident and warm) or "miss" (new, or
    demoted to cold by an epoch eviction), admitting/evicting as
    needed and booking `ia_serve_excache_{hits,misses,evictions}_total`
    (hits/misses carry a {kind} label so warmup traffic never inflates
    the client ledger the sentinel's serving check prices)."""

    def __init__(self, capacity: int = 8, registry=None):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1 ({capacity})")
        self.capacity = int(capacity)
        self._registry = registry
        self._entries: "OrderedDict[ExecKey, _Entry]" = OrderedDict()
        self._lock = threading.Lock()
        self.evictions = 0

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from ..telemetry.metrics import get_registry

        return get_registry()

    def _count(self, which: str, kind: str) -> None:
        self._reg().counter(
            f"ia_serve_excache_{which}_total",
            f"serving executable-cache {which} by request kind "
            "(client vs warmup)",
        ).inc(labels={"kind": kind})

    def lookup(self, key: ExecKey, kind: str = "client",
               request_id: Optional[str] = None) -> str:
        """Admit `key`, return "hit" or "miss", and book the counters.

        A miss either admits a new entry (evicting the LRU entry at
        capacity: an EPOCH eviction, see the module docstring) or
        re-warms a demoted one.  The caller dispatches either way.
        `request_id` stamps the entry with the looking-up request."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                entry.last_used_t = time.monotonic()
                if request_id is not None:
                    entry.last_request_id = request_id
                if entry.warm:
                    entry.hits += 1
                    self._count("hits", kind)
                    return "hit"
                # Demoted by an epoch eviction: the per-shape caches
                # were cleared, so this use pays its first use again.
                entry.warm = True
                entry.compiles += 1
                self._count("misses", kind)
                return "miss"
            entry = _Entry(key)
            entry.warm = True
            entry.compiles = 1
            if request_id is not None:
                entry.last_request_id = request_id
            self._entries[key] = entry
            if len(self._entries) > self.capacity:
                self._evict_lru()
            self._count("misses", kind)
            return "miss"

    def _evict_lru(self) -> None:
        """Capacity eviction (caller holds the lock): drop the LRU
        entry, clear the per-shape caches, and demote every remaining
        entry to cold: the allocator's free blocks and the weights
        cache serve every shape at once, so eviction is honest at epoch
        granularity rather than fictitious at key granularity."""
        evicted_key, _ = self._entries.popitem(last=False)
        self.evictions += 1
        self._reg().counter(
            "ia_serve_excache_evictions_total",
            "serving executable-cache capacity evictions (epoch-"
            "grained: one eviction clears the per-shape caches and "
            "demotes every resident entry to cold)",
        ).inc()
        from ..kernels.patchmatch_tile import clear_first_use_caches

        clear_first_use_caches()
        for entry in self._entries.values():
            entry.warm = False
        import logging

        logging.getLogger("image_analogies_tpu_torch").info(
            "serving excache: evicted %s (epoch eviction: %d resident "
            "entries demoted to cold)",
            key_str(evicted_key), len(self._entries),
        )

    def force_epoch_eviction(self) -> int:
        """Forced epoch eviction, the `serve_evict` chaos point: clear
        the per-shape caches and
        demote every resident entry to cold, exactly the aftermath of
        a capacity eviction but without dropping any accounting entry.
        The next lookup of each key is an honest miss.  Returns how
        many entries were demoted."""
        with self._lock:
            from ..kernels.patchmatch_tile import clear_first_use_caches

            clear_first_use_caches()
            demoted = 0
            for entry in self._entries.values():
                if entry.warm:
                    entry.warm = False
                    demoted += 1
            self.evictions += 1
            self._reg().counter(
                "ia_serve_excache_evictions_total",
                "serving executable-cache capacity evictions (epoch-"
                "grained: one eviction clears the per-shape caches and "
                "demotes every resident entry to cold)",
            ).inc()
            import logging

            logging.getLogger("image_analogies_tpu_torch").warning(
                "serving excache: FORCED epoch eviction (%d resident "
                "entries demoted to cold)", demoted,
            )
            return demoted

    def note_compile_ms(self, key: ExecKey, wall_ms: float) -> None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                entry.compile_ms = round(float(wall_ms), 3)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "capacity": self.capacity,
                "resident": len(self._entries),
                "evictions": self.evictions,
                "entries": [
                    {
                        "key": key_str(e.key),
                        "warm": e.warm,
                        "hits": e.hits,
                        "compiles": e.compiles,
                        "compile_ms": e.compile_ms,
                        "last_request_id": e.last_request_id,
                    }
                    for e in self._entries.values()
                ],
            }


# ---------------------------------------------------------------- warmup
def load_warmup_manifest(path: str) -> List[Dict[str, Any]]:
    """Parse a warmup manifest: {"schema_version": 1, "kind":
    "serve_warmup", "entries": [{"height": H, "width": W,
    "channels": C}, ...]} — the shapes the operator expects traffic
    at, compiled at daemon start so the first client request of each
    shape is a hit.  Malformed manifests raise ValueError at startup
    (a typo'd manifest must fail the daemon's launch, not silently
    leave it cold)."""
    with open(path) as f:
        manifest = json.load(f)
    if not isinstance(manifest, dict) or manifest.get(
        "schema_version"
    ) != WARMUP_SCHEMA_VERSION:
        raise ValueError(
            f"warmup manifest {path}: schema_version "
            f"{manifest.get('schema_version') if isinstance(manifest, dict) else None!r}"
            f" != {WARMUP_SCHEMA_VERSION}"
        )
    if manifest.get("kind") != "serve_warmup":
        raise ValueError(
            f"warmup manifest {path}: kind "
            f"{manifest.get('kind')!r} != 'serve_warmup'"
        )
    entries = manifest.get("entries")
    if not isinstance(entries, list) or not entries:
        raise ValueError(f"warmup manifest {path}: empty 'entries'")
    out = []
    for i, e in enumerate(entries):
        try:
            h, w = int(e["height"]), int(e["width"])
            c = int(e.get("channels", 3))
        except (TypeError, KeyError, ValueError):
            raise ValueError(
                f"warmup manifest {path}: entries[{i}] needs integer "
                "height/width (+ optional channels)"
            ) from None
        if h < 8 or w < 8 or c not in (1, 3):
            raise ValueError(
                f"warmup manifest {path}: entries[{i}] shape "
                f"{h}x{w}x{c} out of range (min 8x8, channels 1|3)"
            )
        out.append({"height": h, "width": w, "channels": c})
    return out


OBSERVED_WARMUP_FILE = "warmup.observed.json"
OBSERVED_WARMUP_KIND = "serve_warmup_observed"


def save_observed_warmup(path: str, shapes, merge: bool = False) -> None:
    """Persist the runtime-observed working set (round 16 satellite:
    warmup-manifest drift).  `shapes` is an LRU-ordered iterable of
    (height, width, channels) actually served by this process; the
    successor merges them into its warmup so restarts pre-compile the
    REAL traffic mix, not just the hand-declared manifest.  Atomic
    write (tmp + replace): a crash mid-write leaves the previous
    generation readable.

    `merge=True` is the round-21 shared-warm-tier mode: the file lives
    under a fleet-shared warm dir, so N replicas write it — each
    writer UNIONS its shapes into whatever is already on disk instead
    of overwriting (last-writer-wins would shrink the fleet's observed
    set to one replica's traffic slice).  The read-union-replace race
    between two simultaneous drains can drop at most one writer's
    fresh shapes for one generation; the loser re-merges them on its
    next sighting, so the union converges."""
    import os

    entries = [
        {"height": int(h), "width": int(w), "channels": int(c)}
        for (h, w, c) in shapes
    ]
    if merge:
        entries = merge_warmup_entries(load_observed_warmup(path),
                                       entries)
    doc = {
        "schema_version": WARMUP_SCHEMA_VERSION,
        "kind": OBSERVED_WARMUP_KIND,
        "entries": entries,
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)


def load_observed_warmup(path: str) -> List[Dict[str, Any]]:
    """Best-effort read of `save_observed_warmup` output: a missing,
    corrupt, or wrong-kind file yields [] — the observed set is an
    optimization, and unlike the operator's manifest it must never
    fail a takeover.  Entries that fail the manifest's own shape
    bounds are skipped individually."""
    import os

    if not os.path.exists(path):
        return []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return []
    if not isinstance(doc, dict) \
            or doc.get("kind") != OBSERVED_WARMUP_KIND:
        return []
    out = []
    for e in doc.get("entries") or []:
        try:
            h, w = int(e["height"]), int(e["width"])
            c = int(e.get("channels", 3))
        except (TypeError, KeyError, ValueError):
            continue
        if h < 8 or w < 8 or c not in (1, 3):
            continue
        out.append({"height": h, "width": w, "channels": c})
    return out


def merge_warmup_entries(*entry_lists) -> List[Dict[str, Any]]:
    """Concatenate warmup entry lists (manifest first, then observed)
    deduplicated by (height, width, channels), order-preserving —
    `run_warmup` dedupes by executable key anyway, this keeps the
    startup report readable."""
    seen = set()
    out = []
    for entries in entry_lists:
        for e in entries or []:
            ident = (e["height"], e["width"], e.get("channels", 3))
            if ident in seen:
                continue
            seen.add(ident)
            out.append(dict(e))
    return out


def run_warmup(entries: List[Dict[str, Any]],
               dispatch_fn: Callable[[tuple], Any],
               cache: "ExecutableCache", key_fn,
               max_workers: int = 4,
               tracer=None) -> List[Dict[str, Any]]:
    """Drive each manifest entry's shape through the daemon's dispatch
    path (a synthetic zero image; `dispatch_fn` performs the cache
    lookup itself, exactly as a client dispatch would, with
    kind="warmup" so warmup traffic stays out of the client ledger).
    Entries are deduplicated by executable key so a manifest that
    repeats a shape never books a warmup "hit" (the sentinel's
    `cache hits <= requests` ledger is a claim about CLIENT traffic).

    Distinct shapes warm CONCURRENTLY on a small thread pool
    (`max_workers`, clamped to the shape count; <= 1 keeps the
    sequential path): their host-side first uses overlap, and the
    card runs their work in submission order on its one queue.  When
    `tracer` is a live Tracer, one `warmup` span tree is attached
    carrying a child span per shape with its first-use wall —
    the per-shape attribution an operator reads instead of one opaque
    startup stall.  Returns per-entry {key, wall_ms} records in
    manifest order."""
    work = []
    seen = set()
    for e in entries:
        shape = (e["height"], e["width"], e["channels"])
        key = key_fn(shape)
        if key in seen:
            continue
        seen.add(key)
        work.append((key, shape))
    t_start = time.perf_counter()
    spans: List[tuple] = []

    def one(key, shape):
        t0 = time.perf_counter()
        dispatch_fn(shape)
        t1 = time.perf_counter()
        wall_ms = (t1 - t0) * 1000.0
        cache.note_compile_ms(key, wall_ms)
        spans.append((key, t0, t1))
        return {"key": key_str(key), "wall_ms": round(wall_ms, 1)}

    if len(work) <= 1 or max_workers <= 1:
        report = [one(key, shape) for key, shape in work]
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
            max_workers=min(int(max_workers), len(work)),
            thread_name_prefix="ia-serve-warmup",
        ) as pool:
            futures = [pool.submit(one, key, shape)
                       for key, shape in work]
            # In submission order (manifest order) — a failed shape
            # raises here exactly as the sequential loop did.
            report = [f.result() for f in futures]
    if tracer is not None and getattr(tracer, "enabled", False) \
            and work:
        from ..telemetry.spans import span_at

        t_end = time.perf_counter()
        root = span_at(
            "warmup", t_start, t_end,
            shapes=len(work),
            workers=min(int(max_workers), len(work)),
        )
        for key, t0, t1 in sorted(spans, key=lambda s: s[1]):
            root.children.append(span_at(
                "warmup_shape", t0, t1, key=key_str(key),
                compile_ms=round((t1 - t0) * 1000.0, 1),
            ))
        tracer.attach_tree(root)
    return report


# ------------------------------------------------------------ disk tier
# The warm tier under <warm root>/excache/ (the fleet-shared --warm-dir,
# else the replica's state dir):
#
#   index.json   {schema_version, fingerprint, entries:
#                 {key_str: {shape, warmup_shape, blobs: []}}}
#
# the reference's index schema (`blobs` stays, always empty: the port
# persists no executable).  An entry is sealed after a successful
# dispatch of its key; the index is merged on every write, so replicas
# sharing one directory compose.  Entries are valid only under the
# BACKEND FINGERPRINT that wrote them (torch and CUDA versions, the
# device, the kernels' sources): any other, the JAX package's included,
# is an honest miss, never a restore.
DISK_SCHEMA_VERSION = 1
_INDEX_FILE = "index.json"


def backend_fingerprint(device: str = "cuda") -> Dict[str, Any]:
    """The environment a sealed warm set is valid in: the torch and CUDA
    versions, the device a daemon on `device` serves on, and the digest
    of the kernels' sources.  A "cpu" daemon never touches CUDA here."""
    import torch

    from ..kernels import sources_digest

    on_card = device == "cuda"
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "platform": "cuda" if on_card else "cpu",
        "device_kind": (torch.cuda.get_device_name(0) if on_card
                        else "cpu"),
        "device_count": torch.cuda.device_count() if on_card else 1,
        "kernels": sources_digest(),
    }


class DiskExecCache:
    """The warm tier: an index of sealed shapes, shared by the replicas
    of a fleet.

    `probe` resolves an in-memory miss one level further down: "disk"
    when the key is sealed under this fingerprint (another process, or
    this one before an eviction, dispatched it), else "miss"; exactly
    one of `ia_excache_disk_{hits,misses}_total{kind}` per probe (the
    sentinel's disk hits + disk misses == in-memory misses).
    `restore_warm_set` dispatches every sealed shape once, before the
    daemon announces, and books the wall in `ia_excache_disk_restore_ms`.
    An unreadable or wrongly-versioned index counts
    `ia_excache_disk_errors_total` and serves misses; it never raises."""

    def __init__(self, root: str, fingerprint: Dict[str, Any],
                 registry=None):
        import os

        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._registry = registry
        self._fp = dict(fingerprint)
        self._lock = threading.RLock()
        # key_str(exec_key) -> {"shape", "warmup_shape", "blobs"}
        self._entries: Dict[str, Dict[str, Any]] = {}
        self.errors = 0
        self.restore_ms: Optional[float] = None
        self.restored: List[list] = []
        self._foreign_seen = False
        self._load_index()

    # ---------------------------------------------------- metrics
    def _reg(self):
        if self._registry is not None:
            return self._registry
        from ..telemetry.metrics import get_registry

        return get_registry()

    def _count(self, which: str, kind: Optional[str] = None) -> None:
        c = self._reg().counter(
            f"ia_excache_disk_{which}_total",
            f"serving warm-tier {which}"
            + (" by request kind" if kind is not None else
               " (unreadable or wrongly-versioned index, failed index "
               "write: counted, served as misses, never raised)"),
        )
        c.inc(labels={"kind": kind} if kind is not None else None)

    def _error(self, why: str) -> None:
        self.errors += 1
        self._count("errors")
        import logging

        logging.getLogger("image_analogies_tpu_torch").warning(
            "disk excache: %s (honest miss)", why
        )

    # ------------------------------------------------------ index
    def _index_path(self) -> str:
        import os

        return os.path.join(self.root, _INDEX_FILE)

    def _read_index(self) -> Optional[Dict[str, Any]]:
        """The on-disk index's entries under this fingerprint; {} when
        there is none or it was written under another backend; None
        (an error counted) when it cannot be read."""
        import os

        path = self._index_path()
        if not os.path.exists(path):
            return {}
        try:
            with open(path, "r", encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            self._error(f"unreadable index {path}")
            return None
        if not isinstance(doc, dict) or doc.get(
            "schema_version"
        ) != DISK_SCHEMA_VERSION:
            self._error(f"index {path}: wrong schema")
            return None
        if doc.get("fingerprint") != self._fp:
            # Not corruption: another backend's warm set is not ours
            # (said once; a probe re-reads the index on every miss).
            if not self._foreign_seen:
                self._foreign_seen = True
                import logging

                logging.getLogger("image_analogies_tpu_torch").warning(
                    "disk excache: backend fingerprint differs (%s vs "
                    "%s); the sealed shapes are honest misses here",
                    doc.get("fingerprint"), self._fp,
                )
            return {}
        out = {}
        for kstr, e in (doc.get("entries") or {}).items():
            if isinstance(e, dict) and isinstance(e.get("shape"), list):
                out[str(kstr)] = {
                    "shape": e.get("shape"),
                    "warmup_shape": e.get("warmup_shape"),
                    "blobs": [],
                }
        return out

    def _load_index(self) -> None:
        entries = self._read_index()
        if entries:
            self._entries.update(entries)

    def _write_index(self) -> None:
        """Whole-index write, merged with what a sibling replica put on
        disk under the same fingerprint (last-writer-wins would drop
        every other replica's sealed shapes).  Two seals racing can
        lose one writer's newest entry for one generation; its next
        seal writes it back, so the union converges."""
        import os

        entries = self._read_index() or {}
        entries.update(self._entries)
        doc = {
            "schema_version": DISK_SCHEMA_VERSION,
            "fingerprint": self._fp,
            "entries": entries,
        }
        tmp = self._index_path() + f".{os.getpid()}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(doc, fh, indent=1, sort_keys=True)
                fh.write("\n")
            os.replace(tmp, self._index_path())
        except OSError as e:
            self._error(f"index write failed: {e}")

    # ------------------------------------------------ seal / probe
    def seal(self, key: ExecKey, warmup_shape) -> None:
        """Seal one key after a SUCCESSFUL dispatch: a failed dispatch
        never claims a warm shape.  `warmup_shape` is the (H, W, C)
        frame shape a restore dispatches."""
        kstr = key_str(key)
        entry = {
            "shape": [int(d) for d in key[0]],
            "warmup_shape": [int(d) for d in warmup_shape],
            "blobs": [],
        }
        with self._lock:
            if self._entries.get(kstr) == entry:
                return
            self._entries[kstr] = entry
            self._write_index()

    def probe(self, key: ExecKey, kind: str = "client") -> str:
        """The verdict for a key the in-memory cache just missed: "disk"
        when it is sealed here or, since this process started, by a
        sibling (the index is re-read on a local miss), else "miss"."""
        kstr = key_str(key)
        with self._lock:
            hit = kstr in self._entries
            if not hit:
                fresh = self._read_index() or {}
                if kstr in fresh:
                    self._entries[kstr] = fresh[kstr]
                    hit = True
        self._count("hits" if hit else "misses", kind)
        return "disk" if hit else "miss"

    # ------------------------------------------------------ restore
    def warmup_shapes(self) -> List[Dict[str, Any]]:
        """The sealed entries' frame shapes as warmup-manifest entries."""
        out = []
        with self._lock:
            for entry in self._entries.values():
                ws = entry.get("warmup_shape")
                if isinstance(ws, list) and len(ws) == 3:
                    out.append({
                        "height": int(ws[0]), "width": int(ws[1]),
                        "channels": int(ws[2]),
                    })
        return out

    def restore_warm_set(self, dispatch_fn: Callable[[tuple], Any]
                         ) -> List[Dict[str, Any]]:
        """Dispatch every sealed shape once through `dispatch_fn` (the
        daemon's warmup dispatch, whose cache lookup misses and whose
        probe answers "disk"), before the port is announced.  Returns
        per-shape {shape, wall_ms} and sets `ia_excache_disk_restore_ms`
        to the total wall."""
        report = []
        t_all = time.perf_counter()
        for e in self.warmup_shapes():
            shape = (e["height"], e["width"], e["channels"])
            t0 = time.perf_counter()
            dispatch_fn(shape)
            report.append({
                "shape": list(shape),
                "wall_ms": round((time.perf_counter() - t0) * 1000.0, 1),
            })
        self.restore_ms = round((time.perf_counter() - t_all) * 1000.0, 1)
        self.restored = [r["shape"] for r in report]
        self._reg().gauge(
            "ia_excache_disk_restore_ms",
            "wall of the last daemon-start warm-tier restore (one "
            "dispatch of every sealed shape, before the port announce)",
        ).set(self.restore_ms)
        return report

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "root": self.root,
                "enabled": True,
                "entries": len(self._entries),
                "restored": list(self.restored),
                "errors": self.errors,
                "restore_ms": self.restore_ms,
                "fingerprint": dict(self._fp),
            }
