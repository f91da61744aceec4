"""Deterministic fault injection: the chaos half of the supervised
execution layer (with runtime/supervisor.py).

Named injection points in the runners' host-side loop, each reproducing
a fault class the supervisor claims to survive:

    level    start of one pyramid level (key = level); also the
             supervisor's abort checkpoint
    kernel   just before the level's matcher work, where its kernels
             launch (key = level)
    ckpt     the per-level checkpoint write, `_save_level` (key = level;
             `truncate` cuts the artifact AFTER the atomic rename: the
             partial write that survived on disk, which resume skips)
    xfer     the host-to-device input transfer (key = ordinal, 0 for a
             run's first)

armed by a fault plan (`IA_FAULT_PLAN` or `set_fault_plan`): comma or
semicolon separated entries

    <point>:<key>:<action>[:<arg>]

    level:2:raise        raise InjectedFault at level 2's start
    level:1:hang:30      hang level 1's start for 30 s (interruptible)
    ckpt:1:truncate      truncate level 1's checkpoint after writing it
    xfer:0:fail          raise InjectedTransferError at transfer 0
    kernel:0:raise:3     raise at level 0's kernel point, 3 times

Each entry is armed for a finite count (default 1; the optional fourth
field is the count for raise / fail / truncate and the seconds for
hang) and disarms as it fires, so a supervised retry that replays the
failed level heals.  Every firing books
`ia_fault_injections_total{point, action}`.

The `level` point is the supervisor's abort checkpoint: each supervised
attempt runs on a worker thread with a thread-local abort token
(`set_abort_token`); a watchdog breach sets it, and the next
`fire("level", ...)` on that thread (or an interrupted `hang`) raises
`LevelAborted`, so an abandoned attempt unwinds at its next level
boundary.  Unsupervised runs carry no token and pay one falsy check.
The reference's module, copied; its serving-plane points wait for the
serving slice.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

POINTS = ("level", "kernel", "ckpt", "xfer")
ACTIONS = ("raise", "hang", "truncate", "fail")

class InjectedFault(RuntimeError):
    """A planned `raise` injection fired."""


class InjectedTransferError(InjectedFault):
    """A planned `fail` injection fired (simulated device-transfer /
    launch failure — a distinct type so tests can assert the class)."""


class LevelAborted(RuntimeError):
    """The supervisor's abort token was set for this attempt: the
    worker unwinds at the next level boundary (never user-visible —
    the supervisor eats it when it reaps the abandoned attempt)."""


@dataclass
class _Entry:
    point: str
    key: int
    action: str
    arg: float  # hang seconds, or remaining-count for other actions
    remaining: int = 1


@dataclass
class FaultPlan:
    """A parsed, mutable (entries disarm as they fire) fault plan.

    `match` is locked: a zombie abandoned attempt that outlived its
    abort grace and the fresh retry can reach the same armed point
    concurrently, and a single-count entry must fire exactly once —
    a double-firing would both kill the retry and double-book the
    injection counter."""

    entries: List[_Entry] = field(default_factory=list)
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    @classmethod
    def parse(cls, spec: Optional[str]) -> Optional["FaultPlan"]:
        """Parse the IA_FAULT_PLAN grammar; None/"" -> None (no plan).
        Malformed specs raise ValueError at parse time — a typo'd plan
        must fail at startup, not silently never fire."""
        if not spec or not str(spec).strip():
            return None
        entries: List[_Entry] = []
        for raw in str(spec).replace(";", ",").split(","):
            raw = raw.strip()
            if not raw:
                continue
            parts = raw.split(":")
            if len(parts) not in (3, 4):
                raise ValueError(
                    f"fault-plan entry {raw!r} is not "
                    "'point:key:action[:arg]'"
                )
            point, key_s, action = parts[0], parts[1], parts[2]
            if point not in POINTS:
                raise ValueError(
                    f"fault-plan point {point!r} names none of {POINTS}"
                )
            if action not in ACTIONS:
                raise ValueError(
                    f"fault-plan action {action!r} names none of "
                    f"{ACTIONS}"
                )
            if action == "truncate" and point != "ckpt":
                raise ValueError(
                    f"fault-plan entry {raw!r}: 'truncate' only "
                    "applies to the 'ckpt' point"
                )
            try:
                key = int(key_s)
            except ValueError:
                raise ValueError(
                    f"fault-plan key {key_s!r} is not an integer"
                ) from None
            arg_s = parts[3] if len(parts) == 4 else None
            if action == "hang":
                try:
                    arg = float(arg_s) if arg_s is not None else 5.0
                except ValueError:
                    raise ValueError(
                        f"fault-plan hang seconds {arg_s!r} is not a "
                        "number"
                    ) from None
                count = 1
            else:
                try:
                    count = int(arg_s) if arg_s is not None else 1
                except ValueError:
                    raise ValueError(
                        f"fault-plan count {arg_s!r} is not an integer"
                    ) from None
                arg = 0.0
            if count < 1:
                raise ValueError(
                    f"fault-plan entry {raw!r}: count must be >= 1"
                )
            entries.append(_Entry(point, key, action, arg, count))
        return cls(entries)

    def match(self, point: str, key: int) -> Optional[_Entry]:
        """The first still-armed entry for (point, key), disarmed by
        one firing — or None."""
        with self._lock:
            for e in self.entries:
                if e.point == point and e.key == key and e.remaining > 0:
                    e.remaining -= 1
                    return e
        return None

    def armed(self) -> List[Tuple[str, int, str]]:
        return [
            (e.point, e.key, e.action)
            for e in self.entries if e.remaining > 0
        ]


# Process-wide plan: parsed once from the environment (subprocess tests
# and the CLI arm it with IA_FAULT_PLAN), replaceable in-process via
# set_fault_plan (the chaos suite / unit tests).  The _PLAN_RESOLVED
# latch keeps the un-armed fast path to one None check.
_PLAN: Optional[FaultPlan] = None
_PLAN_RESOLVED = False
_PLAN_LOCK = threading.Lock()


def resolve_fault_plan() -> Optional[FaultPlan]:
    global _PLAN, _PLAN_RESOLVED
    if not _PLAN_RESOLVED:
        with _PLAN_LOCK:
            if not _PLAN_RESOLVED:
                _PLAN = FaultPlan.parse(os.environ.get("IA_FAULT_PLAN"))
                _PLAN_RESOLVED = True
    return _PLAN


def set_fault_plan(spec_or_plan) -> Optional[FaultPlan]:
    """Install a plan process-wide (None disarms): accepts a grammar
    string or an already-parsed FaultPlan.  Returns the installed
    plan."""
    global _PLAN, _PLAN_RESOLVED
    with _PLAN_LOCK:
        _PLAN = (
            spec_or_plan if isinstance(spec_or_plan, (FaultPlan,
                                                      type(None)))
            else FaultPlan.parse(spec_or_plan)
        )
        _PLAN_RESOLVED = True
    return _PLAN


# Per-thread abort token (runtime/supervisor.AbortToken): each
# supervised attempt installs its own on its worker thread, so a stale
# abandoned attempt keeps seeing its (set) token while the fresh
# attempt runs clean.
_TLS = threading.local()


def set_abort_token(token) -> None:
    _TLS.token = token


def _record_injection(point: str, action: str) -> None:
    from ..telemetry.metrics import get_registry

    get_registry().counter(
        "ia_fault_injections_total",
        "planned fault injections fired (runtime/faults.py)",
    ).inc(labels={"point": point, "action": action})


def fire(point: str, key: int) -> Optional[str]:
    """The injection point: called by the engine's eager glue.

    Checks the thread-local abort token first (raising LevelAborted at
    `level` points when set — the supervisor's attempt-abandonment
    boundary), then the armed plan.  Returns the action name for
    caller-interpreted actions ("truncate"), None otherwise; raising
    actions raise.  The un-armed, un-supervised fast path is two falsy
    checks."""
    token = getattr(_TLS, "token", None)
    if token is not None and point == "level" and token.is_set():
        raise LevelAborted(
            f"supervisor aborted this attempt (level {key})"
        )
    plan = _PLAN if _PLAN_RESOLVED else resolve_fault_plan()
    if plan is None:
        return None
    entry = plan.match(point, key)
    if entry is None:
        return None
    _record_injection(point, entry.action)
    import logging

    logging.getLogger("image_analogies_tpu_torch").warning(
        "fault injection: %s:%d:%s fired", point, key, entry.action
    )
    if entry.action == "hang":
        _hang(entry.arg, token, point, key)
        return None
    if entry.action == "raise":
        raise InjectedFault(f"injected fault at {point}:{key}")
    if entry.action == "fail":
        raise InjectedTransferError(
            f"injected transfer failure at {point}:{key}"
        )
    return entry.action  # "truncate": the ckpt writer interprets it


def _hang(seconds: float, token, point: str, key: int) -> None:
    """Interruptible hang: sleeps in short slices so a supervisor
    abort (watchdog breach) or a delivered signal ends it promptly; an
    aborted hang raises LevelAborted so the abandoned worker unwinds
    instead of finishing the level it was hung at."""
    deadline = time.perf_counter() + float(seconds)
    while time.perf_counter() < deadline:
        if token is not None and token.is_set():
            raise LevelAborted(
                f"supervisor aborted a hung attempt at {point}:{key}"
            )
        time.sleep(min(0.05, max(0.0, deadline - time.perf_counter())))
