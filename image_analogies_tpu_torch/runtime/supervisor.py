"""Supervised synthesis: runs that survive, not only runs that are
observed (with runtime/faults.py).

The engine has what a supervisor needs: bit-exact per-level checkpoint
and resume (`models/analogy.py`; every random draw derives from the
level index, so a resumed run is the uninterrupted run), a per-level
cost model (`level_eta_cost_units`, declared on the `run_plan` mark) and
process-wide fallback switches.  Four pieces:

1. WATCHDOG: each level gets the deadline
       max(min_deadline_s, eta_cost_units[level] x s_per_unit x slack)
   with s_per_unit calibrated from the levels this attempt finished;
   before any level finishes, `static_deadline_s` applies (and bounds a
   run that hangs before its first level).  The watchdog is a tracer
   observer: it reads the plan from `run_plan` and level walls from the
   level spans, so supervision adds no device sync.  A breach flushes
   the flight recorder ("watchdog"), books
   `ia_watchdog_breaches_total{level}` and aborts the attempt.

2. RETRY WITH RESUME: supervised mode forces `save_level_artifacts`, so
   after a failure the retry (with exponential backoff) resumes from the
   last intact checkpoint and replays only the failed level; while the
   ladder has not stepped, the healed run is bit-identical to an
   undisturbed one.  Every failure books `ia_retries_total{stage,
   reason}`.

3. DEGRADATION LADDER: after `max_retries` failures in one mode the
   supervisor steps down `default_ladder` (stream to sequential polish,
   int8 to bf16 candidates, pruned to full candidates), records a
   `degradation` mark and `ia_degradations_total{from, to}`, resets the
   retry budget and tries again.

4. GIVE-UP: with the ladder exhausted and the budget spent, it flushes a
   final flight dump ("violation") and raises `SupervisorGaveUp`; the
   CLI exits non-zero.

Attempts run on daemon worker threads: a hung attempt cannot be killed,
so a breached one is abandoned; its abort token makes the injected hang
and the next level boundary raise `LevelAborted`, and the supervisor
waits up to `abort_grace_s` for it to unwind.  A retry first waits for
the device work already queued (`_settle_device`).  The reference's
module, copied; its serving-dispatch deadline waits for the serving
slice.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from . import faults

# Conservative pre-calibration per-level bound: long enough that no
# legitimate level at the published scales (the kernels' first build
# included) trips it, short enough that an operator's "it's been stuck for a quarter
# hour" intuition is automated.  Post-calibration deadlines come from
# the cost model instead; min_deadline_s floors them so a 64^2 coarse
# level's microsecond-scale units can't produce a hair-trigger.
STATIC_DEADLINE_S = 900.0
MIN_DEADLINE_S = 10.0
WATCHDOG_SLACK = 4.0


class SupervisorGaveUp(RuntimeError):
    """Retries and ladder exhausted; the flight dump is the
    post-mortem.  Carries the last attempt's error as __cause__."""


class AbortToken:
    """Per-attempt abort flag shared between the watchdog (setter),
    the supervisor loop (reader), and the attempt's injection points
    (runtime/faults.fire raises LevelAborted when set)."""

    def __init__(self):
        self._event = threading.Event()
        self.reason: Optional[str] = None

    def set(self, reason: str) -> None:
        self.reason = reason
        self._event.set()

    def is_set(self) -> bool:
        return self._event.is_set()


@dataclass(frozen=True)
class Rung:
    """One degradation-ladder step over an existing seam.

    `applies()` answers "is the process currently in the mode this
    rung steps DOWN from?"; `apply()` installs the degraded mode
    through the switch's setter.  `bit_safe` documents whether the step
    preserves bit-identity to the pre-step mode."""

    name: str
    from_label: str
    to_label: str
    applies: Callable[[], bool]
    apply: Callable[[], None]
    bit_safe: bool = True


def default_ladder() -> List[Rung]:
    """The ladder over the port's process-wide switches, safest and
    cheapest first, in the reference's order.  Each rung engages only
    when the process is in its from-mode, so a default-mode run has no
    rung to step.  The reference's fourth rung, packed to unpacked A
    planes, has no counterpart: the port has no packed layout."""
    from ..kernels import patchmatch_tile as _pt
    from ..models import patchmatch as _pm

    return [
        Rung(
            "polish_stream_to_sequential", "stream", "sequential",
            applies=lambda: _pm._POLISH_MODE == "stream",
            apply=lambda: _pm.set_polish_mode("sequential"),
            bit_safe=True,  # the streamed fetch gives the same rows
        ),
        Rung(
            "cand_int8_to_bf16", "int8", "bf16",
            applies=lambda: _pt.resolve_cand_dtype() == "int8",
            apply=lambda: _pt.set_cand_compression(cand_dtype="bf16"),
            bit_safe=False,  # bf16 is the uncompressed path: better
            # quality, not the int8 arm's bits
        ),
        Rung(
            "cand_pruned_to_full", "pruned", "full",
            applies=lambda: _pt.resolve_prune() is not None,
            apply=lambda: _pt.set_cand_compression(prune="off"),
            bit_safe=False,  # the full candidate set >= the pruned one
        ),
    ]


class _Watchdog:
    """Tracer-observer deadline monitor for one supervise() call.

    State is reset per attempt (`arm`); the observer ignores events
    from threads other than the current attempt's worker, so a zombie
    abandoned attempt can neither calibrate nor false-trigger the
    fresh one."""

    def __init__(self, tracer, registry, slack: float,
                 static_deadline_s: float, min_deadline_s: float):
        self.tracer = tracer
        self.registry = registry
        self.slack = float(slack)
        self.static_deadline_s = float(static_deadline_s)
        self.min_deadline_s = float(min_deadline_s)
        self._lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._token: Optional[AbortToken] = None
        self._reset_state()

    def _reset_state(self) -> None:
        self.units: Dict[int, float] = {}
        self.done_wall_s = 0.0
        self.done_units = 0.0
        self.open_level: Optional[int] = None
        self.open_t: Optional[float] = None
        self.last_level: Optional[int] = None
        self.attempt_t0 = time.perf_counter()
        # Last forward progress: any level close restarts this clock,
        # so the BETWEEN-levels window (where the engine's eager glue,
        # checkpoint writes, and the parallel runners' whole level
        # bodies live — their level spans are recorded close-only,
        # after the fact) is monitored too, against the NEXT level's
        # deadline.
        self.last_progress_t = self.attempt_t0

    # -- observer (runs on the worker thread) -------------------------
    def observe(self, kind: str, sp) -> None:
        if self._worker is not threading.current_thread():
            return
        with self._lock:
            if kind == "mark" and sp.name == "run_plan":
                raw = (sp.attrs or {}).get("eta_cost_units") or {}
                try:
                    self.units = {int(k): float(v) for k, v in raw.items()}
                except (TypeError, ValueError):
                    self.units = {}
            elif sp.name == "level":
                lvl = (sp.attrs or {}).get("level")
                if kind == "open":
                    self.open_level = lvl
                    self.open_t = time.perf_counter()
                    self.last_level = lvl
                elif kind == "close":
                    if sp.wall_ms is not None and lvl is not None:
                        u = self.units.get(int(lvl))
                        if u:
                            self.done_wall_s += sp.wall_ms / 1000.0
                            self.done_units += u
                    if lvl is not None:
                        self.last_level = lvl
                    self.open_level = None
                    self.open_t = None
                    self.last_progress_t = time.perf_counter()

    # -- per-attempt lifecycle ---------------------------------------
    def arm(self, worker: threading.Thread, token: AbortToken) -> None:
        with self._lock:
            self._worker = worker
            self._token = token
            self._reset_state()

    def level_deadline_s(self, level: Optional[int]) -> float:
        """The breach bound for the currently-open level (or for the
        pre-first-level window when `level` is None)."""
        if level is None:
            return self.static_deadline_s
        if self.done_units > 0 and self.done_wall_s > 0:
            rate = self.done_wall_s / self.done_units
            u = self.units.get(int(level))
            if u:
                return max(self.min_deadline_s, u * rate * self.slack)
        return self.static_deadline_s

    def check(self) -> bool:
        """Poll once; returns True (and aborts the attempt) on a
        breach."""
        with self._lock:
            token = self._token
            if token is None or token.is_set():
                return False
            if self.open_t is not None:
                level, elapsed = (
                    self.open_level,
                    time.perf_counter() - self.open_t,
                )
            else:
                # No open span: the pre-first-level window (prologue /
                # transfer), the between-levels glue, or a parallel
                # runner's level body (their spans record close-only).
                # The clock is time-since-last-progress; the bound is
                # the NEXT level's deadline once one is known.
                level = (
                    self.last_level - 1
                    if self.last_level is not None and self.last_level > 0
                    else None
                )
                elapsed = time.perf_counter() - self.last_progress_t
            deadline = self.level_deadline_s(level)
        if elapsed <= deadline:
            return False
        self.registry.counter(
            "ia_watchdog_breaches_total",
            "supervised level deadlines breached (cost-model deadline "
            "x slack, or the static pre-calibration bound)",
        ).inc(labels={"level": str(level if level is not None else "prologue")})
        recorder = getattr(self.tracer, "flight_recorder", None)
        if recorder is not None:
            recorder.flush("watchdog")
        import logging

        logging.getLogger("image_analogies_tpu_torch").warning(
            "watchdog: level %s exceeded its %.1f s deadline "
            "(%.1f s elapsed) — aborting the attempt",
            level if level is not None else "prologue", deadline, elapsed,
        )
        token.set("watchdog")
        return True


def _has_checkpoint(ckpt_dir: str) -> bool:
    """Whether the supervisor's checkpoint dir holds ANY per-level
    artifact yet (chunked batch runs write level files into frames_*
    subdirectories, so the walk covers those too).  Until it does, a
    retry must fall back to the caller's original resume source — a
    failure at the coarsest level would otherwise resume from an empty
    directory, discarding a user-supplied --resume-from's progress
    (and, under --strict-resume, deterministically erroring every
    retry into a spurious give-up)."""
    import re

    try:
        for _root, _dirs, files in os.walk(ckpt_dir):
            if any(re.fullmatch(r"level_\d+\.npz", f) for f in files):
                return True
    except OSError:
        pass
    return False


def _drain_span_stack(tracer) -> None:
    """Pop every open span off the shared tracer's stack after an
    abandoned attempt outlived its abort grace: the zombie thread can
    create no further spans (its next fault checkpoint raises
    LevelAborted before any span opens), but its still-open run/level
    spans would otherwise become the PARENT of the fresh attempt's
    spans, mis-rooting the tree.  List ops are
    GIL-atomic (the stack_snapshot pattern), and Tracer._close pops
    only when its own span is top-of-stack, so the zombie's eventual
    unwinding closes its (already-recorded) spans without touching the
    fresh attempt's.  A zombie that NEVER unwinds leaves its spans
    open — an honest signal that a wedged thread still holds a device
    call."""
    while getattr(tracer, "_stack", None):
        try:
            tracer._stack.pop()
        except IndexError:
            break


def _settle_device() -> None:
    """Before a retry: wait for the device work the failed or abandoned
    attempt queued, so the retry does not allocate beside a run still in
    flight.  Runs inside the retry's attempt: a sticky CUDA error (an
    illegal address poisons the context) raises there, fails the attempt
    like the first one, and the run ends in the give-up, unmasked.  A
    run that never touched CUDA does not initialise it here."""
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _failure_reason(token: AbortToken, error: Optional[BaseException]
                    ) -> str:
    if token.is_set() and token.reason == "watchdog":
        return "watchdog"
    if isinstance(error, faults.InjectedTransferError):
        return "transfer"
    if isinstance(error, faults.InjectedFault):
        return "injected"
    return "exception"


def supervise(
    attempt_fn: Callable[[Optional[str]], Any],
    *,
    ckpt_dir: str,
    tracer=None,
    registry=None,
    initial_resume: Optional[str] = None,
    max_retries: int = 2,
    watchdog_slack: float = WATCHDOG_SLACK,
    static_deadline_s: float = STATIC_DEADLINE_S,
    min_deadline_s: float = MIN_DEADLINE_S,
    backoff_s: float = 0.5,
    max_backoff_s: float = 30.0,
    ladder: Optional[List[Rung]] = None,
    abort_grace_s: float = 10.0,
    poll_s: float = 0.05,
):
    """Run `attempt_fn` under supervision and return its result.

    `attempt_fn(resume_from)` is one synthesis attempt — a closure the
    CLI builds around the chosen runner, whose cfg has
    `save_level_artifacts=ckpt_dir` forced on.  The first attempt gets
    `initial_resume` (the user's --resume-from, usually None); every
    retry resumes from `ckpt_dir`, the checkpoints the failed attempts
    left behind.

    `ladder=None` installs `default_ladder()`; pass [] for no ladder
    (clean-death after the retry budget).  `max_retries` is the retry
    budget PER LADDER RUNG — stepping down a rung resets it.
    """
    from ..telemetry.metrics import get_registry

    if registry is None:
        registry = (
            tracer.registry
            if tracer is not None and getattr(tracer, "registry", None)
            is not None
            else get_registry()
        )
    rungs = list(default_ladder() if ladder is None else ladder)
    watch = _Watchdog(
        tracer, registry, watchdog_slack, static_deadline_s,
        min_deadline_s,
    )
    observing = (
        tracer is not None and getattr(tracer, "enabled", False)
    )
    if observing:
        tracer.add_observer(watch.observe)
    # One booking per supervise() call: attempts and retries are read
    # against it.
    registry.counter(
        "ia_supervisor_invocations_total",
        "supervise() invocations (one per supervised run or serving "
        "dispatch)",
    ).inc()
    attempts_c = registry.counter(
        "ia_supervisor_attempts_total",
        "supervised synthesis attempts started (first try + retries)",
    )
    retries_c = registry.counter(
        "ia_retries_total",
        "supervised attempt failures, by failing stage (pyramid level "
        "or 'prologue'/'run') and reason",
    )
    degr_c = registry.counter(
        "ia_degradations_total",
        "graceful-degradation ladder steps taken {from, to}",
    )

    failures_at_rung = 0
    attempt_idx = 0
    last_error: Optional[BaseException] = None
    try:
        while True:
            token = AbortToken()
            box: Dict[str, Any] = {}
            # Retries resume from the supervisor's checkpoints once any
            # exist; before that (a coarsest-level/prologue failure)
            # the caller's original resume source still applies.
            resume = (
                ckpt_dir
                if attempt_idx > 0 and _has_checkpoint(ckpt_dir)
                else initial_resume
            )

            def _body(resume=resume, token=token, box=box,
                      retry=attempt_idx > 0):
                faults.set_abort_token(token)
                try:
                    if retry:
                        _settle_device()
                    box["result"] = attempt_fn(resume)
                except BaseException as e:  # noqa: BLE001 - reaped below
                    box["error"] = e

            worker = threading.Thread(
                target=_body, name=f"ia-supervised-attempt-{attempt_idx}",
                daemon=True,
            )
            watch.arm(worker, token)
            attempts_c.inc()
            attempt_idx += 1
            worker.start()
            while worker.is_alive() and not token.is_set():
                worker.join(poll_s)
                if worker.is_alive() and observing:
                    # No observer -> no event source: a watchdog that
                    # cannot see levels would clock a healthy long run
                    # against the static bound and falsely breach it.
                    # Without a tracer the supervisor still retries on
                    # exceptions; only deadline enforcement is off.
                    watch.check()
            if token.is_set() and worker.is_alive():
                # Breached: give the abandoned attempt a bounded window
                # to unwind through its abort checkpoints.
                worker.join(abort_grace_s)
                if worker.is_alive():
                    # Truly wedged (a hung device call the abort token
                    # cannot interrupt): clear its open spans off the
                    # shared stack so the retry's tree roots correctly
                    # (_drain_span_stack docstring has the safety
                    # argument).
                    import logging

                    logging.getLogger("image_analogies_tpu_torch").warning(
                        "supervisor: abandoned attempt still alive "
                        "after %.0f s grace — proceeding; its open "
                        "spans are detached from the live stack",
                        abort_grace_s,
                    )
                    _drain_span_stack(tracer)
            if "result" in box and not token.is_set():
                return box["result"]

            error = box.get("error")
            if isinstance(error, (KeyboardInterrupt, SystemExit)):
                raise error
            from ..models.analogy import ResumeError

            if isinstance(error, ResumeError):
                # A strict-resume failure is a CONFIG error, not a
                # transient fault: retrying would recompute from
                # scratch and exit 0 — the exact outcome the flag
                # exists to forbid.
                raise error
            if error is not None:
                # The failed attempt's frames hold its tensors (a whole
                # level's tables at the large sizes): drop them before
                # the retry allocates its own.
                traceback.clear_frames(error.__traceback__)
            last_error = error or SupervisorGaveUp(
                f"attempt aborted: {token.reason}"
            )
            reason = _failure_reason(token, error)
            stage = (
                str(watch.last_level)
                if watch.last_level is not None else "prologue"
            )
            retries_c.inc(labels={"stage": stage, "reason": reason})
            failures_at_rung += 1
            import logging

            log = logging.getLogger("image_analogies_tpu_torch")
            if failures_at_rung > max_retries:
                # Retry budget spent at this mode: step the ladder.
                rung = next((r for r in rungs if r.applies()), None)
                if rung is None:
                    recorder = getattr(tracer, "flight_recorder", None)
                    if recorder is not None:
                        recorder.flush("violation")
                    raise SupervisorGaveUp(
                        f"supervised synthesis failed after "
                        f"{attempt_idx} attempts (retries and "
                        "degradation ladder exhausted) — see the "
                        "flight dump"
                    ) from last_error
                rung.apply()
                degr_c.inc(labels={
                    "from": rung.from_label, "to": rung.to_label,
                })
                if tracer is not None and getattr(
                    tracer, "enabled", False
                ):
                    tracer.annotate(
                        "degradation", rung=rung.name,
                        from_mode=rung.from_label, to_mode=rung.to_label,
                        bit_safe=rung.bit_safe,
                    )
                log.warning(
                    "supervisor: stepping degradation ladder %s "
                    "(%s -> %s) after %d failures",
                    rung.name, rung.from_label, rung.to_label,
                    failures_at_rung,
                )
                failures_at_rung = 0
            else:
                log.warning(
                    "supervisor: attempt %d failed at stage %s "
                    "(%s: %s) — retrying from %s",
                    attempt_idx, stage, reason, last_error, ckpt_dir,
                )
            if backoff_s > 0:
                time.sleep(min(
                    max_backoff_s,
                    backoff_s * (2.0 ** max(0, failures_at_rung - 1)),
                ))
    finally:
        if observing:
            tracer.remove_observer(watch.observe)
