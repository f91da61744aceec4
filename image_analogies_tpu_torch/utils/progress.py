"""Logging setup and the JSON-lines progress stream.

`ProgressWriter` is the JSONL event sink; it is usually the sink of a
`telemetry.Tracer` (the span layer emits the same event stream as its
view) but works on its own.  Each record carries the relative `t`
(seconds since the writer was made) and an absolute ISO-8601 UTC `ts`.
A copy of the reference's module; the port logs under
"image_analogies_tpu_torch".
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import time
from typing import Optional

logger = logging.getLogger("image_analogies_tpu_torch")

_LEVELS = ("debug", "info", "warning", "error", "critical")


def configure_logging(level: Optional[str]) -> None:
    """Attach a stderr handler to the package logger at `level` ('debug'
    | 'info' | ...; None leaves logging as it is).  Idempotent:
    configuring again adjusts the level instead of stacking handlers."""
    if level is None:
        return
    level = level.lower()
    if level not in _LEVELS:
        raise ValueError(f"log level {level!r} not in {_LEVELS}")
    logger.setLevel(getattr(logging, level.upper()))
    for h in logger.handlers:
        if getattr(h, "_ia_cli_handler", False):
            h.setLevel(getattr(logging, level.upper()))
            return
    handler = logging.StreamHandler()
    handler._ia_cli_handler = True  # type: ignore[attr-defined]
    handler.setLevel(getattr(logging, level.upper()))
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    )
    logger.addHandler(handler)


def _iso_now(offset_ms: float = 0.0) -> str:
    """ISO-8601 UTC timestamp, shifted by `offset_ms` (negative: in the
    past; spans recorded after the fact backdate their start so)."""
    t = _dt.datetime.now(_dt.timezone.utc)
    if offset_ms:
        t += _dt.timedelta(milliseconds=offset_ms)
    return t.isoformat(timespec="milliseconds").replace("+00:00", "Z")


class ProgressWriter:
    """Append one JSON object per event to a .jsonl file (or log only).

    The file is opened once, line-buffered, on the first emit, so every
    event reaches the OS as its line is written and a killed run's
    stream is complete up to the kill."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._t0 = time.perf_counter()
        self._f = None

    def emit(self, event: str, **fields) -> None:
        rec = {
            "event": event,
            "t": round(time.perf_counter() - self._t0, 4),
            "ts": _iso_now(),
        }
        rec.update(fields)
        logger.info("%s %s", event, fields)
        if self.path:
            if self._f is None:
                self._f = open(self.path, "a", buffering=1)
            self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "ProgressWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best effort: line buffering already flushed
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
