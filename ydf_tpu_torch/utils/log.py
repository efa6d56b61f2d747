"""Small leveled stderr logger (`YDF_TPU_LOG=quiet|info|debug`);
counterpart of ydf_tpu/utils/log.py.

One write-through point that the telemetry exporter also logs through
(utils/telemetry.py flush). Deliberately not the stdlib `logging`
module: no handler/config surface to drift, one environment variable,
validated EAGERLY at import like every other YDF_TPU_* variable (a
misspelled level fails the first import).

Levels: `quiet` (nothing), `info` (default — user-facing status lines),
`debug` (per-iteration training progress, telemetry exporter notes).
Output format: `[ydf_tpu] message` to stderr; stdout stays reserved for
program OUTPUT (predictions, JSON records, reports).
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Optional

__all__ = ["LEVEL", "LEVELS", "info", "debug", "warn", "is_debug", "set_level"]

LEVELS = ("quiet", "info", "debug")

_RANK = {name: i for i, name in enumerate(LEVELS)}


def _parse_level(value: Optional[str]) -> str:
    v = (value or "info").strip().lower() or "info"
    if v not in LEVELS:
        raise ValueError(
            f"YDF_TPU_LOG={value!r} is not one of {list(LEVELS)}"
        )
    return v


LEVEL: str = _parse_level(os.environ.get("YDF_TPU_LOG"))

_LOCK = threading.Lock()


def set_level(level: str) -> None:
    """Programmatic override (same validation as the env var)."""
    global LEVEL
    LEVEL = _parse_level(level)


def is_debug() -> bool:
    """Guard for call sites whose message FORMATTING is itself costly
    (e.g. materializing device arrays for a per-chunk progress line)."""
    return _RANK[LEVEL] >= _RANK["debug"]


def _write(msg: str) -> None:
    with _LOCK:
        try:
            sys.stderr.write(f"[ydf_tpu] {msg}\n")
            sys.stderr.flush()
        except (OSError, ValueError):
            pass  # closed/broken stderr must never crash the caller
    try:
        # Mirror every emitted line into the telemetry flight recorder
        # (a bounded ring; flight_record is a free no-op when telemetry
        # is off). Lazy import: log must stay importable stand-alone and
        # a telemetry env error must surface from telemetry's own
        # import, not from a log line.
        from ydf_tpu_torch.utils import telemetry

        telemetry.flight_record("log", line=msg)
    except Exception:
        pass


def info(msg: str) -> None:
    if _RANK[LEVEL] >= _RANK["info"]:
        _write(msg)


def warn(msg: str) -> None:
    """Warnings respect `quiet` (an explicit quiet means quiet);
    anything that must not be suppressible should raise instead."""
    if _RANK[LEVEL] >= _RANK["info"]:
        _write(f"warning: {msg}")


def debug(msg: str) -> None:
    if _RANK[LEVEL] >= _RANK["debug"]:
        _write(msg)
