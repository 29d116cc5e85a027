"""The recorder of sanctioned degradations.

Counterpart of ``variantcalling_tpu/utils/degrade.py``. A broad handler
whose fallback cannot change output bytes (a chunk-cache entry that could
not be read or written, a chunk diverted to the quarantine sidecar under
``VCTPU_QUARANTINE=1``) routes through :func:`record`, which logs the event
with its fallback and keeps a bounded trail (:data:`EVENTS`) that tests and
operators can read. Scoring-path failures never degrade: they fail the run.
"""

from __future__ import annotations

import logging
import threading
from collections import deque

log = logging.getLogger(__name__)

#: bounded trail of (point, exception text, fallback) — newest last
EVENTS: deque[tuple[str, str, str]] = deque(maxlen=256)
_LOCK = threading.Lock()


def record(point: str, exc: BaseException | None = None,
           fallback: str = "", warn: bool = False) -> None:
    """Record one sanctioned degradation at ``point`` (a dotted site name);
    ``fallback`` says what the code does instead. ``warn=True`` logs at
    warning level (a human should notice), else at debug."""
    exc_text = "" if exc is None else f"{type(exc).__name__}: {exc}"
    with _LOCK:
        EVENTS.append((point, exc_text, fallback))
    (log.warning if warn else log.debug)("degradation %s: %s -> %s", point, exc_text or "(no exception)",
                                         fallback or "(continue)")


def events_for(point: str) -> list[tuple[str, str, str]]:
    """The recorded events of one point (tests)."""
    with _LOCK:
        return [e for e in EVENTS if e[0] == point]


def clear_for_tests() -> None:
    with _LOCK:
        EVENTS.clear()
