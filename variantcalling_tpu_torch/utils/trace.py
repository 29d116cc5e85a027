"""Tracing: the process-wide table of closed wall-clock spans.

Counterpart of ``variantcalling_tpu/utils/trace.py``. Every stage a tool
times (:func:`variantcalling_tpu_torch.utils.stages.stage`) closes into
:func:`record`: the span goes into a process-global table (``report()``
renders it by thread, the main thread first), into the open obs stream
(:mod:`variantcalling_tpu_torch.obs`), and into the log, at INFO under
``VCTPU_TRACE=1`` and at DEBUG otherwise. Nesting depth lives in a
``threading.local``, so worker threads cannot corrupt each other's. The
reference's ``device_trace`` is the obs run's device trace in the port
(``VCTPU_OBS_JAXPROF``, ``torch.profiler``).
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from dataclasses import dataclass, field

from variantcalling_tpu_torch import knobs, obs

logger = logging.getLogger(__name__)


@dataclass
class Span:
    name: str
    seconds: float
    depth: int
    thread: str = "MainThread"


class _ThreadState(threading.local):
    depth = 0


#: spans the table keeps, newest last: a long-lived process (the serving
#: daemon) records every request's stages
MAX_SPANS = 65536


@dataclass
class _Tracer:
    """Process-global span table; append is thread-safe, depth is
    per-thread (a worker's nesting cannot corrupt another's)."""

    spans: deque = field(default_factory=lambda: deque(maxlen=MAX_SPANS))
    _local: _ThreadState = field(default_factory=_ThreadState, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()

    def report(self) -> str:
        """Per-thread groups: the main thread's spans first (unlabeled,
        the historical format), every worker thread after, labeled."""
        with self._lock:
            spans = list(self.spans)
        threads = ["MainThread"] + sorted(
            {s.thread for s in spans} - {"MainThread"})
        lines = ["stage timings:"]
        for t in threads:
            mine = [s for s in spans if s.thread == t]
            if not mine:
                continue
            if t != "MainThread":
                lines.append(f"  [thread {t}]")
            pad = "  " if t == "MainThread" else "    "
            for s in mine:
                lines.append(f"{pad}{'  ' * s.depth}{s.name}: {s.seconds:.3f}s")
        return "\n".join(lines)


TRACER = _Tracer()


def record(name: str, dt: float, depth: int) -> None:
    """One closed span of ``dt`` seconds at nesting ``depth`` on the
    calling thread: into :data:`TRACER`, the open obs stream, and the log
    (INFO under ``VCTPU_TRACE``, else DEBUG)."""
    thread = threading.current_thread().name
    with TRACER._lock:
        TRACER.spans.append(Span(name, dt, depth, thread))
    if obs.active():
        obs.span(name, dt, thread, depth=depth)
    if knobs.get_bool("VCTPU_TRACE"):
        logger.info("stage %s: %.3fs", name, dt)
    else:
        logger.debug("stage %s: %.3fs", name, dt)


def report() -> str:
    return TRACER.report()
