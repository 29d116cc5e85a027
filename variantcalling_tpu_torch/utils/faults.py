"""Named fault-injection points for robustness testing.

Counterpart of ``variantcalling_tpu/utils/faults.py``, with the same points,
the same ``VCTPU_FAULTS`` grammar and the same arming API. The streaming
filter executor makes failure-semantics promises: a hung stage trips a
watchdog, a transient chunk-read error is retried, an interrupted run never
leaves a partial output at the destination. The failure sites call
:func:`check` on a named injection point, and tests (or an operator,
through ``VCTPU_FAULTS``) arm exactly the failure they want.

Design rules:

- **Zero cost when disarmed.** ``check()`` is a single module-flag test
  when nothing is armed.
- **Injected faults look like real faults.** A chunk-read fault raises
  ``OSError(EIO)``, a writeback fault ``OSError(ENOSPC)``: the handling
  code cannot tell them from the real thing, so a test proves the real
  recovery path.
- **Hangs are cancellable.** An injected hang waits on an event, not a
  bare ``sleep``, so a watchdog that aborts the pipeline can release the
  hung thread (:func:`cancel_hangs`) and still join every worker.
- **Deterministic arming.** A fault fires a fixed number of times
  (``times``), then disarms itself.

Env syntax (comma-separated)::

    VCTPU_FAULTS="io.chunk_read:2,pipeline.stage_hang@30,io.writeback:0+3"

``point[:times][@seconds][+after]``: ``times`` defaults to 1 for raising
faults and unlimited for ``native.build`` (0 or negative also means
unlimited); ``@seconds`` turns the point into a delay or hang of that length
(cancellable); ``+after`` grants that many free passes before the first
firing. The spec is read once, when this module is first imported.
"""

from __future__ import annotations

import contextvars
import errno
import logging
import threading

log = logging.getLogger(__name__)

#: Catalog of injection points: name -> (description, exception factory).
#: ``None`` factory: a delay-style point (armed with seconds), or one whose
#: site expresses the failure itself (``native.build``, in the reference).
POINTS: dict[str, tuple[str, object]] = {
    "native.build": (
        "native engine build/load failure (native.get_lib returns None)",
        None,
    ),
    "io.chunk_read": (
        "transient IO error reading/parsing one streaming ingest chunk",
        lambda: OSError(errno.EIO, "injected fault: chunk read error"),
    ),
    "pipeline.stage": (
        "exception inside a streaming pipeline stage body",
        lambda: RuntimeError("injected fault: stage exception"),
    ),
    "pipeline.stage_hang": (
        "hung/slow streaming pipeline stage (cancellable wait)",
        None,  # delay-style: arm with seconds
    ),
    "pipeline.chunk": (
        "per-chunk scoring failure inside the supervised recovery guard "
        "(retried, then quarantined when VCTPU_QUARANTINE=1)",
        lambda: RuntimeError("injected fault: chunk scoring failure"),
    ),
    "xla.dispatch_oom": (
        "XLA device dispatch failure on a mesh megabatch "
        "(RESOURCE_EXHAUSTED — triggers the megabatch-shrink/dp-degrade "
        "rungs of the recovery ladder)",
        lambda: RuntimeError(
            "RESOURCE_EXHAUSTED: injected fault: device OOM during "
            "scoring dispatch"),
    ),
    "io.commit": (
        "ENOSPC at the atomic output commit (os.replace onto the "
        "destination)",
        lambda: OSError(errno.ENOSPC,
                        "injected fault: no space left on device at commit"),
    ),
    "io.writeback": (
        "writeback IO error (ENOSPC) on the streaming output sink",
        lambda: OSError(errno.ENOSPC, "injected fault: no space left on device"),
    ),
    "io.shard_decompress": (
        "IO worker death mid-BGZF-shard-inflate (parallel ingest)",
        lambda: OSError(errno.EIO, "injected fault: shard inflate error"),
    ),
    "io.shard_compress": (
        "worker death mid-BGZF-block-compress (parallel writeback)",
        lambda: OSError(errno.EIO, "injected fault: shard compress error"),
    ),
    "dist.rank_timeout": (
        "one rank entering a collective late (cancellable delay)",
        None,  # delay-style
    ),
    "cache.entry_read": (
        "IO error reading a chunk-cache entry (degrades to a miss — the "
        "chunk recomputes; torn/poisoned CONTENT needs no injection, the "
        "CRC check catches it)",
        lambda: OSError(errno.EIO, "injected fault: cache entry read error"),
    ),
    "cache.entry_write": (
        "chunk-cache entry publication failure — armed with seconds it "
        "hangs MID-entry-write (the chaoshunt cache_torn SIGKILL window) "
        "before raising; the entry is dropped, output bytes unaffected",
        lambda: OSError(errno.ENOSPC,
                        "injected fault: no space left writing cache entry"),
    ),
}

_LOCK = threading.Lock()
_ARMED: dict[str, "_Fault"] = {}
#: fast-path flag — hot sites check this before taking the lock
_ACTIVE = False

#: open scope layers (below), registered so :func:`cancel_hangs` can
#: release scoped hangs too
_OPEN_SCOPES: list[dict] = []

#: context-scoped fault layer (:class:`scope`): a dict of armed faults
#: carried in a contextvar, consulted before the process-global ``_ARMED``
#: table. The executor propagates the submitting context into its worker
#: pools (parallel/pipeline.py), so the scope follows the run's chunks.
_SCOPE_ARMED: contextvars.ContextVar[dict[str, "_Fault"] | None] = \
    contextvars.ContextVar("vctpu_fault_scope", default=None)
#: count of open fault scopes — keeps the ``_ACTIVE`` fast path honest
_N_SCOPES = 0


class _Fault:
    __slots__ = ("point", "times", "seconds", "after", "fired", "cancel")

    def __init__(self, point: str, times: int | None, seconds: float | None,
                 after: int = 0):
        self.point = point
        self.times = times
        self.seconds = seconds
        self.after = after  # free passes before the first firing
        self.fired = 0
        #: per-fault hang release: a newly armed hang always hangs
        self.cancel = threading.Event()

    def _take(self) -> bool:
        """Consume one firing; False once the budget is spent."""
        if self.after > 0:
            self.after -= 1
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        self.fired += 1
        return True


def _refresh_active() -> None:
    global _ACTIVE
    _ACTIVE = bool(_ARMED) or _N_SCOPES > 0


def arm(point: str, times: int | None = 1, seconds: float | None = None,
        after: int = 0) -> None:
    """Arm ``point`` to fire ``times`` times (None = unlimited).

    ``seconds`` turns a raising point into a delay and is the wait length
    for delay-style points (``pipeline.stage_hang``, ``dist.rank_timeout``).
    ``after`` grants that many free passes before the first firing.
    """
    if point not in POINTS:
        raise KeyError(f"unknown fault point {point!r}; see faults.POINTS")
    with _LOCK:
        _ARMED[point] = _Fault(point, times, seconds, after=after)
        _refresh_active()


def reset() -> None:
    """Disarm everything (test teardown)."""
    with _LOCK:
        _ARMED.clear()
        _refresh_active()


def fired(point: str) -> int:
    """How many times ``point`` has fired (0 when never armed)."""
    with _LOCK:
        f = _ARMED.get(point)
        return f.fired if f is not None else 0


def cancel_hangs() -> None:
    """Release every in-flight injected hang (watchdog and teardown path),
    of the process-global faults and of every open scope."""
    with _LOCK:
        targets = list(_ARMED.values()) + [
            f for layer in _OPEN_SCOPES for f in layer.values()]
    for f in targets:
        f.cancel.set()


def _armed_fault(point: str) -> "_Fault | None":
    """The fault governing ``point`` in this context: the scope layer wins,
    else the process-global table. Callers hold ``_LOCK``."""
    layer = _SCOPE_ARMED.get()
    if layer is not None and point in layer:
        return layer[point]
    return _ARMED.get(point)


def check(point: str) -> None:
    """Fire ``point`` if armed: sleep for delay-style points (cancellable),
    raise the catalogued exception otherwise. No-op when disarmed."""
    if not _ACTIVE:
        return
    with _LOCK:
        f = _armed_fault(point)
        if f is None or not f._take():
            return
        seconds = f.seconds
    _desc, exc_factory = POINTS[point]
    log.debug("injected fault %s fired (%s)", point, "delay" if seconds is not None else "raise")
    if seconds is not None:
        # cancellable: a watchdog that aborts the run can release us so
        # the owning thread still joins
        f.cancel.wait(seconds)
        if exc_factory is None:
            return
    if exc_factory is None:
        return
    raise exc_factory()


def parse_spec(spec: str) -> list[tuple[str, int | None, float | None, int]]:
    """Parse a ``VCTPU_FAULTS``-grammar string into a list of
    ``(point, times, seconds, after)`` tuples (module docstring for the
    grammar). Unknown points are dropped."""
    out: list[tuple[str, int | None, float | None, int]] = []
    for item in (spec or "").split(","):
        item = item.strip()
        if not item:
            continue
        after = 0
        if "+" in item:
            item, after_s = item.rsplit("+", 1)
            try:
                after = max(0, int(after_s))
            except ValueError:
                after = 0
        seconds = None
        if "@" in item:
            item, sec_s = item.split("@", 1)
            try:
                seconds = float(sec_s)
            except ValueError:
                seconds = None
        times: int | None = 1
        explicit_times = ":" in item
        if explicit_times:
            item, times_s = item.split(":", 1)
            try:
                times = int(times_s)
            except ValueError:
                times = 1
            if times <= 0:
                times = None  # 0 / negative = unlimited
        if item == "native.build" and not explicit_times:
            times = None  # an unavailable engine stays unavailable
        if item in POINTS:
            out.append((item, times, seconds, after))
    return out


class scope:
    """Context-scoped fault arming: the given ``VCTPU_FAULTS``-grammar spec
    is armed for the current execution context only; concurrent contexts
    see only their own scopes and the process-global table. An empty spec
    is a no-op scope."""

    __slots__ = ("spec", "_token", "_layer")

    def __init__(self, spec: str):
        self.spec = spec or ""
        self._token = None
        self._layer: dict | None = None

    def __enter__(self) -> "scope":
        global _N_SCOPES
        parsed = parse_spec(self.spec)
        if not parsed:
            return self
        self._layer = {point: _Fault(point, times, seconds, after=after)
                       for point, times, seconds, after in parsed}
        with _LOCK:
            self._token = _SCOPE_ARMED.set(self._layer)
            _OPEN_SCOPES.append(self._layer)
            _N_SCOPES += 1
            _refresh_active()
        return self

    def __exit__(self, *exc) -> bool:
        global _N_SCOPES
        if self._token is not None:
            with _LOCK:
                _SCOPE_ARMED.reset(self._token)
                self._token = None
                _OPEN_SCOPES.remove(self._layer)
                _N_SCOPES -= 1
                _refresh_active()
        return False


def _arm_from_env() -> None:
    """Arm what ``VCTPU_FAULTS`` names (see module docstring), so that a
    subprocess can be given faults through its environment."""
    from variantcalling_tpu_torch import knobs

    spec = (knobs.get_str("VCTPU_FAULTS") or "").strip()
    for point, times, seconds, after in parse_spec(spec):
        arm(point, times=times, seconds=seconds, after=after)


_arm_from_env()
