"""obs — the run telemetry every pipeline run of the port writes through.

Counterpart of ``variantcalling_tpu/obs/__init__.py``, the same module:
one run-scoped, schema-versioned JSONL stream (docs/observability.md):

- a **run manifest** (resolved knob registry, topology, input identity,
  package version) opens every stream (:mod:`~variantcalling_tpu_torch.obs.manifest`);
- a **typed metrics registry** (counters/gauges/histograms with lock-free
  recording from worker threads, :mod:`~variantcalling_tpu_torch.obs.metrics`)
  snapshots into the stream at run end;
- **events** — trace spans, degradations, fault firings, retries,
  journal/resume decisions, engine/strategy resolutions, heartbeats —
  append in one globally ordered sequence (``seq``, monotonic ``ts``);
- exporters turn any stream into a Chrome trace-event file for Perfetto
  or a terminal roll-up (:mod:`~variantcalling_tpu_torch.obs.export`,
  ``python -m variantcalling_tpu_torch obs export|summary|...``).

Contract:

- **output-neutral**: with ``VCTPU_OBS`` on or off, every pipeline's
  output bytes are identical — obs writes only its own sidecar;
- **cheap when off**: every hook bottoms out in one module-bool check
  (:func:`active`);
- **no card synchronisation of its own**: a span times host work; the
  card's own time comes only from the device trace;
- **one ordered stream**: events from any thread serialize through one
  lock that also takes the timestamp, so file order, ``seq`` order and
  ``ts`` order agree.

Knobs: ``VCTPU_OBS=1`` enables recording; ``VCTPU_OBS_PATH`` overrides
the sidecar path (default: ``<output_file>.obs.jsonl`` next to the
pipeline output); ``VCTPU_OBS_PROFILE`` (default on) adds the
performance-attribution layer (:mod:`~variantcalling_tpu_torch.obs.profile`:
per-stage work/wait attribution, RSS/CPU watermark sampler, the scoring
kernel's counted work); ``VCTPU_OBS_CPUPROF=1`` starts the continuous
CPU sampling profiler (:mod:`~variantcalling_tpu_torch.obs.sampler`:
whole-process stack samples + per-thread CPU clocks folded into a
``sample`` event stream at ``VCTPU_OBS_CPUPROF_HZ`` — ``obs flame`` /
``cpuledger`` are the readers); ``VCTPU_OBS_JAXPROF=1`` additionally
captures the device trace next to the run log: in the port that is
``torch.profiler``'s (CPU and CUDA activities), exported as a Chrome
trace into ``<run log>.jaxprof/`` — the directory keeps the reference's
name — so the card's kernels and the host timeline load side by side in
Perfetto.

The live telemetry plane rides the same gate: ``VCTPU_OBS_TRACE``
(default on) threads a causal trace through every chunk's lifecycle —
per-chunk trace ids, per-stage ``trace`` spans with parent links,
recovery linkage — the walkable DAG ``obs critical-path`` consumes;
``VCTPU_OBS_SNAPSHOT_S`` emits periodic in-run ``snapshot`` metrics
(rolling-window quantiles from ``VCTPU_OBS_WINDOW_S``) on the
event-flush cadence; ``VCTPU_OBS_MAX_MB`` rotates the log to ``.segN``
segments at the cap; and ``VCTPU_OBS_PROM_FILE`` atomically rewrites a
Prometheus textfile on every snapshot (``obs tail --follow`` / ``obs
prom`` are the reader-side faces).

Abnormal exits: the first ``start_run`` registers an ``atexit`` hook
plus SIGTERM and SIGINT handlers that flush the metrics snapshot and
``run_end`` event before the process dies (then re-deliver the signal
with the default disposition — the exit code still says killed-by-
signal), so only a SIGKILL can truncate a stream, and every obs reader
tolerates the torn tail (``obs summary``/``tail`` report such a stream
as ``in-flight``).
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import re
import signal
import threading
import logging
import time

from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.obs.metrics import NOOP, MetricsRegistry
from variantcalling_tpu_torch.obs.schema import SCHEMA_VERSION

logger = logging.getLogger(__name__)

OBS_ENV = "VCTPU_OBS"
OBS_PATH_ENV = "VCTPU_OBS_PATH"
JAXPROF_ENV = "VCTPU_OBS_JAXPROF"
TRACE_ENV = "VCTPU_OBS_TRACE"
SNAPSHOT_ENV = "VCTPU_OBS_SNAPSHOT_S"
WINDOW_ENV = "VCTPU_OBS_WINDOW_S"
MAX_MB_ENV = "VCTPU_OBS_MAX_MB"
PROM_FILE_ENV = "VCTPU_OBS_PROM_FILE"

#: flush the stream every this many events (plus manifest and run end) —
#: a crash loses at most one flush window, without per-event fsync cost
FLUSH_EVERY = 32

#: module fast flag — hot sites check this before doing ANY other work
_ACTIVE = False
#: causal-tracing fast flag: True while a run with tracing is open
#: (``VCTPU_OBS_TRACE``, default on) — the one check trace sites pay
_TRACING = False
_RUN: "ObsRun | None" = None
# re-entrant: the SIGTERM flush handler may fire while the main thread is
# already inside start_run/end_run — a plain Lock would self-deadlock the
# dying process
_LOCK = threading.RLock()

#: trace-id spelling (``t<N>``, run-scoped) — obs.trace_of recognizes a
#: bare id threaded through a stage-item tuple by this shape
_TRACE_ID_RE = re.compile(r"^t\d+$")


def enabled() -> bool:
    """Is obs recording requested by the environment (``VCTPU_OBS``)?"""
    return knobs.get_bool(OBS_ENV)


def active() -> bool:
    """Is a run stream currently open? The ONE check every hot-path hook
    performs before paying any obs cost."""
    return _ACTIVE


class ObsRun:
    """One open run stream: file handle, ordered event writer, metrics."""

    def __init__(self, path: str, tool: str):
        self.path = path
        self.tool = tool
        self.metrics = MetricsRegistry(window_s=knobs.get_float(WINDOW_ENV))
        #: attachments, owned by start_run/end_run: the resource watermark
        #: sampler and the device trace (torch.profiler) and its dir
        self.sampler = None
        #: the continuous CPU sampling profiler
        #: (``VCTPU_OBS_CPUPROF``, obs/sampler.py), owned the same way
        self.cpu_sampler = None
        self.jaxprof_dir: str | None = None
        self.device_profiler = None
        #: (strategy, kind) pairs whose cost_analysis already emitted —
        #: the per-chunk scoring loop counts the kernel's work ONCE
        self.cost_recorded: set = set()
        #: causal-tracing state (docs/observability.md "Causal chunk
        #: tracing"): run-scoped id counters plus the per-trace cursor —
        #: trace id -> last span id, so the next stage span of a chunk
        #: knows its parent. Cursor writes are GIL-atomic dict item
        #: assignments, and a chunk's stages execute strictly in
        #: sequence (megabatch fan-in goes through ONE dispatch thread),
        #: so no two threads ever race one trace's cursor.
        self.tracing = knobs.get_bool(TRACE_ENV)
        self.traces: dict[str, str] = {}
        self._trace_n = itertools.count()
        self._span_n = itertools.count()
        #: live-plane state: periodic snapshot throttle + segment
        #: rotation bookkeeping + the Prometheus textfile target
        self._snapshot_s = knobs.get_float(SNAPSHOT_ENV)
        self._last_snapshot = time.perf_counter()
        self._in_snapshot = False
        self._closing = False
        max_mb = knobs.get_int(MAX_MB_ENV)
        self._max_bytes = (max_mb or 0) << 20
        self._bytes = 0
        self._seg = 0
        self.prom_path = knobs.get_str(PROM_FILE_ENV) or None
        self._fh = open(path, "w", encoding="utf-8")
        # re-entrant for the same reason as the module _LOCK: the SIGTERM
        # flush can land while this thread is mid-_emit
        self._lock = threading.RLock()
        self._seq = 0
        self._since_flush = 0
        # ts is derived from ONE wall anchor plus the monotonic clock so
        # the stream's timestamps can never move backwards (NTP steps the
        # wall clock; perf_counter does not step)
        self._t0_wall = time.time()
        self._t0_mono = time.perf_counter()

    def _emit(self, kind: str, name: str, fields: dict, flush: bool = False) -> None:
        pid = os.getpid()
        tid = threading.get_ident()
        flushed = False
        with self._lock:
            # timestamped INSIDE the lock: file order == seq order == ts order
            t = time.perf_counter() - self._t0_mono
            event = dict(fields)  # extras first; the envelope wins on collision
            event.update(v=SCHEMA_VERSION, seq=self._seq,
                         ts=round(self._t0_wall + t, 6), t=round(t, 6),
                         kind=kind, name=name, pid=pid, tid=tid)
            self._seq += 1
            try:
                line = json.dumps(event) + "\n"
                self._fh.write(line)
                self._bytes += len(line)
                self._since_flush += 1
                if flush or self._since_flush >= FLUSH_EVERY:
                    self._fh.flush()
                    self._since_flush = 0
                    flushed = True
                if self._max_bytes and self._bytes >= self._max_bytes:
                    self._rotate()
            except ValueError:
                # a straggler event racing end_run's file close: telemetry
                # must never throw into the recording (worker) thread
                pass
        if flushed:
            # the live plane rides the existing flush cadence: every
            # FLUSH_EVERY events the throttle below may emit an in-run
            # metrics snapshot (kind=snapshot) so an external tail/prom
            # reader sees fresh rolling quantiles without a new thread
            self._maybe_snapshot()

    def _rotate(self) -> None:
        """Segment rollover (``VCTPU_OBS_MAX_MB``): close the current
        file and continue the SAME ordered stream (seq keeps counting)
        in ``<path>.seg<N>`` — readers merge segments exactly like
        ``.rankN`` siblings. Called with the event lock held."""
        try:
            nxt = open(f"{self.path}.seg{self._seg + 1}", "w",
                       encoding="utf-8")
        except OSError as e:
            # rotation failing must never lose events: disable the cap
            # and keep writing the current segment
            self._max_bytes = 0
            logger.warning("obs: cannot open rotation segment for %s: %s — "
                           "size cap disabled for this run", self.path, e)
            return
        old, self._fh = self._fh, nxt
        self._seg += 1
        self._bytes = 0
        self._since_flush = 0
        try:
            old.close()
        except OSError:
            pass

    def _maybe_snapshot(self) -> None:
        """Throttled periodic in-run metrics snapshot (the live plane's
        heartbeat): at most one per ``VCTPU_OBS_SNAPSHOT_S``, emitted on
        the event-flush cadence — an idle stream emits none, a busy one
        emits on schedule. Also rewrites the Prometheus textfile when
        ``VCTPU_OBS_PROM_FILE`` is set."""
        if self._snapshot_s <= 0 or self._in_snapshot or self._closing:
            return
        now = time.perf_counter()
        if now - self._last_snapshot < self._snapshot_s:
            return
        self._in_snapshot = True
        try:
            self._last_snapshot = now
            snap = self.metrics.snapshot()
            self._emit("snapshot", "metrics", snap, flush=True)
            self._write_prom(snap, in_flight=True)
        finally:
            self._in_snapshot = False

    def _write_prom(self, snap: dict, in_flight: bool) -> None:
        if not self.prom_path:
            return
        from variantcalling_tpu_torch.obs import prom
        from variantcalling_tpu_torch.utils import degrade

        try:
            prom.write_textfile(
                self.prom_path,
                prom.snapshot_to_prom(snap, tool=self.tool,
                                      in_flight=in_flight))
        except OSError as e:
            degrade.record("obs.prom_write", e,
                           fallback="Prometheus textfile skipped")

    def close(self, status: str) -> None:
        self._closing = True  # run_end must be the stream's last event
        with self._lock:
            dur = time.perf_counter() - self._t0_mono
        snap = self.metrics.snapshot()
        self._emit("metrics", "final", snap)
        self._emit("run_end", self.tool, {"status": status,
                                          "dur": round(dur, 6)}, flush=True)
        self._fh.close()
        self._write_prom(snap, in_flight=False)


def _rank_suffixed(path: str) -> str:
    """Multi-rank runs must not interleave one file: rank N > 0 writes
    ``<path>.rankN``. The rank is ``VCTPU_RANK``, the pod launcher's
    spelling (``parallel/podrun``)."""
    r = knobs.get_int("VCTPU_RANK") or 0
    return f"{path}.rank{r}" if r else path


def start_run(tool: str, default_path: str | None = None,
              argv: list[str] | None = None,
              inputs: dict[str, str] | None = None,
              force_path: str | None = None,
              device: str | None = None) -> ObsRun | None:
    """Open a run stream and emit its manifest; returns None when obs is
    disabled or a run is already active (the caller that got the ObsRun
    back owns :func:`end_run`; joiners just record into the open stream).

    ``force_path`` bypasses the ``VCTPU_OBS`` gate (the serving daemon's
    ``--obs-log``, tests that must record regardless of environment);
    ``device``: the run's device as its entry point resolved it, for the
    manifest's topology.
    """
    global _ACTIVE, _RUN, _TRACING
    if force_path is None and not enabled():
        return None
    with _LOCK:
        if _RUN is not None:
            return None  # join the open stream, don't nest
        path = force_path or knobs.get_str(OBS_PATH_ENV) or default_path
        if not path:
            return None  # nowhere to write (no output file context)
        path = _rank_suffixed(path)
        from variantcalling_tpu_torch.obs.manifest import build_manifest

        try:
            run = ObsRun(path, tool)
        except OSError as e:
            logger.warning("obs: cannot open run log %s: %s — recording "
                           "disabled for this run", path, e)
            return None
        run._emit("manifest", tool, build_manifest(tool, argv=argv, inputs=inputs,
                                                   device=device), flush=True)
        _RUN = run
        _ACTIVE = True
        _TRACING = run.tracing
        _register_flush_handlers()
        if knobs.get_bool(profile_mod().PROFILE_ENV):
            # RSS/CPU watermark sampler: daemon thread, stopped
            # (and its watermark event emitted) by end_run
            run.sampler = profile_mod().ResourceSampler(run)
            run.sampler.start()
        if knobs.get_bool(sampler_mod().CPUPROF_ENV):
            # continuous CPU sampling profiler: daemon thread
            # folding whole-process stack samples into the stream;
            # stopped (final flush + cpuprof summary event) by end_run
            run.cpu_sampler = sampler_mod().CpuSampler(run)
            run.cpu_sampler.start()
        if knobs.get_bool(JAXPROF_ENV):
            _start_jaxprof(run)
        logger.info("obs: recording run telemetry to %s", path)
        return run


def end_run(run: ObsRun | None, status: str = "ok") -> None:
    """Close the stream opened by the matching :func:`start_run` (no-op
    for joiners, who were handed None)."""
    global _ACTIVE, _RUN, _TRACING
    if run is None:
        return
    with _LOCK:
        if _RUN is not run:
            return
        # attachments stop while the stream still accepts events (the
        # samplers' summary events must precede the metrics snapshot)
        if run.cpu_sampler is not None:
            try:
                run.cpu_sampler.stop()
            except RuntimeError:  # never started (racing interpreter exit)
                pass
            run.cpu_sampler = None
        if run.sampler is not None:
            try:
                run.sampler.stop()
            except RuntimeError:  # never started (racing interpreter exit)
                pass
            run.sampler = None
        if run.jaxprof_dir is not None:
            _stop_jaxprof(run)
        _ACTIVE = False
        _TRACING = False
        _RUN = None
    try:
        run.close(status)
    except OSError as e:  # a full disk must not mask the run's own error
        logger.warning("obs: failed to finalize run log %s: %s", run.path, e)


def profile_mod():
    """The profiler module, imported lazily (it imports this package)."""
    from variantcalling_tpu_torch.obs import profile

    return profile


def sampler_mod():
    """The continuous-profiler module, imported lazily (same reason)."""
    from variantcalling_tpu_torch.obs import sampler

    return sampler


def _start_jaxprof(run: ObsRun) -> None:
    """``VCTPU_OBS_JAXPROF=1``: capture the device trace for the whole run
    into ``<run log>.jaxprof/`` (the reference's directory name; in the
    port it holds ``torch.profiler``'s Chrome trace of the CPU and, where
    a card is visible, the CUDA activities). The export of this stream
    and the device trace share the host wall clock, so the two files load
    side by side in one Perfetto session. A profiler that cannot start is
    a recorded degradation, never a failed run."""
    from variantcalling_tpu_torch.utils import degrade

    logdir = run.path + ".jaxprof"
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 — profiling must not kill the run
        degrade.record("obs.jaxprof_start", e, fallback="no device trace")
        return
    run.jaxprof_dir = logdir
    run.device_profiler = prof
    run._emit("profile", "jaxprof_start", {"logdir": logdir})


#: the Chrome trace file the device trace writes into ``<run log>.jaxprof/``
DEVICE_TRACE_FILE = "device_trace.json"


def _stop_jaxprof(run: ObsRun) -> None:
    from variantcalling_tpu_torch.utils import degrade

    logdir, run.jaxprof_dir = run.jaxprof_dir, None
    prof, run.device_profiler = run.device_profiler, None
    try:
        prof.__exit__(None, None, None)
        path = os.path.join(logdir, DEVICE_TRACE_FILE)
        prof.export_chrome_trace(path)
        run._emit("profile", "jaxprof_stop", {"logdir": logdir, "trace": path})
        logger.info("obs: torch.profiler device trace written to %s", path)
    except Exception as e:  # noqa: BLE001 — a failed stop must not mask the run's exit
        degrade.record("obs.jaxprof_stop", e, fallback="device trace may be "
                       "incomplete")


# -- abnormal-exit flush (satellite: no silently truncated streams) --------

_ATEXIT_REGISTERED = False
_SIGTERM_REGISTERED = False
_SIGINT_REGISTERED = False


def _flush_open_run(status: str) -> None:
    run = _RUN
    if run is not None:
        end_run(run, status)


def _atexit_flush() -> None:
    # a tool that crashed between start_run and its finally (or that
    # never had one) still gets its metrics snapshot and run_end written
    _flush_open_run("atexit")


def _register_flush_handlers() -> None:
    """Idempotent: atexit once; SIGTERM/SIGINT only when the process
    still has the default disposition (a host app's own handler must
    win; for SIGINT "default" is Python's ``default_int_handler``) and
    only from the main thread (signal.signal raises elsewhere). The
    signal attempts RETRY on later start_runs — a first run opened from
    a worker thread must not permanently forfeit the flush for runs the
    main thread opens afterwards."""
    global _ATEXIT_REGISTERED, _SIGTERM_REGISTERED, _SIGINT_REGISTERED
    if not _ATEXIT_REGISTERED:
        _ATEXIT_REGISTERED = True
        atexit.register(_atexit_flush)
    main = threading.current_thread() is threading.main_thread()
    if not _SIGTERM_REGISTERED:
        try:
            if main and signal.getsignal(signal.SIGTERM) is signal.SIG_DFL:
                signal.signal(signal.SIGTERM, _sigterm_flush)
                _SIGTERM_REGISTERED = True
        except (ValueError, OSError):  # exotic platform / embedded interp
            pass
    if not _SIGINT_REGISTERED:
        # Ctrl-C previously tore the stream mid-write (no metrics, no
        # run_end): Python's default SIGINT handler raises
        # KeyboardInterrupt wherever the main thread happens to be, and
        # a consumer loop blocked in a queue get dies without reaching
        # end_run. Same re-deliver pattern as SIGTERM below.
        try:
            if main and signal.getsignal(signal.SIGINT) \
                    is signal.default_int_handler:
                signal.signal(signal.SIGINT, _sigint_flush)
                _SIGINT_REGISTERED = True
        except (ValueError, OSError):
            pass


def _sigterm_flush(signum, frame) -> None:
    _flush_open_run("sigterm")
    # restore the default disposition and re-deliver so the exit code
    # still says "killed by SIGTERM" — obs observes, it never rescues
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    os.kill(os.getpid(), signal.SIGTERM)


def _sigint_flush(signum, frame) -> None:
    _flush_open_run("sigint")
    # same pattern as SIGTERM: default disposition + re-deliver, so the
    # parent still sees "killed by SIGINT" (WIFSIGNALED, exit -2) — obs
    # observes, it never rescues
    signal.signal(signal.SIGINT, signal.SIG_DFL)
    os.kill(os.getpid(), signal.SIGINT)


def event(kind: str, name: str, **fields) -> None:
    """Append one event to the open stream (no-op when inactive).

    ``fields`` must be JSON-serializable; keep them small — this is a
    telemetry stream, not a data channel."""
    if not _ACTIVE:
        return
    run = _RUN
    if run is not None:
        run._emit(kind, name, fields)


def span(name: str, dur: float, thread: str, depth: int = 0, **fields) -> None:
    """Record one closed wall-clock span (called by ``utils.trace`` and
    the stage executor). ``dur`` in seconds."""
    if not _ACTIVE:
        return
    run = _RUN
    if run is not None:
        run._emit("span", name, dict(fields, dur=round(dur, 6),
                                     thread=thread, depth=depth))


# -- causal chunk tracing (docs/observability.md "Causal chunk tracing") ---
#
# Every chunk gets a TRACE at ingest; every stage execution appends a
# trace span carrying (trace_id, span_id, parents) so the chunk's full
# history — including megabatch fan-in, retries and recovery actions —
# is a walkable DAG. `vctpu obs critical-path` consumes it; the Perfetto
# exporter renders the parent links as flow arrows.

_TRACE_TLS = threading.local()


def tracing() -> bool:
    """Is causal tracing recording (an open run with VCTPU_OBS_TRACE on)?
    The ONE check trace sites pay before any other work."""
    return _TRACING


def new_trace() -> str | None:
    """Allocate a fresh run-scoped trace id (one per chunk, at ingest);
    None when tracing is off."""
    run = _RUN if _TRACING else None
    if run is None:
        return None
    return f"t{next(run._trace_n)}"


def trace_span(tid: str | None, name: str, dur: float,
               parents: list[str] | None = None,
               traces: list[str] | None = None, **fields) -> str | None:
    """Record one causal span of trace ``tid`` and advance the trace's
    cursor so the chunk's NEXT span parents to this one.

    ``parents`` overrides the implicit parent (the trace's cursor);
    ``traces`` marks a FAN-IN span (one megabatch dispatch serving many
    chunks): the event lists every member trace id, its parents are each
    member's cursor, and every member's cursor advances to this span —
    the DAG edge set `vctpu obs critical-path` walks. Returns the new
    span id (None when tracing is off)."""
    run = _RUN if _TRACING else None
    if run is None or tid is None:
        return None
    sid = f"s{next(run._span_n)}"
    if parents is None:
        last = run.traces.get(tid)
        parents = [last] if last is not None else []
    body = dict(fields, trace_id=tid, span_id=sid, dur=round(dur, 6))
    if parents:
        body["parents"] = list(parents)
    if traces:
        body["traces"] = list(traces)
    run._emit("trace", name, body)
    for t in (traces if traces else (tid,)):
        run.traces[t] = sid
    return sid


def trace_cursor(tid: str | None) -> str | None:
    """The trace's current last-span id (fan-in callers collect these as
    the dispatch span's parents)."""
    run = _RUN if _TRACING else None
    if run is None or tid is None:
        return None
    return run.traces.get(tid)


def end_trace(tid: str | None) -> None:
    """Drop the trace's cursor (the chunk committed — its DAG is done);
    keeps the per-run cursor table bounded at in-flight chunks."""
    run = _RUN if _TRACING else None
    if run is not None and tid is not None:
        run.traces.pop(tid, None)


def set_current_trace(tid: str | None) -> None:
    """Bind ``tid`` as this thread's current chunk trace — recovery
    sites (retry_chunk, quarantine) read it to link their events to the
    chunk they are recovering."""
    _TRACE_TLS.tid = tid


def current_trace() -> str | None:
    """This thread's current chunk trace id (None outside a chunk body
    or with tracing off)."""
    return getattr(_TRACE_TLS, "tid", None)


class trace_scope:
    """Context manager: bind a chunk's trace id to this thread for the
    duration of its stage body (restores the previous binding, so nested
    bodies and pool workers reusing a thread stay correct)."""

    __slots__ = ("tid", "_prev")

    def __init__(self, tid: str | None):
        self.tid = tid

    def __enter__(self):
        self._prev = getattr(_TRACE_TLS, "tid", None)
        _TRACE_TLS.tid = self.tid
        return self.tid

    def __exit__(self, *exc):
        _TRACE_TLS.tid = self._prev
        return False


def trace_of(item) -> str | None:
    """Best-effort trace id of a stage item: the ``_obs_trace`` attribute
    a traced chunk table carries, or — for the render/compress tuples —
    a bare ``t<N>`` id threaded through the tuple. The watchdog uses this
    to link its re-dispatch events to the wedged chunk's trace."""
    tid = getattr(item, "_obs_trace", None)
    if isinstance(tid, str):
        return tid
    if isinstance(item, tuple):
        for x in item:
            tid = getattr(x, "_obs_trace", None)
            if isinstance(tid, str):
                return tid
            if isinstance(x, str) and _TRACE_ID_RE.match(x):
                return x
    return None


def counter(name: str):
    """The named counter of the open run, or a shared no-op."""
    run = _RUN if _ACTIVE else None
    return run.metrics.counter(name) if run is not None else NOOP


def gauge(name: str):
    run = _RUN if _ACTIVE else None
    return run.metrics.gauge(name) if run is not None else NOOP


def histogram(name: str):
    run = _RUN if _ACTIVE else None
    return run.metrics.histogram(name) if run is not None else NOOP


def current() -> ObsRun | None:
    """The open run."""
    return _RUN
