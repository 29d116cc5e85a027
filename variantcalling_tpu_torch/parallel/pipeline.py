"""Bounded-queue ordered stage executor: the host side of the streaming filter.

Counterpart of ``variantcalling_tpu/parallel/pipeline.py``. The streaming executor runs its stages as a
chunked pipeline over sequence-numbered items: one worker thread per stage,
bounded queues between stages, results consumed strictly in submission
order, so stage time hides behind the slowest stage instead of summing.

Design rules:

- one thread per stage, FIFO queues: per-stage order is preserved by
  construction, so items leave the last stage in exactly the order the
  source yielded them (each carries its sequence number and the consumer
  checks it);
- bounded queues (``queue_depth``): peak memory is O(stages * queue_depth
  * chunk), never O(input);
- ``VCTPU_THREADS=1`` (or a single-core host) runs a plain serial loop
  through the same stage callables: the same bytes, no threads, no queues;
- a stage exception cancels the whole pipeline promptly (stop event and
  queue drain) and re-raises in the consumer;
- a watchdog (``timeout`` / ``VCTPU_STAGE_TIMEOUT_S``) bounds how long the
  consumer waits without any progress: a hung stage raises
  :class:`StageTimeoutError` naming the stuck stage instead of
  deadlocking the run, with queues drained and every joinable worker
  joined on the way out.

Stage bodies are native engine calls, numpy, torch and file IO, which
release the interpreter lock. Worker threads are named ``vctpu-io-w<N>``
(:class:`IoPool`) and ``pipe-*`` (:class:`StagePipeline`); the CPU sampler
attributes each to its family (``obs/sampler.py``).

Telemetry, when an obs run is open: each stage item's span and latency
histogram, the per-stage work, wait-in and wait-out attribution of a
``profiler`` (``obs/profile.StageProfiler``), the pipeline's lifecycle
events, and the retry, quarantine and watchdog events, each linked to the
trace of the chunk it concerns.
"""

from __future__ import annotations

import contextvars
import logging
import os
import queue
import threading
import time
import zlib
from collections import deque
from collections.abc import Callable, Iterable, Iterator

from variantcalling_tpu_torch import knobs, obs
from variantcalling_tpu_torch.obs import sampler as obs_sampler
from variantcalling_tpu_torch.utils import degrade, faults

log = logging.getLogger(__name__)

_SENTINEL = object()


def _get_timed(q: queue.Queue, stats) -> tuple[bool, object]:
    """One bounded (0.1s) queue get, with the blocked time accounted to
    ``stats.wait_in`` when profiling (stage workers and the consumer share
    it). Returns ``(ok, item)``."""
    if stats is None:
        try:
            return True, q.get(timeout=0.1)
        except queue.Empty:
            return False, None
    t0 = time.perf_counter()
    try:
        return True, q.get(timeout=0.1)
    except queue.Empty:
        return False, None
    finally:
        stats.add_wait_in(time.perf_counter() - t0)


def _put_timed(put: Callable, q: queue.Queue, item, stats) -> bool:
    """One bounded put through ``put`` (the pipeline's cancellable
    ``_put``), with the blocked time accounted to ``stats.wait_out`` when
    profiling: backpressure."""
    if stats is None:
        return put(q, item)
    t0 = time.perf_counter()
    ok = put(q, item)
    stats.add_wait_out(time.perf_counter() - t0)
    return ok


class StageTimeoutError(RuntimeError):
    """The pipeline made no progress within the watchdog deadline."""


class LadderEscalation(RuntimeError):
    """Base class of failures that re-dispatching the same chunk cannot
    answer (a sticky device fault): :func:`retry_chunk` and the quarantine
    guard pass them through untouched, so the run fails."""


def resolve_threads() -> int:
    """Pipeline thread policy: ``VCTPU_THREADS`` overrides, else the CPU
    count. ``VCTPU_THREADS=1`` selects the serial path. A malformed value
    raises ``EngineError`` (CLI exit 2)."""
    n = knobs.get_int("VCTPU_THREADS")
    return n if n is not None else (os.cpu_count() or 1)


def resolve_io_threads() -> int:
    """Host-IO worker policy of the parallel ingest and writeback paths
    (sharded BGZF inflate, the per-chunk fan-out, block compress):
    ``VCTPU_IO_THREADS`` overrides, else the CPU count. ``1`` disables
    parallel IO."""
    n = knobs.get_int("VCTPU_IO_THREADS")
    return n if n is not None else (os.cpu_count() or 1)


class _IoFuture:
    """Minimal future for :class:`IoPool` (result/exception + done event)."""

    __slots__ = ("_done", "_result", "_exc")

    def __init__(self):
        self._done = threading.Event()
        self._result = None
        self._exc: BaseException | None = None

    def result(self, timeout: float | None = None):
        if not self._done.wait(timeout):
            raise TimeoutError("IO task did not complete in time")
        if self._exc is not None:
            raise self._exc
        return self._result


class IoPool:
    """Daemon-thread worker pool of the parallel host-IO paths.

    Its workers are daemons, unlike ``ThreadPoolExecutor``'s: a wedged
    native call inside one cannot block process exit. Workers are named
    ``<name>-w<idx>`` and run each task in the submitter's context.
    """

    def __init__(self, threads: int, name: str = "vctpu-io"):
        self.threads = max(1, int(threads))
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self.unjoined: list[str] = []
        self._workers = [
            threading.Thread(target=self._loop, name=f"{name}-w{i}", daemon=True)
            for i in range(self.threads)
        ]
        for w in self._workers:
            w.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, ctx, fn, args = item
            try:
                fut._result = ctx.run(fn, *args)
            except BaseException as e:  # noqa: BLE001 — relayed through the future, re-raised at result()
                fut._exc = e
            finally:
                fut._done.set()

    def submit(self, fn: Callable, *args) -> _IoFuture:
        fut = _IoFuture()
        self._q.put((fut, contextvars.copy_context(), fn, args))
        return fut

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop the workers (bounded join: a wedged worker is recorded in
        ``unjoined`` and abandoned)."""
        for _ in self._workers:
            self._q.put(None)
        self.unjoined = []
        for w in self._workers:
            w.join(timeout=timeout)
            if w.is_alive():
                self.unjoined.append(w.name)
        if self.unjoined:
            log.warning("IO pool: %d worker(s) did not join: %s", len(self.unjoined), ", ".join(self.unjoined))


def imap_ordered(pool: IoPool, fn: Callable, items: Iterable, window: int) -> Iterator:
    """Map ``fn`` over ``items`` on ``pool``, yielding results strictly in
    submission order with at most ``window`` tasks in flight. A failed task
    re-raises at its ordinal position, as a serial loop would."""
    pending: deque[_IoFuture] = deque()
    it = iter(items)
    exhausted = False
    while True:
        while not exhausted and len(pending) < max(1, window):
            try:
                item = next(it)
            except StopIteration:
                exhausted = True
                break
            pending.append(pool.submit(fn, item))
        if not pending:
            return
        yield pending.popleft().result()


def resolve_stage_timeout() -> float:
    """Watchdog deadline from ``VCTPU_STAGE_TIMEOUT_S`` (0 disables)."""
    return knobs.get_float("VCTPU_STAGE_TIMEOUT_S")


def _retry_delay(attempt: int, backoff_s: float, who: str) -> float:
    """Exponential backoff with bounded deterministic jitter, seeded by the
    retrying worker's name, so that workers hit by one fault together do
    not wake together: [1x, 1.5x) of ``backoff_s * 2^attempt``."""
    base = backoff_s * (2 ** attempt)
    frac = (zlib.crc32(f"{who}:{attempt}".encode()) % 1024) / 1024.0
    return base * (1.0 + 0.5 * frac)


def retry_transient(fn: Callable, what: str, attempts: int | None = None,
                    backoff_s: float | None = None,
                    retry_on: tuple[type[BaseException], ...] = (OSError,)):
    """Run ``fn()`` with bounded retry and exponential backoff on transient
    IO errors: the executor's recovery primitive for chunk reads and sink
    writes. ``attempts`` counts total tries (default ``VCTPU_IO_RETRIES`` +
    1); backoff doubles from ``backoff_s`` (default ``VCTPU_IO_BACKOFF_S``).
    Other exceptions propagate at once, the last retryable one after the
    budget is spent."""
    if attempts is None:
        attempts = 1 + knobs.get_int("VCTPU_IO_RETRIES")
    if backoff_s is None:
        backoff_s = knobs.get_float("VCTPU_IO_BACKOFF_S")
    last: BaseException | None = None
    for k in range(max(1, attempts)):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 — the retry loop is the point
            last = e
            if k + 1 >= attempts:
                break
            delay = _retry_delay(k, backoff_s, threading.current_thread().name)
            if obs.active():
                obs.event("retry", what, attempt=k + 1, attempts=attempts, error=f"{type(e).__name__}: {e}")
                obs.counter("io.retries").add(1)
            log.warning("transient error in %s (attempt %d/%d): %s — retrying in %.2fs", what, k + 1, attempts, e,
                        delay)
            if delay:
                time.sleep(delay)
    raise last  # type: ignore[misc]


#: per-thread re-dispatch context: the quarantine guard diverts a poison
#: chunk only on the final attempt of the budget, and learns which attempt
#: it is on through this cell (retry_chunk runs its body inline)
_RETRY_TLS = threading.local()


def on_final_attempt() -> bool:
    """True when the calling chunk body is on its last (or only) dispatch
    attempt. Code not running under :func:`retry_chunk` is always final."""
    return getattr(_RETRY_TLS, "final", True)


def resolve_chunk_retries() -> int:
    """Chunk re-dispatch budget (``VCTPU_CHUNK_RETRIES``, default 1)."""
    return knobs.get_int("VCTPU_CHUNK_RETRIES")


def retry_chunk(fn: Callable, what: str, seq: int | None = None):
    """Re-dispatch of a failed chunk body, the second rung of the recovery
    ladder. Chunk bodies are pure functions of their input, so re-running
    one cannot change output bytes. ``EngineError``, :class:`StageTimeoutError`
    and :class:`LadderEscalation` propagate at once; the final failure
    re-raises unchanged."""
    from variantcalling_tpu_torch.engine import EngineError

    attempts = 1 + resolve_chunk_retries()
    last: BaseException | None = None
    prev = getattr(_RETRY_TLS, "final", True)
    try:
        for k in range(max(1, attempts)):
            if k:
                if obs.active():
                    fields = {"what": what, "attempt": k, "retries": attempts - 1,
                              "chunk": -1 if seq is None else seq, "error": f"{type(last).__name__}: {last}"}
                    # the re-dispatch names the trace of the chunk it recovers
                    # (the chunk body bound it with obs.trace_scope)
                    tid = obs.current_trace()
                    if tid is not None:
                        fields["trace_id"] = tid
                    obs.event("recovery", "chunk_retry", **fields)
                    obs.counter("recovery.chunk_retries").add(1)
                log.warning("chunk failure in %s%s (attempt %d/%d): %s — re-dispatching", what,
                            "" if seq is None else f" (chunk {seq})", k, attempts, last)
            _RETRY_TLS.final = k + 1 >= attempts
            try:
                return fn()
            except (EngineError, StageTimeoutError, LadderEscalation):
                raise
            except Exception as e:  # noqa: BLE001 — bounded re-dispatch; the last failure re-raises below
                last = e
    finally:
        _RETRY_TLS.final = prev
    raise last  # type: ignore[misc]


def record_quarantine(what: str, records: int, exc: BaseException, trace_id: str | None = None) -> None:
    """The bookkeeping of a chunk diverted to the quarantine sidecar: a
    sanctioned degradation at warning level, and the ``recovery``/
    ``quarantine`` obs event carrying the chunk's trace id."""
    degrade.record("stream.quarantine", exc, warn=True,
                   fallback=f"chunk of {records} records diverted to the .quarantine sidecar ({what})")
    if obs.active():
        fields = {"what": what, "records": records, "error": f"{type(exc).__name__}: {exc}"}
        tid = trace_id if trace_id is not None else obs.current_trace()
        if tid is not None:
            fields["trace_id"] = tid
        obs.event("recovery", "quarantine", **fields)
        obs.counter("recovery.quarantined_chunks").add(1)


class StagePipeline:
    """Run items through ``stages`` (list of callables) with stage overlap.

    ``run(source)`` yields ``stages[-1](...stages[0](item))`` for every item
    of ``source``, in source order. With more than one resolved thread each
    stage runs in its own worker thread connected by bounded queues; with
    one, the same callables run inline (the serial path).

    ``recover=True`` (the streaming filter's supervised mode): a failed stage
    item re-dispatches through :func:`retry_chunk` before the failure is
    final; the watchdog's first expiry releases injected hangs, re-dispatches
    the wedged chunk once on a one-shot thread and grants one more deadline
    (duplicate deliveries are dropped by sequence number: chunk bodies are
    pure). A stage callable with ``retry_safe = False`` (the BGZF carry) is
    never re-dispatched.

    ``profiler`` (an ``obs/profile.StageProfiler``) takes each stage's work,
    wait-in and wait-out while an obs run with profiling is open; the
    caller emits it. ``source_name`` and ``consumer_name`` label the feed's
    reads and the consumer's waits; ``source_pooled``: the source is an
    ordered drain of a worker pool whose workers attribute their own work,
    so time blocked in its ``next()`` is wait, not work.
    """

    def __init__(self, stages: list[Callable], queue_depth: int = 2,
                 threads: int | None = None, timeout: float | None = None,
                 recover: bool = False, profiler=None, source_name: str = "source",
                 consumer_name: str = "consume", source_pooled: bool = False):
        if stages is None:
            raise ValueError("StagePipeline needs a stage list")
        # an empty stage list is legal: source -> bounded queue -> consumer,
        # with the watchdog, error and teardown contracts
        self.stages = list(stages)
        self.queue_depth = max(1, int(queue_depth))
        self.threads = resolve_threads() if threads is None else max(1, int(threads))
        self.timeout = resolve_stage_timeout() if timeout is None else max(0.0, float(timeout))
        self.recover = bool(recover)
        self.profiler = profiler
        self.source_name = source_name
        self.consumer_name = consumer_name
        self.source_pooled = source_pooled
        #: True when the watchdog spent its single retry on the last run
        self.watchdog_retried = False
        #: threads that did not join within the grace period on the last run
        #: (a wedged native call cannot be interrupted; they are daemons)
        self.unjoined: list[str] = []

    @property
    def parallel(self) -> bool:
        return self.threads > 1

    def _stage_name(self, i: int) -> str:
        return getattr(self.stages[i], "__name__", None) or f"stage{i}"

    # -- serial path -------------------------------------------------------

    def _active_profiler(self):
        """The attribution sink for this run, or None (profiling rides the
        obs run: no stream, or ``VCTPU_OBS_PROFILE=0``, no cost)."""
        if self.profiler is None or not obs.active():
            return None
        return self.profiler if obs.profile_mod().enabled() else None

    def _record_stage_work(self, name: str, dt: float, seq: int, prof) -> None:
        """One stage item closed: span, latency histogram, attribution."""
        obs.span(name, dt, threading.current_thread().name, chunk=seq)
        obs.histogram(f"stage.{name}.s").observe(dt)
        if prof is not None:
            prof.stage(name).add_work(dt)

    def _next_timed(self, it: Iterator, seq: int, prof) -> tuple[bool, object]:
        """One source read, timed into the source stage when obs is on
        (the serial loop and the feed thread share it). ``(ok, item)``."""
        if not obs.active():
            try:
                return True, next(it)
            except StopIteration:
                return False, None
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return False, None
        dt = time.perf_counter() - t0
        if self.source_pooled:
            # a pooled source: time blocked on the pool is wait-in, not work
            obs.span(self.source_name, dt, threading.current_thread().name, chunk=seq)
            obs.histogram(f"stage.{self.source_name}.s").observe(dt)
            if prof is not None:
                prof.stage(self.source_name).add_wait_in(dt, items=1)
        else:
            self._record_stage_work(self.source_name, dt, seq, prof)
        return True, item

    def _stage_item(self, i: int, fn: Callable, seq: int, item, prof):
        """One stage applied to one item: the injection points fire per
        stage, on both paths, and the body is timed when obs is on."""
        faults.check("pipeline.stage")
        faults.check("pipeline.stage_hang")
        if not obs.active():
            return fn(item)
        t0 = time.perf_counter()
        out = fn(item)
        self._record_stage_work(self._stage_name(i), time.perf_counter() - t0, seq, prof)
        return out

    def _apply_stages(self, item, seq: int, prof):
        """One item through the serial stage chain, each stage with its own
        re-dispatch budget in supervised mode (``retry_safe = False`` stages
        run exactly once); the chunk's trace is bound so that the ladder's
        events name it."""
        for i, fn in enumerate(self.stages):
            if self.recover and getattr(fn, "retry_safe", True):
                with obs.trace_scope(obs.trace_of(item) if obs.tracing() else None):
                    item = retry_chunk(lambda it_=item, i_=i, fn_=fn: self._stage_item(i_, fn_, seq, it_, prof),
                                       self._stage_name(i), seq=seq)
            else:
                item = self._stage_item(i, fn, seq, item, prof)
        return item

    def _run_serial(self, source: Iterable) -> Iterator:
        prof = self._active_profiler()
        it = iter(source)
        seq = 0
        while True:
            ok, item = self._next_timed(it, seq, prof)
            if not ok:
                break
            yield self._apply_stages(item, seq, prof)
            seq += 1

    # -- threaded path -----------------------------------------------------

    def run(self, source: Iterable) -> Iterator:
        if obs.active():
            obs.event("stage", "pipeline_start", stages=[self._stage_name(i) for i in range(len(self.stages))],
                      threads=self.threads, queue_depth=self.queue_depth,
                      mode="threaded" if self.parallel else "serial",
                      # the serial loop runs no watchdog
                      watchdog_s=self.timeout if self.parallel else 0)
            if self.timeout and self.parallel:
                obs.counter("watchdog.armed").add(1)
        if not self.parallel:
            done = 0
            try:
                for item in self._run_serial(source):
                    done += 1
                    yield item
            finally:
                if obs.active():  # the lifecycle closes on every exit
                    obs.event("stage", "pipeline_end", chunks=done, unjoined=[])
            return

        stop = threading.Event()
        queues = [queue.Queue(maxsize=self.queue_depth) for _ in range(len(self.stages) + 1)]
        # monotonic time each stage last started an item, None while idle:
        # the watchdog names the stuck stage
        busy_since: list[float | None] = [None] * len(self.stages)
        # the in-flight (seq, item) of each stage: what the watchdog
        # re-dispatches when the owning worker is wedged
        busy_item: list[tuple | None] = [None] * len(self.stages)

        def _put(q: queue.Queue, item) -> bool:
            # a bounded put that stays responsive to cancellation
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        # error relay: a failing stage or source puts (_SENTINEL, exc)
        # downstream and exits; it does not set the stop event, or the next
        # stage could see stop before the error. Only the consumer sets stop.

        prof = self._active_profiler()

        def _feed() -> None:
            obs_sampler.register_current("pipe.src")
            src = prof.stage(self.source_name) if prof is not None else None
            try:
                it = iter(source)
                seq = 0
                while True:
                    ok, item = self._next_timed(it, seq, prof)
                    if not ok:
                        break
                    if not _put_timed(_put, queues[0], (seq, item), src):
                        return
                    if obs.active():
                        obs.gauge("queue.source.depth").set(queues[0].qsize())
                    seq += 1
                _put(queues[0], _SENTINEL)
            except BaseException as e:  # noqa: BLE001 — relayed to the consumer, re-raised there
                _put(queues[0], (_SENTINEL, e))

        def _stage(i: int, fn: Callable) -> None:
            # the sampler's family by stage name: flames read "pipe.render_stage"
            obs_sampler.register_current(f"pipe.{self._stage_name(i)}")
            q_in, q_out = queues[i], queues[i + 1]
            stats = prof.stage(self._stage_name(i)) if prof is not None else None
            # a stateful stage (retry_safe = False) sees each item exactly
            # once: no re-dispatch, and duplicates from an upstream watchdog
            # re-dispatch dropped before its body
            retryable = self.recover and getattr(fn, "retry_safe", True)
            last_seq = -1
            try:
                while not stop.is_set():
                    ok, got = _get_timed(q_in, stats)
                    if not ok:
                        continue
                    if got is _SENTINEL or (isinstance(got, tuple) and got[0] is _SENTINEL):
                        _put(q_out, got)
                        return
                    seq, item = got
                    if self.recover and seq <= last_seq:
                        continue  # duplicate delivery from a watchdog re-dispatch upstream
                    busy_since[i] = time.monotonic()
                    busy_item[i] = got
                    try:
                        if retryable:
                            # the ladder's events name the chunk they recover
                            with obs.trace_scope(obs.trace_of(item) if obs.tracing() else None):
                                out = retry_chunk(lambda: self._stage_item(i, fn, seq, item, prof),
                                                  self._stage_name(i), seq=seq)
                        else:
                            out = self._stage_item(i, fn, seq, item, prof)
                        last_seq = seq
                        if obs.active():
                            obs.gauge(f"queue.stage{i}.depth").set(q_out.qsize())
                    finally:
                        busy_since[i] = None
                        busy_item[i] = None
                    _put_timed(_put, q_out, (seq, out), stats)
            except BaseException as e:  # noqa: BLE001 — relayed to the consumer, re-raised there
                _put(q_out, (_SENTINEL, e))

        def _watchdog_recover() -> None:
            """First expiry in supervised mode: release injected hangs (a
            cancellable wait resumes its stage) and re-dispatch each wedged
            stage's in-flight chunk once on a one-shot thread; the consumer
            drops duplicate sequence numbers. The run then gets one more
            deadline before the abort."""
            msg = self._watchdog_message(busy_since, workers)
            log.warning("stage pipeline watchdog: first deadline expired — re-dispatching the wedged chunk once "
                        "before aborting. %s", msg)
            if obs.active():
                # the wedged chunks' traces, so the re-dispatch resolves to their DAGs
                tids = [tid for tid in (obs.trace_of(got[1]) for got in busy_item if got is not None)
                        if tid is not None]
                obs.event("recovery", "watchdog_retry", detail=msg, trace_ids=tids)
                obs.counter("recovery.watchdog_retries").add(1)
            faults.cancel_hangs()
            for i, got in enumerate(busy_item):
                if got is None or not getattr(self.stages[i], "retry_safe", True):
                    continue  # a stateful stage cannot absorb the same item twice
                seq, item = got
                fn, q_out = self.stages[i], queues[i + 1]

                def _redispatch(i=i, fn=fn, seq=seq, item=item, q_out=q_out):
                    try:
                        out = self._stage_item(i, fn, seq, item, prof)
                    except BaseException as e:  # noqa: BLE001 — relayed to the consumer, re-raised there
                        _put(q_out, (_SENTINEL, e))
                        return
                    _put(q_out, (seq, out))

                w = threading.Thread(target=_in_ctx, args=(_redispatch,), name=f"pipe-stage{i}-retry", daemon=True)
                workers.append(w)
                w.start()

        # every worker runs in the caller's context (a fresh copy each: a
        # Context object is single-threaded), so scoped faults follow it
        run_ctx = contextvars.copy_context()

        def _in_ctx(fn: Callable, *args) -> None:
            run_ctx.copy().run(fn, *args)

        workers = [threading.Thread(target=_in_ctx, args=(_feed,), name="pipe-src", daemon=True)]
        workers += [threading.Thread(target=_in_ctx, args=(_stage, i, fn), name=f"pipe-stage{i}", daemon=True)
                    for i, fn in enumerate(self.stages)]
        for w in workers:
            w.start()
        expect = 0
        last_progress = time.monotonic()
        self.watchdog_retried = False
        consume = prof.stage(self.consumer_name) if prof is not None else None
        try:
            while True:
                ok, got = _get_timed(queues[-1], consume)
                if not ok:
                    if stop.is_set():
                        raise RuntimeError("stage pipeline cancelled") from None
                    if self.timeout and time.monotonic() - last_progress > self.timeout:
                        if self.recover and not self.watchdog_retried:
                            self.watchdog_retried = True
                            _watchdog_recover()
                            last_progress = time.monotonic()
                            continue
                        msg = self._watchdog_message(busy_since, workers)
                        if obs.active():
                            obs.event("stage", "watchdog_fire", detail=msg)
                            obs.counter("watchdog.fired").add(1)
                        raise StageTimeoutError(msg) from None
                    continue
                last_progress = time.monotonic()
                if got is _SENTINEL:
                    return
                if isinstance(got, tuple) and got[0] is _SENTINEL:
                    raise got[1]
                seq, item = got
                if self.recover and seq < expect:
                    continue  # the wedged worker woke after its re-dispatch delivered
                if seq != expect:
                    raise RuntimeError(f"stage pipeline: chunk {seq} arrived, {expect} expected")
                expect += 1
                yield item
        finally:
            stop.set()
            # release any injected hang so its thread can see stop and join
            faults.cancel_hangs()
            for q in queues:  # unblock any worker parked on a full queue
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
            self.unjoined = []
            for w in workers:
                w.join(timeout=5.0)
                if w.is_alive():
                    self.unjoined.append(w.name)
            if self.unjoined:
                log.warning("stage pipeline: %d worker(s) did not join: %s", len(self.unjoined),
                            ", ".join(self.unjoined))
            if obs.active():
                obs.event("stage", "pipeline_end", chunks=expect, unjoined=list(self.unjoined))

    def _watchdog_message(self, busy_since: list[float | None], workers: list[threading.Thread]) -> str:
        now = time.monotonic()
        stuck = [f"stage {i} ({self._stage_name(i)}) busy {now - t:.1f}s"
                 for i, t in enumerate(busy_since) if t is not None]
        alive = [w.name for w in workers if w.is_alive()]
        detail = "; ".join(stuck) if stuck else "no stage reports busy (source stalled?)"
        return (f"stage pipeline watchdog: no progress for {self.timeout:.0f}s — {detail}; alive workers: "
                f"{', '.join(alive) or 'none'}. Raise VCTPU_STAGE_TIMEOUT_S for legitimately slow stages.")
