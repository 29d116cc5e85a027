"""Admission control and load shedding of the serving daemon.

Counterpart of ``variantcalling_tpu/serve/admission.py``, the same policy:

- at most ``VCTPU_SERVE_MAX_INFLIGHT`` requests execute at once (a run
  takes the host's cores and the card; more in flight would convoy);
- at most ``VCTPU_SERVE_QUEUE_DEPTH`` admitted requests wait for a slot; an
  arrival beyond that is shed at once with an explicit 503 (``status:
  shed, reason: queue_full``): the queue is bounded, so overload gives
  latency or sheds, never an unbounded backlog or a hang;
- the early shed: when the rolling latency p50 (:mod:`serve.metrics`)
  predicts that the queue wait alone would exceed the request's deadline,
  the request is shed now (``reason: slo``) rather than admitted to fail;
- a request whose deadline expires while it is queued is refused with its
  own ``deadline`` status and never starts; expiry while it executes trips
  its cancel token (chunk-granular, ``utils/cancellation``).
"""

from __future__ import annotations

import threading
import time

from variantcalling_tpu_torch import knobs


class ShedError(Exception):
    """The request was refused at admission (explicit shed response)."""

    def __init__(self, reason: str, retry_after_s: float = 1.0):
        super().__init__(f"shed: {reason}")
        self.reason = reason
        self.retry_after_s = retry_after_s


class QueueDeadlineError(Exception):
    """The request's deadline expired while it was still queued."""


class AdmissionController:
    """Bounded two-stage admission: queue (waiters) -> slots (executors).

    ``latency_p50`` is a callable ``endpoint -> rolling p50 seconds or
    None`` (serve.metrics) feeding the SLO-aware early shed.
    """

    def __init__(self, latency_p50=None):
        self.max_inflight = knobs.get_int("VCTPU_SERVE_MAX_INFLIGHT")
        self.queue_depth = knobs.get_int("VCTPU_SERVE_QUEUE_DEPTH")
        self._latency_p50 = latency_p50 or (lambda endpoint: None)
        self._slots = threading.Semaphore(self.max_inflight)
        self._lock = threading.Lock()
        self._queued = 0
        self._inflight = 0
        self.draining = False

    # -- introspection ------------------------------------------------------

    @property
    def queued(self) -> int:
        return self._queued

    @property
    def inflight(self) -> int:
        return self._inflight

    def idle(self) -> bool:
        with self._lock:
            return self._inflight == 0 and self._queued == 0

    # -- the decision -------------------------------------------------------

    def _estimated_wait_s(self, endpoint: str, queued: int,
                          inflight: int) -> float | None:
        """Predicted queue wait from the rolling p50: the work ahead of
        this arrival (queued + in-flight requests) divided over the
        executor slots. None until the endpoint has a latency history."""
        p50 = self._latency_p50(endpoint)
        if p50 is None:
            return None
        ahead = queued + inflight
        return (ahead * p50) / max(1, self.max_inflight)

    def admit(self, endpoint: str, deadline_s: float | None):
        """Block until an execution slot is held (returns the release
        callable) or refuse: :class:`ShedError` for queue-full / SLO /
        draining sheds, :class:`QueueDeadlineError` when the deadline
        expires first. The caller MUST call the returned release exactly
        once (a ``finally`` away from the request body)."""
        if self.draining:
            raise ShedError("draining")
        # a free execution slot admits immediately — the bounded queue
        # (and its depth/SLO checks) only governs requests that must WAIT
        if self._slots.acquire(blocking=False):
            with self._lock:
                self._inflight += 1
        else:
            with self._lock:
                if self._queued >= self.queue_depth:
                    raise ShedError("queue_full")
                if deadline_s is not None:
                    est = self._estimated_wait_s(endpoint, self._queued,
                                                 self._inflight)
                    if est is not None and est > deadline_s:
                        # admitting would only burn a queue slot on a
                        # request the deadline already condemned — shed
                        # with the honest wait estimate as the retry hint
                        raise ShedError("slo", retry_after_s=round(est, 3))
                self._queued += 1
            t0 = time.monotonic()
            try:
                ok = self._slots.acquire(
                    timeout=deadline_s if deadline_s is not None else None)
            finally:
                with self._lock:
                    self._queued -= 1
            if not ok:
                raise QueueDeadlineError(
                    f"deadline ({deadline_s:.1f}s) expired after "
                    f"{time.monotonic() - t0:.1f}s in the admission queue")
            if self.draining:
                # drain began while we waited: give the slot back unused
                self._slots.release()
                raise ShedError("draining")
            with self._lock:
                self._inflight += 1

        released = threading.Event()

        def release() -> None:
            if released.is_set():
                return
            released.set()
            with self._lock:
                self._inflight -= 1
            self._slots.release()

        return release
