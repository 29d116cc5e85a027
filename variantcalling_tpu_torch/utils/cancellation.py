"""Cooperative request cancellation for long-running pipeline bodies.

Counterpart of ``variantcalling_tpu/utils/cancellation.py``. The serving
daemon (:mod:`variantcalling_tpu_torch.serve`) gives every request a
deadline; a request that blows it must stop using the daemon's cores and
card, but a streaming run cannot be killed from outside without tearing its
partial and journal. So cancellation is cooperative and chunk-granular: the
daemon binds a :class:`CancelToken` to the request's execution context, a
deadline reaper (or the drain) trips the token from any thread, and the
streaming commit loop polls :func:`check` once per chunk. The run then
unwinds through its normal failure teardown, as if a chunk had failed.

The token rides a ``contextvars.ContextVar``, so concurrent requests cannot
trip each other, and the executor's context propagation
(``parallel/pipeline.py``) carries it onto pooled workers. With no scope
bound, :func:`check` is one contextvar read.
"""

from __future__ import annotations

import contextvars
import threading

_TOKEN: contextvars.ContextVar["CancelToken | None"] = contextvars.ContextVar("vctpu_cancel_token", default=None)


class CancelledError(RuntimeError):
    """The bound scope's work was cancelled (deadline expiry, daemon drain).
    Not an ``EngineError``: cancellation is a per-request outcome, not a
    configuration error."""


class CancelToken:
    """One cancellable unit of work (a serve request). ``cancel`` may be
    called from any thread, any number of times; the first reason wins."""

    __slots__ = ("_event", "reason")

    def __init__(self):
        self._event = threading.Event()
        self.reason: str = ""

    def cancel(self, reason: str = "cancelled") -> None:
        if not self._event.is_set():
            self.reason = reason
            self._event.set()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()


class scope:
    """Bind ``token`` to the current execution context; the previous binding
    is restored on exit, so nested and sibling scopes stay correct."""

    __slots__ = ("token", "_cv_token")

    def __init__(self, token: CancelToken):
        self.token = token
        self._cv_token = None

    def __enter__(self) -> CancelToken:
        self._cv_token = _TOKEN.set(self.token)
        return self.token

    def __exit__(self, *exc) -> bool:
        _TOKEN.reset(self._cv_token)
        self._cv_token = None
        return False


def current() -> CancelToken | None:
    """The context's bound token (None outside any scope)."""
    return _TOKEN.get()


def check(what: str = "run") -> None:
    """Raise :class:`CancelledError` when the context's token (if any) has
    been tripped: the one polling point of the pipeline loops."""
    token = _TOKEN.get()
    if token is not None and token.cancelled:
        raise CancelledError(f"{what} cancelled: {token.reason or 'cancelled'}")
