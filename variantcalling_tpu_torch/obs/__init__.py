"""obs: the run-scoped telemetry stream the serving daemon writes.

Counterpart of ``variantcalling_tpu/obs/__init__.py``, for what the daemon
writes: one schema-versioned JSONL stream (the reference's
``obs/event_schema.json``, version :data:`SCHEMA_VERSION`) opened by
:func:`start_run` with a run manifest (the resolved knob registry, the
topology, the package version), then events appended from any
thread in one ordered sequence (``seq``, monotonic ``ts``), and closed by
:func:`end_run` with the metrics snapshot and a ``run_end`` event carrying
the run's status. :func:`counter`, :func:`gauge` and :func:`histogram` record
into the open run's :class:`~variantcalling_tpu_torch.obs.metrics.MetricsRegistry`,
or into a shared no-op when no run is open, so callers record without
branching.

Knobs: ``VCTPU_OBS=1`` asks for a stream (:func:`enabled`);
``VCTPU_OBS_PATH`` overrides its path; ``VCTPU_OBS_WINDOW_S`` sets the
histograms' rolling window. A process that exits with a run still open
writes its snapshot and ``run_end`` (status ``atexit``) on the way out.

Left out until the port's telemetry slice (``ROADMAP.md`` A9): trace spans
and causal chunk traces, the stage profiler, the CPU sampler, periodic
snapshots, log rotation, the Prometheus textfile and the ``obs`` tool.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import socket
import threading
import time

from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.obs.metrics import NOOP, MetricsRegistry

log = logging.getLogger(__name__)

#: the reference's event schema version (``variantcalling_tpu/obs/event_schema.json``)
SCHEMA_VERSION = 1

#: flush the stream every this many events (and at the manifest and the run's end)
FLUSH_EVERY = 32

#: module fast flag: every hook checks this before any other work
_ACTIVE = False
_RUN: "ObsRun | None" = None
_LOCK = threading.RLock()
_ATEXIT_REGISTERED = False


def enabled() -> bool:
    """Is a stream requested by the environment (``VCTPU_OBS``)?"""
    return knobs.get_bool("VCTPU_OBS")


def active() -> bool:
    """Is a run stream open? The one check every hook makes first."""
    return _ACTIVE


class ObsRun:
    """One open run stream: the file, its ordered event writer, its metrics."""

    def __init__(self, path: str, tool: str):
        self.path = path
        self.tool = tool
        self.metrics = MetricsRegistry(window_s=knobs.get_float("VCTPU_OBS_WINDOW_S"))
        self._fh = open(path, "w", encoding="utf-8")
        self._lock = threading.RLock()
        self._seq = 0
        self._since_flush = 0
        # ts is one wall anchor plus the monotonic clock, so it never moves back
        self._t0_wall = time.time()
        self._t0_mono = time.perf_counter()

    def _emit(self, kind: str, name: str, fields: dict, flush: bool = False) -> None:
        pid = os.getpid()
        tid = threading.get_ident()
        with self._lock:
            # timestamped inside the lock: file order == seq order == ts order
            t = time.perf_counter() - self._t0_mono
            event = dict(fields)  # the envelope wins on a name collision
            event.update(v=SCHEMA_VERSION, seq=self._seq, ts=round(self._t0_wall + t, 6), t=round(t, 6),
                         kind=kind, name=name, pid=pid, tid=tid)
            self._seq += 1
            try:
                self._fh.write(json.dumps(event) + "\n")
                self._since_flush += 1
                if flush or self._since_flush >= FLUSH_EVERY:
                    self._fh.flush()
                    self._since_flush = 0
            except ValueError:
                # a straggler racing the close: telemetry never throws into its caller
                pass

    def close(self, status: str) -> None:
        with self._lock:
            dur = time.perf_counter() - self._t0_mono
        self._emit("metrics", "final", self.metrics.snapshot())
        self._emit("run_end", self.tool, {"status": status, "dur": round(dur, 6)}, flush=True)
        self._fh.close()


def _topology(device: str | None) -> dict:
    import torch

    topo = {"hostname": socket.gethostname(), "cpu_count": os.cpu_count() or 1, "process_count": 1,
            "process_index": 0, "cuda_devices": torch.cuda.device_count() if torch.cuda.is_available() else 0}
    if device is not None:
        topo["device"] = device
    return topo


def build_manifest(tool: str, device: str | None = None) -> dict:
    """The manifest event's body (the writer adds the envelope); ``device``:
    the run's device, as its entry point resolved it."""
    from variantcalling_tpu_torch import __version__

    return {
        "tool": tool, "version": __version__,
        "knobs": {name: {"value": value if isinstance(value, (bool, int, float, str, type(None))) else str(value),
                         "source": src} for name, value, src in knobs.resolved()},
        "topology": _topology(device),
    }


def start_run(tool: str, default_path: str | None = None, force_path: str | None = None,
              device: str | None = None) -> ObsRun | None:
    """Open a run stream and write its manifest. None when obs is off, when a
    run is already open (the caller joins it and must not end it), or when
    there is nowhere to write. ``force_path`` opens a stream there whatever
    ``VCTPU_OBS`` says."""
    global _ACTIVE, _RUN, _ATEXIT_REGISTERED
    if force_path is None and not enabled():
        return None
    with _LOCK:
        if _RUN is not None:
            return None
        path = force_path or knobs.get_str("VCTPU_OBS_PATH") or default_path
        if not path:
            return None
        try:
            run = ObsRun(path, tool)
        except OSError as e:
            log.warning("obs: cannot open run log %s: %s; recording off for this run", path, e)
            return None
        run._emit("manifest", tool, build_manifest(tool, device=device), flush=True)
        _RUN = run
        _ACTIVE = True
        if not _ATEXIT_REGISTERED:
            _ATEXIT_REGISTERED = True
            atexit.register(_atexit_flush)
        log.info("obs: recording run telemetry to %s", path)
        return run


def end_run(run: ObsRun | None, status: str = "ok") -> None:
    """Close the stream opened by the matching :func:`start_run` (a no-op for
    a joiner, who was handed None)."""
    global _ACTIVE, _RUN
    if run is None:
        return
    with _LOCK:
        if _RUN is not run:
            return
        _ACTIVE = False
        _RUN = None
    try:
        run.close(status)
    except OSError as e:  # a full disk must not mask the run's own error
        log.warning("obs: failed to finalize run log %s: %s", run.path, e)


def _atexit_flush() -> None:
    run = _RUN
    if run is not None:
        end_run(run, "atexit")


def event(kind: str, name: str, **fields) -> None:
    """Append one event to the open stream (a no-op when none is open).
    ``fields`` must be JSON-serializable."""
    if not _ACTIVE:
        return
    run = _RUN
    if run is not None:
        run._emit(kind, name, fields)


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
