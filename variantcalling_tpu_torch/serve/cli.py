"""CLI: ``python -m variantcalling_tpu_torch serve``: the daemon in the foreground.

Counterpart of ``variantcalling_tpu/serve/cli.py``, with the reference's
options; ``--backend gpu|cpu`` (default ``gpu``) in place of ``tpu|cpu``, as
on every tool of the port. Configuration comes from the ``VCTPU_SERVE_*``
knobs (address, socket, admission limits, deadlines, drain budget); the
flags are what a supervisor or a test harness needs:

- ``--ready-file PATH``: written (JSON: address, port, pid) once the
  listener is up;
- ``--status-file PATH``: written at exit with the shutdown report (status,
  reason, counters, leaked threads);
- ``--obs-log PATH``: an obs stream at this path, whatever ``VCTPU_OBS``
  says.

The serving fabric's two tiers (``docs/serving_fabric.md``):

- ``--fabric``: the router (:mod:`.router`), the scatter-gather front door
  over the backends named by ``--backends`` or ``VCTPU_FABRIC_BACKENDS``.
  It resolves no device and imports no torch;
- ``--fabric-backend``: a backend (:mod:`.backend`), the daemon plus the
  streaming ``/v1/segment`` endpoint, on the device ``--backend`` names.

SIGTERM and SIGINT start the graceful drain (requests in flight finish
within ``VCTPU_SERVE_DRAIN_S``, new ones get 503 ``draining``, the obs stream
closes with status ``drain``) and the process exits 0. Exit 2 on a malformed
knob (``VCTPU_FABRIC_TOKENS`` among them), on ``--backend gpu`` without a
card (the daemon and a backend; no CPU fallback), and on ``--fabric``
together with ``--fabric-backend``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading
import time

log = logging.getLogger(__name__)


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="serve", description="fault-isolated resident scoring daemon")
    ap.add_argument("--host", default=None, help="bind address (default VCTPU_SERVE_HOST)")
    ap.add_argument("--port", type=int, default=None, help="TCP port, 0 = ephemeral (default VCTPU_SERVE_PORT)")
    ap.add_argument("--socket", default=None,
                    help="AF_UNIX socket path (overrides host/port; default VCTPU_SERVE_SOCKET)")
    ap.add_argument("--ready-file", default=None, help="write {address, port, pid} JSON once listening")
    ap.add_argument("--status-file", default=None, help="write the shutdown report JSON at exit")
    ap.add_argument("--obs-log", default=None, help="force an obs run stream at this path")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    ap.add_argument("--fabric", action="store_true",
                    help="run the fabric ROUTER tier: the scatter-gather front door over the backends named by "
                         "VCTPU_FABRIC_BACKENDS / --backends; never touches torch or the card")
    ap.add_argument("--fabric-backend", action="store_true",
                    help="run a fabric BACKEND: the resident daemon plus the streaming /v1/segment endpoint the "
                         "router fans spans out to")
    ap.add_argument("--backends", default=None,
                    help="router only: comma-separated backend addresses (default VCTPU_FABRIC_BACKENDS)")
    return ap


def _leaked_threads() -> list[str]:
    """Executor and serving threads still alive at shutdown, after a short
    grace period."""
    deadline = time.monotonic() + 3.0
    prefixes = ("vctpu-", "pipe-", "genome-prefetch", "obs-sampler")
    while time.monotonic() < deadline:
        leaked = sorted(t.name for t in threading.enumerate() if t.name.startswith(prefixes) and t.is_alive())
        if not leaked:
            return []
        time.sleep(0.05)
    return leaked


def run(argv: list[str]) -> int:
    args = get_parser().parse_args(argv)
    from variantcalling_tpu_torch import knobs
    from variantcalling_tpu_torch.engine import EngineError

    if args.fabric and args.fabric_backend:
        log.error("--fabric and --fabric-backend are different tiers; pick one")
        return 2
    try:
        knobs.validate_all()
    except EngineError as e:
        log.error("%s", e)
        return 2
    if args.fabric:
        # the router places, moves bytes and splices: no pipeline, no torch,
        # no device
        from variantcalling_tpu_torch.serve.router import Router

        try:
            server = Router(host=args.host, port=args.port, socket_path=args.socket, obs_log=args.obs_log,
                            backends=[a.strip() for a in args.backends.split(",") if a.strip()]
                            if args.backends is not None else None)
        except ValueError as e:  # a malformed VCTPU_FABRIC_TOKENS
            log.error("%s", e)
            return 2
    else:
        from variantcalling_tpu_torch import device as device_mod

        try:
            device = device_mod.resolve(args.backend)
        except device_mod.DeviceUnavailable as e:
            log.error("%s", e)
            return 2
        if args.fabric_backend:
            from variantcalling_tpu_torch.serve.backend import Backend as _Cls
        else:
            from variantcalling_tpu_torch.serve.daemon import Server as _Cls
        server = _Cls(host=args.host, port=args.port, socket_path=args.socket, obs_log=args.obs_log, device=device)
    stop_reason: dict = {}

    def _signal_drain(signum, frame):
        stop_reason["signal"] = signal.Signals(signum).name.lower()
        threading.Thread(target=server.drain, args=(stop_reason["signal"],), name="vctpu-serve-drain",
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _signal_drain)
    signal.signal(signal.SIGINT, _signal_drain)
    server.start()
    if args.ready_file:
        tmp = args.ready_file + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"address": server.address, "port": server.port, "pid": os.getpid()}, fh)
        os.replace(tmp, args.ready_file)
    # a bounded wait: a signal delivered to another thread only marks the
    # handler pending, and the main thread runs it when it next wakes
    while not server.stopped.wait(0.2):
        pass
    if args.status_file:
        with open(args.status_file, "w", encoding="utf-8") as fh:
            json.dump({"status": "drained", "reason": stop_reason.get("signal", "stopped"),
                       "counters": server.metrics.snapshot().get("counters", {}), "leaked": _leaked_threads()}, fh)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
