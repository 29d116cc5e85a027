"""The serving daemon: resident state, admission, isolation, HTTP.

Counterpart of ``variantcalling_tpu/serve/daemon.py``. Transport: the
standard library's threading HTTP server over localhost TCP
(``VCTPU_SERVE_HOST``/``VCTPU_SERVE_PORT``) or a Unix-domain socket
(``VCTPU_SERVE_SOCKET``); handler threads are daemons named
``vctpu-serve-h<N>``.

Endpoints:

- ``POST /v1/filter``: the filter pipeline (``filter_variants.run_loaded``,
  the streaming executor by default) against the resident model and genome,
  on the daemon's device; writes the request's output with the CLI's bytes;
- ``POST /v1/score``: scores a VCF in memory (``FilterContext.score_table``)
  and returns summary statistics;
- ``POST /v1/coverage``: the one-pass host coverage reduce over an inline
  depth vector (``ops/coverage.host_coverage_stats``);
- ``POST /v1/warm``: loads a model and a reference into the resident caches;
- ``GET /healthz``, ``GET /v1/status``, ``GET /v1/metrics``: liveness,
  admission and cache state, the Prometheus text exposition.

A subclass adds streaming endpoints through ``STREAM_ROUTES`` (the fabric
backend's ``POST /v1/segment``), which own their whole exchange and are
dispatched before the JSON routes. The module imports torch only when a
:class:`Server` is built, so the fabric's router reaches its HTTP server
classes without it.

Every pipeline request runs behind the admission controller, under its own
``knobs.scope``, ``faults.scope`` and cancel token (:meth:`Server.execute`):
a request that fails, is poisoned or blows its deadline gets its own error
response, leaves no partial or journal behind, and changes nothing for the
daemon or a concurrent request. A daemon on the card serves every forest
request through the card's kernels; a kernel that fails to build or launch
fails that request (500), and no plain version serves it instead.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import logging
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs, obs
from variantcalling_tpu_torch.engine import EngineError
from variantcalling_tpu_torch.serve.admission import AdmissionController, QueueDeadlineError, ShedError
from variantcalling_tpu_torch.serve.metrics import ServeMetrics
from variantcalling_tpu_torch.serve.state import ResidentState
from variantcalling_tpu_torch.utils import cancellation, faults

log = logging.getLogger(__name__)

#: knobs a request may not scope: they set daemon-wide machinery (the serving
#: topology, the obs stream), not the request's run; ``VCTPU_FAULTS`` is armed
#: once at import, so its request-level channel is the ``faults`` field
_UNSCOPABLE = frozenset(n for n in knobs.REGISTRY if n.split("_")[1] in ("SERVE", "FABRIC", "OBS")) \
    | {"VCTPU_FAULTS"}


class RequestError(Exception):
    """A malformed request (HTTP 400, ``status: bad_request``)."""


def _filter_namespace(body: dict, output_file: str | None, backend: str) -> argparse.Namespace:
    """The pipeline's arguments a request body maps to: one constructor for filter
    and score, so that neither drifts from the CLI."""
    for field in ("input", "model", "model_name", "reference"):
        if not body.get(field):
            raise RequestError(f"missing required field {field!r}")
    for field in ("input", "model", "reference"):
        if not os.path.exists(body[field]):
            raise RequestError(f"{field} path does not exist: {body[field]}")
    return argparse.Namespace(
        input_file=body["input"], model_file=body["model"], model_name=body["model_name"],
        reference_file=body["reference"], output_file=output_file, runs_file=body.get("runs_file"),
        blacklist=body.get("blacklist"), blacklist_cg_insertions=bool(body.get("blacklist_cg_insertions")),
        hpol_filter_length_dist=[int(v) for v in body.get("hpol_filter_length_dist", [10, 10])],
        flow_order=body.get("flow_order", "TGCA"), is_mutect=bool(body.get("is_mutect")),
        annotate_intervals=list(body.get("annotate_intervals") or []),
        limit_to_contig=body.get("limit_to_contig"), backend=backend)


class Server:
    """One resident daemon on one device: warmed state, admission, HTTP front.
    ``device``: a ``torch.device``, or ``"gpu"`` (the default) / ``"cpu"``;
    asking for the card where there is none raises ``DeviceUnavailable``."""

    #: endpoint name -> unbound handler (bound at the bottom of this module;
    #: the fabric backend extends it with ``dict(Server.ENDPOINTS, ...)``)
    ENDPOINTS: dict = {}
    #: path -> method name of the endpoints that own their transport
    #: (streamed bodies, not the JSON round trip); checked before the JSON
    #: routes
    STREAM_ROUTES: dict = {}

    def __init__(self, host: str | None = None, port: int | None = None, socket_path: str | None = None,
                 obs_log: str | None = None, device: torch.device | str = "gpu"):
        # torch is imported here, not with the module: the fabric's router
        # reaches this module's HTTP server classes without importing torch
        from variantcalling_tpu_torch import device as device_mod

        self.device = device_mod.as_device(device)
        self.host = host if host is not None else knobs.get_str("VCTPU_SERVE_HOST")
        self.port = port if port is not None else knobs.get_int("VCTPU_SERVE_PORT")
        self.socket_path = socket_path if socket_path is not None else (knobs.get_str("VCTPU_SERVE_SOCKET") or None)
        self.default_deadline_s = knobs.get_float("VCTPU_SERVE_DEADLINE_S")
        self.drain_s = knobs.get_float("VCTPU_SERVE_DRAIN_S")
        self.state = ResidentState()
        self.metrics = ServeMetrics()
        self.admission = AdmissionController(latency_p50=self.metrics.rolling_p50)
        self.address: str | None = None
        self._req_n = itertools.count()
        self._started = time.monotonic()
        self._httpd: ThreadingHTTPServer | None = None
        self._serve_thread: threading.Thread | None = None
        #: the deadline reaper's table: request id -> (monotonic deadline, token)
        self._deadlines: dict[str, tuple[float, cancellation.CancelToken]] = {}
        self._deadline_lock = threading.Lock()
        self._reaper_stop = threading.Event()
        self._reaper: threading.Thread | None = None
        self.draining = threading.Event()
        self.stopped = threading.Event()
        self._obs_log = obs_log
        self._obs_run = None

    @property
    def backend(self) -> str:
        return "gpu" if self.device.type == "cuda" else "cpu"

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Bind and serve on background threads (the caller keeps the
        foreground: the CLI's main loop, or a test)."""
        from variantcalling_tpu_torch.io import chunk_cache

        # runs that repeat an input span under one scoring config replay the
        # rendered bytes from memory (with VCTPU_CACHE=1)
        chunk_cache.resident_mode(True)
        if self._obs_log:
            self._obs_run = obs.start_run("serve", force_path=self._obs_log, device=str(self.device))
        elif obs.enabled():
            self._obs_run = obs.start_run("serve", default_path=os.path.abspath("vctpu_serve.obs.jsonl"),
                                          device=str(self.device))
        handler = _make_handler(self)
        if self.socket_path:
            with contextlib.suppress(OSError):
                os.remove(self.socket_path)
            self._httpd = _UnixHTTPServer(self.socket_path, handler)
            self.address = self.socket_path
        else:
            self._httpd = _NamedThreadingHTTPServer((self.host, self.port), handler)
            self.port = self._httpd.server_address[1]
            self.address = f"http://{self.host}:{self.port}"
        self._reaper = threading.Thread(target=self._reap_deadlines, name="vctpu-serve-reaper", daemon=True)
        self._reaper.start()
        self._serve_thread = threading.Thread(target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
                                              name="vctpu-serve-accept", daemon=True)
        self._serve_thread.start()
        if obs.active():
            obs.event("serve", "listening", address=self.address, device=str(self.device),
                      max_inflight=self.admission.max_inflight, queue_depth=self.admission.queue_depth)
        log.info("serve: listening on %s on %s (max_inflight=%d, queue_depth=%d)", self.address, self.device,
                 self.admission.max_inflight, self.admission.queue_depth)

    def drain(self, reason: str = "sigterm") -> None:
        """Graceful shutdown: refuse new work (503 ``draining``), let requests
        in flight finish within ``VCTPU_SERVE_DRAIN_S``, cancel the rest, close
        the obs stream with status ``drain``."""
        from variantcalling_tpu_torch.io import chunk_cache

        if self.draining.is_set():
            return
        self.draining.set()
        self.admission.draining = True
        log.info("serve: draining (%s): refusing new requests, waiting up to %.0f s for %d in flight", reason,
                 self.drain_s, self.admission.inflight)
        if obs.active():
            obs.event("serve", "drain_start", reason=reason, inflight=self.admission.inflight,
                      queued=self.admission.queued)
        deadline = time.monotonic() + self.drain_s
        while not self.admission.idle() and time.monotonic() < deadline:
            time.sleep(0.05)
        if not self.admission.idle():
            # the drain budget is spent: cancel what is left, so that the
            # request threads unwind through their normal teardown
            with self._deadline_lock:
                stragglers = list(self._deadlines.values())
            for _, token in stragglers:
                token.cancel("daemon drain timeout")
            give_up = time.monotonic() + 10.0
            while not self.admission.idle() and time.monotonic() < give_up:
                time.sleep(0.05)
        self._reaper_stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5.0)
        if self._reaper is not None:
            self._reaper.join(timeout=5.0)
        if self.socket_path:
            with contextlib.suppress(OSError):
                os.remove(self.socket_path)
        chunk_cache.resident_mode(False)
        if obs.active():
            obs.event("serve", "drain_end", clean=self.admission.idle())
        obs.end_run(self._obs_run, "drain")
        self._obs_run = None
        self._drained()
        self.stopped.set()
        log.info("serve: stopped")

    def _drained(self) -> None:
        """What a subclass does once drained, before ``stopped`` is set (the
        fabric backend removes its spool and logs its kernel launches)."""

    # -- deadlines ----------------------------------------------------------

    def _register_deadline(self, req: str, deadline_s: float | None, token: cancellation.CancelToken) -> None:
        with self._deadline_lock:
            self._deadlines[req] = (time.monotonic() + deadline_s if deadline_s else float("inf"), token)

    def _unregister_deadline(self, req: str) -> None:
        with self._deadline_lock:
            self._deadlines.pop(req, None)

    def _reap_deadlines(self) -> None:
        """Trips the cancel token of every expired request, so that its run
        unwinds at its next chunk boundary."""
        while not self._reaper_stop.wait(0.1):
            now = time.monotonic()
            with self._deadline_lock:
                expired = [(req, tok) for req, (at, tok) in self._deadlines.items() if now > at]
            for req, token in expired:
                token.cancel("request deadline expired")
                self._unregister_deadline(req)

    # -- request execution --------------------------------------------------

    def execute(self, endpoint: str, body: dict) -> tuple[int, dict]:
        """One pipeline request end to end: admission -> isolation scope ->
        endpoint -> (HTTP status, JSON payload). Never raises: every failure
        is this request's response."""
        req = f"r{next(self._req_n)}"
        deadline_s = body.get("deadline_s", self.default_deadline_s)
        try:
            deadline_s = float(deadline_s) if deadline_s else None
        except (TypeError, ValueError):
            return 400, {"status": "bad_request", "req": req,
                         "error": f"deadline_s must be a number, got {body.get('deadline_s')!r}"}
        t0 = time.perf_counter()
        self.metrics.set_load(self.admission.inflight, self.admission.queued)
        try:
            release = self.admission.admit(endpoint, deadline_s)
        except ShedError as e:
            self.metrics.count(endpoint, "shed")
            if obs.active():
                obs.event("serve", "shed", req=req, endpoint=endpoint, reason=e.reason)
            return 503, {"status": "draining" if e.reason == "draining" else "shed", "req": req,
                         "reason": e.reason, "retry_after_s": e.retry_after_s}
        except QueueDeadlineError as e:
            self.metrics.count(endpoint, "deadline")
            if obs.active():
                obs.event("serve", "deadline", req=req, endpoint=endpoint, where="queued")
            return 504, {"status": "deadline", "req": req, "error": str(e)}
        self.metrics.count(endpoint, "accepted")
        self.metrics.set_load(self.admission.inflight, self.admission.queued)
        token = cancellation.CancelToken()
        queued_s = time.perf_counter() - t0
        remaining = None if deadline_s is None else max(0.1, deadline_s - queued_s)
        self._register_deadline(req, remaining, token)
        if obs.active():
            obs.event("serve", "request_start", req=req, endpoint=endpoint, queued_s=round(queued_s, 6),
                      deadline_s=deadline_s or 0)
        try:
            code, payload = self._execute_isolated(endpoint, body, req, token)
        finally:
            self._unregister_deadline(req)
            release()
            self.metrics.set_load(self.admission.inflight, self.admission.queued)
        dur = time.perf_counter() - t0
        self.metrics.observe_latency(endpoint, dur)
        # the terminal counter from the payload's status: a drain-cancelled
        # request counts as cancelled, not failed
        outcome = payload.get("status")
        self.metrics.count(endpoint, outcome if outcome in ("ok", "deadline", "cancelled") else "failed")
        payload.setdefault("req", req)
        payload["dur_s"] = round(dur, 6)
        if obs.active():
            obs.event("serve", "request_end", req=req, endpoint=endpoint, status=payload.get("status"), code=code,
                      dur=round(dur, 6))
        return code, payload

    def _execute_isolated(self, endpoint: str, body: dict, req: str,
                          token: cancellation.CancelToken) -> tuple[int, dict]:
        """The per-request isolation envelope: scoped knobs, scoped faults, the
        bound cancel token, then the endpoint. Exceptions become this
        request's response here, so nothing a request does reaches the
        daemon."""
        overrides = dict(body.get("knobs") or {})
        for name in overrides:
            if name in _UNSCOPABLE:
                return 400, {"status": "config_error", "error": f"knob {name} cannot be scoped per request"}
        try:
            knob_scope = knobs.scope(overrides)
        except KeyError as e:
            return 400, {"status": "config_error", "error": str(e)}
        try:
            with knob_scope, faults.scope(body.get("faults") or ""), cancellation.scope(token):
                # a malformed scoped value is this request's configuration error
                knobs.validate_all()
                return self.ENDPOINTS[endpoint](self, body, req)
        except RequestError as e:
            return 400, {"status": "bad_request", "error": str(e)}
        except EngineError as e:
            return 400, {"status": "config_error", "error": str(e)}
        except cancellation.CancelledError as e:
            reason = token.reason or str(e)
            if "drain" in reason:
                return 503, {"status": "cancelled", "error": reason}
            return 504, {"status": "deadline", "error": reason}
        # the isolation boundary: any other failure (a poisoned chunk past its
        # retries, a watchdog abort, an IO error, a kernel that failed to build
        # or launch) is reported to this request's client and recorded
        except Exception as e:  # noqa: BLE001
            if obs.active():
                obs.event("serve", "request_error", req=req, endpoint=endpoint, error_kind=type(e).__name__,
                          error=str(e)[:500])
            log.warning("serve: request %s (%s) failed: %s: %s", req, endpoint, type(e).__name__, e)
            return 500, {"status": "error", "kind": type(e).__name__, "error": str(e)[:2000]}

    # -- endpoint bodies ----------------------------------------------------

    def _do_filter(self, body: dict, req: str) -> tuple[int, dict]:
        from variantcalling_tpu_torch.io import bed as bedio
        from variantcalling_tpu_torch.io import journal as journal_mod
        from variantcalling_tpu_torch.pipelines import filter_variants as fv

        if not body.get("output"):
            raise RequestError("missing required field 'output'")
        args = _filter_namespace(body, body["output"], self.backend)
        engine = engine_mod.resolve_request(self.device)
        model = self.state.get_model(args.model_file, args.model_name)
        fasta = self.state.get_fasta(args.reference_file)
        annotate = {fv._interval_name(p): bedio.read_intervals(p) for p in args.annotate_intervals}
        blacklist = fv.read_blacklist(args.blacklist) if args.blacklist else None
        try:
            rc = fv.run_loaded(args, model, fasta, annotate, blacklist, self.device)
        except BaseException:
            # a request is answered, not resumed: a failed or cancelled run
            # leaves no partial output or journal behind
            journal_mod.discard(args.output_file)
            raise
        if rc != 0:
            return 500, {"status": "failed", "rc": rc}
        return 200, {"status": "ok", "output": args.output_file, "engine": engine}

    def _do_score(self, body: dict, req: str) -> tuple[int, dict]:
        import numpy as np

        from variantcalling_tpu_torch.io.vcf import read_vcf
        from variantcalling_tpu_torch.pipelines import filter_variants as fv

        args = _filter_namespace(body, None, self.backend)
        engine = engine_mod.resolve_request(self.device)
        model = self.state.get_model(args.model_file, args.model_name)
        fasta = self.state.get_fasta(args.reference_file)
        table = read_vcf(args.input_file)
        cancellation.check("score request")
        ctx = fv.FilterContext(model, fasta, self.device, flow_order=args.flow_order, is_mutect=args.is_mutect)
        score, filters = ctx.score_table(table)
        cancellation.check("score request")
        return 200, {"status": "ok", "n": int(len(table)), "n_pass": int(np.sum(filters.codes == 0)),
                     "engine": engine, "score_mean": round(float(np.mean(score)), 6),
                     "score_min": round(float(np.min(score)), 6), "score_max": round(float(np.max(score)), 6)}

    def _do_coverage(self, body: dict, req: str) -> tuple[int, dict]:
        import numpy as np

        from variantcalling_tpu_torch.ops.coverage import host_coverage_stats

        depth = body.get("depth")
        if not isinstance(depth, list) or not depth:
            raise RequestError("field 'depth' must be a non-empty list of ints")
        window = int(body.get("window", 100))
        if window <= 0:
            raise RequestError("field 'window' must be positive")
        stats = host_coverage_stats(np.asarray(depth, dtype=np.int32), window,
                                    qs=np.asarray([0.05, 0.5, 0.95], dtype=np.float32))
        return 200, {"status": "ok", "n": len(depth), "window": window, "windows": int(len(stats["means"])),
                     "mean": round(float(np.mean(stats["means"])), 6),
                     "percentiles": {"p5": int(stats["percentiles"][0]), "p50": int(stats["percentiles"][1]),
                                     "p95": int(stats["percentiles"][2])}}

    def _do_warm(self, body: dict, req: str) -> tuple[int, dict]:
        warmed = []
        if body.get("model") and body.get("model_name"):
            if not os.path.exists(body["model"]):
                raise RequestError(f"model path does not exist: {body['model']}")
            self.state.get_model(body["model"], body["model_name"])
            warmed.append("model")
        if body.get("reference"):
            if not os.path.exists(body["reference"]):
                raise RequestError(f"reference path does not exist: {body['reference']}")
            self.state.get_fasta(body["reference"]).encode_all()  # the .venc sidecar written or read now
            warmed.append("reference")
        if not warmed:
            raise RequestError("nothing to warm: pass model+model_name and/or reference")
        return 200, {"status": "ok", "warmed": warmed}

    # -- introspection ------------------------------------------------------

    def status_payload(self) -> dict:
        from variantcalling_tpu_torch.io import chunk_cache

        per_endpoint = {}
        for ep in sorted(self.ENDPOINTS):
            p50, p99 = self.metrics.rolling_p50(ep), self.metrics.rolling_p99(ep)
            if p50 is not None or p99 is not None:
                per_endpoint[ep] = {"rolling_p50_s": round(p50, 6) if p50 else None,
                                    "rolling_p99_s": round(p99, 6) if p99 else None}
        return {"status": "draining" if self.draining.is_set() else "ok",
                "uptime_s": round(time.monotonic() - self._started, 1), "address": self.address,
                "device": str(self.device), "engine": engine_mod.engine_name(self.device),
                "in_flight": self.admission.inflight, "queued": self.admission.queued,
                "max_inflight": self.admission.max_inflight, "queue_depth": self.admission.queue_depth,
                "endpoints": per_endpoint, "resident": self.state.stats(), "cache": chunk_cache.resident_stats()}

    def metrics_payload(self) -> str:
        from variantcalling_tpu_torch.obs import prom

        return prom.snapshot_to_prom(self.metrics.snapshot(), tool="serve", in_flight=not self.draining.is_set())


#: the pipeline endpoints, which admission guards (the GET endpoints bypass
#: it: they must answer under overload)
Server.ENDPOINTS = {"filter": Server._do_filter, "score": Server._do_score, "coverage": Server._do_coverage,
                    "warm": Server._do_warm}


# -- transport ----------------------------------------------------------------

_HANDLER_N = itertools.count()


class _NamedThreadingHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def process_request(self, request, client_address):
        """``ThreadingMixIn.process_request`` with named daemon threads
        (``vctpu-serve-h<N>``), which the leak checks see."""
        t = threading.Thread(target=self.process_request_thread, args=(request, client_address),
                             name=f"vctpu-serve-h{next(_HANDLER_N)}", daemon=True)
        t.start()


class _UnixHTTPServer(_NamedThreadingHTTPServer):
    """HTTP over an AF_UNIX socket (``VCTPU_SERVE_SOCKET``)."""

    address_family = socket.AF_UNIX

    def __init__(self, path: str, handler):
        super().__init__(path, handler, bind_and_activate=True)

    def server_bind(self):
        # HTTPServer.server_bind unpacks (host, port): bind the path directly
        self.socket.bind(self.server_address)
        self.server_name = "unix"
        self.server_port = 0

    def get_request(self):
        request, _ = self.socket.accept()
        return request, ("unix", 0)


def _make_handler(server: Server):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        #: an idle keep-alive connection, or a client that sent half a
        #: request, releases its handler thread after this many seconds
        timeout = 60
        _POST_ROUTES = {f"/v1/{name}": name for name in server.ENDPOINTS}

        def log_message(self, fmt, *args):  # quiet: the obs stream carries the events
            log.debug("serve http: " + fmt, *args)

        def address_string(self):  # AF_UNIX: client_address is not a pair
            try:
                return super().address_string()
            except (TypeError, IndexError):
                return "unix"

        def _respond(self, code: int, payload: dict, retry_after_s: float | None = None) -> None:
            data = (json.dumps(payload) + "\n").encode()
            try:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                if retry_after_s is not None:
                    self.send_header("Retry-After", str(max(1, int(retry_after_s))))
                self.end_headers()
                self.wfile.write(data)
            except OSError:
                # the client went away: its work is already done or failed
                # on this side; count it, the daemon carries on
                server.metrics.registry.counter("serve.disconnects").add(1)
                obs.counter("serve.disconnects").add(1)
                log.info("serve: client went away before the response")

        def _respond_text(self, code: int, text: str, content_type: str) -> None:
            data = text.encode()
            try:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            except OSError:
                pass

        def do_GET(self):
            if self.path in ("/healthz", "/v1/healthz"):
                self._respond(200, {"status": "draining" if server.draining.is_set() else "ok"})
            elif self.path == "/v1/status":
                self._respond(200, server.status_payload())
            elif self.path == "/v1/metrics":
                self._respond_text(200, server.metrics_payload(), "text/plain; version=0.0.4; charset=utf-8")
            else:
                self._respond(404, {"status": "not_found", "error": f"unknown path {self.path}"})

        def do_POST(self):
            stream = server.STREAM_ROUTES.get(self.path)
            if stream is not None:
                # a streaming endpoint owns its whole exchange (chunked upload
                # in, chunked artifact out); a fault of the serving layer
                # still answers the client
                try:
                    getattr(server, stream)(self)
                except Exception as e:  # noqa: BLE001
                    log.warning("serve: internal error handling %s: %s: %s", self.path, type(e).__name__, e)
                    self._respond(500, {"status": "error", "kind": type(e).__name__, "error": str(e)[:2000]})
                return
            endpoint = self._POST_ROUTES.get(self.path)
            if endpoint is None:
                self._respond(404, {"status": "not_found", "error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("request body must be a JSON object")
            except (ValueError, OSError) as e:
                self._respond(400, {"status": "bad_request", "error": f"malformed request: {e}"})
                return
            try:
                code, payload = server.execute(endpoint, body)
            # the last resort under the isolation boundary: a fault of the
            # serving layer itself still answers the client
            except Exception as e:  # noqa: BLE001
                log.warning("serve: internal error handling %s: %s: %s", endpoint, type(e).__name__, e)
                code, payload = 500, {"status": "error", "kind": type(e).__name__, "error": str(e)[:2000]}
            self._respond(code, payload, retry_after_s=payload.get("retry_after_s"))

    return Handler
