"""The fabric router: ``python -m variantcalling_tpu_torch serve --fabric``.

Counterpart of ``variantcalling_tpu/serve/router.py``. The front door of the
serving fabric, the tier that puts the resident daemon and the elastic pod's
partition, run and merge together into one online system:

- **registry and heartbeat**: the router registers the backend daemons named
  by ``VCTPU_FABRIC_BACKENDS`` (or ``--backends``) and polls each one's
  ``/v1/status`` (its rolling per-endpoint latency series) and ``/v1/metrics``
  (Prometheus text) every ``VCTPU_FABRIC_HEARTBEAT_S``;
  ``VCTPU_FABRIC_DEAD_AFTER`` failures in a row mark a backend dead (a
  ``membership`` event), a later good beat has it join again;
- **scatter**: each ``POST /v1/filter`` streams its input body in (a chunked
  upload: no host-local path crosses the front door), is cut into spans
  contig-aware (``parallel/rank_plan.contig_spans``), and each span goes to a
  live backend as ``header + slice``;
- **gather**: the segments stream back, are staged beside the spooled output
  under the elastic lease protocol (``parallel/elastic.claim_lease``: one
  claimant per (span, generation) offer), and the response path runs the seam
  merge the batch pod runs (``elastic.merge_spans`` ->
  ``rank_plan.splice_segments``): the client gets the batch CLI's bytes
  outside the ``##vctpu_*`` provenance lines;
- **admission across the fleet**: the rolling-latency shed decides on the
  worst live backend's rolling p50; bearer tokens (``VCTPU_FABRIC_TOKENS``) and
  a per-principal quota (``VCTPU_FABRIC_QUOTA``) guard the door before it;
- **failures** (never a hang): a backend that dies mid-request is marked dead
  and its span is offered again, under the next lease generation, to a live
  backend, within ``VCTPU_FABRIC_SPAN_ATTEMPTS``; a span past its attempts
  fails the request with the distinct status ``backend_lost``; a backend's
  shed propagates as a shed; a request's own errors (400, 504) fail it at once,
  without a re-span. Every socket operation has a timeout and the fan-out's
  join has a bound.

The router imports no torch and never touches the card: it places, moves
bytes and splices, which is cheap enough to sit in front of backends that
hold the card.
"""

from __future__ import annotations

import contextlib
import gzip
import itertools
import json
import logging
import os
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler

from variantcalling_tpu_torch import knobs, obs
from variantcalling_tpu_torch.serve import transport
from variantcalling_tpu_torch.serve.admission import AdmissionController, QueueDeadlineError, ShedError
from variantcalling_tpu_torch.serve.metrics import ServeMetrics

log = logging.getLogger(__name__)


@dataclass
class BackendEntry:
    """One registered backend daemon (``id``: its 1-based place in the fleet)."""

    id: int
    address: str
    alive: bool = False
    failures: int = 0
    status: dict = field(default_factory=dict)
    prom: str = ""
    last_seen: float = 0.0
    inflight: int = 0  # spans this router has placed on it now


@dataclass
class _SpanResult:
    """One span's fan-out outcome."""

    span: object  # elastic.Span, its last generation
    ok: bool = False
    code: int = 0
    payload: dict = field(default_factory=dict)
    stats: dict = field(default_factory=dict)
    attempts: int = 0
    backend: int | None = None


class Router:
    """The scatter-gather front door (see the module docstring)."""

    def __init__(self, host: str | None = None, port: int | None = None, socket_path: str | None = None,
                 obs_log: str | None = None, backends: list[str] | None = None):
        self.host = host if host is not None else knobs.get_str("VCTPU_SERVE_HOST")
        self.port = port if port is not None else knobs.get_int("VCTPU_SERVE_PORT")
        self.socket_path = socket_path if socket_path is not None else (knobs.get_str("VCTPU_SERVE_SOCKET") or None)
        self.default_deadline_s = knobs.get_float("VCTPU_SERVE_DEADLINE_S")
        self.drain_s = knobs.get_float("VCTPU_SERVE_DRAIN_S")
        self.heartbeat_s = knobs.get_float("VCTPU_FABRIC_HEARTBEAT_S")
        self.dead_after = knobs.get_int("VCTPU_FABRIC_DEAD_AFTER")
        self.span_attempts = knobs.get_int("VCTPU_FABRIC_SPAN_ATTEMPTS")
        self.tokens = transport.parse_tokens(knobs.get_str("VCTPU_FABRIC_TOKENS"))
        self.quota = transport.PrincipalQuota()
        addrs = backends if backends is not None else [
            a.strip() for a in knobs.get_str("VCTPU_FABRIC_BACKENDS").split(",") if a.strip()]
        self.backends = [BackendEntry(id=i + 1, address=a) for i, a in enumerate(addrs)]
        self._registry_lock = threading.Lock()
        self.metrics = ServeMetrics()
        self.admission = AdmissionController(latency_p50=self._fleet_p50)
        self.address: str | None = None
        self._req_n = itertools.count()
        self._started = time.monotonic()
        self._spool_root = tempfile.mkdtemp(prefix="vctpu-router-")
        self._httpd = None
        self._serve_thread: threading.Thread | None = None
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        self.draining = threading.Event()
        self.stopped = threading.Event()
        self._obs_log = obs_log
        self._obs_run = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        from variantcalling_tpu_torch.serve.daemon import _NamedThreadingHTTPServer, _UnixHTTPServer

        # the manifest names the host: the router holds no device
        if self._obs_log:
            self._obs_run = obs.start_run("fabric", force_path=self._obs_log, device="cpu")
        elif obs.enabled():
            self._obs_run = obs.start_run("fabric", default_path=os.path.abspath("vctpu_fabric.obs.jsonl"),
                                          device="cpu")
        self._beat()  # the fleet registered before any work is taken
        handler = _make_router_handler(self)
        if self.socket_path:
            with contextlib.suppress(OSError):
                os.remove(self.socket_path)
            self._httpd = _UnixHTTPServer(self.socket_path, handler)
            self.address = self.socket_path
        else:
            self._httpd = _NamedThreadingHTTPServer((self.host, self.port), handler)
            self.port = self._httpd.server_address[1]
            self.address = f"http://{self.host}:{self.port}"
        self._hb_thread = threading.Thread(target=self._heartbeat_loop, name="vctpu-fabric-heartbeat", daemon=True)
        self._hb_thread.start()
        self._serve_thread = threading.Thread(target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
                                              name="vctpu-fabric-accept", daemon=True)
        self._serve_thread.start()
        alive = sum(1 for b in self.backends if b.alive)
        if obs.active():
            obs.event("serve", "fabric_listening", address=self.address, backends=len(self.backends), alive=alive)
        log.info("fabric: listening on %s (%d/%d backends alive)", self.address, alive, len(self.backends))

    def drain(self, reason: str = "sigterm") -> None:
        """Refuse new requests (503 ``draining``), let those in flight finish
        within ``VCTPU_SERVE_DRAIN_S``, stop the heartbeat and the listener,
        close the obs stream with status ``drain`` and remove the spool."""
        if self.draining.is_set():
            return
        self.draining.set()
        self.admission.draining = True
        log.info("fabric: draining (%s): %d in flight", reason, self.admission.inflight)
        if obs.active():
            obs.event("serve", "drain_start", reason=reason, inflight=self.admission.inflight,
                      queued=self.admission.queued)
        deadline = time.monotonic() + self.drain_s
        while not self.admission.idle() and time.monotonic() < deadline:
            time.sleep(0.05)
        self._hb_stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5.0)
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
        if self.socket_path:
            with contextlib.suppress(OSError):
                os.remove(self.socket_path)
        if obs.active():
            obs.event("serve", "drain_end", clean=self.admission.idle())
        obs.end_run(self._obs_run, "drain")
        self._obs_run = None
        shutil.rmtree(self._spool_root, ignore_errors=True)
        self.stopped.set()
        log.info("fabric: stopped")

    # -- registry and heartbeat ------------------------------------------------

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(self.heartbeat_s):
            self._beat()

    def _beat(self) -> None:
        timeout = max(1.0, self.heartbeat_s * 2)
        for be in self.backends:
            try:
                with transport.request(be.address, "GET", "/v1/status", timeout=timeout) as r:
                    if r.status != 200:
                        raise transport.TransportError(f"status probe answered {r.status}")
                    status = r.json()
                prom = ""
                with transport.request(be.address, "GET", "/v1/metrics", timeout=timeout) as r:
                    if r.status == 200:
                        prom = r.read().decode(errors="replace")
            except OSError as e:  # TransportError among them
                self._mark_failure(be, str(e))
                continue
            with self._registry_lock:
                be.status, be.prom = status, prom
                be.failures = 0
                be.last_seen = time.monotonic()
                joined = not be.alive
                be.alive = True
            if joined:
                log.info("fabric: backend %d (%s) joined", be.id, be.address)
                if obs.active():
                    obs.event("membership", f"backend {be.id}", action="join", address=be.address)
        self.metrics.registry.gauge("fabric.backends_alive").set(sum(1 for b in self.backends if b.alive))

    def _mark_failure(self, be: BackendEntry, why: str, immediate: bool = False) -> None:
        with self._registry_lock:
            be.failures = self.dead_after if immediate else be.failures + 1
            died = be.alive and be.failures >= self.dead_after
            if died:
                be.alive = False
        if died:
            log.warning("fabric: backend %d (%s) marked dead: %s", be.id, be.address, why)
            if obs.active():
                obs.event("membership", f"backend {be.id}", action="dead", address=be.address, reason=why[:200])
            self.metrics.registry.gauge("fabric.backends_alive").set(sum(1 for b in self.backends if b.alive))

    def _live(self) -> list[BackendEntry]:
        with self._registry_lock:
            return [b for b in self.backends if b.alive]

    def _pick_backend(self, exclude: set[int]) -> BackendEntry | None:
        """The least-loaded live backend outside ``exclude`` (the span's
        failed hosts); any live backend if there is none outside it."""
        live = self._live()
        pool = [b for b in live if b.id not in exclude] or live
        if not pool:
            return None
        with self._registry_lock:
            return min(pool, key=lambda b: (b.inflight, b.id))

    def _fleet_p50(self, endpoint: str) -> float | None:
        """The admission's latency estimate across the fleet: the worst live
        backend's rolling ``segment`` p50 (a span may land on the slowest),
        its ``filter`` series while the segment series warms up."""
        vals = []
        with self._registry_lock:
            for be in self.backends:
                if not be.alive:
                    continue
                eps = (be.status or {}).get("endpoints") or {}
                for ep in ("segment", "filter"):
                    p50 = (eps.get(ep) or {}).get("rolling_p50_s")
                    if p50:
                        vals.append(float(p50))
                        break
        return max(vals) if vals else None

    # -- the front door ------------------------------------------------------

    def handle_filter(self, handler) -> None:
        """``POST /v1/filter``: auth, quota, admission, scatter, gather, seam
        merge, streamed response. Owns the whole exchange; every outcome is a
        response, never a hang."""
        req = f"f{next(self._req_n)}"
        try:
            principal = transport.authenticate(handler.headers.get("Authorization"), self.tokens)
        except transport.AuthError as e:
            self.metrics.count("filter", "shed")
            _respond_json(handler, 401, {"status": "unauthorized", "req": req, "error": str(e)})
            return
        try:
            release_quota = self.quota.acquire(principal)
        except transport.QuotaError as e:
            self.metrics.count("filter", "shed")
            if obs.active():
                obs.event("serve", "quota", req=req, principal=principal)
            _respond_json(handler, 429, {"status": "quota", "req": req, "principal": principal,
                                         "retry_after_s": e.retry_after_s}, retry_after_s=e.retry_after_s)
            return
        try:
            self._admitted_filter(handler, req, principal)
        finally:
            release_quota()

    def _admitted_filter(self, handler, req: str, principal: str) -> None:
        try:
            params = json.loads(handler.headers.get(transport.PARAMS_HEADER) or "{}")
            if not isinstance(params, dict):
                raise ValueError("params header must be a JSON object")
        except ValueError as e:
            _respond_json(handler, 400, {"status": "bad_request", "req": req, "error": f"malformed params: {e}"})
            return
        deadline_s = params.get("deadline_s", self.default_deadline_s)
        try:
            deadline_s = float(deadline_s) if deadline_s else None
        except (TypeError, ValueError):
            _respond_json(handler, 400, {"status": "bad_request", "req": req, "error": "deadline_s must be a number"})
            return
        t0 = time.perf_counter()
        try:
            release = self.admission.admit("filter", deadline_s)
        except ShedError as e:
            self.metrics.count("filter", "shed")
            if obs.active():
                obs.event("serve", "shed", req=req, endpoint="filter", reason=e.reason)
            _respond_json(handler, 503, {"status": "draining" if e.reason == "draining" else "shed", "req": req,
                                         "reason": e.reason, "retry_after_s": e.retry_after_s},
                          retry_after_s=e.retry_after_s)
            return
        except QueueDeadlineError as e:
            self.metrics.count("filter", "deadline")
            _respond_json(handler, 504, {"status": "deadline", "req": req, "error": str(e)})
            return
        self.metrics.count("filter", "accepted")
        self.metrics.set_load(self.admission.inflight, self.admission.queued)
        if obs.active():
            obs.event("serve", "request_start", req=req, endpoint="filter", principal=principal,
                      deadline_s=deadline_s or 0)
        spool = os.path.join(self._spool_root, req)
        code, payload, artifact, stats = 500, {"status": "error"}, None, {}
        try:
            code, payload, artifact, stats = self._scatter_gather(handler, req, params, deadline_s, spool)
        finally:
            release()
            self.metrics.set_load(self.admission.inflight, self.admission.queued)
            dur = time.perf_counter() - t0
            self.metrics.observe_latency("filter", dur)
            outcome = payload.get("status")
            self.metrics.count("filter", outcome if outcome in ("ok", "deadline", "cancelled") else "failed")
            if obs.active():
                obs.event("serve", "request_end", req=req, endpoint="filter", status=payload.get("status"),
                          code=code, dur=round(dur, 6))
            try:
                if artifact is None:
                    payload.setdefault("req", req)
                    _respond_json(handler, code, payload, retry_after_s=payload.get("retry_after_s"))
                else:
                    try:
                        transport.send_stream(handler, 200, artifact, {transport.STATS_HEADER: json.dumps(stats)})
                    except OSError:
                        self.metrics.registry.counter("serve.disconnects").add(1)
                        log.info("fabric: client went away mid-download")
            finally:
                shutil.rmtree(spool, ignore_errors=True)

    def _scatter_gather(self, handler, req: str, params: dict, deadline_s: float | None, spool: str):
        """The request's body: spool the upload, plan the spans, fan out,
        splice. Returns ``(code, payload, artifact path or None, stats)``; an
        artifact streams back as the 200 response."""
        from variantcalling_tpu_torch.io import identity as identity_mod
        from variantcalling_tpu_torch.parallel import elastic
        from variantcalling_tpu_torch.parallel import rank_plan as rank_plan_mod

        for fld in ("model", "model_name", "reference"):
            if not params.get(fld):
                return 400, {"status": "bad_request", "error": f"missing required param {fld!r}"}, None, {}
        os.makedirs(spool, exist_ok=True)
        input_path = os.path.join(spool, "input.vcf")
        try:
            transport.spool_body(handler, input_path)
            _inflate_in_place(input_path)
        except (ValueError, OSError) as e:
            return 400, {"status": "bad_request", "error": f"body upload failed: {e}"}, None, {}
        out_name = os.path.basename(str(params.get("output_name") or "out.vcf"))
        out_path = os.path.join(spool, out_name)
        deadline_at = None if deadline_s is None else time.monotonic() + deadline_s

        live = self._live()
        if not live:
            return 503, {"status": "shed", "reason": "no_backends", "retry_after_s": self.heartbeat_s * 2}, None, {}
        want = params.get("ranks")
        n = int(want) if want else len(live)
        if n <= 0:
            return 400, {"status": "bad_request", "error": f"ranks must be positive, got {n}"}, None, {}
        try:
            cuts = rank_plan_mod.contig_spans(input_path, n)
        except (OSError, ValueError) as e:
            return 400, {"status": "bad_request", "error": f"cannot span-partition the input: {e}"}, None, {}
        with open(input_path, "rb") as fh:
            header = fh.read(cuts[0][0])
        plan = rank_plan_mod.RankPlan(ranks=len(cuts), rank=0, source="fabric",
                                      reason=f"fabric fan-out over {len(live)} live backends")
        if obs.active():
            obs.event("serve", "fan_out", req=req, spans=len(cuts), backends=len(live), ranks=plan.ranks)

        identity = {"fabric": {
            "req": req, "input": identity_mod.file_sig(input_path), "model": params["model"],
            "model_name": params["model_name"], "reference": params["reference"],
            "knobs": params.get("knobs") or {}, "faults": params.get("faults") or ""}}

        abort = threading.Event()
        results = [_SpanResult(span=elastic.Span(lo, hi, 0)) for lo, hi in cuts]
        threads = []
        for i, res in enumerate(results):
            t = threading.Thread(target=self._run_span,
                                 args=(res, i, req, params, input_path, header, out_path, deadline_at, abort),
                                 name=f"vctpu-fabric-{req}-s{i}", daemon=True)
            threads.append(t)
            t.start()
        join_bound = time.monotonic() + 60.0 if deadline_at is None else deadline_at + 30.0
        for t in threads:
            t.join(timeout=max(0.5, join_bound - time.monotonic()))
        if any(t.is_alive() for t in threads):
            # every attempt's socket has a timeout: this bound is the last
            # resort, not the expected path
            abort.set()
            return 504, {"status": "deadline", "error": "fan-out exceeded the request deadline"}, None, {}

        failed = [r for r in results if not r.ok]
        if failed:
            # a sibling span cancelled by another's failure says "cancelled":
            # the root cause answers the request, so cancellations rank last
            def _rank(r):
                if r.payload.get("status") == "cancelled":
                    return 9
                return {400: 0, 504: 1, 503: 2}.get(r.code, 3)

            worst = min(failed, key=_rank)
            payload = dict(worst.payload)
            payload.setdefault("status", "error")
            payload["span"] = worst.span.label()
            payload["attempts"] = worst.attempts
            return worst.code or 502, payload, None, {}

        respans = sum(r.attempts - 1 for r in results)
        for r in results:
            seg = elastic.span_segment_path(out_path, r.span.lo, r.span.hi)
            rank_plan_mod.write_marker(seg, identity, r.stats)
        try:
            merged = elastic.merge_spans(out_path, [r.span for r in results])
        except rank_plan_mod.MergeError as e:
            log.warning("fabric: %s: seam merge refused: %s", req, e)
            return 502, {"status": "merge_failed", "error": str(e)}, None, {}
        stats = {"status": "ok", "req": req, "n": merged["n"], "n_pass": merged["n_pass"],
                 "spans": merged["spans"], "respans": respans, "bytes": merged["bytes"]}
        if respans:
            self.metrics.registry.counter("fabric.respans").add(respans)
        return 200, {"status": "ok"}, out_path, stats

    def _run_span(self, res: _SpanResult, idx: int, req: str, params: dict, input_path: str, header: bytes,
                  out_path: str, deadline_at: float | None, abort: threading.Event) -> None:
        """One span end to end: place it, stream its slice, stage its segment;
        on a backend's death offer it again (the next generation) within the
        attempt budget. A terminal failure sets ``abort``, so that the sibling
        spans spend no more attempts on a request that has failed."""
        from variantcalling_tpu_torch.parallel import elastic

        tried: set[int] = set()
        span = res.span
        while True:
            if abort.is_set():
                res.code, res.payload = 503, {"status": "cancelled", "error": "sibling span failed first"}
                return
            if deadline_at is not None and time.monotonic() > deadline_at:
                res.code, res.payload = 504, {"status": "deadline", "error": "span deadline expired"}
                return
            be = self._pick_backend(tried)
            if be is None:
                res.code = 502
                res.payload = {"status": "backend_lost", "error": f"no live backends for span {span.label()}"}
                abort.set()
                return
            res.attempts += 1
            res.backend = be.id
            tried.add(be.id)
            with self._registry_lock:
                be.inflight += 1
            try:
                kind, code, payload, stats = self._attempt_span(be, span, req, idx, params, input_path, header,
                                                                out_path, deadline_at)
            finally:
                with self._registry_lock:
                    be.inflight = max(0, be.inflight - 1)
            if kind == "ok":
                res.ok, res.code, res.stats, res.span = True, 200, stats, span
                return
            if kind == "fatal":
                # the request's own error (bad input, deadline): no re-span
                res.code, res.payload = code, payload
                abort.set()
                return
            # a transport or host failure, or a backend's shed: offer the span
            # again under the next lease generation
            if kind == "dead":
                self._mark_failure(be, payload.get("error", "span attempt"), immediate=True)
            if res.attempts >= self.span_attempts:
                res.code = code or 502
                res.payload = payload or {"status": "backend_lost"}
                abort.set()
                return
            span = elastic.Span(span.lo, span.hi, span.gen + 1)
            res.span = span
            log.info("fabric: %s span %s offered again (gen %d) after backend %d failed", req, span.label(),
                     span.gen, be.id)
            if obs.active():
                obs.event("serve", "respan", req=req, span=span.label(), gen=span.gen, backend=be.id)

    def _attempt_span(self, be: BackendEntry, span, req: str, idx: int, params: dict, input_path: str,
                      header: bytes, out_path: str, deadline_at: float | None):
        """One placement. Returns ``(kind, code, payload, stats)``, ``kind``
        one of ok, fatal, shed, dead, error."""
        from variantcalling_tpu_torch.parallel import elastic

        remaining = None if deadline_at is None else max(1.0, deadline_at - time.monotonic())
        seg_params = {"req": f"{req}-s{idx}g{span.gen}", "model": params["model"],
                      "model_name": params["model_name"], "reference": params["reference"],
                      "knobs": params.get("knobs"), "faults": params.get("faults")}
        if remaining is not None:
            seg_params["deadline_s"] = remaining
        for k in transport.SEGMENT_PARAMS:
            if params.get(k) is not None:
                seg_params[k] = params[k]

        def slice_iter():
            yield header
            with open(input_path, "rb") as fh:
                fh.seek(span.lo)
                left = span.hi - span.lo
                while left:
                    block = fh.read(min(left, transport.chunk_bytes()))
                    if not block:
                        raise transport.TransportError("input spool truncated under a span read")
                    yield block
                    left -= len(block)

        seg = elastic.span_segment_path(out_path, span.lo, span.hi)
        staging = f"{seg}.g{span.gen}.tmp"
        try:
            with transport.request(be.address, "POST", "/v1/segment",
                                   headers={transport.PARAMS_HEADER: json.dumps(seg_params)},
                                   body_iter=slice_iter(), timeout=min(remaining or 300.0, 300.0)) as resp:
                if resp.status != 200:
                    payload = resp.json()
                    if resp.status in (400, 504) or payload.get("status") == "deadline":
                        return "fatal", resp.status, payload, {}
                    if resp.status == 503:
                        return "shed", 503, payload, {}
                    return "error", resp.status, payload, {}
                stats = json.loads(resp.headers.get(transport.STATS_HEADER.lower(), "{}"))
                with open(staging, "wb") as sink:
                    resp.copy_to(sink.write)
        except (OSError, ValueError) as e:  # TransportError among them
            with contextlib.suppress(OSError):
                os.remove(staging)
            return "dead", 502, {"status": "backend_lost", "error": f"backend {be.id}: {e}"}, {}
        if not elastic.claim_lease(seg, span.gen):
            # a second claimant of this (span, generation) offer: the elastic
            # rule keeps one, so this copy goes
            with contextlib.suppress(OSError):
                os.remove(staging)
            return "error", 502, {"status": "backend_lost",
                                  "error": f"lease lost for {span.label()} gen {span.gen}"}, {}
        os.replace(staging, seg)
        return "ok", 200, {}, stats

    # -- introspection ------------------------------------------------------

    def status_payload(self) -> dict:
        per_endpoint = {}
        p50, p99 = self.metrics.rolling_p50("filter"), self.metrics.rolling_p99("filter")
        if p50 is not None or p99 is not None:
            per_endpoint["filter"] = {"rolling_p50_s": round(p50, 6) if p50 else None,
                                      "rolling_p99_s": round(p99, 6) if p99 else None}
        with self._registry_lock:
            backends = {str(b.id): {"address": b.address, "alive": b.alive, "failures": b.failures,
                                    "inflight": b.inflight, "endpoints": (b.status or {}).get("endpoints") or {}}
                        for b in self.backends}
        return {"status": "draining" if self.draining.is_set() else "ok", "role": "router",
                "uptime_s": round(time.monotonic() - self._started, 1), "address": self.address,
                "in_flight": self.admission.inflight, "queued": self.admission.queued,
                "max_inflight": self.admission.max_inflight, "queue_depth": self.admission.queue_depth,
                "endpoints": per_endpoint, "principals": self.quota.in_flight(),
                "fleet": {"alive": sum(1 for b in self.backends if b.alive), "registered": len(self.backends),
                          "p50_s": self._fleet_p50("filter")},
                "backends": backends}

    def backends_payload(self) -> dict:
        """``GET /v1/fabric/backends``: the registry, with each backend's last
        heartbeat (its rolling latency series in ``status``, its Prometheus
        text in ``prom``)."""
        with self._registry_lock:
            return {"backends": [{"id": b.id, "address": b.address, "alive": b.alive, "failures": b.failures,
                                  "status": b.status, "prom": b.prom} for b in self.backends]}

    def metrics_payload(self) -> str:
        from variantcalling_tpu_torch.obs import prom

        return prom.snapshot_to_prom(self.metrics.snapshot(), tool="fabric", in_flight=not self.draining.is_set())

    def warm_fleet(self, body: dict) -> tuple[int, dict]:
        """``POST /v1/warm`` passed on to every live backend (they share one
        deployment, so the same model and reference paths resolve on each)."""
        warmed, errors = [], []
        for be in self._live():
            try:
                with transport.request(be.address, "POST", "/v1/warm",
                                       headers={"Content-Type": "application/json"},
                                       body=json.dumps(body).encode(), timeout=120.0) as r:
                    (warmed if r.status == 200 else errors).append(be.id)
                    r.read()
            except OSError:  # TransportError among them
                errors.append(be.id)
        code = 200 if warmed and not errors else (502 if errors else 503)
        return code, {"status": "ok" if code == 200 else "error", "warmed": warmed, "errors": errors}


def _inflate_in_place(path: str) -> None:
    """A gzip-compressed upload (by its magic) is inflated into the plain
    spool the span planner reads; a plain upload stays as it is."""
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic != b"\x1f\x8b":
        return
    plain = path + ".tmp"
    with gzip.open(path, "rb") as src, open(plain, "wb") as dst:
        shutil.copyfileobj(src, dst, 1 << 20)
    os.replace(plain, path)


def _respond_json(handler, code: int, payload: dict, retry_after_s: float | None = None) -> None:
    data = (json.dumps(payload) + "\n").encode()
    try:
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(data)))
        if retry_after_s is not None:
            handler.send_header("Retry-After", str(max(1, int(retry_after_s))))
        handler.end_headers()
        handler.wfile.write(data)
    except OSError:
        log.info("fabric: client went away before the response")


def _make_router_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = 60

        def log_message(self, fmt, *args):
            log.debug("fabric http: " + fmt, *args)

        def address_string(self):
            try:
                return super().address_string()
            except (TypeError, IndexError):
                return "unix"

        def do_GET(self):
            if self.path in ("/healthz", "/v1/healthz"):
                _respond_json(self, 200, {"status": "draining" if router.draining.is_set() else "ok",
                                          "role": "router"})
            elif self.path == "/v1/status":
                _respond_json(self, 200, router.status_payload())
            elif self.path == "/v1/fabric/backends":
                _respond_json(self, 200, router.backends_payload())
            elif self.path == "/v1/metrics":
                data = router.metrics_payload().encode()
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except OSError:
                    pass
            else:
                _respond_json(self, 404, {"status": "not_found", "error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                if self.path == "/v1/filter":
                    router.handle_filter(self)
                elif self.path == "/v1/warm":
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    code, payload = router.warm_fleet(body)
                    _respond_json(self, code, payload)
                else:
                    _respond_json(self, 404, {"status": "not_found", "error": f"unknown path {self.path}"})
            # the last resort: a fault of the router itself still answers the client
            except Exception as e:  # noqa: BLE001
                log.warning("fabric: internal error handling %s: %s: %s", self.path, type(e).__name__, e)
                _respond_json(self, 500, {"status": "error", "kind": type(e).__name__, "error": str(e)[:2000]})

    return Handler
