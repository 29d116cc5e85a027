"""The fabric backend: ``python -m variantcalling_tpu_torch serve --fabric-backend``.

Counterpart of ``variantcalling_tpu/serve/backend.py``. One resident daemon
of the serving fabric: all that the plain daemon is (the resident models and
genome, the predictors with their kernel tables on the card, admission,
per-request isolation, no interpreter or torch start per request) plus the
span-segment endpoint the router fans filter requests out to:

- ``POST /v1/segment``, a streaming endpoint (:mod:`.transport`): the router
  uploads ``header + its span's slice`` of the request's record region as a
  standalone VCF (chunked); the backend runs the unchanged filter pipeline on
  it, on the daemon's device, under the request's scoped knobs, faults and
  deadline, and streams the finished segment back (chunked) with its run
  stats in the ``X-Vctpu-Stats`` header. The slice is a whole single-rank
  input, so every sibling span's segment carries the same header bytes, and
  the router's seam merge (``rank_plan.splice_segments``) splices them into
  the serial record stream.

On the card every forest segment runs the hand-written kernels: ``cuda-wide``
(``csrc/forest_wide.cu``) on ``auto``, ``cuda-gemm``
(``csrc/forest_tree_step.cu``) where the request scopes
``VCTPU_FOREST_STRATEGY=gemm``. A kernel that fails to build or launch fails
that segment request (500); no plain version serves it instead.

Heartbeats are pulled: the router polls ``GET /v1/status`` (the rolling
per-endpoint latency series, ``segment`` among them) and ``GET /v1/metrics``.
The status payload says ``"role": "backend"``. A request's failure (a poisoned
span, a watchdog abort, a deadline) is that segment request's error response;
the backend and its concurrent segments carry on. A dead backend is the
router's business: it re-offers the span to another backend.

At drain the backend logs :data:`DRAIN_LOG`, its process's forest kernel
launches and its peak card memory, which a launcher reads from its log (the
launches of a backend process are not visible to its parent).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import shutil
import tempfile

from variantcalling_tpu_torch.serve import transport
from variantcalling_tpu_torch.serve.daemon import Server

log = logging.getLogger(__name__)

#: the line a backend logs at drain
DRAIN_LOG = ("fabric backend: drained; forest kernel launches in this process: wide %d, tree_step %d; "
             "peak card memory %d bytes")


def segment_stats(path: str) -> dict:
    """The run stats the router records in a segment's ``.done`` marker: the
    record count and the PASS count, from the finished bytes themselves."""
    n = n_pass = 0
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b"#"):
                continue
            n += 1
            cols = line.split(b"\t", 8)
            if len(cols) > 6 and cols[6] == b"PASS":
                n_pass += 1
    return {"n": n, "n_pass": n_pass}


class Backend(Server):
    """A resident daemon of the fabric (see the module docstring)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        #: the local spool of streamed-in slices and their finished segments,
        #: swept after each request and at drain
        self._spool = tempfile.mkdtemp(prefix="vctpu-backend-")
        self._seg_n = itertools.count()

    # -- the segment's pipeline (the JSON half) ------------------------------

    def _do_segment(self, body: dict, req: str) -> tuple[int, dict]:
        """The filter endpoint (the same ``run_loaded``, the same resident
        caches) on the spooled slice, and the stats of the finished bytes.
        Runs inside ``execute``'s admission and isolation envelope."""
        code, payload = self._do_filter(body, req)
        if code == 200:
            payload["stats"] = segment_stats(body["output"])
        return code, payload

    # -- the streaming half ---------------------------------------------------

    def _handle_segment(self, handler) -> None:
        """The whole ``POST /v1/segment`` exchange: spool the chunked slice,
        run the pipeline through ``execute`` (admission, shedding, deadline
        and isolation all apply), stream the finished segment back with its
        stats in the header."""
        try:
            params = json.loads(handler.headers.get(transport.PARAMS_HEADER) or "{}")
            if not isinstance(params, dict):
                raise ValueError("params header must be a JSON object")
        except ValueError as e:
            handler._respond(400, {"status": "bad_request", "error": f"malformed params: {e}"})
            return
        # unique within the backend: two routers may number their requests alike
        tag = f"{os.path.basename(str(params.get('req') or 'seg'))}.{next(self._seg_n)}"
        spool_in = os.path.join(self._spool, f"{tag}.in.vcf")
        spool_out = os.path.join(self._spool, f"{tag}.out.vcf")
        try:
            try:
                transport.spool_body(handler, spool_in)
            except (ValueError, OSError) as e:
                handler._respond(400, {"status": "bad_request", "error": f"body upload failed: {e}"})
                return
            body = {"input": spool_in, "output": spool_out, "model": params.get("model"),
                    "model_name": params.get("model_name"), "reference": params.get("reference"),
                    "knobs": params.get("knobs"), "faults": params.get("faults")}
            if params.get("deadline_s") is not None:
                body["deadline_s"] = params["deadline_s"]
            for k in transport.SEGMENT_PARAMS:
                if params.get(k) is not None:
                    body[k] = params[k]
            code, payload = self.execute("segment", body)
            if code != 200:
                handler._respond(code, payload, retry_after_s=payload.get("retry_after_s"))
                return
            try:
                transport.send_stream(handler, 200, spool_out,
                                      {transport.STATS_HEADER: json.dumps(payload.get("stats") or {})})
            except OSError:
                # the router went away mid-download (a re-span, or its own
                # death): the segment was computed and sent as far as the
                # socket allowed; count it and carry on
                self.metrics.registry.counter("serve.disconnects").add(1)
                log.info("backend: peer went away mid-segment stream")
        finally:
            from variantcalling_tpu_torch.io import journal as journal_mod

            for p in (spool_in, spool_out):
                try:
                    os.remove(p)
                except OSError:
                    pass
            try:
                journal_mod.discard(spool_out)
            except OSError:
                pass

    # -- introspection ---------------------------------------------------------

    def status_payload(self) -> dict:
        payload = super().status_payload()
        payload["role"] = "backend"
        return payload

    def _drained(self) -> None:
        from variantcalling_tpu_torch.models import forest_cuda

        shutil.rmtree(self._spool, ignore_errors=True)
        peak = 0
        if self.device.type == "cuda":
            import torch

            peak = torch.cuda.max_memory_allocated(self.device)
        log.info(DRAIN_LOG, forest_cuda.LAUNCHES, forest_cuda.TREE_STEP_LAUNCHES, peak)


Backend.ENDPOINTS = dict(Server.ENDPOINTS, segment=Backend._do_segment)
Backend.STREAM_ROUTES = {"/v1/segment": "_handle_segment"}
