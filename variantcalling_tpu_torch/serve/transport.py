"""The fabric's transport: chunked body streaming, bearer auth, quota.

Counterpart of ``variantcalling_tpu/serve/transport.py``, with its wire:
the same headers, the same chunked framing, the same status payloads. The
serving fabric moves request and response bodies between processes, so
nothing here assumes a shared filesystem:

- a small HTTP/1.1 client (:func:`request`) over the two address families
  the daemon listens on, ``http://host:port`` TCP and a filesystem path for
  AF_UNIX, with a ``Transfer-Encoding: chunked`` upload from any byte
  iterator and a streaming download reader; every socket operation has a
  timeout, so no exchange hangs;
- the server-side halves (:func:`spool_body`, :func:`send_stream`) a
  ``BaseHTTPRequestHandler`` uses to spool an uploaded body to a local file
  and to stream a finished file back;
- the front door's policy: :func:`authenticate` (bearer tokens to
  principals, ``VCTPU_FABRIC_TOKENS``) and :class:`PrincipalQuota`
  (concurrent requests per principal, ``VCTPU_FABRIC_QUOTA``).

The framing never shows in the spooled stream: the same bytes arrive
whatever ``VCTPU_FABRIC_STREAM_CHUNK_BYTES`` says. Standard library only:
the router imports this module and never imports torch.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time

from variantcalling_tpu_torch import knobs

#: the request's parameters travel in this header (JSON), its body in the stream
PARAMS_HEADER = "X-Vctpu-Params"
#: a segment's run stats ride back in this response header (JSON)
STATS_HEADER = "X-Vctpu-Stats"

#: the filter parameters a segment request carries on, besides model, reference, knobs, faults and deadline
SEGMENT_PARAMS = ("runs_file", "blacklist", "blacklist_cg_insertions", "flow_order", "is_mutect", "annotate_intervals",
                  "limit_to_contig", "hpol_filter_length_dist")

#: the upload spool's cap: a runaway stream is answered 400, it does not fill the disk
MAX_BODY_BYTES = 8 << 30


class TransportError(OSError):
    """A transport failure (connect, read, write, timeout, a short or torn
    stream). Callers treat it as "that attempt on that peer failed", never as
    an error of the request itself."""


class AuthError(Exception):
    """A missing or unknown bearer token (HTTP 401)."""


class QuotaError(Exception):
    """A principal past its quota (HTTP 429)."""

    def __init__(self, principal: str, limit: int, retry_after_s: float = 1.0):
        super().__init__(f"principal {principal!r} is at its quota ({limit} concurrent requests)")
        self.principal = principal
        self.limit = limit
        self.retry_after_s = retry_after_s


def chunk_bytes() -> int:
    return knobs.get_int("VCTPU_FABRIC_STREAM_CHUNK_BYTES")


def stream_file(path: str, chunk: int | None = None):
    """Yield a file's bytes in transport-sized frames."""
    chunk = chunk or chunk_bytes()
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                return
            yield block


# -- the client: HTTP/1.1 over TCP or AF_UNIX, chunked both ways ----------------


def _connect(address: str, timeout: float) -> socket.socket:
    try:
        if address.startswith("http://"):
            host, _, port = address[len("http://"):].partition(":")
            return socket.create_connection((host, int(port or 80)), timeout=timeout)
        # a filesystem path: the daemon's AF_UNIX face
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        try:
            s.connect(address)
        except OSError:
            s.close()
            raise
        return s
    except (OSError, ValueError) as e:
        raise TransportError(f"cannot connect to {address}: {e}") from e


class Response:
    """A streamed HTTP response: the status and headers now, the body on
    demand (``Content-Length`` or chunked). ``read()`` drains the rest;
    ``copy_to`` streams it into a sink and returns the byte count. A short or
    torn stream raises :class:`TransportError`; it never truncates silently."""

    def __init__(self, sock: socket.socket, fh):
        self._sock = sock
        self._fh = fh
        line = fh.readline(8192)
        parts = line.split(None, 2)
        if len(parts) < 2 or not parts[1].isdigit():
            raise TransportError(f"malformed status line {line!r}")
        self.status = int(parts[1])
        self.headers: dict[str, str] = {}
        while True:
            line = fh.readline(65536)
            if line in (b"\r\n", b"\n", b""):
                break
            name, _, value = line.decode("latin-1").partition(":")
            self.headers[name.strip().lower()] = value.strip()
        self._chunked = self.headers.get("transfer-encoding", "").lower() == "chunked"
        self._remaining = None if self._chunked else int(self.headers.get("content-length", 0))

    def json(self) -> dict:
        try:
            doc = json.loads(self.read() or b"{}")
        except ValueError as e:
            raise TransportError(f"malformed JSON response body: {e}") from e
        if not isinstance(doc, dict):
            raise TransportError("response body is not a JSON object")
        return doc

    def read(self) -> bytes:
        out = []
        self.copy_to(out.append)
        return b"".join(out)

    def copy_to(self, write) -> int:
        try:
            if self._chunked:
                return self._copy_chunked(write)
            total = 0
            while self._remaining:
                block = self._fh.read(min(self._remaining, 1 << 20))
                if not block:
                    raise TransportError(f"short read: {self._remaining} bytes missing")
                write(block)
                total += len(block)
                self._remaining -= len(block)
            return total
        except TransportError:
            raise
        except (OSError, ValueError) as e:
            raise TransportError(f"response stream failed: {e}") from e

    def _copy_chunked(self, write) -> int:
        total = 0
        while True:
            size_line = self._fh.readline(1024)
            try:
                size = int(size_line.split(b";", 1)[0].strip(), 16)
            except ValueError:
                raise TransportError(f"malformed chunk size {size_line!r}") from None
            if size == 0:
                self._fh.readline(1024)  # the trailing CRLF
                return total
            remaining = size
            while remaining:
                block = self._fh.read(min(remaining, 1 << 20))
                if not block:
                    raise TransportError("short read inside a chunk")
                write(block)
                total += len(block)
                remaining -= len(block)
            self._fh.readline(1024)  # the chunk's CRLF

    def close(self) -> None:
        try:
            self._fh.close()
        finally:
            try:
                self._sock.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def request(address: str, method: str, path: str, headers: dict[str, str] | None = None, body: bytes | None = None,
            body_iter=None, timeout: float = 60.0) -> Response:
    """One HTTP exchange with a fabric peer. ``body`` is sent with
    ``Content-Length``; ``body_iter`` is streamed with chunked transfer
    encoding. The returned :class:`Response` owns the socket: close it (or
    use ``with``)."""
    sock = _connect(address, timeout)
    try:
        head = [f"{method} {path} HTTP/1.1", "Host: fabric", "Connection: close"]
        for k, v in (headers or {}).items():
            head.append(f"{k}: {v}")
        if body is not None:
            head.append(f"Content-Length: {len(body)}")
        elif body_iter is not None:
            head.append("Transfer-Encoding: chunked")
        sock.sendall(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        try:
            if body is not None:
                sock.sendall(body)
            elif body_iter is not None:
                for block in body_iter:
                    if block:
                        sock.sendall(b"%x\r\n" % len(block) + block + b"\r\n")
                sock.sendall(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            # the peer answered early and closed its read side (401 at the
            # door, 400 before the body, a shed): its verdict is in the receive
            # buffer; read it, and fail only if there is no response after all
            pass
        return Response(sock, sock.makefile("rb"))
    except (OSError, ValueError) as e:
        try:
            sock.close()
        except OSError:
            pass
        if isinstance(e, TransportError):
            raise
        raise TransportError(f"request to {address}{path} failed: {e}") from e


# -- the server-side halves (BaseHTTPRequestHandler helpers) ---------------------


def spool_body(handler, dest_path: str, max_bytes: int = MAX_BODY_BYTES) -> int:
    """Stream a request body (``Content-Length`` or a chunked upload) into a
    local spool file and return its byte count. Raises ``ValueError`` on
    malformed framing or a body over the cap: the caller answers 400."""
    te = (handler.headers.get("Transfer-Encoding") or "").lower()
    total = 0
    with open(dest_path, "wb") as sink:
        if te == "chunked":
            while True:
                size_line = handler.rfile.readline(1024)
                size = int(size_line.split(b";", 1)[0].strip(), 16)
                if size == 0:
                    handler.rfile.readline(1024)
                    return total
                total += size
                if total > max_bytes:
                    raise ValueError(f"body exceeds {max_bytes} bytes")
                remaining = size
                while remaining:
                    block = handler.rfile.read(min(remaining, 1 << 20))
                    if not block:
                        raise ValueError("short read inside a chunk")
                    sink.write(block)
                    remaining -= len(block)
                handler.rfile.readline(1024)
        remaining = int(handler.headers.get("Content-Length", 0))
        if remaining > max_bytes:
            raise ValueError(f"body exceeds {max_bytes} bytes")
        while remaining:
            block = handler.rfile.read(min(remaining, 1 << 20))
            if not block:
                raise ValueError("short read in request body")
            sink.write(block)
            total += len(block)
            remaining -= len(block)
    return total


def send_stream(handler, code: int, path: str, extra_headers: dict[str, str] | None = None) -> None:
    """Stream a finished local file back as a chunked response. A client
    that goes away mid-stream surfaces as ``OSError`` to the caller, which
    counts it; the file itself is already committed."""
    handler.send_response(code)
    handler.send_header("Content-Type", "application/octet-stream")
    handler.send_header("Transfer-Encoding", "chunked")
    for k, v in (extra_headers or {}).items():
        handler.send_header(k, v)
    handler.end_headers()
    for block in stream_file(path):
        handler.wfile.write(b"%x\r\n" % len(block) + block + b"\r\n")
    handler.wfile.write(b"0\r\n\r\n")


# -- the front door's policy: bearer tokens, per-principal quota -----------------


def parse_tokens(spec: str) -> dict[str, str]:
    """``token:principal,...`` -> ``{token: principal}``. A malformed entry
    is a configuration error: refused, not guessed at."""
    out: dict[str, str] = {}
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        token, sep, principal = entry.partition(":")
        if not sep or not token or not principal:
            raise ValueError(f"malformed VCTPU_FABRIC_TOKENS entry {entry!r} (want token:principal)")
        out[token] = principal
    return out


def authenticate(auth_header: str | None, tokens: dict[str, str]) -> str:
    """The request's principal. An empty token table turns auth off (a
    single-tenant fabric): every request is ``anonymous``. With a table, only
    ``Authorization: Bearer <known token>`` passes."""
    if not tokens:
        return "anonymous"
    if not auth_header or not auth_header.startswith("Bearer "):
        raise AuthError("missing bearer token")
    principal = tokens.get(auth_header[len("Bearer "):].strip())
    if principal is None:
        raise AuthError("unknown bearer token")
    return principal


class PrincipalQuota:
    """The front door's cap on each principal's concurrent requests.
    ``acquire`` returns a release callable (idempotent) or raises
    :class:`QuotaError`, which the caller answers 429 with ``Retry-After``."""

    def __init__(self, limit: int | None = None):
        self.limit = limit if limit is not None else knobs.get_int("VCTPU_FABRIC_QUOTA")
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def acquire(self, principal: str):
        with self._lock:
            n = self._counts.get(principal, 0)
            if n >= self.limit:
                raise QuotaError(principal, self.limit)
            self._counts[principal] = n + 1
        released = threading.Event()

        def release():
            if released.is_set():
                return
            released.set()
            with self._lock:
                left = self._counts.get(principal, 1) - 1
                if left <= 0:
                    self._counts.pop(principal, None)
                else:
                    self._counts[principal] = left

        return release

    def in_flight(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


# -- the front door's client (tests, operators) -----------------------------------


def client_filter(address: str, params: dict, input_path: str, out_path: str, token: str | None = None,
                  timeout: float = 300.0) -> tuple[int, dict]:
    """One filter request through the fabric's front door: the input
    streamed up, the result streamed down into ``out_path``. Returns
    ``(http_status, payload)``: the error or shed JSON on any other status
    than 200, the ``X-Vctpu-Stats`` dict on 200 (the bytes are then in
    ``out_path``). The download goes through a ``.tmp`` spool and
    ``os.replace``, so a torn stream never leaves a partial output."""
    headers = {PARAMS_HEADER: json.dumps(params), "Content-Type": "application/octet-stream"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    with request(address, "POST", "/v1/filter", headers=headers, body_iter=stream_file(input_path),
                 timeout=timeout) as resp:
        if resp.status != 200:
            return resp.status, resp.json()
        stats = json.loads(resp.headers.get(STATS_HEADER.lower(), "{}"))
        part = out_path + f".{os.getpid()}-{time.time_ns():x}.tmp"
        try:
            with open(part, "wb") as sink:
                resp.copy_to(sink.write)
            os.replace(part, out_path)
        except BaseException:
            try:
                os.remove(part)
            except OSError:
                pass
            raise
        return 200, stats
