"""The port's serving fabric on the CPU, held against the JAX package's.

World: the reference's own fabric fixture (``bench.make_fixtures(n=1500,
genome_len=120_000)``, an 8-tree depth-4 ``synthetic_forest`` pickled by the
JAX package), the JAX package's batch CLI output as the bytes every fabric
answer must give outside ``##vctpu_*`` lines. Tolerance 0: byte identity.

- The transport against the reference's functions on the same inputs: token
  tables (and the malformed specs), ``authenticate``, ``PrincipalQuota``; a
  chunked upload spooled and streamed back, with each package's server half
  read by each package's client half, equal bytes; a torn chunked body is a
  ``TransportError`` in both.
- ``segment_stats`` equals the reference's; a port ``Backend``'s
  ``/v1/segment`` answer (bytes and ``X-Vctpu-Stats``) equals a reference
  ``Backend``'s on the same slice.
- A port ``Router`` over two port ``Backend``s (``device="cpu"``): ``ranks=2``
  and ``ranks=1`` give the batch CLI's bytes, missing params 400
  ``bad_request``, the status, registry and metrics payloads, bearer tokens
  (401, 401, 200), the quota (429 ``quota``), a re-span after a backend's
  death (200, ``respans >= 1``, equal bytes) and then ``backend_lost`` (502,
  or 503 once the fleet is marked dead) with no output; the error cases'
  (code, status) are the reference fabric's.
- The wire both ways: the reference's ``Router`` over the port's backends,
  the port's ``Router`` over the reference's backends, each the batch CLI's
  bytes.
- A scoped ``VCTPU_FABRIC_*`` knob is answered 400 by both packages;
  ``serve --fabric --fabric-backend`` exits 2 in both.

Every test runs under the leak sentinel (``tests.conftest.assert_no_stream_leaks``),
and the router's and backends' spools are gone after each fleet drains.
"""

import json
import os
import pickle
import shutil
import socket
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from tests.conftest import assert_no_stream_leaks
from tests.fixtures import strip_vctpu_header
from variantcalling_tpu.serve import transport as jtransport
from variantcalling_tpu_torch.serve import transport

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is absent: the engine cannot be built")

#: directories the leak sentinel sweeps after every test of this module
_WATCHED_DIRS: list[str] = []
PACKAGES = {"port": transport, "ref": jtransport}


@pytest.fixture(autouse=True)
def _leak_sentinel(monkeypatch):
    for k in ("VCTPU_FABRIC_TOKENS", "VCTPU_FABRIC_QUOTA", "VCTPU_FABRIC_HEARTBEAT_S", "VCTPU_FABRIC_BACKENDS",
              "VCTPU_FOREST_STRATEGY", "VCTPU_FAULTS", "VCTPU_OBS", "VCTPU_CACHE"):
        monkeypatch.delenv(k, raising=False)
    yield
    assert_no_stream_leaks(_WATCHED_DIRS)


@pytest.fixture(scope="module")
def fabric_world(tmp_path_factory):
    import bench
    from variantcalling_tpu.pipelines.filter_variants import run as frun
    from variantcalling_tpu.synthetic import synthetic_forest

    d = tmp_path_factory.mktemp("fabric_world")
    _WATCHED_DIRS.append(str(d))
    bench.make_fixtures(str(d), n=1500, genome_len=120_000)
    model = synthetic_forest(np.random.default_rng(0), n_trees=8, depth=4)
    model_pkl = str(d / "model.pkl")
    with open(model_pkl, "wb") as fh:
        pickle.dump({"m": model}, fh)
    ref_out = str(d / "reference.vcf")
    assert frun(["--input_file", str(d / "calls.vcf"), "--model_file", model_pkl, "--model_name", "m",
                 "--reference_file", str(d / "ref.fa"), "--output_file", ref_out, "--backend", "cpu"]) == 0
    with open(ref_out, "rb") as fh:
        want = fh.read()
    return {"dir": str(d), "input": str(d / "calls.vcf"), "model": model_pkl, "ref": str(d / "ref.fa"),
            "reference_bytes": want}


def _params(w, out_name, **extra):
    return {"model": w["model"], "model_name": "m", "reference": w["ref"], "output_name": out_name,
            "deadline_s": 120.0, **extra}


def _same(path, w) -> bool:
    with open(path, "rb") as fh:
        return strip_vctpu_header(fh.read()) == strip_vctpu_header(w["reference_bytes"])


def _spool_left(router, bound_s: float = 5.0) -> list[str]:
    """What the router's spool still holds once the request handlers are done
    (a handler removes its request's spool just after its response)."""
    deadline = time.monotonic() + bound_s
    while (left := os.listdir(router._spool_root)) and time.monotonic() < deadline:
        time.sleep(0.05)
    return left


def _backend(kind: str):
    if kind == "port":
        from variantcalling_tpu_torch.serve.backend import Backend

        b = Backend(port=0, device="cpu")
    else:
        from variantcalling_tpu.serve.backend import Backend

        b = Backend(port=0)
    b.start()
    return b


def _router(kind: str, addresses: list[str]):
    if kind == "port":
        from variantcalling_tpu_torch.serve.router import Router
    else:
        from variantcalling_tpu.serve.router import Router
    r = Router(port=0, backends=addresses)
    r.start()
    return r


class _Fleet:
    """A router over two backends, in process; drained (and its spools
    checked gone) on exit."""

    def __init__(self, router_kind: str = "port", backend_kind: str = "port"):
        self.backends = [_backend(backend_kind), _backend(backend_kind)]
        self.router = _router(router_kind, [b.address for b in self.backends])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.router.drain("test")
        for b in self.backends:
            b.drain("test")
        assert not os.path.exists(self.router._spool_root)
        assert not any(os.path.exists(b._spool) for b in self.backends)


# -- the transport ---------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("spec,want", [("", {}), ("t1:alice, t2:bob,", {"t1": "alice", "t2": "bob"}),
                                       ("a:b", {"a": "b"}), (" x:y ,,z:w", {"x": "y", "z": "w"})])
def test_parse_tokens_roundtrip(spec, want):
    assert transport.parse_tokens(spec) == jtransport.parse_tokens(spec) == want


@pytest.mark.parametrize("spec", ["t1", "t1:", ":alice", "t1:a,oops"])
def test_parse_tokens_malformed_refused(spec):
    messages = []
    for mod in (transport, jtransport):
        with pytest.raises(ValueError, match="malformed") as e:
            mod.parse_tokens(spec)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("header,tokens", [
    (None, {}), ("Bearer whatever", {}), ("Bearer sekrit", {"sekrit": "alice"}), (None, {"sekrit": "alice"}),
    ("", {"sekrit": "alice"}), ("Basic sekrit", {"sekrit": "alice"}), ("Bearer nope", {"sekrit": "alice"}),
    ("Bearer  sekrit ", {"sekrit": "alice"}),
])
def test_authenticate_against_the_reference(header, tokens):
    def outcome(mod):
        try:
            return "ok", mod.authenticate(header, tokens)
        except mod.AuthError as e:
            return "auth", str(e)

    assert outcome(transport) == outcome(jtransport)


def test_principal_quota_against_the_reference():
    """The same acquire/release sequence on both quotas: the same grants,
    refusals and in-flight tables at every step."""

    def replay(mod):
        q = mod.PrincipalQuota(limit=2)
        trace, releases = [], {}
        for step, (op, who) in enumerate([("a", "alice"), ("a", "alice"), ("a", "alice"), ("a", "bob"),
                                          ("r", 0), ("r", 0), ("a", "alice"), ("r", 1), ("r", 3), ("a", "bob")]):
            if op == "a":
                try:
                    releases[step] = q.acquire(who)
                    trace.append(("granted", who))
                except mod.QuotaError as e:
                    trace.append(("refused", e.principal, e.limit, e.retry_after_s, str(e)))
            else:
                releases[who]()  # released twice at step 5: idempotent
            trace.append(q.in_flight())
        return trace

    assert replay(transport) == replay(jtransport)


class _EchoHandler(BaseHTTPRequestHandler):
    """Spools the upload with one package's ``spool_body`` and streams it back
    with its ``send_stream``; ``torn`` sends half a chunk and closes."""

    protocol_version = "HTTP/1.1"
    mod = transport
    spool = ""
    torn = False

    def log_message(self, *args):
        pass

    def do_POST(self):
        n = self.mod.spool_body(self, self.spool)
        if self.torn:
            self.send_response(200)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self.wfile.write(b"100\r\n" + b"x" * 10)
            self.wfile.flush()
            self.connection.shutdown(socket.SHUT_RDWR)
            return
        self.mod.send_stream(self, 200, self.spool, {self.mod.STATS_HEADER: json.dumps({"n": n})})


def _echo_server(mod, spool, torn=False):
    handler = type("H", (_EchoHandler,), {"mod": mod, "spool": spool, "torn": torn})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    httpd.daemon_threads = True
    t = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True)
    t.start()
    return httpd, t, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.mark.parametrize("frame", [4096, 1 << 20])
@pytest.mark.parametrize("server,client", [("ref", "port"), ("port", "ref"), ("port", "port")])
def test_streamed_bodies_cross_the_packages(fabric_world, tmp_path, monkeypatch, server, client, frame):
    """A chunked upload spooled by one package's server half and streamed
    back by its ``send_stream``, read by the other package's ``request`` and
    ``Response.copy_to``: the input's bytes, whatever the frame size."""
    monkeypatch.setenv("VCTPU_FABRIC_STREAM_CHUNK_BYTES", str(frame))
    smod, cmod = PACKAGES[server], PACKAGES[client]
    httpd, t, address = _echo_server(smod, str(tmp_path / "spool.bin"))
    try:
        got = []
        with cmod.request(address, "POST", "/echo", body_iter=cmod.stream_file(fabric_world["input"]),
                          timeout=30) as resp:
            assert resp.status == 200
            stats = json.loads(resp.headers[cmod.STATS_HEADER.lower()])
            n = resp.copy_to(got.append)
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(5)
    with open(fabric_world["input"], "rb") as fh:
        want = fh.read()
    assert b"".join(got) == want and n == stats["n"] == len(want)
    assert len(got) == -(-len(want) // min(frame, 1 << 20))  # one frame a chunk


@pytest.mark.parametrize("kind", ["port", "ref"])
def test_a_torn_chunked_body_is_a_transport_error(tmp_path, kind):
    mod = PACKAGES[kind]
    httpd, t, address = _echo_server(mod, str(tmp_path / "spool.bin"), torn=True)
    try:
        with mod.request(address, "POST", "/echo", body=b"abc", timeout=10) as resp:
            with pytest.raises(mod.TransportError, match="short read inside a chunk"):
                resp.read()
        with pytest.raises(mod.TransportError, match="cannot connect"):
            mod.request(str(tmp_path / "no.sock"), "GET", "/v1/status", timeout=2)
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(5)


# -- the backend -----------------------------------------------------------------------------------------------------


def test_segment_stats_equal_the_reference(fabric_world, tmp_path):
    from variantcalling_tpu.serve.backend import segment_stats as jsegment_stats
    from variantcalling_tpu_torch.serve.backend import segment_stats

    path = tmp_path / "reference.vcf"
    path.write_bytes(fabric_world["reference_bytes"])
    assert segment_stats(str(path)) == jsegment_stats(str(path)) == {"n": 1500, "n_pass": 677}


def test_a_backends_segment_equals_the_references(fabric_world):
    """The second span of a 2-span plan, as the router sends it (header +
    slice), to a port backend and to a reference backend: the same bytes
    outside ``##vctpu_*`` and the same stats header."""
    from variantcalling_tpu_torch.parallel import rank_plan

    w = fabric_world
    cuts = rank_plan.contig_spans(w["input"], 2)
    assert len(cuts) == 2
    with open(w["input"], "rb") as fh:
        header = fh.read(cuts[0][0])
        fh.seek(cuts[1][0])
        body = header + fh.read(cuts[1][1] - cuts[1][0])
    answers = {}
    for kind in ("port", "ref"):
        b = _backend(kind)
        try:
            params = {"req": "t-s1g0", "model": w["model"], "model_name": "m", "reference": w["ref"]}
            with transport.request(b.address, "POST", "/v1/segment",
                                   headers={transport.PARAMS_HEADER: json.dumps(params)},
                                   body_iter=iter([body[:5000], body[5000:]]), timeout=120) as resp:
                assert resp.status == 200
                answers[kind] = (json.loads(resp.headers[transport.STATS_HEADER.lower()]),
                                 strip_vctpu_header(resp.read()))
            with urllib.request.urlopen(b.address + "/v1/status", timeout=10) as r:
                status = json.loads(r.read())
            assert status["role"] == "backend" and "segment" in status["endpoints"]
        finally:
            b.drain("test")
        assert not os.path.exists(b._spool)
    assert answers["port"] == answers["ref"]
    stats, data = answers["port"]
    assert stats["n"] == len([ln for ln in data.split(b"\n") if ln and not ln.startswith(b"#")]) > 0


# -- the fleet -------------------------------------------------------------------------------------------------------


def _get(address, path):
    with urllib.request.urlopen(address + path, timeout=10) as resp:
        return resp.read()


def test_fabric_parity_auth_and_observability(fabric_world, tmp_path, monkeypatch):
    w = fabric_world
    with _Fleet() as fleet:
        router = fleet.router
        for ranks in (2, 1):
            out = str(tmp_path / f"ranks{ranks}.vcf")
            code, stats = transport.client_filter(router.address, _params(w, f"ranks{ranks}.vcf", ranks=ranks),
                                                  w["input"], out)
            assert code == 200, stats
            assert stats["spans"] == ranks and stats["respans"] == 0 and (stats["n"], stats["n_pass"]) == (1500, 677)
            assert _same(out, w)
            assert _spool_left(router) == []
        code, payload = transport.client_filter(router.address, {"output_name": "x.vcf"}, w["input"],
                                                str(tmp_path / "x.vcf"))
        assert code == 400 and payload["status"] == "bad_request" and not (tmp_path / "x.vcf").exists()

        status = json.loads(_get(router.address, "/v1/status"))
        assert status["role"] == "router" and status["fleet"]["alive"] == 2
        assert status["fleet"]["registered"] == 2 and set(status["backends"]) == {"1", "2"}
        reg = json.loads(_get(router.address, "/v1/fabric/backends"))
        assert [b["alive"] for b in reg["backends"]] == [True, True]
        assert all("endpoints" in b["status"] and b["status"]["role"] == "backend" for b in reg["backends"])
        assert 'endpoint="filter"' in _get(router.address, "/v1/metrics").decode()
        assert json.loads(_get(router.address, "/healthz")) == {"status": "ok", "role": "router"}

        monkeypatch.setenv("VCTPU_FABRIC_TOKENS", "sekrit:alice")
        auth = _router("port", [b.address for b in fleet.backends])
        try:
            for token in (None, "wrong"):
                code, payload = transport.client_filter(auth.address, _params(w, "a.vcf", ranks=2), w["input"],
                                                        str(tmp_path / "a.vcf"), token=token)
                assert code == 401 and payload["status"] == "unauthorized"
            out = str(tmp_path / "authed.vcf")
            code, stats = transport.client_filter(auth.address, _params(w, "authed.vcf", ranks=2), w["input"], out,
                                                  token="sekrit")
            assert code == 200, stats
            assert _same(out, w)
        finally:
            auth.drain("test")
        assert not os.path.exists(auth._spool_root)


def _door_answers(kind: str, w, tmp_path, monkeypatch) -> list:
    """The front door's error answers of one package's fleet: (code, status)
    for a missing param, a bad ``ranks``, malformed params, 401 twice, a
    principal at its quota (held by the test itself), an unscopable knob."""
    monkeypatch.setenv("VCTPU_FABRIC_TOKENS", "sekrit:alice")
    monkeypatch.setenv("VCTPU_FABRIC_QUOTA", "1")
    answers = []
    with _Fleet(kind, kind) as fleet:
        address = fleet.router.address

        def released():
            # the handler releases a request's quota just after its response
            deadline = time.monotonic() + 5.0
            while fleet.router.quota.in_flight() and time.monotonic() < deadline:
                time.sleep(0.02)

        out = str(tmp_path / kind / "o.vcf")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        for params, token in [({"model_name": "m", "reference": w["ref"]}, "sekrit"),
                              (_params(w, "o.vcf", ranks=-1), "sekrit"),
                              (_params(w, "o.vcf"), None), (_params(w, "o.vcf"), "nope")]:
            released()
            code, payload = transport.client_filter(address, params, w["input"], out, token=token)
            answers.append((code, payload.get("status")))
        released()
        with transport.request(address, "POST", "/v1/filter",
                               headers={transport.PARAMS_HEADER: "[1, 2]", "Authorization": "Bearer sekrit"},
                               body=b"x", timeout=30) as resp:
            answers.append((resp.status, resp.json().get("status")))
        released()
        release = fleet.router.quota.acquire("alice")
        try:
            code, payload = transport.client_filter(address, _params(w, "o.vcf"), w["input"], out, token="sekrit")
            answers.append((code, payload.get("status"), payload.get("principal")))
        finally:
            release()
        released()
        code, payload = transport.client_filter(address, _params(w, "o.vcf", ranks=2,
                                                                  knobs={"VCTPU_FABRIC_QUOTA": "3"}),
                                                w["input"], out, token="sekrit")
        answers.append((code, payload.get("status")))
        assert not os.path.exists(out)
        assert _spool_left(fleet.router) == []
    return answers


def test_the_front_doors_errors_are_the_references(fabric_world, tmp_path, monkeypatch):
    port = _door_answers("port", fabric_world, tmp_path, monkeypatch)
    ref = _door_answers("ref", fabric_world, tmp_path, monkeypatch)
    assert port == ref
    assert port == [(400, "bad_request"), (400, "bad_request"), (401, "unauthorized"), (401, "unauthorized"),
                    (400, "bad_request"), (429, "quota", "alice"), (400, "config_error")]


def test_fabric_respan_on_death_then_distinct_backend_lost(fabric_world, tmp_path, monkeypatch):
    w = fabric_world
    # a long heartbeat freezes the registry between beats, so the death is
    # found by the span's attempt (the re-span path), not by the poller
    monkeypatch.setenv("VCTPU_FABRIC_HEARTBEAT_S", "60")
    with _Fleet() as fleet:
        router, (b1, b2) = fleet.router, fleet.backends
        code, _ = transport.client_filter(router.address, _params(w, "warm.vcf", ranks=2), w["input"],
                                          str(tmp_path / "warm.vcf"))
        assert code == 200
        # the lowest id is the placement's preference: a span tries the dead one
        b1.drain("test")
        out = str(tmp_path / "respan.vcf")
        code, stats = transport.client_filter(router.address, _params(w, "respan.vcf", ranks=2), w["input"], out)
        assert code == 200, stats
        assert stats["respans"] >= 1 and _same(out, w)
        status = json.loads(_get(router.address, "/v1/status"))
        assert status["fleet"]["alive"] == 1 and status["backends"]["1"]["alive"] is False
        b2.drain("test")
        code, payload = transport.client_filter(router.address, _params(w, "lost.vcf", ranks=2), w["input"],
                                                str(tmp_path / "lost.vcf"))
        assert code in (502, 503), payload
        assert payload["status"] in ("backend_lost", "shed")
        assert not (tmp_path / "lost.vcf").exists() and _spool_left(router) == []


@pytest.mark.parametrize("router_kind,backend_kind", [("ref", "port"), ("port", "ref")])
def test_the_wire_both_ways(fabric_world, tmp_path, router_kind, backend_kind):
    """Each package's router over the other's backends: the batch CLI's bytes
    at two spans and at one."""
    w = fabric_world
    with _Fleet(router_kind, backend_kind) as fleet:
        for ranks in (2, 1):
            out = str(tmp_path / f"wire{ranks}.vcf")
            code, stats = transport.client_filter(fleet.router.address, _params(w, f"wire{ranks}.vcf", ranks=ranks),
                                                  w["input"], out)
            assert code == 200, stats
            assert stats["spans"] == ranks and _same(out, w)


@pytest.mark.parametrize("kind", ["port", "ref"])
def test_serve_fabric_with_fabric_backend_exits_2(kind, tmp_path):
    if kind == "port":
        from variantcalling_tpu_torch.serve import cli
    else:
        from variantcalling_tpu.serve import cli
    ready = tmp_path / "ready.json"
    assert cli.run(["--fabric", "--fabric-backend", "--port", "0", "--ready-file", str(ready)]) == 2
    assert not ready.exists()
