"""The port's serving daemon on the CPU, held against the JAX package's daemon and CLI.

World: a three-contig synthetic callset of 3,000 records and a 12-tree
forest saved by the JAX package; 16 KiB streaming chunks
(``VCTPU_STREAM_CHUNK_BYTES``), so every request streams many chunks.

- The port's in-process daemon (``device="cpu"``) and the JAX package's
  ``Server`` (run as the reference's own tests run it) filter the world to
  the same bytes outside ``##vctpu_*`` lines, which are the JAX package's
  CLI output's, as ``.vcf`` and ``.vcf.gz``; concurrent requests too, with
  the model loaded once and its predictor built once; a request scoped to
  ``VCTPU_FOREST_STRATEGY=gemm`` builds its own and writes the same bytes.
- ``/v1/score`` (``n``, ``n_pass``, the score's mean, min and max: exact for
  a forest) and ``/v1/coverage`` answer as the reference's.
- Each error case of the reference's tests (bad body, unknown path,
  unscopable, unknown and malformed scoped knobs, shed, queue deadline,
  poisoned request, request deadline, drain, and the field checks) gets the
  reference's HTTP status and ``status`` field; the poisoned and the
  deadline cases are made deterministic by scoped faults (a poisoned chunk;
  a hang point longer than the deadline), and the port's daemon leaves no
  partial or journal behind.
- The admission controller's decisions and the metrics registry's
  Prometheus text equal the reference's on the same inputs.
- The port's obs stream validates against the reference's
  ``obs/event_schema.json``.
- ``python -m variantcalling_tpu_torch serve --backend cpu`` drains on
  SIGTERM and SIGINT: the request in flight completes with the reference's
  bytes, a new one gets 503 ``draining``, the process exits 0 and reports no
  leaked thread, its obs stream ends with status ``drain``.

Skipped where g++ is absent (streaming needs the native engine).
"""

import contextlib
import dataclasses
import gzip
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from tests import fixtures
from tests.conftest import assert_no_stream_leaks
from variantcalling_tpu.models import registry as jregistry
from variantcalling_tpu.models.forest import FlatForest as JFlatForest
from variantcalling_tpu.obs.schema import validate_lines
from variantcalling_tpu.pipelines import filter_variants as fvp
from variantcalling_tpu.utils import faults as jfaults
from variantcalling_tpu_torch import synthetic
from variantcalling_tpu_torch.models import registry as tregistry
from variantcalling_tpu_torch.pipelines import filter_variants as tfv
from variantcalling_tpu_torch.utils import faults

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is absent: the engine cannot be built")

ROOT = Path(__file__).resolve().parents[1]
RF = "rf_model_ignore_gt_incl_hpol_runs"
CONTIGS = [("chr1", 200_000), ("chr2", 150_000), ("chr3", 100_000)]
ENV = {"VCTPU_STREAM_CHUNK_BYTES": str(16 << 10), "VCTPU_SERVE_MAX_INFLIGHT": "2", "VCTPU_SERVE_QUEUE_DEPTH": "2",
       "VCTPU_IO_BACKOFF_S": "0"}
#: a hang long enough to outlast any case; released by ``cancel_hangs``
HANG = "pipeline.stage_hang:1@60"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_world")
    w = synthetic.write_world(str(d), seed=43, n_variants=3000, n_trees=12, depth=5, contigs=CONTIGS)
    forest = tregistry.load_model(w["model"], w["model_name"])
    model = d / "jmodel.pkl"
    jregistry.save_models(str(model), {RF: JFlatForest(**{f.name: getattr(forest, f.name)
                                                         for f in dataclasses.fields(JFlatForest)})})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VCTPU_STREAM_CHUNK_BYTES", ENV["VCTPU_STREAM_CHUNK_BYTES"])
        cli = d / "reference_cli.vcf"
        assert fvp.run(["--input_file", w["vcf"], "--model_file", str(model), "--model_name", RF,
                        "--reference_file", w["fasta"], "--output_file", str(cli), "--backend", "cpu"]) == 0
    return {"dir": d, "vcf": w["vcf"], "fasta": w["fasta"], "model": str(model), "cli": cli.read_bytes()}


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path, request):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("VCTPU_CACHE_DIR", str(tmp_path / "chunk_cache"))
    for k in ("VCTPU_THREADS", "VCTPU_STREAM", "VCTPU_IO_THREADS", "VCTPU_CACHE", "VCTPU_QUARANTINE", "VCTPU_RESUME",
              "VCTPU_FAULTS", "VCTPU_OBS", "VCTPU_OBS_PATH", "VCTPU_CHUNK_RETRIES", "VCTPU_FOREST_STRATEGY"):
        monkeypatch.delenv(k, raising=False)
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    faults.reset()
    jfaults.reset()
    yield
    faults.cancel_hangs()
    jfaults.cancel_hangs()
    faults.reset()
    jfaults.reset()
    assert_no_stream_leaks([tmp_path / "port"] + ([request.getfixturevalue("world")["dir"]]
                                                 if "world" in request.fixturenames else []))


def _start(kind: str, obs_log: str | None = None):
    if kind == "port":
        from variantcalling_tpu_torch.serve import Server

        server = Server(port=0, device="cpu", obs_log=obs_log)
    else:
        from variantcalling_tpu.serve.daemon import Server

        server = Server(port=0, obs_log=obs_log)
    server.start()
    return server


@contextlib.contextmanager
def _daemon(kind: str, obs_log: str | None = None):
    server = _start(kind, obs_log)
    try:
        yield server
    finally:
        (faults if kind == "port" else jfaults).cancel_hangs()
        if not server.draining.is_set():
            server.drain("test")


def _post(address: str, path: str, body, timeout: float = 120) -> tuple[int, dict]:
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(address + path, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(address: str, path: str) -> tuple[int, bytes]:
    with urllib.request.urlopen(address + path, timeout=30) as r:
        return r.status, r.read()


def _filter_body(w: dict, out, **kw) -> dict:
    return {"input": w["vcf"], "model": w["model"], "model_name": RF, "reference": w["fasta"], "output": str(out),
            **kw}


def _read(path) -> bytes:
    data = Path(path).read_bytes()
    return gzip.decompress(data) if str(path).endswith(".gz") else data


def _same_records(a: bytes, b: bytes) -> bool:
    return fixtures.strip_vctpu_header(a) == fixtures.strip_vctpu_header(b)


def _sweep(d: Path) -> None:
    """Remove what a failed request of the reference's daemon keeps for a resume."""
    for p in d.iterdir():
        if ".partial" in p.name or p.name.endswith((".journal", ".quarantine")):
            p.unlink()


# -- filter, score, coverage -------------------------------------------------------


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
def test_filter_equals_the_references_daemon_and_cli(world, tmp_path, suffix):
    outs = {}
    for kind in ("port", "ref"):
        out = tmp_path / kind / f"served{suffix}"
        with _daemon(kind) as d:
            code, payload = _post(d.address, "/v1/filter", _filter_body(world, out))
        assert (code, payload["status"]) == (200, "ok"), payload
        outs[kind] = _read(out)
    assert payload["engine"] and _same_records(outs["port"], outs["ref"])
    assert _same_records(outs["port"], world["cli"])
    if suffix == ".vcf.gz":
        assert (tmp_path / "port" / "served.vcf.gz.tbi").exists()


def test_concurrent_filters_load_once_and_build_the_predictor_once(world, tmp_path):
    with _daemon("port") as d:
        code, payload = _post(d.address, "/v1/warm", {"model": world["model"], "model_name": RF,
                                                       "reference": world["fasta"]})
        assert (code, payload["warmed"]) == (200, ["model", "reference"])
        before = tfv.predictor_cache_stats()["misses"]
        results = {}

        def call(i):
            results[i] = _post(d.address, "/v1/filter", _filter_body(world, tmp_path / "port" / f"c{i}.vcf"))

        for pair in ((0, 1), (2, 3)):  # two at a time
            threads = [threading.Thread(target=call, args=(i,)) for i in pair]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        assert all(results[i][0] == 200 for i in range(4)), results
        for i in range(4):
            assert _same_records((tmp_path / "port" / f"c{i}.vcf").read_bytes(), world["cli"])
        resident = d.status_payload()["resident"]
        assert resident["models"] == {"entries": 1, "hits": 4, "misses": 1}
        assert resident["genomes"]["misses"] == 1
        assert tfv.predictor_cache_stats()["misses"] - before == 1
        # a request scoped to the per-tree strategy builds its own predictor, once
        for i in (4, 5):
            out = tmp_path / "port" / f"g{i}.vcf"
            code, _ = _post(d.address, "/v1/filter", _filter_body(world, out, knobs={"VCTPU_FOREST_STRATEGY": "gemm"}))
            assert code == 200 and b"##vctpu_forest_strategy=gemm" in out.read_bytes()
            assert _same_records(out.read_bytes(), world["cli"])
        assert tfv.predictor_cache_stats()["misses"] - before == 2


def test_score_payloads_equal(world):
    body = {"input": world["vcf"], "model": world["model"], "model_name": RF, "reference": world["fasta"]}
    got = {}
    for kind in ("port", "ref"):
        with _daemon(kind) as d:
            code, payload = _post(d.address, "/v1/score", body)
        assert code == 200, payload
        got[kind] = {k: payload[k] for k in ("status", "n", "n_pass", "score_mean", "score_min", "score_max")}
    assert got["port"] == got["ref"] and got["port"]["n"] == 3000 and 0 < got["port"]["n_pass"] < 3000


@pytest.mark.parametrize("case", ["ramp", "random", "short_tail", "deep"])
def test_coverage_payloads_equal(case):
    rng = np.random.default_rng(7)
    depth, window = {"ramp": (list(range(400)), 40),
                     "random": (rng.integers(0, 80, size=10_001).tolist(), 100),
                     "short_tail": ([5, 0, 3, 9, 9, 2, 7], 3),
                     "deep": (rng.integers(900, 1500, size=5_000).tolist(), 64)}[case]
    got = {}
    for kind in ("port", "ref"):
        with _daemon(kind) as d:
            code, payload = _post(d.address, "/v1/coverage", {"depth": depth, "window": window})
        assert code == 200
        got[kind] = {k: v for k, v in payload.items() if k not in ("req", "dur_s")}
    assert got["port"] == got["ref"]


# -- error cases ------------------------------------------------------------------------


def _wait(cond, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.02)


@contextlib.contextmanager
def _occupied(d, w: dict, out_dir: Path, queued: int = 0):
    """Both execution slots held by requests hung at their first chunk, and
    ``queued`` clean requests waiting; on exit the hangs are released and every
    request completes."""
    fmod = faults if type(d).__module__.startswith("variantcalling_tpu_torch") else jfaults
    results = []
    threads = []

    def call(body):
        results.append(_post(d.address, "/v1/filter", body))

    for i in range(2):
        threads.append(threading.Thread(target=call, args=(_filter_body(w, out_dir / f"hung{i}.vcf", faults=HANG),)))
        threads[-1].start()
    _wait(lambda: d.admission.inflight == 2)
    for i in range(queued):
        threads.append(threading.Thread(target=call, args=(_filter_body(w, out_dir / f"queued{i}.vcf"),)))
        threads[-1].start()
    _wait(lambda: d.admission.queued == queued)
    try:
        yield
    finally:
        _wait(lambda: fmod.cancel_hangs() or not any(t.is_alive() for t in threads))
        for t in threads:
            t.join(timeout=60)
        assert [code for code, _ in results] == [200] * (2 + queued), results


def _poisoned(d, w, out_dir):
    """A poisoned request beside a clean one: the poisoned one fails, the clean
    one writes the reference's bytes."""
    res = {}

    def call(name, body):
        res[name] = _post(d.address, "/v1/filter", body)

    threads = [threading.Thread(target=call, args=("bad", _filter_body(
        w, out_dir / "poison.vcf", faults="pipeline.chunk:0", knobs={"VCTPU_CHUNK_RETRIES": "0"}))),
        threading.Thread(target=call, args=("good", _filter_body(w, out_dir / "good.vcf")))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert res["good"][0] == 200 and _same_records((out_dir / "good.vcf").read_bytes(), w["cli"])
    assert res["bad"][1]["kind"] == "RuntimeError" and not (out_dir / "poison.vcf").exists()
    return res["bad"]


def _shed(d, w, out_dir):
    with _occupied(d, w, out_dir, queued=2):
        code, payload = _post(d.address, "/v1/filter", _filter_body(w, out_dir / "shed.vcf"))
    assert payload["reason"] == "queue_full" and not (out_dir / "shed.vcf").exists()
    return code, payload


def _queue_deadline(d, w, out_dir):
    with _occupied(d, w, out_dir):
        return _post(d.address, "/v1/filter", _filter_body(w, out_dir / "late_in_queue.vcf", deadline_s=0.3))


def _request_deadline(d, w, out_dir):
    # the first chunk hangs 3 s, well past the deadline: the run cannot end
    # before its token is tripped, and every chunk's commit checks the token
    code, payload = _post(d.address, "/v1/filter", _filter_body(w, out_dir / "late.vcf", deadline_s=0.5,
                                                                  faults="pipeline.stage_hang:1@3"))
    assert not (out_dir / "late.vcf").exists()
    return code, payload


def _draining(d, w, out_dir):
    """A request that arrives while the daemon drains, its two slots busy."""
    with _occupied(d, w, out_dir):
        drainer = threading.Thread(target=d.drain, args=("test",))
        drainer.start()
        _wait(d.draining.is_set)
        got = _post(d.address, "/v1/filter", _filter_body(w, out_dir / "after_drain.vcf"))
    drainer.join(timeout=60)
    assert not drainer.is_alive() and d.stopped.is_set()
    return got


CASES = {
    "bad_body": (lambda d, w, o: _post(d.address, "/v1/filter", b"not json{"), (400, "bad_request")),
    "body_not_an_object": (lambda d, w, o: _post(d.address, "/v1/filter", b"[1, 2]"), (400, "bad_request")),
    "unknown_path": (lambda d, w, o: _post(d.address, "/v1/nope", {}), (404, "not_found")),
    "missing_field": (lambda d, w, o: _post(d.address, "/v1/filter", {**_filter_body(w, o / "x.vcf"), "model": ""}),
                      (400, "bad_request")),
    "missing_output": (lambda d, w, o: _post(d.address, "/v1/filter", _filter_body(w, "")), (400, "bad_request")),
    "missing_path": (lambda d, w, o: _post(d.address, "/v1/score", {**_filter_body(w, None), "input": str(o / "no")}),
                     (400, "bad_request")),
    "bad_deadline": (lambda d, w, o: _post(d.address, "/v1/filter", _filter_body(w, o / "x.vcf", deadline_s="soon")),
                     (400, "bad_request")),
    "unscopable_knob": (lambda d, w, o: _post(d.address, "/v1/filter", _filter_body(
        w, o / "x.vcf", knobs={"VCTPU_SERVE_PORT": "1"})), (400, "config_error")),
    "unknown_knob": (lambda d, w, o: _post(d.address, "/v1/filter", _filter_body(
        w, o / "x.vcf", knobs={"VCTPU_TYPO_KNOB": "1"})), (400, "config_error")),
    "malformed_scoped_knob": (lambda d, w, o: _post(d.address, "/v1/filter", _filter_body(
        w, o / "x.vcf", knobs={"VCTPU_CHUNK_RETRIES": "nan!"})), (400, "config_error")),
    "warm_nothing": (lambda d, w, o: _post(d.address, "/v1/warm", {}), (400, "bad_request")),
    "empty_depth": (lambda d, w, o: _post(d.address, "/v1/coverage", {"depth": []}), (400, "bad_request")),
    "poisoned_request": (_poisoned, (500, "error")),
    "request_deadline": (_request_deadline, (504, "deadline")),
    "shed": (_shed, (503, "shed")),
    "queue_deadline": (_queue_deadline, (504, "deadline")),
    "drain": (_draining, (503, "draining")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_error_case_answers_as_the_reference(world, tmp_path, case):
    run, want = CASES[case]
    got = {}
    for kind in ("port", "ref"):
        out_dir = tmp_path / kind
        with _daemon(kind) as d:
            code, payload = run(d, world, out_dir)
            got[kind] = (code, payload.get("status"))
            if case != "drain":
                assert _get(d.address, "/healthz")[0] == 200  # the daemon serves on
        if kind == "ref":
            _sweep(out_dir)
    assert got["port"] == got["ref"] == want, got
    # the port's failed requests left no partial, journal or output behind
    assert not [p.name for p in (tmp_path / "port").iterdir() if ".partial" in p.name or ".journal" in p.name]


# -- admission and metrics against the reference's ------------------------------------


@pytest.mark.parametrize("case", ["queue_full", "queue_deadline", "slo", "draining", "free_slot"])
def test_admission_decides_as_the_reference(monkeypatch, case):
    from variantcalling_tpu.serve import admission as jadm
    from variantcalling_tpu_torch.serve import admission as tadm

    monkeypatch.setenv("VCTPU_SERVE_MAX_INFLIGHT", "1")
    monkeypatch.setenv("VCTPU_SERVE_QUEUE_DEPTH", "0" if case == "queue_full" else "4")

    def decide(mod):
        ac = mod.AdmissionController(latency_p50=(lambda ep: 10.0) if case == "slo" else None)
        ac.draining = case == "draining"
        try:
            hold = ac.admit("filter", 60.0)
        except mod.ShedError as e:
            return ("shed", e.reason)
        try:
            if case == "free_slot":
                hold()
            ac.admit("filter", 0.2 if case == "queue_deadline" else 5.0)()
            return ("admitted", ac.inflight, ac.queued)
        except mod.ShedError as e:
            return ("shed", e.reason, e.retry_after_s >= 10.0)
        except mod.QueueDeadlineError:
            return ("deadline", ac.inflight, ac.queued)
        finally:
            hold()
            assert ac.idle()

    assert decide(tadm) == decide(jadm)


def test_metrics_and_prometheus_text_equal_the_reference(monkeypatch):
    import time as time_mod

    from variantcalling_tpu.obs import metrics as jmetrics
    from variantcalling_tpu.obs import prom as jprom
    from variantcalling_tpu_torch.obs import metrics as tmetrics
    from variantcalling_tpu_torch.obs import prom as tprom

    monkeypatch.setattr(time_mod, "monotonic", lambda: 12_345.0)  # both histograms' rolling slots
    rng = np.random.default_rng(3)
    regs = {"port": tmetrics.MetricsRegistry(window_s=60.0), "ref": jmetrics.MetricsRegistry(window_s=60.0)}
    for reg in regs.values():
        for i, v in enumerate(rng.lognormal(-2, 1.5, size=500)):
            reg.histogram(f"serve.request_s.by_endpoint.{('filter', 'score')[i % 2]}").observe(float(v))
            reg.counter(f"serve.requests_ok.by_endpoint.{('filter', 'score')[i % 2]}").add(1)
            reg.gauge("serve.in_flight").set(i % 3)
        rng = np.random.default_rng(3)
    snaps = {k: r.snapshot() for k, r in regs.items()}
    assert snaps["port"] == snaps["ref"]
    assert tprom.snapshot_to_prom(snaps["port"], tool="serve") == jprom.snapshot_to_prom(snaps["ref"], tool="serve")
    assert tmetrics.bucket_index(0.25) == jmetrics.bucket_index(0.25)


def test_status_and_metrics_endpoints_count_as_the_reference(world, tmp_path):
    texts, statuses = {}, {}
    for kind in ("port", "ref"):
        with _daemon(kind) as d:
            assert _post(d.address, "/v1/filter", _filter_body(world, tmp_path / kind / "m.vcf"))[0] == 200
            assert _post(d.address, "/v1/coverage", {"depth": [1, 2, 3], "window": 2})[0] == 200
            assert _post(d.address, "/v1/filter", _filter_body(world, tmp_path / kind / "n.vcf",
                                                               knobs={"VCTPU_SERVE_PORT": "1"}))[0] == 400
            code, body = _get(d.address, "/v1/status")
            statuses[kind] = json.loads(body)
            code, body = _get(d.address, "/v1/metrics")
            texts[kind] = body.decode()
    port, ref = statuses["port"], statuses["ref"]
    assert set(ref) <= set(port) and port["in_flight"] == ref["in_flight"] == 0
    assert set(port["endpoints"]) == set(ref["endpoints"]) == {"filter", "coverage"}
    assert port["resident"]["models"] == ref["resident"]["models"] == {"entries": 1, "hits": 0, "misses": 1}

    def counters(text):
        return sorted(ln for ln in text.splitlines() if ln.startswith(("vctpu_serve_requests_", "# TYPE")))

    assert counters(texts["port"]) == counters(texts["ref"])
    assert 'vctpu_serve_requests_ok_total{endpoint="filter"} 1' in texts["port"]
    assert 'vctpu_serve_requests_failed_total{endpoint="filter"} 1' in texts["port"]


def test_obs_stream_validates_against_the_references_schema(world, tmp_path):
    log_path = tmp_path / "serve.obs.jsonl"
    with _daemon("port", obs_log=str(log_path)) as d:
        assert _post(d.address, "/v1/filter", _filter_body(world, tmp_path / "port" / "o.vcf"))[0] == 200
        poisoned = _filter_body(world, tmp_path / "port" / "p.vcf", faults="pipeline.chunk:0",
                                knobs={"VCTPU_CHUNK_RETRIES": "0"})
        assert _post(d.address, "/v1/filter", poisoned)[0] == 500
    lines = log_path.read_text().splitlines()
    assert validate_lines(lines) == []
    events = [json.loads(ln) for ln in lines]
    kinds = [(e["kind"], e["name"]) for e in events]
    assert kinds[0] == ("manifest", "serve") and events[0]["topology"]["device"] == "cpu"
    assert ("serve", "listening") in kinds and ("fault", "pipeline.chunk") in kinds
    ends = [e for e in events if e["name"] == "request_end"]
    assert [(e["status"], e["code"]) for e in ends] == [("ok", 200), ("error", 500)]
    assert events[-1]["kind"] == "run_end" and events[-1]["status"] == "drain"
    assert events[-2]["counters"]["serve.requests_ok"] == 1


# -- the subprocess daemon -----------------------------------------------------------


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT], ids=["sigterm", "sigint"])
def test_subprocess_daemon_drains_on_signal(world, tmp_path, sig):
    ready, status_file, obs_log = tmp_path / "ready.json", tmp_path / "status.json", tmp_path / "obs.jsonl"
    env = {k: v for k, v in os.environ.items() if not k.startswith("VCTPU_") and k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="", VCTPU_STREAM_CHUNK_BYTES=ENV["VCTPU_STREAM_CHUNK_BYTES"],
               VCTPU_SERVE_DRAIN_S="60")
    proc = subprocess.Popen([sys.executable, "-m", "variantcalling_tpu_torch", "serve", "--backend", "cpu", "--port",
                             "0", "--ready-file", str(ready), "--status-file", str(status_file), "--obs-log",
                             str(obs_log)], env=env, cwd=tmp_path, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        _wait(lambda: proc.poll() is not None or ready.exists(), timeout=120)
        assert proc.poll() is None, "the daemon died before listening"
        address = json.loads(ready.read_text())["address"]
        out = tmp_path / "port" / "inflight.vcf"
        result = {}

        def slow_request():  # every chunk delayed, so that the signal lands mid-request
            result["r"] = _post(address, "/v1/filter", _filter_body(world, out, faults="pipeline.stage_hang:0@0.25"))

        t = threading.Thread(target=slow_request)
        t.start()
        _wait(lambda: json.loads(_get(address, "/v1/status")[1])["in_flight"] > 0)
        proc.send_signal(sig)
        _wait(lambda: json.loads(_get(address, "/healthz")[1])["status"] == "draining")
        code, payload = _post(address, "/v1/filter", _filter_body(world, tmp_path / "port" / "new.vcf"), timeout=30)
        assert (code, payload["status"]) == (503, "draining")
        t.join(timeout=120)
        assert result["r"][0] == 200 and _same_records(out.read_bytes(), world["cli"])
        assert proc.wait(timeout=90) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    status = json.loads(status_file.read_text())
    assert status["status"] == "drained" and status["reason"] == sig.name.lower() and status["leaked"] == []
    assert status["counters"]["serve.requests_ok"] == 1 and status["counters"]["serve.requests_shed"] == 1
    lines = obs_log.read_text().splitlines()
    assert validate_lines(lines) == [] and json.loads(lines[-1])["status"] == "drain"
    assert not (tmp_path / "port" / "new.vcf").exists()
