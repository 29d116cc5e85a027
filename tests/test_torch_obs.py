"""The port's run telemetry (``variantcalling_tpu_torch/obs``) against the JAX package's, on the CPU.

The same logs go through both packages' readers — the ``obs`` tool's every
subcommand (``summary``, ``bottleneck``, ``critical-path``, ``flame`` and
``flame --diff``, ``cpuledger``, ``tail``, ``prom``, ``export``, ``diff``),
the schema validators, the critical path, the sampler's folds and the
Prometheus text — and the output must be equal (text, JSON, written files):

- a log recorded by the JAX package's filter run (``VCTPU_OBS=1``, the CPU
  sampler on) and one by the port's on the same world (a 3,000-record
  callset in 16 KiB chunks; the port's pinned to ``wide``, so its log holds
  the forest kernel's ``cost_analysis`` event);
- the synthetic logs of the JAX package's unit tests, rebuilt here: the
  known-geometry trace DAG, a megabatch fan-in, an empty run, a hand-folded
  sampled log, a two-rank pod, an in-flight log with a torn tail, and a
  slower twin of the geometry for ``diff``.

One line differs by design: ``bottleneck``'s scoring-cost line reads the
port's ``roofline_vps_h100`` (the forest kernel's counted work on the
H100) where the reference reads XLA's ``roofline_vps_v5e``; it is compared
apart (``ROADMAP.md``, differences). Then the port alone: the validator on
broken streams, rotation into ``.segN`` and the merged read, snapshot
cadence, the in-flight tolerance, the atexit, SIGTERM and SIGINT flushes,
tracing turned off by its knob, the device trace's fallback, and the
scoring cost's count against ``forest_cuda.scoring_work``.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from variantcalling_tpu.obs import cli as jcli
from variantcalling_tpu.obs import schema as jschema
from variantcalling_tpu_torch import obs
from variantcalling_tpu_torch.obs import cli as tcli
from variantcalling_tpu_torch.obs import critical as tcritical
from variantcalling_tpu_torch.obs import export as texport
from variantcalling_tpu_torch.obs import schema as tschema

ROOT = Path(__file__).resolve().parents[1]
RF = "rf_model_ignore_gt_incl_hpol_runs"


def _env(seq, t, kind, name, **fields):
    return dict(fields, v=1, seq=seq, ts=1000.0 + t, t=t, kind=kind, name=name, pid=1, tid=1)


def _manifest():
    return _env(0, 0.0, "manifest", "synthetic", tool="synthetic", version="0", knobs={}, topology={})


def _geometry(n_chunks: int = 10, score: float = 0.5) -> list[dict]:
    """Known geometry: a chunk's ingest 0.01 s, a wait of 0.04, score
    ``score``, render 0.05, a wait of 0.02, writeback 0.01; the profile rows
    match the trace sums."""
    events = [_manifest()]

    def emit(t, kind, name, **fields):
        events.append(_env(len(events), round(t, 6), kind, name, **fields))

    sid = 0
    for i in range(n_chunks):
        base, tid = float(i), f"t{i}"

        def span(end, name, dur, parents):
            nonlocal sid
            s = f"s{sid}"
            sid += 1
            emit(base + end, "trace", name, trace_id=tid, span_id=s, dur=dur,
                 **({"parents": parents} if parents else {}))
            return s

        a = span(0.01, "ingest", 0.01, None)
        b = span(0.05 + score, "score_stage", score, [a])
        c = span(0.10 + score, "render_stage", 0.05, [b])
        span(0.13 + score, "writeback", 0.01, [c])
        emit(base + 0.13 + score, "heartbeat", "stream", chunks=i + 1, records=100 * (i + 1), vps=100)
    wall = float(n_chunks)
    for stage, work, wait_in in (("ingest", 0.01, 0.0), ("score_stage", score, 0.04), ("render_stage", 0.05, 0.0),
                                 ("writeback", 0.01, 0.02)):
        emit(wall, "profile", "stage", stage=stage, work_s=work * n_chunks, wait_in_s=wait_in * n_chunks,
             wait_out_s=0.0, items=n_chunks, records=100 * n_chunks)
    emit(wall, "profile", "pipeline", wall_s=wall, records=100 * n_chunks,
         stages=["ingest", "score_stage", "render_stage", "writeback"], bytes_in=0, bytes_out=0)
    emit(wall, "metrics", "final", counters={"records": 100 * n_chunks}, gauges={},
         histograms={"stage.score_stage.s": {"count": n_chunks, "sum": score * n_chunks, "min": score,
                                             "max": score, "p50": score, "p95": score, "p99": score}})
    emit(wall + 0.01, "run_end", "synthetic", status="ok", dur=wall)
    return events


def _fanin() -> list[dict]:
    """One dispatch span serving two chunks, the second one late."""
    events = [_manifest()]

    def tr(t, name, tid, sid, dur, parents=None, traces=None):
        f = {"trace_id": tid, "span_id": sid, "dur": dur}
        if parents:
            f["parents"] = parents
        if traces:
            f["traces"] = traces
        events.append(_env(len(events), t, "trace", name, **f))

    tr(0.01, "ingest", "t0", "s0", 0.01)
    tr(0.30, "ingest", "t1", "s1", 0.01)
    tr(0.90, "score_stage", "t0", "s2", 0.5, parents=["s0", "s1"], traces=["t0", "t1"])
    tr(0.95, "writeback", "t0", "s3", 0.01, parents=["s2"])
    tr(1.00, "writeback", "t1", "s4", 0.01, parents=["s2"])
    events.append(_env(len(events), 1.2, "run_end", "m", status="ok", dur=1.2))
    return events


def _empty() -> list[dict]:
    return [_manifest(), _env(1, 1.0, "run_end", "synthetic", status="ok", dur=1.0)]


def _sampled(records: int = 1_000_000) -> list[dict]:
    """A hand-folded sampled log at 100 Hz: 40 score, 30 parse, 20 render
    and 10 commit CPU samples, and 500 wait samples."""
    rows = [
        ("sample", "io", dict(stack="io.vcf:parse_chunk;native:fused_chunk_score", n=40, cat="native",
                              family="io", win_t0=0.0)),
        ("sample", "io", dict(stack="io.vcf:parse_chunk;native:vcf_parse", n=30, cat="gil", family="io",
                              win_t0=0.0)),
        ("sample", "io", dict(stack="pipelines.filter_variants:render_stage", n=20, cat="gil", family="io",
                              win_t0=0.0)),
        ("sample", "committer", dict(stack="pipelines.filter_variants:_sink_write", n=10, cat="gil",
                                     family="committer", win_t0=0.0)),
        ("sample", "main", dict(stack="threading:wait", n=500, cat="wait", family="main", win_t0=0.0)),
        ("profile", "cpuprof", dict(hz=100.0, interval_s=0.01, samples=600, cpu_samples=100, threads=3,
                                    cpu_s_total=1.0, families={"io": 0.9, "committer": 0.1})),
        ("heartbeat", "stream", dict(chunks=1, records=records)),
        ("metrics", "final", dict(counters={"records": records}, gauges={}, histograms={})),
        ("run_end", "t", dict(status="ok", dur=3.0)),
    ]
    return [_manifest()] + [_env(i + 1, 1.0 + 0.1 * i, k, n, **f) for i, (k, n, f) in enumerate(rows)]


def _rank(score_dur: float) -> list[dict]:
    return [_manifest(),
            _env(1, 0.01, "trace", "ingest", trace_id="t0", span_id="s0", dur=0.01),
            _env(2, 0.01 + score_dur, "trace", "score_stage", trace_id="t0", span_id="s1", dur=score_dur,
                 parents=["s0"]),
            _env(3, 0.02 + score_dur, "trace", "writeback", trace_id="t0", span_id="s2", dur=0.01, parents=["s1"]),
            _env(4, 1.0, "run_end", "m", status="ok", dur=1.0)]


def _write(path: Path, events: list[dict], tail: str = "") -> str:
    with open(path, "w", encoding="utf-8") as fh:
        for e in events:
            fh.write(json.dumps(e) + "\n")
        fh.write(tail)
    return str(path)


def _record_filter_runs(d: Path) -> dict[str, str]:
    """The JAX package's and the port's filter runs on one world, obs on with
    the CPU sampler: their run logs."""
    from variantcalling_tpu.models import registry as jregistry
    from variantcalling_tpu.models.forest import FlatForest as JFlatForest
    from variantcalling_tpu.pipelines import filter_variants as jfv
    from variantcalling_tpu_torch import synthetic
    from variantcalling_tpu_torch.models import registry as tregistry
    from variantcalling_tpu_torch.pipelines import filter_variants as tfv

    w = synthetic.write_world(str(d / "world"), seed=41, n_variants=3000, n_trees=12, depth=5,
                              contigs=[("chr1", 200_000), ("chr2", 150_000), ("chr3", 100_000)])
    forest = tregistry.load_model(w["model"], w["model_name"])
    jmodel = d / "jmodel.pkl"
    jregistry.save_models(str(jmodel), {RF: JFlatForest(**{f.name: getattr(forest, f.name)
                                                          for f in dataclasses.fields(JFlatForest)})})

    def argv(out):
        return ["--input_file", w["vcf"], "--model_file", str(jmodel), "--model_name", RF,
                "--reference_file", w["fasta"], "--output_file", str(out), "--backend", "cpu"]

    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("VCTPU_")]:
            mp.delenv(k)
        mp.setenv("VCTPU_STREAM_CHUNK_BYTES", str(16 << 10))
        mp.setenv("VCTPU_OBS", "1")
        mp.setenv("VCTPU_OBS_CPUPROF", "1")
        mp.setenv("VCTPU_OBS_CPUPROF_HZ", "97")
        assert jfv.run(argv(d / "jax.vcf")) == 0
        mp.setenv("VCTPU_FOREST_STRATEGY", "wide")
        assert tfv.run(argv(d / "port.vcf")) == 0
    return {"jax_run": str(d / "jax.vcf.obs.jsonl"), "port_run": str(d / "port.vcf.obs.jsonl")}


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    import shutil

    d = tmp_path_factory.mktemp("obs_logs")
    out = {
        "geometry": _write(d / "geometry.jsonl", _geometry()),
        "fanin": _write(d / "fanin.jsonl", _fanin()),
        "empty": _write(d / "empty.jsonl", _empty()),
        "sampled": _write(d / "sampled.jsonl", _sampled()),
        "ranks": _write(d / "pod.jsonl", _rank(0.10)),
        # a crashed run: no run_end, its last line torn mid-JSON
        "in_flight": _write(d / "inflight.jsonl", _geometry(3)[:-2], tail='{"v": 1, "seq": 99, "ts": 1.0, "kin'),
    }
    _write(d / "pod.jsonl.rank1", _rank(0.50))
    out["slower"] = _write(d / "slower.jsonl", _geometry(score=0.8))
    if shutil.which("g++") is not None:  # the streaming runs need the native engine
        out.update(_record_filter_runs(d))
    return out


LOGS = ["geometry", "fanin", "empty", "sampled", "ranks", "in_flight", "jax_run", "port_run"]
#: subcommand -> its options; output to stdout
PRINTING = {
    "summary": [], "summary --json": ["--json"], "bottleneck": [], "bottleneck --json": ["--json"],
    "critical-path": [], "critical-path --json": ["--json"], "cpuledger": [], "cpuledger --json": ["--json"],
    "tail": [], "tail --json": ["--json"], "prom": [],
}


def _log(logs, name: str) -> str:
    if name not in logs:
        pytest.skip("g++ is absent: the filter runs need the native engine")
    return logs[name]


def _both(argv: list[str], capsys) -> tuple[tuple, tuple]:
    """(rc, stdout, stderr) of the JAX package's tool, then of the port's."""
    out = []
    for cli in (jcli, tcli):
        rc = cli.run(list(argv))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out[0], out[1]


def _without_cost_line(text: str) -> str:
    return "\n".join(ln for ln in text.splitlines() if not ln.startswith("scoring program ("))


@pytest.mark.parametrize("log", LOGS)
@pytest.mark.parametrize("cmd", list(PRINTING))
def test_subcommand_prints_what_the_reference_prints(logs, log, cmd, capsys):
    want, got = _both([cmd.split()[0], _log(logs, log), *PRINTING[cmd]], capsys)
    if cmd == "bottleneck" and "scoring program (" in want[1]:
        # the one line of design difference: the cost line's field and wording
        assert got[0] == want[0] == 0
        assert _without_cost_line(got[1]) == _without_cost_line(want[1])
        assert "FLOP/variant measured by XLA cost_analysis; v5e roofline" in want[1]
        assert "operations/variant counted for the forest kernel; H100 bound" in got[1]
        return
    assert got == want


@pytest.mark.parametrize("log", LOGS)
def test_export_writes_the_references_trace(logs, log, tmp_path, capsys):
    src = _log(logs, log)
    rcs = []
    for name, cli in (("j", jcli), ("t", tcli)):
        rcs.append(cli.run(["export", src, "-o", str(tmp_path / f"{name}.trace.json")]))
        capsys.readouterr()
    assert rcs == [0, 0]
    got = json.loads((tmp_path / "t.trace.json").read_text())
    assert got == json.loads((tmp_path / "j.trace.json").read_text()) and got["traceEvents"]


@pytest.mark.parametrize("log", ["sampled", "jax_run", "port_run"])
def test_flame_writes_the_references_speedscope_and_stacks(logs, log, tmp_path, capsys):
    src = _log(logs, log)
    printed = []
    for name, cli in (("j", jcli), ("t", tcli)):
        rc = cli.run(["flame", src, "-o", str(tmp_path / f"{name}.speedscope.json"),
                      "--collapsed", str(tmp_path / f"{name}.collapsed.txt")])
        printed.append((rc, capsys.readouterr().out.replace(f"/{name}.", "/X.")))
    assert printed[0] == printed[1] and printed[0][0] == 0
    assert (tmp_path / "t.speedscope.json").read_bytes() == (tmp_path / "j.speedscope.json").read_bytes()
    assert (tmp_path / "t.collapsed.txt").read_bytes() == (tmp_path / "j.collapsed.txt").read_bytes()


@pytest.mark.parametrize("json_out", [False, True], ids=["text", "json"])
@pytest.mark.parametrize("pair", [("slower", "geometry"), ("geometry", "slower"), ("port_run", "jax_run"),
                                  ("geometry", "in_flight")])
def test_diff_prints_and_exits_as_the_reference(logs, pair, json_out, capsys):
    argv = ["diff", _log(logs, pair[0]), _log(logs, pair[1])] + (["--json"] if json_out else [])
    want, got = _both(argv, capsys)
    assert got == want
    if pair == ("slower", "geometry"):
        assert got[0] == 1  # a regression beyond the noise band


@pytest.mark.parametrize("json_out", [False, True], ids=["text", "json"])
def test_flame_diff_prints_what_the_reference_prints(logs, json_out, capsys):
    argv = ["flame", "--diff", _log(logs, "port_run"), _log(logs, "jax_run")] + (["--json"] if json_out else [])
    want, got = _both(argv, capsys)
    assert got == want and got[0] == 0


def test_prom_textfile_equals_the_reference(logs, tmp_path, capsys):
    for name, cli in (("j", jcli), ("t", tcli)):
        assert cli.run(["prom", _log(logs, "port_run"), "-o", str(tmp_path / f"{name}.prom")]) == 0
        capsys.readouterr()
    assert (tmp_path / "t.prom").read_bytes() == (tmp_path / "j.prom").read_bytes()


@pytest.mark.parametrize("argv", [["summary", "/nonexistent/run.jsonl"], ["cpuledger", "GEOMETRY"],
                                  ["flame", "GEOMETRY"], ["flame", "--diff", "GEOMETRY"]],
                         ids=["missing_log", "ledger_without_samples", "flame_without_samples",
                              "flame_diff_one_log"])
def test_usage_and_unreadable_logs_exit_2_as_the_reference(logs, argv, capsys):
    argv = [logs["geometry"] if a == "GEOMETRY" else a for a in argv]
    want, got = _both(argv, capsys)
    assert got == want and got[0] == 2


@pytest.mark.parametrize("log", ["jax_run", "port_run"])
def test_recorded_streams_validate_under_both_schemas(logs, log):
    lines = Path(_log(logs, log)).read_text().splitlines()
    assert tschema.validate_lines(lines) == [] and jschema.validate_lines(lines) == []


def test_port_cost_event_is_the_forest_kernels_count(logs):
    """The port's ``cost_analysis`` event: the wide kernel's count of the
    first table it scored, by ``forest_cuda.scoring_work``."""
    from variantcalling_tpu_torch.featurize import BASE_FEATURES
    from variantcalling_tpu_torch.models import forest as fmod
    from variantcalling_tpu_torch.models import forest_cuda
    from variantcalling_tpu_torch.models import registry as tregistry

    events = texport.read_run(_log(logs, "port_run"))
    (cost,) = [e for e in events if e["kind"] == "profile" and e["name"] == "cost_analysis"]
    model = tregistry.load_model(str(Path(logs["port_run"]).parent / "jmodel.pkl"), RF)
    names = list(BASE_FEATURES)  # the host featurization's order: the run's columns
    kernel = forest_cuda.WideForestKernel(fmod.with_feature_order(model, names), len(names), "cpu")
    work = kernel.work(cost["n"])
    assert cost["strategy"] == "wide" and cost["flops"] == work["ops"] and cost["bytes_accessed"] == work["bytes"]
    assert cost["roofline_vps_h100"] == round(cost["n"] / (work["bound_ms"] / 1e3)) > 0


# -- the port alone -------------------------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _obs_isolated(monkeypatch):
    for k in [k for k in os.environ if k.startswith("VCTPU_")]:
        monkeypatch.delenv(k)
    yield
    run = obs.current()
    if run is not None:
        obs.end_run(run, "test-teardown")


def _open_run(path: Path):
    run = obs.start_run("test_tool", force_path=str(path))
    assert run is not None
    return run


BROKEN = {
    "missing_common_field": lambda ev: [dict(e) if i else {k: v for k, v in e.items() if k != "tid"}
                                        for i, e in enumerate(ev)],
    "mistyped_field": lambda ev: [dict(e, seq=str(e["seq"])) if i == 1 else e for i, e in enumerate(ev)],
    "seq_gap": lambda ev: [dict(e, seq=e["seq"] + 1) if i >= 2 else e for i, e in enumerate(ev)],
    "ts_backwards": lambda ev: [dict(e, ts=0.0) if i == 3 else e for i, e in enumerate(ev)],
    "no_manifest_first": lambda ev: ev[1:],
    "kind_field_missing": lambda ev: [{k: v for k, v in e.items() if k != "dur"} if e["kind"] == "trace" else e
                                      for e in ev],
    "wrong_version": lambda ev: [dict(e, v=2) if i == 2 else e for i, e in enumerate(ev)],
    "not_json": None,
}


@pytest.mark.parametrize("case", list(BROKEN))
def test_the_validator_names_what_the_reference_names(case):
    events = _geometry(2)
    lines = [json.dumps(e) for e in (BROKEN[case](events) if BROKEN[case] else events)]
    if case == "not_json":
        lines[2] = lines[2][:10]
    got = tschema.validate_lines(lines)
    assert got and got == jschema.validate_lines(lines)


def test_rotation_segments_merge_and_validate(tmp_path, monkeypatch):
    monkeypatch.setenv("VCTPU_OBS_MAX_MB", "1")
    path = tmp_path / "rot.jsonl"
    run = _open_run(path)
    n = 9000  # about 1.4 MB of events: at least one rollover
    for i in range(n):
        obs.event("journal", "resume_decision", outcome="fresh", i=i)
    obs.end_run(run, "ok")
    assert (tmp_path / "rot.jsonl.seg1").exists() and path.stat().st_size <= (1 << 20) + 4096
    events = texport.read_run(str(path))
    assert [e["seq"] for e in events] == list(range(len(events)))
    assert events[0]["kind"] == "manifest" and events[-1]["kind"] == "run_end"
    assert sum(e["kind"] == "journal" for e in events) == n
    seg = (tmp_path / "rot.jsonl.seg1").read_text().splitlines()
    assert tschema.validate_lines(seg) and tschema.validate_lines(seg, continuation=True) == []
    assert tschema.validate_lines(path.read_text().splitlines()) == []
    assert texport.summarize(events)["run"]["status"] == "ok"


@pytest.mark.parametrize("snapshot_s", ["0.01", "0"])
def test_snapshot_cadence(tmp_path, monkeypatch, snapshot_s):
    monkeypatch.setenv("VCTPU_OBS_SNAPSHOT_S", snapshot_s)
    prom = tmp_path / "live.prom"
    monkeypatch.setenv("VCTPU_OBS_PROM_FILE", str(prom))
    path = tmp_path / "snap.jsonl"
    run = _open_run(path)
    for i in range(120):
        obs.histogram("stage.score_stage.s").observe(0.01)
        obs.event("journal", "resume_decision", outcome="fresh", i=i)
        if i % 40 == 0:
            time.sleep(0.02)
    obs.end_run(run, "ok")
    events = [json.loads(ln) for ln in path.read_text().splitlines()]
    snaps = [e for e in events if e["kind"] == "snapshot"]
    assert events[-1]["kind"] == "run_end" and tschema.validate_lines(path.read_text().splitlines()) == []
    if snapshot_s == "0":
        assert not snaps
    else:
        assert snaps and snaps[-1]["histograms"]["stage.score_stage.s"]["rolling"]["count"] > 0
    # the textfile is rewritten at the run's end either way
    assert "vctpu_stage_score_stage_s" in prom.read_text()


def test_in_flight_log_reads_as_in_flight(logs, capsys):
    assert tcli.run(["summary", logs["in_flight"], "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["run"]["status"] == "in-flight"
    bad = Path(logs["in_flight"]).parent / "garbage_mid_file.jsonl"
    lines = Path(logs["geometry"]).read_text().splitlines()
    bad.write_text("\n".join(lines[:3] + ["{torn"] + lines[3:]) + "\n")
    assert tcli.run(["summary", str(bad)]) == 2  # garbage before the end is not a torn tail


_FLUSH_SCRIPT = textwrap.dedent("""
    import sys, time
    from variantcalling_tpu_torch import obs
    run = obs.start_run("flush_test", force_path=sys.argv[1])
    obs.counter("records").add(7)
    print("READY", flush=True)
    if "--exit" in sys.argv:
        sys.exit(0)          # no end_run: the atexit hook flushes
    time.sleep(30)           # the test signals here
""")


@pytest.mark.parametrize("how", ["atexit", "sigterm", "sigint"])
def test_abnormal_exit_flushes_the_stream(tmp_path, how):
    log = tmp_path / f"{how}.jsonl"
    env = {k: v for k, v in os.environ.items() if not k.startswith("VCTPU_")}
    env["PYTHONPATH"] = str(ROOT)
    argv = [sys.executable, "-c", _FLUSH_SCRIPT, str(log)] + (["--exit"] if how == "atexit" else [])
    proc = subprocess.Popen(argv, env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "READY"
        if how != "atexit":
            proc.send_signal(signal.SIGTERM if how == "sigterm" else signal.SIGINT)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    # the handlers re-deliver the signal after the flush: killed by it
    assert rc == {"atexit": 0, "sigterm": -signal.SIGTERM, "sigint": -signal.SIGINT}[how]
    events = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert events[-1]["kind"] == "run_end" and events[-1]["status"] == how
    assert [e for e in events if e["kind"] == "metrics"][-1]["counters"]["records"] == 7
    assert tschema.validate_lines(log.read_text().splitlines()) == []


@pytest.mark.parametrize("trace", ["1", "0"])
def test_tracing_follows_its_knob(tmp_path, monkeypatch, trace):
    monkeypatch.setenv("VCTPU_OBS_TRACE", trace)
    path = tmp_path / "trace.jsonl"
    run = _open_run(path)
    tid = obs.new_trace()
    a = obs.trace_span(tid, "ingest", 0.01)
    b = obs.trace_span(tid, "score_stage", 0.02)
    with obs.trace_scope(tid):
        assert obs.current_trace() == tid
    assert obs.current_trace() is None
    obs.end_trace(tid)
    obs.end_run(run, "ok")
    traces = [json.loads(ln) for ln in path.read_text().splitlines() if '"kind": "trace"' in ln]
    if trace == "0":
        assert (tid, a, b, traces) == (None, None, None, [])
    else:
        assert [t["span_id"] for t in traces] == [a, b] and traces[1]["parents"] == [a]
        assert tcritical.critical_path(texport.read_run(str(path)))["chunks"] == 1


def test_device_trace_on_the_cpu(tmp_path, monkeypatch):
    """``VCTPU_OBS_JAXPROF=1`` on the CPU: torch.profiler's Chrome trace of
    the run lands in ``<run log>.jaxprof/``, its start and stop in the
    stream."""
    import torch

    monkeypatch.setenv("VCTPU_OBS_JAXPROF", "1")
    path = tmp_path / "dev.jsonl"
    run = _open_run(path)
    torch.ones(64).cumsum(0)
    obs.end_run(run, "ok")
    events = [json.loads(ln) for ln in path.read_text().splitlines()]
    names = [e["name"] for e in events if e["kind"] == "profile"]
    assert "jaxprof_start" in names and "jaxprof_stop" in names
    trace = json.loads((tmp_path / "dev.jsonl.jaxprof" / obs.DEVICE_TRACE_FILE).read_text())
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])


def test_device_trace_summary_merges_overlapping_kernels(tmp_path):
    from variantcalling_tpu_torch.obs import profile as tprofile

    wide = "(anonymous namespace)::forest_wide_margin_kernel(float const*, long long, int (*)(int))"
    events = [{"cat": "kernel", "name": wide, "ts": 0, "dur": 10},
              {"cat": "kernel", "name": wide, "ts": 5, "dur": 10},
              {"cat": "kernel", "name": "void at::native::elementwise_kernel<128, 4>(int, float)", "ts": 30, "dur": 5},
              {"cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 100}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = tprofile.device_trace_summary(str(path))
    assert got["kernels"] == {"(anonymous namespace)::forest_wide_margin_kernel": 2,
                              "void at::native::elementwise_kernel<128, 4>": 1}
    assert got["kernel_events"] == 3
    assert got["busy_s"] == pytest.approx(20e-6) and got["kernel_s"] == pytest.approx(25e-6)
