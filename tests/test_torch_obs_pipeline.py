"""The run telemetry of the port's main paths against the JAX package's, on the CPU.

The filter CLI (``--backend cpu``) on a three-contig 3,000-record world in
16 KiB chunks, with the CPU sampler on:

- obs on and off give equal output bytes, on the streaming executor's
  pooled and serial-IO layouts, into ``.vcf.gz``, with the chunk cache, and
  on the serial path (``VCTPU_STREAM=0``);
- the stream validates under both packages' schema validators, and its
  manifest lists the knobs (names, values, sources) the JAX package's lists;
- the streaming layouts give one complete trace a chunk, from ingest to
  the commit, each a chain whose span names equal those of the JAX
  package's run on the same input and knobs, and ``obs critical-path``
  counts as many chunks as the run committed;
- the stage profiler's rows and the run's counters are there, and the
  serial path emits its stage spans.

``train_dan`` with obs on: as many ``step`` events as the JAX package's run
and losses within 1e-5 of it, both runs at float32 products from the JAX
package's initial weights carried into the port (``models/convert``), on
the same batches (the port draws the reference's rows).
"""

import collections
import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from tests.conftest import assert_no_stream_leaks
from variantcalling_tpu.obs import schema as jschema
from variantcalling_tpu.pipelines import filter_variants as jfv
from variantcalling_tpu_torch.obs import critical as tcritical
from variantcalling_tpu_torch.obs import export as texport
from variantcalling_tpu_torch.obs import schema as tschema
from variantcalling_tpu_torch.pipelines import filter_variants as tfv

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is absent: the engine cannot be built")

RF = "rf_model_ignore_gt_incl_hpol_runs"
CHUNK = str(16 << 10)
#: layout -> its knobs and output suffix
LAYOUTS = {
    "pooled": ({}, ".vcf"),
    "serial-io": ({"VCTPU_IO_THREADS": "1"}, ".vcf"),
    "pooled-gz": ({}, ".vcf.gz"),
    "serial-io-cache": ({"VCTPU_IO_THREADS": "1", "VCTPU_CACHE": "1"}, ".vcf"),
    "serial-path": ({"VCTPU_STREAM": "0"}, ".vcf"),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from variantcalling_tpu.models import registry as jregistry
    from variantcalling_tpu.models.forest import FlatForest as JFlatForest
    from variantcalling_tpu_torch import synthetic
    from variantcalling_tpu_torch.models import registry as tregistry

    d = tmp_path_factory.mktemp("obs_pipe")
    w = synthetic.write_world(str(d / "world"), seed=43, n_variants=3000, n_trees=12, depth=5,
                              contigs=[("chr1", 200_000), ("chr2", 150_000), ("chr3", 100_000)])
    forest = tregistry.load_model(w["model"], w["model_name"])
    model = d / "model.pkl"
    jregistry.save_models(str(model), {RF: JFlatForest(**{f.name: getattr(forest, f.name)
                                                         for f in dataclasses.fields(JFlatForest)})})
    return {"dir": d, "vcf": w["vcf"], "fasta": w["fasta"], "model": str(model)}


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path, request):
    import os

    for k in [k for k in os.environ if k.startswith("VCTPU_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("VCTPU_STREAM_CHUNK_BYTES", CHUNK)
    monkeypatch.setenv("VCTPU_CACHE_DIR", str(tmp_path / "chunk_cache"))
    yield
    dirs = [tmp_path] + ([request.getfixturevalue("world")["dir"]] if "world" in request.fixturenames else [])
    assert_no_stream_leaks(dirs)


def _argv(world, out) -> list[str]:
    return ["--input_file", world["vcf"], "--model_file", world["model"], "--model_name", RF,
            "--reference_file", world["fasta"], "--output_file", str(out), "--backend", "cpu"]


def _events(path) -> list[dict]:
    return [json.loads(ln) for ln in Path(path).read_text().splitlines()]


def _chains(events: list[dict]) -> dict[str, list[str]]:
    """trace id -> its span names in stream order, each span parented on the
    one before it (a chain from the root)."""
    spans = collections.defaultdict(list)
    for e in events:
        if e["kind"] == "trace":
            spans[e["trace_id"]].append(e)
    for tid, chain in spans.items():
        assert "parents" not in chain[0], tid
        for prev, cur in zip(chain, chain[1:]):
            assert cur["parents"] == [prev["span_id"]], tid
    return {tid: [e["name"] for e in chain] for tid, chain in spans.items()}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_obs_changes_no_output_byte(world, tmp_path, monkeypatch, layout):
    knobs, suffix = LAYOUTS[layout]
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    off, on = tmp_path / f"off{suffix}", tmp_path / f"on{suffix}"
    assert tfv.run(_argv(world, off)) == 0
    assert not Path(str(off) + ".obs.jsonl").exists()
    monkeypatch.setenv("VCTPU_OBS", "1")
    monkeypatch.setenv("VCTPU_OBS_CPUPROF", "1")
    assert tfv.run(_argv(world, on)) == 0
    assert on.read_bytes() == off.read_bytes()
    if suffix == ".vcf.gz":
        assert Path(str(on) + ".tbi").read_bytes() == Path(str(off) + ".tbi").read_bytes()
    lines = Path(str(on) + ".obs.jsonl").read_text().splitlines()
    assert tschema.validate_lines(lines) == [] and jschema.validate_lines(lines) == []
    events = [json.loads(ln) for ln in lines]
    assert events[0]["kind"] == "manifest" and events[-1]["kind"] == "run_end" and events[-1]["status"] == "ok"
    resolved = {e["name"]: e["value"] for e in events if e["kind"] == "resolve"}
    assert resolved == {"engine": "torch-cpu", "forest_strategy": "gather", "model_family": "forest"}
    if layout == "serial-path":
        names = {e["name"] for e in events if e["kind"] == "span"}
        assert {"ingest", "host_featurize", "device_score", "filters", "writeback"} <= names
        assert not [e for e in events if e["kind"] == "trace"]
        return
    committed = [e for e in events if e["kind"] == "journal" and e["name"] == "committed"][-1]
    chains = _chains(events)
    assert len(chains) == committed["chunks"] > 1
    assert tcritical.critical_path(texport.read_run(str(on) + ".obs.jsonl"))["chunks"] == committed["chunks"]
    beats = [e for e in events if e["kind"] == "heartbeat"]
    assert len(beats) == committed["chunks"] and beats[-1]["records"] == committed["records"] == 3000
    stages = {e["stage"] for e in events if e["kind"] == "profile" and e["name"] == "stage"}
    assert {"ingest", "writeback"} <= stages
    # with the cache the obs-off run filled it: every chunk of this run hits
    assert any(s.startswith("score_stage") for s in stages) == ("cache" not in layout)
    final = [e for e in events if e["kind"] == "metrics"][-1]
    assert final["counters"]["records"] == 3000
    assert [e for e in events if e["kind"] == "profile" and e["name"] == "cpuprof"]  # the CPU sampler ran


@pytest.mark.parametrize("layout", ["pooled", "serial-io", "pooled-gz", "serial-io-cache"])
def test_chunk_traces_name_the_references_spans(world, tmp_path, monkeypatch, layout):
    """Per chunk, the trace's span names equal the JAX package's on the same
    input and knobs (with the cache, a second run's hits too)."""
    knobs, suffix = LAYOUTS[layout]
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("VCTPU_OBS", "1")
    runs = 2 if "cache" in layout else 1
    got, want = [], []
    for i in range(runs):
        for pkg, run, chains in (("jax", jfv.run, want), ("port", tfv.run, got)):
            monkeypatch.setenv("VCTPU_CACHE_DIR", str(tmp_path / f"cache_{pkg}"))
            out = tmp_path / f"{pkg}{i}{suffix}"
            assert run(_argv(world, out)) == 0
            chains.append(_chains(_events(str(out) + ".obs.jsonl")))
    assert got == want and all(len(c) > 1 for c in got)
    shapes = {tuple(v) for c in got for v in c.values()}
    expect = {"pooled": {("ingest", "score_stage", "render_stage", "writeback")},
              "serial-io": {("ingest", "score_stage", "render_stage", "writeback")},
              "pooled-gz": {("ingest", "score_stage", "render_stage", "compress_stage", "writeback")},
              "serial-io-cache": {("ingest", "score_stage", "render_stage", "writeback"),
                                  ("cache_hit", "writeback")}}[layout]
    assert shapes == expect


def test_manifest_lists_the_references_knobs(world, tmp_path, monkeypatch):
    monkeypatch.setenv("VCTPU_OBS", "1")
    monkeypatch.setenv("VCTPU_IO_THREADS", "3")
    assert tfv.run(_argv(world, tmp_path / "port.vcf")) == 0
    assert jfv.run(_argv(world, tmp_path / "jax.vcf")) == 0
    got = _events(tmp_path / "port.vcf.obs.jsonl")[0]
    want = _events(tmp_path / "jax.vcf.obs.jsonl")[0]
    assert got["knobs"] == want["knobs"] and got["knobs"]["VCTPU_IO_THREADS"] == {"value": 3, "source": "env"}
    assert (got["tool"], got["argv"][:-3], got["inputs"]) == (want["tool"], want["argv"][:-3], want["inputs"])
    assert got["topology"]["backend"] == "cpu" and got["topology"]["process_count"] == 1


# -- train_dan ----------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dan_h5(tmp_path_factory):
    from tests.unit.test_somatic_and_dan import _training_h5

    path = str(tmp_path_factory.mktemp("obs_dan") / "conc.h5")
    _training_h5(path, np.random.default_rng(42))
    return path


def test_train_dan_step_events_follow_the_reference(dan_h5, tmp_path, monkeypatch):
    import jax

    from variantcalling_tpu.models import dan as jdan
    from variantcalling_tpu.pipelines import train_dan as jtd
    from variantcalling_tpu_torch.models import convert
    from variantcalling_tpu_torch.models import dan as tdan
    from variantcalling_tpu_torch.pipelines import train_dan as ttd

    # float32 products in both (the configs' dtype default), and the
    # reference's initial weights in the port
    for cls in (jdan.DanConfig, tdan.DanConfig):
        defaults = tuple("float32" if d == "bfloat16" else d for d in cls.__init__.__defaults__)
        monkeypatch.setattr(cls.__init__, "__defaults__", defaults)
    real_init = jdan.init_params

    def carried(cfg, seed, device="cpu"):
        ref = real_init(jdan.DanConfig(**dataclasses.asdict(cfg)), jax.random.PRNGKey(seed))
        return {k: v.to(device) for k, v in convert.dan_params_from_reference(
            {k: np.asarray(v) for k, v in ref.items()}).items()}

    monkeypatch.setattr(tdan, "init_params", carried)
    monkeypatch.setenv("VCTPU_OBS", "1")
    argv = ["--input_file", dan_h5, "--n_steps", "20", "--log_every", "1", "--batch_size", "256",
            "--hidden", "32", "--embed_dim", "4"]
    assert ttd.run([*argv, "--output_file_prefix", str(tmp_path / "port"), "--backend", "cpu"]) == 0
    assert jtd.run([*argv, "--output_file_prefix", str(tmp_path / "ref")]) == 0
    got, want = (_events(tmp_path / f"{p}.obs.jsonl") for p in ("port", "ref"))
    for events in (got, want):
        lines = [json.dumps(e) for e in events]
        assert tschema.validate_lines(lines) == [] and jschema.validate_lines(lines) == []
    steps = {p: [e for e in ev if e["kind"] == "train" and e["name"] == "step"] for p, ev in (("g", got), ("w", want))}
    assert [e["step"] for e in steps["g"]] == [e["step"] for e in steps["w"]] == list(range(20))
    np.testing.assert_allclose([e["loss"] for e in steps["g"]], [e["loss"] for e in steps["w"]], rtol=1e-5)
    ingest = [e for e in got if e["kind"] == "train" and e["name"] == "ingest_chunk"]
    assert len(ingest) == len([e for e in want if e["kind"] == "train" and e["name"] == "ingest_chunk"]) >= 1
    hist = [e for e in got if e["kind"] == "metrics"][-1]["histograms"]["train.step_s"]
    assert hist["count"] == 20
    assert got[-1]["kind"] == "run_end" and got[-1]["status"] == "ok"
