"""The port's streaming executor through its CLI, against the JAX package's and its own serial path.

Worlds: a three-contig synthetic callset (3,000 records) with a forest pickle
saved by the JAX package, that pickle with a threshold model and a DAN
added, and an xgboost JSON model over a three-contig callset where some
records lack SOR and GQ; and ``tests/torch_worlds.write_gatk_world`` (QUAL as
GATK writes it, a CRLF copy, ``.bed`` and ``.h5`` blacklists). Chunks are
16 KiB (``VCTPU_STREAM_CHUNK_BYTES``), so every run crosses chunk and contig
boundaries. Every run is on the CPU (``--backend cpu``).

- With default knobs both packages stream; the port's output equals the JAX
  package's outside ``##vctpu_*`` (forests: every byte; threshold and DAN:
  ``tests/torch_vcf_compare.py``'s rule at 1e-6 / 1e-5), in ``.vcf`` and
  ``.vcf.gz``, in the pooled layout, with ``VCTPU_IO_THREADS=1`` and with
  ``VCTPU_CACHE=1``.
- Streaming equals the port's own serial run (``VCTPU_THREADS=1``) file for
  file, BGZF framing and ``.tbi`` included.
- ``streaming_eligible`` answers as the reference's over a table of
  environments.
- Resume after ``io.writeback`` and ``io.commit`` faults under both
  ``VCTPU_RESUME_VERIFY`` values; no resume across models or engines;
  ``.vcf.gz`` restarts; ``VCTPU_JOURNAL_FSYNC=1`` changes no byte.
- Quarantine against the JAX package's (main output and sidecar); without
  the knob the run fails. A sticky device fault fails the run at once (exit
  1, no output, the journal kept, never quarantined); a device OOM is
  re-dispatched.
- The chunk cache: a second run hits every chunk and sends nothing to the
  device; its read and write faults change no byte.
- Peak RSS of streaming runs (subprocesses) grows far slower with the
  input than the serial path's: by less than three bytes a byte of input
  (the input's mapped pages and the chunks in flight), where the serial
  path's grows by more than five.

Every test runs under ``tests.conftest.assert_no_stream_leaks`` over its
directories and resets the armed faults of both packages. Skipped where
g++ is absent (streaming needs the native engine).
"""

import dataclasses
import gzip
import json
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests import fixtures, torch_worlds
from tests.conftest import assert_no_stream_leaks
from tests.test_torch_filter_pipeline import FAMILY_NAMES, FAMILY_TOL, _save_family_pickle
from tests.torch_vcf_compare import differing_records
from variantcalling_tpu.models import registry as jregistry
from variantcalling_tpu.models.forest import FlatForest as JFlatForest
from variantcalling_tpu.pipelines import filter_variants as fvp
from variantcalling_tpu.utils import faults as jfaults
from variantcalling_tpu_torch import synthetic
from variantcalling_tpu_torch.__main__ import main as torch_main
from variantcalling_tpu_torch.io import journal
from variantcalling_tpu_torch.models import registry as tregistry
from variantcalling_tpu_torch.pipelines import filter_variants as tfv
from variantcalling_tpu_torch.utils import faults

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is absent: the engine cannot be built")

ROOT = Path(__file__).resolve().parents[1]
RF = "rf_model_ignore_gt_incl_hpol_runs"
CHUNK = str(16 << 10)
CONTIGS = [("chr1", 200_000), ("chr2", 150_000), ("chr3", 100_000)]
LAYOUTS = {"pooled": {}, "serial-io": {"VCTPU_IO_THREADS": "1"}, "pooled-cache": {"VCTPU_CACHE": "1"}}


@pytest.fixture(scope="module")
def syn(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream_cli")
    w = synthetic.write_world(str(d / "pickle"), seed=41, n_variants=3000, n_trees=12, depth=5, contigs=CONTIGS)
    forest = tregistry.load_model(w["model"], w["model_name"])
    jmodel = d / "pickle" / "jmodel.pkl"
    jregistry.save_models(str(jmodel), {RF: JFlatForest(**{f.name: getattr(forest, f.name)
                                                          for f in dataclasses.fields(JFlatForest)})})
    x = synthetic.write_world(str(d / "xgb"), seed=42, n_variants=3000, n_trees=12, depth=5, contigs=CONTIGS,
                              xgboost=True)
    return {"dir": d, "vcf": w["vcf"], "fasta": w["fasta"],
            "models": {"pickle": (str(jmodel), RF), "xgboost": (x["model"], x["model_name"])},
            "xgb_vcf": x["vcf"], "xgb_fasta": x["fasta"],
            "families": str(_save_family_pickle(jmodel, d / "pickle" / "families.pkl")), "ref": {}}


@pytest.fixture(scope="module")
def gatk(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream_gatk")
    return {**torch_worlds.write_gatk_world(d), "ref": {}}


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path, request):
    monkeypatch.setenv("VCTPU_STREAM_CHUNK_BYTES", CHUNK)
    monkeypatch.setenv("VCTPU_CACHE_DIR", str(tmp_path / "chunk_cache"))
    monkeypatch.setenv("VCTPU_IO_BACKOFF_S", "0")
    for k in ("VCTPU_THREADS", "VCTPU_STREAM", "VCTPU_IO_THREADS", "VCTPU_CACHE", "VCTPU_QUARANTINE",
              "VCTPU_RESUME", "VCTPU_RESUME_VERIFY", "VCTPU_JOURNAL_FSYNC", "VCTPU_FAULTS"):
        monkeypatch.delenv(k, raising=False)
    yield
    faults.reset()
    jfaults.reset()
    dirs = [tmp_path] + [request.getfixturevalue(n)["dir"] for n in ("syn", "gatk") if n in request.fixturenames]
    assert_no_stream_leaks(dirs)


class _Log(logging.Handler):
    """The port's ``STREAM_LOG`` summary and its per-table transfers."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.stream = None
        self.transfers = 0

    def emit(self, record):
        if record.msg == tfv.STREAM_LOG:
            keys = ("output", "layout", "chunks", "resumed", "quarantined", "records", "cache_hits", "peak")
            self.stream = dict(zip(keys, record.args))
        elif record.msg == tfv.TRANSFER_LOG:
            self.transfers += 1


def _argv(input_file, fasta, model, name, out, extra=()) -> list[str]:
    return ["--input_file", str(input_file), "--model_file", str(model), "--model_name", name,
            "--reference_file", str(fasta), "--output_file", str(out), "--backend", "cpu", *extra]


def _syn_argv(syn, model_key, out, extra=()) -> list[str]:
    model, name = syn["models"][model_key]
    vcf, fasta = (syn["xgb_vcf"], syn["xgb_fasta"]) if model_key == "xgboost" else (syn["vcf"], syn["fasta"])
    return _argv(vcf, fasta, model, name, out, extra)


def _port(argv) -> tuple[int, dict | None, int]:
    """(exit code, STREAM_LOG summary or None for a serial run, tables that reached the device)."""
    handler = _Log()
    plog = logging.getLogger("variantcalling_tpu_torch")
    level = plog.level
    plog.setLevel(logging.INFO)
    plog.addHandler(handler)
    try:
        rc = torch_main(["filter_variants_pipeline", *argv])
    finally:
        plog.removeHandler(handler)
        plog.setLevel(level)
    return rc, handler.stream, handler.transfers


def _read(path) -> bytes:
    data = Path(path).read_bytes()
    return gzip.decompress(data) if str(path).endswith(".gz") else data


def _reference(world, key, argv_of) -> bytes:
    """The JAX package's output (decompressed) for ``argv_of(out)``, run once a key."""
    if key not in world["ref"]:
        out = world["dir"] / f"ref_{len(world['ref'])}{'.vcf.gz' if key[-1] == '.vcf.gz' else '.vcf'}"
        assert fvp.run(argv_of(out)) == 0
        world["ref"][key] = _read(out)
    return world["ref"][key]


# -- the port against the JAX package, both streaming ----------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
@pytest.mark.parametrize("model_key", ["pickle", "xgboost"])
def test_forests_stream_to_the_references_bytes(syn, tmp_path, monkeypatch, model_key, suffix, layout):
    want = _reference(syn, (model_key, suffix), lambda out: _syn_argv(syn, model_key, out))
    for k, v in LAYOUTS[layout].items():
        monkeypatch.setenv(k, v)
    out = tmp_path / f"port{suffix}"
    rc, stream, _ = _port(_syn_argv(syn, model_key, out))
    assert rc == 0 and stream["layout"] == layout.removesuffix("-cache") and stream["chunks"] >= 10
    assert stream["records"] == 3000 and stream["resumed"] == stream["quarantined"] == 0
    assert fixtures.strip_vctpu_header(_read(out)) == fixtures.strip_vctpu_header(want)


@pytest.mark.parametrize("family", ["threshold", "dan"])
def test_families_stream_within_the_rule(syn, tmp_path, family):
    def argv(out):
        return _argv(syn["vcf"], syn["fasta"], syn["families"], FAMILY_NAMES[family], out)

    want = _reference(syn, (family, ".vcf"), argv)
    rc, stream, _ = _port(argv(tmp_path / "port.vcf"))
    assert rc == 0 and stream["chunks"] >= 10
    n_diff = differing_records((tmp_path / "port.vcf").read_bytes(), want, 0.5 if family == "dan" else 0.25,
                               FAMILY_TOL[family])
    assert n_diff <= 3000 // 100


@pytest.mark.parametrize("blacklist", [None, "blacklist.bed", "blacklist_vctpu.h5"])
@pytest.mark.parametrize("input_name", ["calls.vcf", "calls_crlf.vcf.gz"])
def test_gatk_world_streams_to_the_references_bytes(gatk, tmp_path, monkeypatch, input_name, blacklist):
    monkeypatch.setenv("VCTPU_STREAM_CHUNK_BYTES", str(8 << 10))  # the world is small: several chunks
    d = gatk["dir"]
    extra = ("--blacklist", str(d / blacklist)) if blacklist else ()

    def argv(out):
        return _argv(d / input_name, d / "ref.fa", d / "model.pkl", RF, out, extra)

    want = _reference(gatk, (input_name, blacklist, ".vcf"), argv)
    rc, stream, _ = _port(argv(tmp_path / "port.vcf"))
    assert rc == 0 and stream["chunks"] >= 2
    got = (tmp_path / "port.vcf").read_bytes()
    assert fixtures.strip_vctpu_header(got) == fixtures.strip_vctpu_header(want)
    if blacklist:
        assert got.count(b"\tCOHORT_FP") == gatk["blacklisted"]


# -- streaming against the port's own serial path --------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
def test_streaming_equals_the_serial_run_file_for_file(syn, tmp_path, monkeypatch, suffix, layout):
    monkeypatch.setenv("VCTPU_THREADS", "1")
    rc, stream, _ = _port(_syn_argv(syn, "pickle", tmp_path / f"serial{suffix}"))
    assert rc == 0 and stream is None
    monkeypatch.delenv("VCTPU_THREADS")
    for k, v in LAYOUTS[layout].items():
        monkeypatch.setenv(k, v)
    rc, stream, _ = _port(_syn_argv(syn, "pickle", tmp_path / f"stream{suffix}"))
    assert rc == 0 and stream["chunks"] >= 10
    assert (tmp_path / f"stream{suffix}").read_bytes() == (tmp_path / f"serial{suffix}").read_bytes()
    if suffix == ".vcf.gz":
        assert (tmp_path / "stream.vcf.gz.tbi").read_bytes() == (tmp_path / "serial.vcf.gz.tbi").read_bytes()


@pytest.mark.parametrize("env,limit", [
    ({}, None), ({"VCTPU_THREADS": "1"}, None), ({"VCTPU_THREADS": "3"}, None), ({"VCTPU_STREAM": "0"}, None),
    ({"VCTPU_STREAM": "off", "VCTPU_THREADS": "4"}, None), ({"VCTPU_STREAM": "1", "VCTPU_THREADS": "2"}, None),
    ({}, "chr1"), ({"VCTPU_THREADS": "8"}, "chr2"),
])
def test_path_selection_answers_as_the_reference(monkeypatch, env, limit):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tfv.streaming_eligible(limit) == fvp.streaming_eligible(limit)


def test_limit_to_contig_and_no_engine_run_serial(syn, tmp_path, monkeypatch):
    """``--limit_to_contig`` and ``VCTPU_NO_NATIVE=1`` select the serial path
    (the reference reads ``VCTPU_NO_NATIVE`` once a process, so it is not in
    the in-process table above)."""
    rc, stream, _ = _port(_syn_argv(syn, "pickle", tmp_path / "limited.vcf", ("--limit_to_contig", "chr2")))
    assert rc == 0 and stream is None
    records = [ln for ln in (tmp_path / "limited.vcf").read_bytes().split(b"\n") if ln and not ln.startswith(b"#")]
    assert records and all(ln.startswith(b"chr2\t") for ln in records)
    monkeypatch.setenv("VCTPU_NO_NATIVE", "1")
    assert not tfv.streaming_eligible()
    rc, stream, _ = _port(_syn_argv(syn, "pickle", tmp_path / "plain.vcf"))
    assert rc == 0 and stream is None


# -- resume ------------------------------------------------------------------


def _clean(syn, tmp_path, suffix=".vcf") -> bytes:
    out = tmp_path / f"clean{suffix}"
    assert _port(_syn_argv(syn, "pickle", out))[0] == 0
    return out.read_bytes()


def _interrupted(argv, out, spec: str) -> None:
    """A run failed by the faults of ``spec``: no output, and (``.vcf``) the
    journal and one partial kept for the resume."""
    for point, times, seconds, after in faults.parse_spec(spec):
        faults.arm(point, times=times, seconds=seconds, after=after)
    try:
        with pytest.raises(OSError, match="injected fault"):
            _port(argv)
    finally:
        faults.reset()
    assert not out.exists()


@pytest.mark.parametrize("verify", ["last", "full"])
@pytest.mark.parametrize("spec", ["io.writeback:0+2", "io.commit:0"])
def test_a_failed_run_resumes_to_the_clean_bytes(syn, tmp_path, monkeypatch, spec, verify):
    clean = _clean(syn, tmp_path)
    monkeypatch.setenv("VCTPU_RESUME_VERIFY", verify)
    out = tmp_path / "resumed.vcf"
    _interrupted(_syn_argv(syn, "pickle", out), out, spec)
    kept = journal.ChunkJournal.load(str(out))
    assert kept is not None and len(kept[1]) >= 1 and len(list(tmp_path.glob("resumed.vcf.partial.*"))) == 1
    rc, stream, _ = _port(_syn_argv(syn, "pickle", out))
    assert rc == 0 and stream["resumed"] == len(kept[1]) >= 1 and out.read_bytes() == clean
    if spec.startswith("io.commit"):
        assert stream["resumed"] == stream["chunks"]


def test_no_resume_across_models_or_engines(syn, tmp_path):
    out = tmp_path / "out.vcf"
    _interrupted(_syn_argv(syn, "pickle", out), out, "io.writeback:0+3")
    # another model (the same forest in another pickle) starts fresh
    other = _argv(syn["vcf"], syn["fasta"], syn["families"], RF, out)
    rc, stream, _ = _port(other)
    assert rc == 0 and stream["resumed"] == 0 and out.read_bytes() == _clean(syn, tmp_path)
    # a partial written on the card never resumes on the CPU
    out.unlink()
    _interrupted(_syn_argv(syn, "pickle", out), out, "io.writeback:0+3")
    path = Path(journal.journal_path(str(out)))
    lines = path.read_text().splitlines()
    meta = json.loads(lines[0])
    assert meta["config"]["engine"] == "torch-cpu"
    meta["config"]["engine"] = "cuda"
    path.write_text("\n".join([json.dumps(meta, sort_keys=True), *lines[1:]]) + "\n")
    rc, stream, _ = _port(_syn_argv(syn, "pickle", out))
    assert rc == 0 and stream["resumed"] == 0 and out.read_bytes() == _clean(syn, tmp_path)


def test_vcf_gz_output_restarts(syn, tmp_path):
    clean = _clean(syn, tmp_path, ".vcf.gz")
    out = tmp_path / "out.vcf.gz"
    _interrupted(_syn_argv(syn, "pickle", out), out, "io.writeback:0+3")
    assert not list(tmp_path.glob("out.vcf.gz.partial*")) and not Path(journal.journal_path(str(out))).exists()
    rc, stream, _ = _port(_syn_argv(syn, "pickle", out))
    assert rc == 0 and stream["resumed"] == 0 and out.read_bytes() == clean


def test_journal_fsync_changes_no_byte(syn, tmp_path, monkeypatch):
    clean = _clean(syn, tmp_path)
    monkeypatch.setenv("VCTPU_JOURNAL_FSYNC", "1")
    assert _port(_syn_argv(syn, "pickle", tmp_path / "fsync.vcf"))[0] == 0
    out = tmp_path / "fsync_resumed.vcf"
    _interrupted(_syn_argv(syn, "pickle", out), out, "io.writeback:0+4")
    rc, stream, _ = _port(_syn_argv(syn, "pickle", out))
    assert rc == 0 and stream["resumed"] >= 1
    assert (tmp_path / "fsync.vcf").read_bytes() == out.read_bytes() == clean


# -- quarantine and device failures -------------------------------------------


def test_quarantine_equals_the_references(syn, tmp_path, monkeypatch):
    """Serial IO (chunks scored in order on one stage thread), one chunk that
    fails on every attempt (1 + ``VCTPU_CHUNK_RETRIES``): diverted to the
    sidecar by both packages."""
    monkeypatch.setenv("VCTPU_IO_THREADS", "1")
    monkeypatch.setenv("VCTPU_QUARANTINE", "1")
    ref_out, port_out = tmp_path / "ref.vcf", tmp_path / "port.vcf"
    jfaults.arm("pipeline.chunk", times=2, after=3)
    assert fvp.run(_syn_argv(syn, "pickle", ref_out)) == 0
    faults.arm("pipeline.chunk", times=2, after=3)
    rc, stream, _ = _port(_syn_argv(syn, "pickle", port_out))
    port_q, ref_q = Path(tfv.quarantine_path(port_out)), Path(fvp.quarantine_path(str(ref_out)))
    try:
        assert rc == 0 and stream["quarantined"] == 1
        main = fixtures.strip_vctpu_header(port_out.read_bytes())
        assert main == fixtures.strip_vctpu_header(ref_out.read_bytes())
        diverted = port_q.read_bytes()
        assert diverted == ref_q.read_bytes() and diverted.count(b"\n") > 0
        assert sum(not ln.startswith(b"#") for ln in main.splitlines()) + diverted.count(b"\n") == 3000
    finally:
        port_q.unlink(missing_ok=True)
        ref_q.unlink(missing_ok=True)


def test_without_the_knob_a_poison_chunk_fails_the_run(syn, tmp_path):
    out = tmp_path / "out.vcf"
    faults.arm("pipeline.chunk", times=None, after=3)
    with pytest.raises(RuntimeError, match="injected fault: chunk scoring failure"):
        _port(_syn_argv(syn, "pickle", out))
    assert not out.exists() and not Path(tfv.quarantine_path(out)).exists()
    journal.discard(str(out))


def test_a_sticky_device_fault_fails_the_run_at_once(syn, tmp_path, monkeypatch):
    monkeypatch.setenv("VCTPU_QUARANTINE", "1")
    calls = []
    score = tfv.FusedScorer.score

    def sticky(self, *args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return score(self, *args)

    monkeypatch.setattr(tfv.FusedScorer, "score", sticky)
    out = tmp_path / "out.vcf"
    monkeypatch.setenv("VCTPU_IO_THREADS", "1")
    rc, stream, _ = _port(_syn_argv(syn, "pickle", out))
    assert rc == 1 and stream is None and not out.exists()
    assert len(calls) == 3  # neither re-dispatched nor quarantined
    assert not Path(tfv.quarantine_path(out)).exists()
    kept = journal.ChunkJournal.load(str(out))
    assert kept is not None and len(kept[1]) == 2
    journal.discard(str(out))


def test_a_device_oom_is_redispatched(syn, tmp_path, monkeypatch):
    calls = []
    score = tfv.FusedScorer.score

    def oom_once(self, *args):
        calls.append(1)
        if len(calls) == 2:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return score(self, *args)

    monkeypatch.setattr(tfv.FusedScorer, "score", oom_once)
    monkeypatch.setenv("VCTPU_IO_THREADS", "1")
    clean = _clean(syn, tmp_path)
    assert calls[1:2] == [1]
    rc, stream, _ = _port(_syn_argv(syn, "pickle", tmp_path / "again.vcf"))
    assert rc == 0 and (tmp_path / "again.vcf").read_bytes() == clean


# -- the chunk cache -------------------------------------------------------------


def test_a_cached_rerun_hits_every_chunk_and_sends_nothing(syn, tmp_path, monkeypatch):
    monkeypatch.setenv("VCTPU_CACHE", "1")
    faults.arm("cache.entry_write", times=1)  # one entry dropped: that chunk recomputes next time
    rc, cold, sent = _port(_syn_argv(syn, "pickle", tmp_path / "cold.vcf"))
    assert rc == 0 and cold["cache_hits"] == 0 and sent == cold["chunks"]
    rc, warm, sent = _port(_syn_argv(syn, "pickle", tmp_path / "warm.vcf"))
    assert rc == 0 and warm["cache_hits"] == warm["chunks"] - 1 and sent == 1
    rc, hot, sent = _port(_syn_argv(syn, "pickle", tmp_path / "hot.vcf"))
    assert rc == 0 and hot["cache_hits"] == hot["chunks"] and sent == 0
    faults.arm("cache.entry_read", times=2)  # read errors: misses, recomputed
    rc, flaky, sent = _port(_syn_argv(syn, "pickle", tmp_path / "flaky.vcf"))
    assert rc == 0 and flaky["cache_hits"] == flaky["chunks"] - 2 and sent == 2
    data = {p: (tmp_path / f"{p}.vcf").read_bytes() for p in ("cold", "warm", "hot", "flaky")}
    assert len(set(data.values())) == 1
    # a run of another model does not hit
    other = _argv(syn["vcf"], syn["fasta"], syn["families"], FAMILY_NAMES["threshold"], tmp_path / "thr.vcf")
    rc, thr, _ = _port(other)
    assert rc == 0 and thr["cache_hits"] == 0


# -- memory ------------------------------------------------------------------------


def _peak_rss(world: dict, out: Path, env: dict) -> int:
    # VmHWM, not ru_maxrss: the latter keeps this (large) process's size at the fork
    code = (
        "import sys\n"
        "from variantcalling_tpu_torch.__main__ import main\n"
        "assert main(sys.argv[1:]) == 0\n"
        "print('RSS_KB', [ln.split()[1] for ln in open('/proc/self/status') if ln.startswith('VmHWM:')][0])\n")
    full = {k: v for k, v in os.environ.items() if not k.startswith("VCTPU_") and k != "PYTHONPATH"}
    full.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="", **env)
    argv = ["filter_variants_pipeline", *_argv(world["vcf"], world["fasta"], world["model"], world["model_name"],
                                               out)]
    proc = subprocess.run([sys.executable, "-c", code, *argv], capture_output=True, text=True, env=full,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return int(proc.stdout.split("RSS_KB")[1].split()[0]) * 1024


def test_streaming_peak_rss_grows_far_slower_than_the_input(tmp_path):
    worlds = {n: synthetic.write_world(str(tmp_path / str(n)), seed=7, n_variants=n, n_trees=4, depth=4,
                                       contigs=[("chr1", 1_500_000), ("chr2", 1_000_000)])
              for n in (30_000, 240_000)}
    grow = {}
    for mode, env in (("stream", {"VCTPU_STREAM_CHUNK_BYTES": str(256 << 10)}), ("serial", {"VCTPU_STREAM": "0"})):
        rss = {n: _peak_rss(w, tmp_path / f"{mode}_{n}.vcf", env) for n, w in worlds.items()}
        grow[mode] = rss[240_000] - rss[30_000]
    input_grow = os.path.getsize(worlds[240_000]["vcf"]) - os.path.getsize(worlds[30_000]["vcf"])
    # the serial path holds the whole callset's text, arrays and output at
    # once (about 20 bytes of memory a byte of input); the streaming path a
    # few chunks in flight and the input's mapped pages
    assert grow["serial"] > 5 * input_grow and grow["stream"] < 3 * input_grow < grow["serial"] / 3, \
        (grow, input_grow)
