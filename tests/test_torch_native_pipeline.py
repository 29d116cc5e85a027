"""The port's filter_variants_pipeline CLI on its native host engine, against its plain path and the JAX package.

On ``tests/torch_worlds.write_gatk_world`` (GATK-style QUAL, a CRLF copy,
plain-gzip ``.vcf.gz`` inputs, two contigs, h5 blacklists), each case runs
the port's CLI twice: with the engine (the default) and with
``VCTPU_NO_NATIVE=1`` (the plain Python versions). Both must write the same
bytes, the reference CLI's bytes outside ``##vctpu_*`` (forests: byte
identity; threshold and DAN: the records that differ counted and held to
``tests/torch_vcf_compare.py``'s rule at 1e-6 / 1e-5), and each run's call
counters must show which version served: the scan, the INFO formatter and
the record assembly natively on every engine run, the BGZF codec on
``.vcf.gz`` input or output, the host window gather on the host-gather
path; no native call at all with the engine off. Also ``--limit_to_contig``
(the scan's arrays carried through the row subset) and a malformed record
(the scan declines, the plain path serves, the same bytes). Skipped, with
the reason, where g++ is absent.
"""

import gzip
import logging
import shutil

import numpy as np
import pytest

from tests import fixtures, torch_worlds
from tests.test_torch_filter_pipeline import FAMILY_NAMES, FAMILY_TOL, _save_family_pickle
from tests.torch_vcf_compare import differing_records
from variantcalling_tpu.pipelines import filter_variants as fvp
from variantcalling_tpu_torch import featurize as tfeat
from variantcalling_tpu_torch import native
from variantcalling_tpu_torch.__main__ import main as torch_main

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is absent: the engine cannot be built")

RF, XGB = "rf_model_ignore_gt_incl_hpol_runs", "xgb_model_ignore_gt_incl_hpol_runs"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_native_fvp")
    w = torch_worlds.write_gatk_world(d)
    w["families"] = _save_family_pickle(d / "model.pkl", d / "families.pkl")
    w["ref"] = {}
    return w


def _argv(w, out, input_name="calls.vcf", model_name=RF, model_file="model.pkl", extra=()) -> list[str]:
    d = w["dir"]
    return ["--input_file", str(d / input_name), "--model_file", str(d / model_file), "--model_name", model_name,
            "--reference_file", str(d / "ref.fa"), "--output_file", str(out), "--backend", "cpu", *extra]


def _read(path) -> bytes:
    data = path.read_bytes()
    return gzip.decompress(data) if str(path).endswith(".gz") else data


def _reference(w, suffix=".vcf", **kw) -> bytes:
    """The reference CLI's output bytes (decompressed) for these arguments, run once."""
    key = (suffix, *sorted((k, str(v)) for k, v in kw.items()))
    if key not in w["ref"]:
        out = w["dir"] / f"ref_{len(w['ref'])}{suffix}"
        assert fvp.run(_argv(w, out, **kw)) == 0
        w["ref"][key] = _read(out)
    return w["ref"][key]


def _port(w, tmp_path, monkeypatch, engine: str, suffix=".vcf", **kw) -> tuple[bytes, dict]:
    """The port's output bytes (decompressed) and its call counters, with the
    engine (``native``) or without it (``plain``), on the serial path
    (``VCTPU_STREAM=0``), whose entry points these counters name: the
    streaming executor inflates and scans chunk by chunk
    (``tests/test_torch_streaming_cli.py``)."""
    monkeypatch.setenv("VCTPU_STREAM", "0")
    if engine == "plain":
        monkeypatch.setenv("VCTPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("VCTPU_NO_NATIVE", raising=False)
    out = tmp_path / f"{engine}{suffix}"
    native.reset_calls()
    try:
        assert torch_main(["filter_variants_pipeline", *_argv(w, out, **kw)]) == 0
    finally:
        monkeypatch.delenv("VCTPU_NO_NATIVE", raising=False)
    return _read(out), {k: dict(v) for k, v in native.CALLS.items() if v["native"] or v["plain"]}


def _served(calls: dict, engine: str, expected: set[str]) -> None:
    """``native``: every expected entry point served natively and none by its
    plain version; ``plain``: no native call, and the expected ones plain."""
    kind, other = ("native", "plain") if engine == "native" else ("plain", "native")
    assert {k for k, v in calls.items() if v[kind]} >= expected, calls
    assert not any(v[other] for v in calls.values()), calls


@pytest.fixture
def windows(request, monkeypatch):
    if request.param == "resident":
        monkeypatch.setattr(tfeat, "GENOME_RESIDENT_MIN_VARIANTS", 0)
        monkeypatch.setattr(tfeat, "_DEVICE_GENOME_CACHE", {})
    return request.param


@pytest.mark.parametrize("windows", ["host", "resident"], indirect=True)
@pytest.mark.parametrize("input_name", ["calls.vcf", "calls.vcf.gz", "calls_crlf.vcf", "calls_crlf.vcf.gz"])
@pytest.mark.parametrize("model_name", [RF, XGB])
def test_native_and_plain_write_the_reference_bytes(world, tmp_path, monkeypatch, windows, input_name,
                                                    model_name):
    want = fixtures.strip_vctpu_header(_reference(world, input_name=input_name, model_name=model_name))
    expected = {"vcf_parse", "format_float_info", "vcf_assemble"}
    expected |= {"bgzf_decompress_array"} if input_name.endswith(".gz") else set()
    expected |= {"gather_windows_contig"} if windows == "host" else set()
    got = {}
    for engine in ("native", "plain"):
        got[engine], calls = _port(world, tmp_path, monkeypatch, engine, input_name=input_name,
                                   model_name=model_name)
        _served(calls, engine, expected)
    assert got["native"] == got["plain"]
    assert fixtures.strip_vctpu_header(got["native"]) == want


@pytest.mark.parametrize("input_name", ["calls.vcf", "calls_crlf.vcf.gz"])
@pytest.mark.parametrize("model_name", [RF, XGB])
def test_vcf_gz_output_through_the_engine(world, tmp_path, monkeypatch, input_name, model_name):
    """BGZF out: the same payload both ways, and the reference's. (This
    world's output fits one block, which the writer's close deflates in
    Python in both packages: ``bgzf_compress`` serves full blocks only.)"""
    want = fixtures.strip_vctpu_header(_reference(world, ".vcf.gz", input_name=input_name, model_name=model_name))
    native_bytes, calls = _port(world, tmp_path, monkeypatch, "native", ".vcf.gz", input_name=input_name,
                                model_name=model_name)
    _served(calls, "native", {"vcf_parse", "vcf_assemble"})
    assert (tmp_path / "native.vcf.gz.tbi").exists()
    plain_bytes, calls = _port(world, tmp_path, monkeypatch, "plain", ".vcf.gz", input_name=input_name,
                               model_name=model_name)
    _served(calls, "plain", {"vcf_parse", "vcf_assemble"})
    assert native_bytes == plain_bytes and fixtures.strip_vctpu_header(native_bytes) == want
    assert (tmp_path / "native.vcf.gz.tbi").read_bytes() == (tmp_path / "plain.vcf.gz.tbi").read_bytes()


@pytest.mark.parametrize("layout", ["vctpu", "pytables"])
def test_h5_blacklists_through_the_engine(world, tmp_path, monkeypatch, layout):
    extra = ("--blacklist", str(world["dir"] / f"blacklist_{layout}.h5"))
    want = fixtures.strip_vctpu_header(_reference(world, extra=extra))
    got = {e: _port(world, tmp_path, monkeypatch, e, extra=extra)[0] for e in ("native", "plain")}
    assert got["native"] == got["plain"] and fixtures.strip_vctpu_header(got["native"]) == want
    filters = [ln.split(b"\t")[6] for ln in got["native"].split(b"\n") if ln and not ln.startswith(b"#")]
    assert sum(f.startswith(b"COHORT_FP") for f in filters) == world["blacklisted"]


def test_cg_insertions_and_hpol_runs_through_the_engine(world, tmp_path, monkeypatch):
    """--blacklist_cg_insertions reads the scan's allele classes and REF
    lengths (no REF/ALT strings), on the host gather."""
    d = world["dir"]
    (d / "runs.bed").write_text("chr1\t1000\t1015\nchr1\t5000\t5012\nchr2\t2000\t2005\n")
    extra = ("--blacklist_cg_insertions", "--runs_file", str(d / "runs.bed"))
    want = fixtures.strip_vctpu_header(_reference(world, extra=extra))
    got = {}
    for engine in ("native", "plain"):
        got[engine], calls = _port(world, tmp_path, monkeypatch, engine, extra=extra)
        _served(calls, engine, {"vcf_parse", "gather_windows_contig", "vcf_assemble"})
    assert got["native"] == got["plain"] and fixtures.strip_vctpu_header(got["native"]) == want


@pytest.mark.parametrize("contig", ["chr1", "chr2"])
def test_limit_to_contig_carries_the_scan(world, tmp_path, monkeypatch, contig):
    """The row subset keeps the scan's arrays aligned: the writeback still
    splices natively, and only the contig's records are written."""
    extra = ("--limit_to_contig", contig)
    want = fixtures.strip_vctpu_header(_reference(world, extra=extra))
    got = {}
    for engine in ("native", "plain"):
        got[engine], calls = _port(world, tmp_path, monkeypatch, engine, extra=extra)
        _served(calls, engine, {"vcf_parse", "vcf_assemble"})
    assert got["native"] == got["plain"] and fixtures.strip_vctpu_header(got["native"]) == want
    records = [ln for ln in got["native"].split(b"\n") if ln and not ln.startswith(b"#")]
    assert records and all(ln.startswith(contig.encode() + b"\t") for ln in records)


def test_malformed_record_runs_on_the_plain_path(world, tmp_path, monkeypatch, caplog):
    """A record cut to 7 columns: the scan declines (counted), and the run
    writes the bytes of the plain path."""
    lines = (world["dir"] / "calls.vcf").read_bytes().split(b"\n")
    first = next(i for i, ln in enumerate(lines) if ln and not ln.startswith(b"#"))
    lines[first + 5] = b"\t".join(lines[first + 5].split(b"\t")[:7])
    (world["dir"] / "malformed.vcf").write_bytes(b"\n".join(lines))
    native_bytes, calls = _port(world, tmp_path, monkeypatch, "native", input_name="malformed.vcf")
    assert calls["vcf_parse"] == {"native": 0, "native_s": 0.0, "plain": 1} and calls["vcf_assemble"]["plain"] == 1
    plain_bytes, _ = _port(world, tmp_path, monkeypatch, "plain", input_name="malformed.vcf")
    assert native_bytes == plain_bytes
    rec = [ln for ln in native_bytes.split(b"\n") if ln and not ln.startswith(b"#")][5]
    assert rec.split(b"\t")[7].startswith(b"TREE_SCORE=")


@pytest.mark.parametrize("family", ["threshold", "dan"])
def test_families_through_the_engine(world, tmp_path, monkeypatch, caplog, family):
    """Threshold and DAN: equal bytes with and without the engine, and the
    reference's records within the family's tolerance rule."""
    kw = {"model_file": "families.pkl", "model_name": FAMILY_NAMES[family]}
    want = _reference(world, **kw)
    got = {}
    for engine in ("native", "plain"):
        got[engine], calls = _port(world, tmp_path, monkeypatch, engine, **kw)
        _served(calls, engine, {"vcf_parse", "format_float_info", "vcf_assemble"})
    assert got["native"] == got["plain"]
    n_diff = differing_records(got["native"], want, 0.5 if family == "dan" else 0.25, FAMILY_TOL[family])
    assert n_diff <= world["n_records"] // 100


def test_host_engine_is_logged_not_written(world, tmp_path, monkeypatch, caplog):
    caplog.set_level(logging.INFO, logger="variantcalling_tpu_torch")
    data, _ = _port(world, tmp_path, monkeypatch, "native")
    assert any("host engine native" in r.getMessage() for r in caplog.records)
    assert b"##vctpu_engine=torch-cpu\n" in data and b"native" not in data.split(b"#CHROM")[0]
    caplog.clear()
    _port(world, tmp_path, monkeypatch, "plain")
    assert any("host engine plain" in r.getMessage() for r in caplog.records)


def test_no_native_output_keeps_every_byte(world, tmp_path, monkeypatch):
    """The two runs' whole files, header included, are the same."""
    a, _ = _port(world, tmp_path, monkeypatch, "native", input_name="calls_crlf.vcf")
    b, _ = _port(world, tmp_path, monkeypatch, "plain", input_name="calls_crlf.vcf")
    assert a == b and a.startswith(b"##fileformat=VCFv4.2\r\n")
    assert np.sum([ln.endswith(b"\r") for ln in a.split(b"\n") if not ln.startswith(b"##")]) == 0
