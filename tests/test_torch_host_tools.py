"""The host-only tools of the port against the JAX package's, on the CPU.

Each tool runs from both packages on the same seeded input
(``synthetic_tools``, ``synthetic.write_world``) and is held exactly:

- ``ppmseq_qc``: the h5 (keys, stored kinds, values), also on hand-built
  records whose tags are lowercase, empty, non-ASCII, repeated, of other
  types or cut short by an unknown type;
- ``find_adapter_coords`` on 2,000 reads (both adapters and UMIs, each
  alone, a short adapter), the inflated BAM bytes; the batched matcher
  against the JAX package's ``find_left``/``find_right``/``analyze_read``
  on hypothesis-drawn reads and adapters (truncated, all adapter, empty,
  longer than the read, UMIs on either side);
- ``add_ml_tags_bam`` on ``.npy`` and ``.bin`` tensors, with and without
  ``--regressed_key``, the inflated BAM bytes;
- ``collect_hpol_table``, ``annotate_contig`` (plain, bgzipped, through a
  ``.tbi`` with ``--contig``), ``intersect_bed_regions``,
  ``index_vcf_file`` (``.vcf``, a CRLF ``.vcf``, ``.vcf.gz``),
  ``remove_vcf_duplicates``, ``remove_empty_files`` and ``cloud_sync`` (a
  local path, a stub ``gsutil`` on ``PATH``, no CLI at all): file bytes and
  printed lines.
"""

import contextlib
import gzip
import importlib
import io
import os
import shutil
import struct
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import variantcalling_tpu.__main__ as jmain
import variantcalling_tpu_torch.__main__ as tmain
from tests.torch_report_compare import store_problems
from variantcalling_tpu.pipelines import find_adapter_coords as jfind
from variantcalling_tpu_torch import synthetic, synthetic_tools
from variantcalling_tpu_torch.pipelines import find_adapter_coords as tfind


def _run(pkg: str, tool: str, argv: list[str]) -> tuple[int, str]:
    module = importlib.import_module((jmain if pkg == "jax" else tmain).TOOLS[tool])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.run(argv)
    return rc, out.getvalue()


def _both(tmp_path: Path, tool: str, argv_of, files: list[str]) -> dict:
    """The tool from both packages, each in its own directory (``argv_of(dir)``):
    exit codes and printed lines (the directory as ``D``) equal, and each of ``files``."""
    got = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        rc, printed = _run(pkg, tool, argv_of(d))
        got[pkg] = (rc, printed.replace(str(d), "D"))
    assert got["torch"] == got["jax"]
    for name in files:
        a, b = (tmp_path / "torch" / name).read_bytes(), (tmp_path / "jax" / name).read_bytes()
        if name.endswith(".bam"):
            a, b = gzip.decompress(a), gzip.decompress(b)
        assert a == b, name
    return {pkg: tmp_path / pkg for pkg in got}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("host_tools")
    w = synthetic.write_world(str(d / "w"), seed=7, length=2_000_000, n_variants=4_000, n_trees=3, depth=3)
    return {
        **w,
        "dir": d,
        "beds": synthetic_tools.write_region_beds(str(d / "beds"), seed=7, contig="chr20", length=2_000_000,
                                                  n=3, n_intervals=300),
        "hpol_bed": synthetic_tools.write_hpol_bed(str(d / "h.bed"), seed=7, contig="chr20", length=2_000_000,
                                                   n_intervals=80, total_bp=800_000),
        "reads": synthetic_tools.write_read_world(str(d / "reads"), seed=7, n_reads=2_000),
    }


# -- ppmseq_qc -----------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--max_reads", "777"], ["--start_tag", "ae", "--end_tag", "as"]])
def test_ppmseq_qc_equals_the_reference(world, tmp_path, extra):
    out = _both(tmp_path, "ppmseq_qc", lambda d: ["--input_bam", world["reads"]["bam"], "--output_h5",
                                                  str(d / "q.h5"), *extra], [])
    assert not store_problems(str(out["torch"] / "q.h5"), str(out["jax"] / "q.h5"))


def test_ppmseq_qc_crosstab_counts_the_drawn_tags(world, tmp_path):
    from variantcalling_tpu_torch.pipelines import ppmseq_qc

    r = world["reads"]
    cross = ppmseq_qc.categorize(r["bam"], "as", "ae")
    want = np.zeros((6, 6), dtype=np.int64)
    np.add.at(want, (r["cat_start"], r["cat_end"]), 1)
    assert (cross == want).all()


def _odd_tag_bam(path: str) -> None:
    """Reads whose tags test the categorization's corners."""
    values = [b"asZmixed\x00aeZPlus\x00", b"asZ\x00aeZ\x00", b"asZM\xc4\xb1XED\x00aeZMIX\xc3\xa9D\x00",
              b"asZMINUS\x00asZPLUS\x00aeZPLUS\x00", b"asi\x05\x00\x00\x00aeAM", b"asZUNDETERMINEDX\x00",
              b"asq\x01aeZMIXED\x00", b"aeBc\x02\x00\x00\x00\x01\x02asZEND_UNREACHED\x00", b"xxZMIXED\x00",
              b"asHMISSING\x00aeZmissing\x00", b"asZMI\xc3\x9fING\x00", b""]
    seq = np.frombuffer(b"ACGT" * 5, np.uint8)[None, :].repeat(len(values), axis=0)
    synthetic_tools._write_bgzf(path, synthetic_tools._ubam_header(), synthetic_tools.ubam_records(seq, "o", values))


def test_ppmseq_qc_odd_tags_equal_the_reference(tmp_path):
    _odd_tag_bam(str(tmp_path / "odd.bam"))
    out = _both(tmp_path, "ppmseq_qc", lambda d: ["--input_bam", str(tmp_path / "odd.bam"), "--output_h5",
                                                  str(d / "q.h5")], [])
    assert not store_problems(str(out["torch"] / "q.h5"), str(out["jax"] / "q.h5"))


# -- find_adapter_coords -------------------------------------------------------------------------------------------

ADAPTER_ARGS = {
    "both": ["--left_adapter", synthetic_tools.LEFT_ADAPTER, "--right_adapter", synthetic_tools.RIGHT_ADAPTER,
             "--left_umi_length", "8", "--right_umi_length", "6"],
    "left": ["--left_adapter", synthetic_tools.LEFT_ADAPTER, "--left_umi_length", "8", "--error_rate_5p", "0.1"],
    "right": ["--right_adapter", synthetic_tools.RIGHT_ADAPTER, "--right_umi_length", "5", "--min_overlap_3p", "3"],
    "short": ["--right_adapter", "AGATCGG", "--left_adapter", "CTACAC"],
    "none": [],
}


@pytest.mark.parametrize("case", list(ADAPTER_ARGS))
def test_find_adapter_coords_equals_the_reference(world, tmp_path, case):
    _both(tmp_path, "find_adapter_coords", lambda d: ["--input_bam", world["reads"]["bam"], "--output_bam",
                                                      str(d / "a.bam"), *ADAPTER_ARGS[case]], ["a.bam"])


def test_find_adapter_coords_finds_the_planted_adapters(world):
    from variantcalling_tpu_torch.io import bam

    r = world["reads"]
    buf = bam.read_stream(r["bam"])
    starts, sizes = bam.record_offsets(buf, bam.header_end(buf))
    reads = bam.sequence_letters(buf, bam.record_layout(buf, starts, sizes)["seq"], 200)
    args = SimpleNamespace(left_adapter=synthetic_tools.LEFT_ADAPTER, right_adapter="", error_rate_5p=0.15,
                           error_rate_3p=0.2, min_overlap_5p=5, min_overlap_3p=5, left_umi_length=8,
                           right_umi_length=0)
    xf, _, rx, _ = tfind.analyze_reads(reads, args)
    full = (r["left_end"] > 0) & ~r["truncated"]
    hit = xf[full] == r["left_end"][full] + 8 + 1
    assert hit.mean() >= 0.99
    umis = r["umi"][full][hit]
    assert (rx[full][hit] == umis).all()


_BASE = st.sampled_from("ACGTN")


def _text(min_size=0, max_size=60):
    return st.text(alphabet="ACGTN", min_size=min_size, max_size=max_size)


@st.composite
def _read_and_adapter(draw):
    adapter = draw(_text(0, 30))
    body = draw(_text(0, 80))
    shape = draw(st.sampled_from(["random", "left", "truncated", "right", "all_adapter", "inner"]))
    if shape == "left":
        read = adapter + body
    elif shape == "truncated":
        read = adapter[draw(st.integers(0, max(len(adapter), 0))):] + body
    elif shape == "right":
        read = body + adapter[:draw(st.integers(0, len(adapter)))]
    elif shape == "all_adapter":
        read = (adapter * 3)[:draw(st.integers(0, 3 * len(adapter)))]
    elif shape == "inner":
        read = body[:10] + adapter + body[10:]
    else:
        read = body
    flips = draw(st.lists(st.tuples(st.integers(0, 200), _BASE), max_size=4))
    chars = list(read)
    for at, b in flips:
        if chars:
            chars[at % len(chars)] = b
    return "".join(chars), adapter


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_read_and_adapter(), st.sampled_from([0.0, 0.1, 0.15, 0.2, 0.3]), st.integers(1, 8))
def test_batched_matcher_equals_the_reference_rule(case, rate, min_overlap):
    read, adapter = case
    reads = np.frombuffer(read.encode(), np.uint8)[None, :]
    r, a = jfind._encode(read), jfind._encode(adapter)
    assert tfind.match_left(reads, adapter, rate, min_overlap)[0] == jfind.find_left(r, a, rate, min_overlap)
    assert tfind.match_right(reads, adapter, rate, min_overlap)[0] == jfind.find_right(r, a, rate, min_overlap)


@settings(max_examples=120, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(_read_and_adapter(), min_size=1, max_size=12), _text(0, 12), _text(0, 12), st.integers(0, 6),
       st.integers(0, 6), st.sampled_from([0.0, 0.15, 0.2]), st.integers(1, 6), st.integers(0, 40))
def test_batched_reads_equal_analyze_read(cases, left, right, lu, ru, rate, overlap, length):
    """Reads cut or padded to one length, through :func:`analyze_reads`, against the reference's ``analyze_read``."""
    seqs = [(s + "ACGT" * 20)[:length] for s, _ in cases]
    args = SimpleNamespace(left_adapter=left, right_adapter=right, error_rate_5p=rate, error_rate_3p=rate,
                           min_overlap_5p=overlap, min_overlap_3p=overlap, left_umi_length=lu, right_umi_length=ru)
    reads = np.frombuffer("".join(seqs).encode(), np.uint8).reshape(len(seqs), length)
    xf, xt, rx, rx_len = tfind.analyze_reads(reads, args)
    for i, s in enumerate(seqs):
        want = jfind.analyze_read(s, args)
        got_rx = None if rx_len[i] < 0 else bytes(rx[i, :rx_len[i]]).decode()
        assert (int(xf[i]), int(xt[i]), got_rx) == want
        assert tfind.analyze_read(s, args) == want  # the port's plain spec is the reference's


# -- add_ml_tags_bam -----------------------------------------------------------------------------------------------


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("regressed", [False, True])
def test_add_ml_tags_bam_equals_the_reference(tmp_path, binary, regressed):
    w = synthetic_tools.write_ml_world(str(tmp_path / "w"), seed=8, n_reads=700, n_flows=48, n_classes=11,
                                       bin_tensor=binary)
    extra = (["--n_flows", "48", "--n_classes", "11"] if binary else []) + \
        (["--regressed_key", w["key"]] if regressed else [])
    _both(tmp_path, "add_ml_tags_bam", lambda d: ["--probability_tensor", w["probs"], "--input_ubam", w["bam"],
                                                  "--output_ubam", str(d / "m.bam"), *extra], ["m.bam"])


def test_block_tags_equal_read_tags():
    from variantcalling_tpu_torch.pipelines import add_ml_tags_bam as t

    rng = np.random.default_rng(9)
    probs = rng.random((40, 30, 7), dtype=np.float32) ** 4
    probs[:, ::5, 2] = 0.003  # at the threshold exactly
    key = rng.normal(2, 2, (40, 30)).astype(np.float32)
    assert t.block_tags(probs, key, 0.003, 10.0) == [t.read_tags(probs[i], key[i], 0.003, 10.0) for i in range(40)]


# -- the reference and interval tools ------------------------------------------------------------------------------


def test_collect_hpol_table_equals_the_reference(world, tmp_path):
    _both(tmp_path, "collect_hpol_table", lambda d: ["--reference", world["fasta"], "--collection_regions",
                                                     world["hpol_bed"], "--output", str(d / "h.tsv"),
                                                     "--max_number_to_collect", "4000", "--max_hpol_length", "12"],
          ["h.tsv"])


def test_collect_hpol_table_skips_contigs_the_reference_lacks(world, tmp_path):
    bed = tmp_path / "mixed.bed"
    bed.write_text(Path(world["hpol_bed"]).read_text()[:2000].rsplit("\n", 1)[0] + "\nchrUn\t0\t5000\n")
    _both(tmp_path, "collect_hpol_table", lambda d: ["--reference", world["fasta"], "--collection_regions",
                                                     str(bed), "--output", str(d / "h.tsv")], ["h.tsv"])


@pytest.mark.parametrize("output", ["a.vcf", "a.vcf.gz"])
def test_annotate_contig_equals_the_reference(world, tmp_path, output):
    files = [output] + ([output + ".tbi"] if output.endswith(".gz") else [])
    _both(tmp_path, "annotate_contig", lambda d: ["--input_vcf", world["vcf"], "--output_vcf", str(d / output),
                                                  "--annotate_intervals", *world["beds"][:2], "--contig", "chr20"],
          files)


def test_annotate_contig_reads_one_contig_through_the_index(world, tmp_path):
    """A bgzipped input with its ``.tbi``: the contig's records through the
    index give the plain input's output (the reference's bin walk of the
    open region runs out of memory here; the port clamps it)."""
    shutil.copy(world["vcf"], tmp_path / "c.vcf")
    assert _run("torch", "index_vcf_file", [str(tmp_path / "c.vcf")])[0] == 0
    argv = ["--annotate_intervals", *world["beds"], "--contig", "chr20"]
    assert _run("torch", "annotate_contig", ["--input_vcf", str(tmp_path / "c.vcf.gz"), "--output_vcf",
                                             str(tmp_path / "i.vcf"), *argv])[0] == 0
    assert _run("jax", "annotate_contig", ["--input_vcf", world["vcf"], "--output_vcf", str(tmp_path / "p.vcf"),
                                           *argv])[0] == 0
    assert (tmp_path / "i.vcf").read_bytes() == (tmp_path / "p.vcf").read_bytes()


@pytest.mark.parametrize("exclude", [False, True])
def test_intersect_bed_regions_equals_the_reference(world, tmp_path, exclude):
    b = world["beds"]
    _both(tmp_path, "intersect_bed_regions", lambda d: ["--include-regions", b[0], b[1], "--output-bed",
                                                        str(d / "o.bed"), *(["--exclude-regions", b[2]] if exclude
                                                                           else [])], ["o.bed"])


@pytest.mark.parametrize("kind", ["vcf", "crlf", "gz"])
def test_index_vcf_file_equals_the_reference(world, tmp_path, kind):
    text = Path(world["vcf"]).read_bytes()

    def argv(d):
        if kind == "gz":
            from variantcalling_tpu_torch.io.bgzf import BgzfWriter

            with BgzfWriter(str(d / "c.vcf.gz")) as out:
                out.write(text)
        else:
            (d / "c.vcf").write_bytes(text.replace(b"\n", b"\r\n") if kind == "crlf" else text)
        return [str(d / ("c.vcf.gz" if kind == "gz" else "c.vcf"))]

    _both(tmp_path, "index_vcf_file", argv, ["c.vcf.gz", "c.vcf.gz.tbi"])


@pytest.mark.parametrize("output", ["o.vcf", "o.vcf.gz"])
def test_remove_vcf_duplicates_equals_the_reference(world, tmp_path, output):
    dup = synthetic_tools.write_dup_vcf(str(tmp_path / "dup.vcf"), world["vcf"], seed=7, n_dups=40)
    files = [output] + ([output + ".tbi"] if output.endswith(".gz") else [])
    out = _both(tmp_path, "remove_vcf_duplicates", lambda d: [dup["vcf"], str(d / output)], files)
    data = (out["torch"] / output).read_bytes()
    text = gzip.decompress(data) if output.endswith(".gz") else data
    assert len([ln for ln in text.split(b"\n") if ln and not ln.startswith(b"#")]) == len(dup["records"])


@pytest.mark.parametrize("dry_run", [False, True])
def test_remove_empty_files_equals_the_reference(tmp_path, dry_run):
    def argv(d):
        w = synthetic_tools.write_empty_files(str(d / "f"), seed=7, n=30, n_empty=9)
        return [*w["paths"], str(d / "absent.txt"), *(["--dry_run"] if dry_run else [])]

    out = _both(tmp_path, "remove_empty_files", argv, [])
    assert sorted(os.listdir(out["torch"] / "f")) == sorted(os.listdir(out["jax"] / "f"))
    assert len(os.listdir(out["torch"] / "f")) == (30 if dry_run else 21)


def _stub_gsutil(bin_dir: Path, source: Path) -> None:
    bin_dir.mkdir()
    stub = bin_dir / "gsutil"
    stub.write_text(f"#!/bin/sh\n# gsutil -q cp URI DEST: copies {source}\ncp '{source}' \"$4\"\n")
    stub.chmod(0o755)


def test_cloud_sync_local_path_passes_through(world, tmp_path):
    _both(tmp_path, "cloud_sync", lambda d: [world["vcf"], "--cache_dir", str(d / "cache")], [])


def test_cloud_sync_localizes_through_a_stub_cli(world, tmp_path, monkeypatch):
    _stub_gsutil(tmp_path / "bin", Path(world["vcf"]))
    monkeypatch.setenv("PATH", str(tmp_path / "bin") + os.pathsep + os.environ.get("PATH", ""))
    out = _both(tmp_path, "cloud_sync", lambda d: ["gs://bucket/dir/calls.vcf", "--cache_dir", str(d / "cache")],
                [])
    cached = out["torch"] / "cache" / "gs" / "bucket" / "dir" / "calls.vcf"
    assert cached.read_bytes() == Path(world["vcf"]).read_bytes()


def test_cloud_sync_without_a_cli_fails_as_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    errors = {}
    for pkg in ("jax", "torch"):
        with pytest.raises(RuntimeError) as e:
            _run(pkg, "cloud_sync", ["gs://bucket/x.vcf", "--cache_dir", str(tmp_path / pkg)])
        errors[pkg] = str(e.value).split("(")[0]
    assert errors["torch"] == errors["jax"] == "could not localize gs://bucket/x.vcf: no working cloud CLI "


def test_cloud_timeout_knob_is_honoured(tmp_path, monkeypatch):
    from variantcalling_tpu_torch import knobs
    from variantcalling_tpu_torch.utils import cloud

    seen = {}

    def fake_run(cmd, **kw):
        seen["timeout"] = kw["timeout"]
        raise OSError("no CLI")

    monkeypatch.setattr(cloud.subprocess, "run", fake_run)
    monkeypatch.setenv("VCTPU_CLOUD_TIMEOUT", "17")
    assert "VCTPU_CLOUD_TIMEOUT" in knobs.HONOURED
    assert cloud.optional_cloud_sync("s3://b/k", str(tmp_path)) == "s3://b/k"
    assert seen["timeout"] == 17


def test_bam_record_helpers_round_trip(tmp_path):
    """``append_to_records`` with nothing appended gives the stream back; with
    bytes appended, every record's size and tail are as written."""
    from variantcalling_tpu_torch.io import bam

    w = synthetic_tools.write_read_world(str(tmp_path), seed=3, n_reads=50, read_len=31)
    buf = bam.read_stream(w["bam"])
    first = bam.header_end(buf)
    starts, sizes = bam.record_offsets(buf, first)
    same = bam.append_to_records(buf, first, starts, sizes, np.zeros(0, np.uint8), np.zeros(len(starts), np.int64))
    assert bytes(same) == bytes(buf)
    extra = np.frombuffer(b"".join(b"x" * (i % 3) for i in range(50)), np.uint8)
    out = bam.append_to_records(buf, first, starts, sizes, extra, np.arange(50) % 3)
    s2, z2 = bam.record_offsets(out, first)
    assert (z2 == sizes + np.arange(50) % 3).all()
    assert all(bytes(out[s + 4 + z - i % 3:s + 4 + z]) == b"x" * (i % 3) for i, (s, z) in enumerate(zip(s2, z2)))
    assert struct.unpack_from("<i", out, int(s2[-1]))[0] == z2[-1]
