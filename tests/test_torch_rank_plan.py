"""The port's rank-partitioned filter and ``merge-ranks`` against the JAX package's.

World: ``tests/torch_worlds.write_pod_world`` (2,500 records on two contigs,
``.vcf``, BGZF ``.vcf.gz`` and plain gzip, a forest pickle both packages
load), in 16 KiB chunks, on the CPU.

- ``rank_plan.resolve`` gives the reference's plans and errors (rank, span,
  both, a rank without a count, a rank out of range, a malformed span).
- ``VcfChunkReader(rank_span=)`` and ``(span_targets=)``: the same chunks,
  ``chunk_ends`` and span sizes as the reference's reader on the same file,
  for 2, 3 and 8 ranks and for re-cut target plans, on ``.vcf`` and BGZF
  ``.vcf.gz``, at IO threads 1 and 2; the ranks tile the serial stream; plain
  gzip is refused (exit 2 through the CLI, nothing written).
- ``merge_ranks`` re-carries the BGZF block carry across seams as the
  reference does (its body sizes: seams mid-block, at a block boundary, an
  empty segment), byte for byte.
- Each package's merge takes the other's segments and writes the same bytes;
  ``merge-ranks``' exit codes and refusals are the reference's.
- Pods of 1, 2 and 4 ranks into ``.vcf`` and ``.vcf.gz``: the merged bytes
  equal the JAX package's pod's outside ``##vctpu_*`` (the
  ``##vctpu_ranks=n=N`` line in both for N > 1) and the port's single-rank
  run's.
- C7 (``ROADMAP.md``) on ``write_gatk_world`` through the CLI: a rank launch
  writes its segment and marker and never the output, ``merge-ranks`` then
  writes the single-rank records; a span launch writes its segment, marker
  and lease; a launch that cannot stream exits 2 and writes nothing.
"""

import argparse
import gzip
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import fixtures, torch_worlds
from tests.conftest import assert_no_stream_leaks
from variantcalling_tpu import engine as jengine
from variantcalling_tpu.engine import EngineError as JEngineError
from variantcalling_tpu.io import bgzf as jbgzf
from variantcalling_tpu.io import vcf as jvcf
from variantcalling_tpu.io.fasta import FastaReader as JFastaReader
from variantcalling_tpu.models.registry import load_model as jload_model
from variantcalling_tpu.parallel import rank_plan as jrp
from variantcalling_tpu.pipelines import filter_variants as fvp
from variantcalling_tpu.utils import faults as jfaults
from variantcalling_tpu_torch.__main__ import main as torch_main
from variantcalling_tpu_torch.engine import EngineError
from variantcalling_tpu_torch.io import vcf as tvcf
from variantcalling_tpu_torch.io.fasta import FastaReader
from variantcalling_tpu_torch.models import registry as tregistry
from variantcalling_tpu_torch.parallel import rank_plan as trp
from variantcalling_tpu_torch.pipelines import filter_variants as tfv
from variantcalling_tpu_torch.utils import faults

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is absent: the engine cannot be built")

CHUNK = 16 << 10


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return torch_worlds.write_pod_world(tmp_path_factory.mktemp("pod_world"))


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path, request):
    monkeypatch.setenv("VCTPU_STREAM_CHUNK_BYTES", str(CHUNK))
    monkeypatch.setenv("VCTPU_IO_BACKOFF_S", "0")
    for k in ("VCTPU_THREADS", "VCTPU_STREAM", "VCTPU_IO_THREADS", "VCTPU_CACHE", "VCTPU_RESUME",
              "VCTPU_RESUME_VERIFY", "VCTPU_FAULTS", "VCTPU_RANK", "VCTPU_NUM_PROCESSES", "VCTPU_SPAN"):
        monkeypatch.delenv(k, raising=False)
    yield
    faults.reset()
    jfaults.reset()
    jengine.reset_for_tests()
    dirs = [tmp_path] + ([request.getfixturevalue("world")["dir"]] if "world" in request.fixturenames else [])
    assert_no_stream_leaks(dirs)


def _ns(inp, out) -> argparse.Namespace:
    return argparse.Namespace(input_file=str(inp), output_file=str(out), runs_file=None,
                              hpol_filter_length_dist=[10, 10], blacklist=None, blacklist_cg_insertions=False,
                              annotate_intervals=[], flow_order="TGCA", is_mutect=False, limit_to_contig=None)


def _read(path) -> bytes:
    data = Path(path).read_bytes()
    return gzip.decompress(data) if str(path).endswith(".gz") else data


def _leftovers(out) -> list[str]:
    """Files a pod leaves beside its output: none once it committed."""
    d, base = os.path.dirname(str(out)), os.path.basename(str(out))
    return sorted(p for p in os.listdir(d) if p.startswith(base) and any(
        s in p for s in (".seg", ".done", ".lease", ".journal", ".partial", ".podrun.json", ".podlog")))


def port_stage(world, inp, out, ranks: int, span: tuple | None = None) -> list[dict]:
    """The port's workers, one after another in process: each rank (or the
    one span) through ``rank_plan.run_scaleout`` into its segment. Ranks
    share no state, so this is byte-equivalent to N processes (the
    subprocess pods are ``tests/test_torch_podrun.py``'s)."""
    model = tregistry.load_model(world["model"], world["model_name"])
    with FastaReader(world["fasta"]) as fasta:
        plans = ([trp.RankPlan(ranks=1, rank=0, source="span", reason="test", span=span)] if span is not None
                 else [trp.RankPlan(ranks=ranks, rank=r, source="env", reason="test") for r in range(ranks)])
        for plan in plans:
            ctx = tfv.FilterContext(model, fasta, torch.device("cpu"), rank_plan=plan)
            assert trp.run_scaleout(_ns(inp, out), ctx, plan=plan) == 0
    return plans


def ref_stage(world, inp, out, ranks: int) -> None:
    """The JAX package's workers, the same way, through its ``run_scaleout``."""
    model = jload_model(world["model"], world["model_name"])
    fasta = JFastaReader(world["fasta"])
    eng = jengine.resolve_for_run()
    for r in range(ranks):
        plan = jrp.RankPlan(ranks=ranks, rank=r, source="env", reason="test")
        assert jrp.run_scaleout(_ns(inp, out), model, fasta, {}, None, engine=eng, plan=plan) == 0


# -- plan resolution ---------------------------------------------------------------------------------------------


@pytest.mark.parametrize("env", [
    {}, {"VCTPU_RANK": "1", "VCTPU_NUM_PROCESSES": "4"}, {"VCTPU_RANK": "0", "VCTPU_NUM_PROCESSES": "1"},
    {"VCTPU_SPAN": "366:64195:1"}, {"VCTPU_SPAN": "0:10:0", "VCTPU_RANK": "0", "VCTPU_NUM_PROCESSES": "2"},
    {"VCTPU_RANK": "0"}, {"VCTPU_RANK": "2", "VCTPU_NUM_PROCESSES": "2"}, {"VCTPU_SPAN": "5:4:0"},
    {"VCTPU_SPAN": "1:2"},
], ids=lambda e: ",".join(f"{k[6:]}={v}" for k, v in e.items()) or "none")
def test_resolve_answers_as_the_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def outcome(resolve, error):
        try:
            p = resolve()
        except error as e:
            return "error", str(e).split(" — ")[0].split(" (")[0]
        return p.ranks, p.rank, p.source, p.span, p.gen, p.header_line()

    assert outcome(trp.resolve, EngineError) == outcome(jrp.resolve, JEngineError)


def test_output_header_records_and_strips_ranks_line():
    head = (b"##fileformat=VCFv4.2\n##vctpu_ranks=n=7\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    header, _ = tvcf.parse_header_bytes(head)
    tfv._ensure_output_header(header, "torch-cpu", "wide", "forest", trp.RankPlan(2, 1, "env", "t"))
    assert [ln for ln in header.lines if ln.startswith("##vctpu_ranks=")] == ["##vctpu_ranks=n=2"]
    for plan in (None, trp.RankPlan(1, 0, "single", "t"), trp.RankPlan(1, 0, "span", "t", span=(5, 9))):
        header, _ = tvcf.parse_header_bytes(head)
        tfv._ensure_output_header(header, "torch-cpu", "wide", "forest", plan)
        assert not [ln for ln in header.lines if ln.startswith("##vctpu_ranks=")]


# -- the span partition --------------------------------------------------------------------------------------------


def _chunks(reader) -> tuple[list[bytes], list[int], int | None]:
    raw = [bytes(memoryview(b)) if isinstance(b, np.ndarray) else bytes(b) for b, _ in reader.iter_raw()]
    return raw, list(reader.chunk_ends), reader.span_bytes


@pytest.mark.parametrize("io_threads", [1, 2])
@pytest.mark.parametrize("key", ["vcf", "vcf_gz"])
@pytest.mark.parametrize("ranks", [2, 3, 8])
def test_rank_spans_match_the_reference(world, ranks, key, io_threads):
    path = world[key]
    serial = b"".join(_chunks(tvcf.VcfChunkReader(path, chunk_bytes=CHUNK, io_threads=1))[0])
    got = []
    for r in range(ranks):
        mine = _chunks(tvcf.VcfChunkReader(path, chunk_bytes=CHUNK, io_threads=io_threads, rank_span=(r, ranks)))
        ref = _chunks(jvcf.VcfChunkReader(path, chunk_bytes=CHUNK, io_threads=io_threads, rank_span=(r, ranks)))
        assert mine == ref, f"rank {r} of {ranks}"
        got.append(b"".join(mine[0]))
    assert b"".join(got) == serial


@pytest.mark.parametrize("key", ["vcf", "vcf_gz"])
def test_recut_span_targets_match_the_reference(world, key):
    """Any monotone target plan (the rank fractions, targets mid-line, an
    empty span, a cut at a chunk end) tiles the record stream as the
    reference's reader cuts it."""
    from variantcalling_tpu.parallel import elastic as jelastic

    path = world[key]
    h, total = tvcf.scan_record_region(path)
    assert (h, total) == jvcf.scan_record_region(path)
    serial = b"".join(_chunks(tvcf.VcfChunkReader(path, chunk_bytes=CHUNK, io_threads=1))[0])
    body = total - h
    first = tvcf.VcfChunkReader(path, chunk_bytes=CHUNK, io_threads=1, span_targets=(h, total))
    ends = _chunks(first)[1]
    plans = [[(s.lo, s.hi) for s in jelastic.initial_spans(h, total, 3)],
             [(h, h + 1234), (h + 1234, h + 1234), (h + 1234, h + body // 2 + 17), (h + body // 2 + 17, total)],
             [(h, ends[2]), (ends[2], total)]]
    for plan in plans:
        got = []
        for lo, hi in plan:
            for io_threads in (1, 2):
                mine = _chunks(tvcf.VcfChunkReader(path, chunk_bytes=CHUNK, io_threads=io_threads,
                                                   span_targets=(lo, hi)))
                assert mine == _chunks(jvcf.VcfChunkReader(path, chunk_bytes=CHUNK, io_threads=io_threads,
                                                           span_targets=(lo, hi))), (lo, hi, io_threads)
            got.append(b"".join(mine[0]))
        assert b"".join(got) == serial, plan


@pytest.mark.parametrize("slack", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_contig_spans_equal_the_references(world, n, slack):
    """The serving fabric's contig-aware plan: the same spans, tiling the
    record region."""
    got = trp.contig_spans(world["vcf"], n, slack=slack)
    assert got == jrp.contig_spans(world["vcf"], n, slack=slack)
    h, total = tvcf.scan_record_region(world["vcf"])
    assert got[0][0] == h and got[-1][1] == total and all(a[1] == b[0] for a, b in zip(got, got[1:]))


def test_plain_gzip_is_refused_as_the_reference_refuses_it(world, tmp_path, monkeypatch):
    path = world["plain_gz"]
    for kw in ({"rank_span": (0, 2)}, {"span_targets": (0, 1000)}):
        with pytest.raises(EngineError, match="BGZF-framed"):
            tvcf.VcfChunkReader(path, **kw)
        with pytest.raises(JEngineError, match="BGZF-framed"):
            jvcf.VcfChunkReader(path, **kw)
    with pytest.raises(EngineError, match="BGZF-framed"):
        tvcf.scan_record_region(path)
    assert len(list(tvcf.VcfChunkReader(path, io_threads=1).iter_raw())) > 0  # single-rank reads stay fine
    monkeypatch.setenv("VCTPU_RANK", "1")
    monkeypatch.setenv("VCTPU_NUM_PROCESSES", "2")
    out = tmp_path / "o.vcf"
    assert torch_main(["filter_variants_pipeline", *_argv(world, path, out)]) == 2
    assert os.listdir(tmp_path) == []


def _argv(world, inp, out) -> list[str]:
    return ["--input_file", str(inp), "--model_file", world["model"], "--model_name", world["model_name"],
            "--reference_file", world["fasta"], "--output_file", str(out), "--backend", "cpu"]


# -- the merge -------------------------------------------------------------------------------------------------------


def _stage_bodies(rp, out: str, bodies: list[bytes], ident: dict, header=b"##fileformat=VCFv4.2\n#CHROM\tPOS\n"):
    ranks = len(bodies)
    for r, bo in enumerate(bodies):
        seg = rp.segment_path(out, r, ranks)
        Path(seg).write_bytes(header + bo)
        rp.write_marker(seg, dict(ident, ranks=[r, ranks]), {"n": 1, "n_pass": 1, "chunks": 1})


@pytest.mark.parametrize("body_sizes", [(100_000, 70_001, 3), (jbgzf.MAX_BLOCK_DATA * 2, 65_279, 65_281),
                                        (50_000, 0, 50_001)])
def test_merge_recarries_bgzf_seams_as_the_reference(tmp_path, body_sizes):
    rng = np.random.default_rng(7)
    bodies = []
    for n in body_sizes:
        b = bytes(rng.integers(33, 126, size=n, dtype=np.uint8)) if n else b""
        bodies.append(b[:-1] + b"\n" if n else b"")
    outs = {}
    for name, rp in (("port", trp), ("ref", jrp)):
        (tmp_path / name).mkdir()
        out = str(tmp_path / name / "merged.vcf.gz")
        _stage_bodies(rp, out, bodies, {"k": 1})
        rp.merge_ranks(out, len(bodies))
        outs[name] = Path(out).read_bytes()
        assert _leftovers(out) == []
    serial = tmp_path / "serial.vcf.gz"
    with jbgzf.BgzfWriter(str(serial)) as w:
        w.write(b"##fileformat=VCFv4.2\n#CHROM\tPOS\n")
        for bo in bodies:
            w.write(bo)
    assert outs["port"] == outs["ref"] == serial.read_bytes()


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
def test_each_merge_takes_the_others_segments(world, tmp_path, suffix):
    """The JAX package's segments merged by the port write the reference's
    merged bytes, and the port's segments merged by the reference write the
    port's."""
    def twice(stage, name):
        a, b = tmp_path / f"{name}_a", tmp_path / f"{name}_b"
        a.mkdir()
        stage(world, world["vcf"], a / f"o{suffix}", 3)
        shutil.copytree(a, b, dirs_exist_ok=True)
        return a / f"o{suffix}", b / f"o{suffix}"

    ref_a, ref_b = twice(ref_stage, "ref")
    trp.merge_ranks(str(ref_a), 3)
    jrp.merge_ranks(str(ref_b), 3)
    assert ref_a.read_bytes() == ref_b.read_bytes()
    port_a, port_b = twice(port_stage, "port")
    jrp.merge_ranks(str(port_a), 3)
    trp.merge_ranks(str(port_b))  # the rank count found on disk
    assert port_a.read_bytes() == port_b.read_bytes()
    assert fixtures.strip_vctpu_header(_read(port_a)) == fixtures.strip_vctpu_header(_read(ref_a))
    if suffix == ".vcf.gz":
        assert Path(f"{port_a}.tbi").read_bytes() == Path(f"{port_b}.tbi").read_bytes()
    for out in (ref_a, ref_b, port_a, port_b):
        assert _leftovers(out) == []


def _merge_case(rp, out: str, case: str) -> list[str]:
    """Stage the segments of ``case`` beside ``out``; the ``merge-ranks`` argv."""
    if case == "none":
        return [out]
    _stage_bodies(rp, out, [b"a\n", b"b\n"], {"k": 1})
    seg1 = rp.segment_path(out, 1, 2)
    if case == "missing":
        os.remove(seg1)
    elif case == "drift":
        rp.write_marker(seg1, {"k": 2, "ranks": [1, 2]}, {"n": 1, "n_pass": 1, "chunks": 1})
    elif case == "header":
        Path(seg1).write_bytes(b"##fileformat=VCFv4.3\n#CHROM\tPOS\nb\n")
        rp.write_marker(seg1, {"k": 1, "ranks": [1, 2]}, {"n": 1, "n_pass": 1, "chunks": 1})
    elif case == "marker":
        os.remove(rp.marker_path(seg1))
    elif case == "torn":
        with open(seg1, "ab") as fh:
            fh.write(b"x\n")
    elif case == "mixed":  # leftovers of a launch of another rank count
        _stage_bodies(rp, out, [b"a\n", b"b\n", b"c\n"], {"k": 1})
    return {"ok": [out, "--ranks", "2"], "keep": [out, "--keep-segments"], "ranks0": [out, "--ranks", "0"],
            "count": [out, "--ranks", "3"]}.get(case, [out])


@pytest.mark.parametrize("case", ["ok", "keep", "none", "missing", "drift", "header", "marker", "torn", "ranks0",
                                  "count", "mixed"])
def test_merge_ranks_answers_as_the_reference(tmp_path, capsys, case):
    got = {}
    for name, rp in (("port", trp), ("ref", jrp)):
        (tmp_path / name).mkdir()
        out = str(tmp_path / name / "o.vcf")
        rc = rp.run(_merge_case(rp, out, case))
        err = capsys.readouterr().err
        got[name] = (rc, err.split(" — ")[0].split(" (")[0].replace(str(tmp_path / name), "D"),
                     os.path.exists(out) and Path(out).read_bytes(), sorted(os.listdir(tmp_path / name)))
    assert got["port"] == got["ref"]
    assert got["port"][0] == {"ok": 0, "keep": 0, "ranks0": 2}.get(case, 3)


def test_a_relaunched_rank_skips_its_sealed_segment(world, tmp_path, caplog):
    out = tmp_path / "o.vcf"
    port_stage(world, world["vcf"], out, 2)
    seg = trp.segment_path(str(out), 0, 2)
    before = Path(seg).read_bytes(), Path(trp.marker_path(seg)).read_bytes()
    caplog.set_level("INFO")
    port_stage(world, world["vcf"], out, 2)
    assert caplog.text.count("segment already complete") == 2
    assert (Path(seg).read_bytes(), Path(trp.marker_path(seg)).read_bytes()) == before
    with open(seg, "ab") as fh:  # a torn segment is recomputed
        fh.write(b"x")
    assert trp.valid_segment(seg, json.loads(Path(trp.marker_path(seg)).read_text())["identity"]) is None
    trp.discard_segments(str(out))
    assert _leftovers(out) == []


# -- pod parity ------------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_pods_equal_the_references_and_the_single_rank_run(world, tmp_path, ranks, suffix):
    """Into ``.vcf`` from the ``.vcf`` input, into ``.vcf.gz`` from the BGZF one."""
    inp = world["vcf"] if suffix == ".vcf" else world["vcf_gz"]
    single = tmp_path / f"single{suffix}"
    assert torch_main(["filter_variants_pipeline", *_argv(world, inp, single)]) == 0
    port, ref = tmp_path / f"port{suffix}", tmp_path / f"ref{suffix}"
    port_stage(world, inp, port, ranks)
    stats = trp.merge_ranks(str(port), ranks)
    ref_stage(world, inp, ref, ranks)
    jrp.merge_ranks(str(ref), ranks)
    assert stats["n"] == world["n"] and stats["ranks"] == ranks
    got, want = _read(port), _read(ref)
    assert fixtures.strip_vctpu_header(got) == fixtures.strip_vctpu_header(want)
    assert fixtures.strip_vctpu_header(got) == fixtures.strip_vctpu_header(_read(single))
    line = f"##vctpu_ranks=n={ranks}".encode()
    assert (line in got) == (line in want) == (ranks > 1)
    if suffix == ".vcf.gz":
        assert Path(f"{port}.tbi").exists()
    assert _leftovers(port) == _leftovers(ref) == []


# -- C7: a rank or span launch of the filter CLI ------------------------------------------------------------------


@pytest.fixture(scope="module")
def gatk(tmp_path_factory):
    return torch_worlds.write_gatk_world(tmp_path_factory.mktemp("c7_gatk"))


def _gatk_argv(gatk, out) -> list[str]:
    d = gatk["dir"]
    return ["--input_file", str(d / "calls.vcf"), "--model_file", str(d / "model.pkl"), "--model_name",
            "rf_model_ignore_gt_incl_hpol_runs", "--reference_file", str(d / "ref.fa"), "--output_file", str(out),
            "--backend", "cpu"]


def test_c7_rank_launches_stage_segments_and_merge_ranks_commits(gatk, tmp_path, monkeypatch):
    single = tmp_path / "single.vcf"
    assert torch_main(["filter_variants_pipeline", *_gatk_argv(gatk, single)]) == 0
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    monkeypatch.setenv("VCTPU_NUM_PROCESSES", "2")
    for r in (0, 1):
        monkeypatch.setenv("VCTPU_RANK", str(r))
        assert torch_main(["filter_variants_pipeline", *_gatk_argv(gatk, tmp_path / "port" / "o.vcf")]) == 0
        assert fvp.run(_gatk_argv(gatk, tmp_path / "ref" / "o.vcf")) == 0
        assert not (tmp_path / "port" / "o.vcf").exists()
    staged = ["o.vcf.rank0of2.seg", "o.vcf.rank0of2.seg.done", "o.vcf.rank1of2.seg", "o.vcf.rank1of2.seg.done"]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "ref")) == staged
    monkeypatch.delenv("VCTPU_RANK")
    monkeypatch.delenv("VCTPU_NUM_PROCESSES")
    assert torch_main(["merge-ranks", str(tmp_path / "port" / "o.vcf")]) == 0
    got = (tmp_path / "port" / "o.vcf").read_bytes()
    records = [ln for ln in got.split(b"\n") if ln and not ln.startswith(b"#")]
    assert len(records) == len([ln for ln in single.read_bytes().split(b"\n") if ln and not ln.startswith(b"#")])
    assert fixtures.strip_vctpu_header(got) == fixtures.strip_vctpu_header(single.read_bytes())
    assert b"##vctpu_ranks=n=2" in got
    assert sorted(os.listdir(tmp_path / "port")) == ["o.vcf"]
    jrp.discard_segments(str(tmp_path / "ref" / "o.vcf"))


def test_c7_a_span_launch_writes_its_segment_marker_and_lease(gatk, tmp_path, monkeypatch):
    monkeypatch.setenv("VCTPU_SPAN", "0:20000:1")
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    assert torch_main(["filter_variants_pipeline", *_gatk_argv(gatk, tmp_path / "port" / "o.vcf")]) == 0
    assert fvp.run(_gatk_argv(gatk, tmp_path / "ref" / "o.vcf")) == 0
    want = ["o.vcf.span0-20000.seg", "o.vcf.span0-20000.seg.done", "o.vcf.span0-20000.seg.lease.g1"]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "ref")) == want
    seg = "o.vcf.span0-20000.seg"
    assert (tmp_path / "port" / seg).read_bytes().split(b"\n#CHROM")[1] == \
        (tmp_path / "ref" / seg).read_bytes().split(b"\n#CHROM")[1]
    # the lease is held: a second offer of the same generation yields (exit 6)
    assert torch_main(["filter_variants_pipeline", *_gatk_argv(gatk, tmp_path / "port" / "o.vcf")]) == 6


@pytest.mark.parametrize("env,extra", [({"VCTPU_THREADS": "1"}, ()), ({"VCTPU_STREAM": "0"}, ()),
                                       ({}, ("--limit_to_contig", "chr1")), ({"VCTPU_NO_NATIVE": "1"}, ())])
@pytest.mark.parametrize("launch", [{"VCTPU_RANK": "1", "VCTPU_NUM_PROCESSES": "2"}, {"VCTPU_SPAN": "0:20000:0"}])
def test_c7_a_launch_that_cannot_stream_exits_2_and_writes_nothing(gatk, tmp_path, monkeypatch, caplog, env,
                                                                    extra, launch):
    for k, v in {**env, **launch}.items():
        monkeypatch.setenv(k, v)
    assert torch_main(["filter_variants_pipeline", *_gatk_argv(gatk, tmp_path / "o.vcf"), *extra]) == 2
    assert "cannot run the rank-partitioned streaming executor" in caplog.text
    assert os.listdir(tmp_path) == []
