"""The port's chunked VCF reader against its whole-file reader and the JAX package's chunk reader.

On a three-contig synthetic world cut into 16 KiB chunks (so that chunks
cross contig boundaries), as ``.vcf``, a BGZF ``.vcf.gz`` and a plain
(single-member) gzip ``.vcf.gz``, with ``VCTPU_IO_THREADS`` 1 and 4:

- every chunk is a row slice of :func:`read_vcf`'s table, column for column,
  and the chunks together are the whole table;
- the chunk boundaries (``chunk_ends``) are the JAX package's
  ``VcfChunkReader``'s for the same file and chunk size;
- ``iter_raw`` + ``parse_chunk`` give the chunks iteration gives, and
  ``skip`` advances past chunks without parsing them.

And ``synthetic.write_world``, which takes a list of contigs, still
writes the one-contig chr20 worlds byte for byte.

Skipped where g++ is absent (the reader needs the native engine).
"""

import gzip
import shutil

import numpy as np
import pytest

from tests.conftest import assert_no_stream_leaks
from variantcalling_tpu.io import vcf as jvcf
from variantcalling_tpu_torch import synthetic
from variantcalling_tpu_torch.io import vcf as tvcf
from variantcalling_tpu_torch.io.bgzf import BgzfWriter
from variantcalling_tpu_torch.utils import faults

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is absent: the engine cannot be built")

CHUNK = 16 << 10
COLUMNS = ("chrom", "pos", "qual", "vid", "ref", "alt", "filters", "info", "tail", "qual_text")


@pytest.fixture(autouse=True)
def _no_leaks(tmp_path):
    yield
    faults.reset()
    assert_no_stream_leaks([tmp_path])


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream_reader")
    w = synthetic.write_world(str(d), seed=11, n_variants=2500, n_trees=2, depth=3,
                              contigs=[("chr1", 150_000), ("chr2", 90_000), ("chr3", 60_000)])
    text = open(w["vcf"], "rb").read()
    with BgzfWriter(str(d / "calls.bgzf.vcf.gz")) as fh:
        fh.write(text)
    (d / "calls.gzip.vcf.gz").write_bytes(gzip.compress(text))
    return {"vcf": w["vcf"], "bgzf": str(d / "calls.bgzf.vcf.gz"), "gzip": str(d / "calls.gzip.vcf.gz")}


def _chunks(path: str, io_threads: int) -> tuple[list, list[int]]:
    reader = tvcf.VcfChunkReader(path, chunk_bytes=CHUNK, io_threads=io_threads)
    try:
        tables = list(reader)
    finally:
        reader.close()
    return tables, reader.chunk_ends


@pytest.mark.parametrize("io_threads", [1, 4])
@pytest.mark.parametrize("form", ["vcf", "bgzf", "gzip"])
def test_chunks_are_row_slices_of_the_whole_table(inputs, form, io_threads):
    whole = tvcf.read_vcf(inputs[form])
    tables, ends = _chunks(inputs[form], io_threads)
    assert len(tables) >= 8 and sum(map(len, tables)) == len(whole)
    assert any(len(set(t.chrom)) > 1 for t in tables), "no chunk crosses a contig boundary"
    lo = 0
    for t in tables:
        hi = lo + len(t)
        assert t.aux is not None and t.header.samples == whole.header.samples
        for col in COLUMNS:
            np.testing.assert_array_equal(getattr(t, col), getattr(whole, col)[lo:hi], err_msg=col)
        np.testing.assert_array_equal(t.aux.gt, whole.aux.gt[lo:hi])
        np.testing.assert_array_equal(t.aux.info_vals, whole.aux.info_vals[lo:hi])
        lo = hi


@pytest.mark.parametrize("io_threads", [1, 4])
@pytest.mark.parametrize("form", ["vcf", "bgzf", "gzip"])
def test_chunk_boundaries_equal_the_references(inputs, form, io_threads):
    _, ends = _chunks(inputs[form], io_threads)
    ref = jvcf.VcfChunkReader(inputs[form], chunk_bytes=CHUNK, io_threads=io_threads)
    try:
        n_ref = sum(1 for _ in ref)
    finally:
        ref.close()
    assert ends == ref.chunk_ends and n_ref == len(ends)


@pytest.mark.parametrize("form", ["vcf", "bgzf"])
def test_raw_buffers_and_skip(inputs, form):
    tables, ends = _chunks(inputs[form], 1)
    reader = tvcf.VcfChunkReader(inputs[form], chunk_bytes=CHUNK, io_threads=1)
    try:
        reader.skip(3)
        raw = [reader.parse_chunk(*r) for r in reader.iter_raw()]
    finally:
        reader.close()
    assert len(raw) == len(tables) - 3 and reader.chunk_ends == ends
    for got, want in zip(raw, tables[3:]):
        np.testing.assert_array_equal(got.pos, want.pos)
        np.testing.assert_array_equal(got.info, want.info)


def test_a_transient_chunk_read_error_is_retried(inputs, monkeypatch):
    monkeypatch.setenv("VCTPU_IO_BACKOFF_S", "0")
    faults.arm("io.chunk_read", times=2)
    tables, _ = _chunks(inputs["vcf"], 1)
    assert faults.fired("io.chunk_read") == 2 and sum(map(len, tables)) == 2500


@pytest.mark.parametrize("seed,xgboost,vcf_sha,fasta_sha", [
    (2026, False, "d39d3f1512a01532ba3f916c480a893cb2f92d78927d42fc97c55ed0deaa97f1",
     "f75c646dd3690b5d36ad568337a79a23925a5f767b4ae36b80cdde8515eb24cb"),
    (2027, True, "41635948e5632d78eefde440c37183fbc4aee4de0fdcd5c3255d7736a5544c1a",
     "4f2bd3101844e593be12fbd3dd3d0bf404fd76c83e825cdde544a984286ac7aa"),
])
def test_the_chr20_worlds_keep_their_bytes(tmp_path, seed, xgboost, vcf_sha, fasta_sha):
    """The one-contig worlds of ``chip_smoke.py`` (104,000 variants on chr20)
    are written byte for byte as before ``write_world`` took a contig list,
    so the committed blacklists and earlier chip numbers stay comparable."""
    import hashlib

    w = synthetic.write_world(str(tmp_path), seed=seed, xgboost=xgboost, n_trees=2, depth=3)
    assert hashlib.sha256(open(w["vcf"], "rb").read()).hexdigest() == vcf_sha
    assert hashlib.sha256(open(w["fasta"], "rb").read()).hexdigest() == fasta_sha
    assert open(w["fasta"] + ".fai").read() == "chr20\t64444167\t7\t60\t61\n"
