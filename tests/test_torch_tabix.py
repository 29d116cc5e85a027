"""The port's ``.tbi`` against the JAX package's ``build_tabix_index`` on the same file.

The index's bytes depend on the BGZF block layout, so both indexes are
built over one ``.vcf.gz``: the port's (written by ``write_vcf``, which
indexes it) and a copy indexed by the reference. Files: the port's
writer output over three contigs (lines across block boundaries, long
deletions), and a file whose lines end exactly where its blocks end.
Region reads through the port's index (by the reference's
``read_region_lines`` and the port's) return the records that overlap the
region; ``reg2bin`` agrees; unsorted records write no index.
"""

import gzip
import shutil

import numpy as np
import pytest

from variantcalling_tpu.io import tabix as jtabix
from variantcalling_tpu_torch.io import tabix as ttabix
from variantcalling_tpu_torch.io.bgzf import MAX_BLOCK_DATA, BgzfWriter, block_spans
from variantcalling_tpu_torch.io.vcf import read_vcf, write_vcf

HEADER = ["##fileformat=VCFv4.2", "##contig=<ID=chr1,length=3000000>", "##contig=<ID=chr2,length=3000000>",
          "##contig=<ID=chrX,length=200000>", "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]


def _records(rng: np.random.Generator) -> list[str]:
    recs = []
    for contig, n, span in (("chr1", 4000, 2_900_000), ("chr2", 2500, 2_000_000), ("chrX", 300, 150_000)):
        for p in np.sort(rng.choice(np.arange(1, span), n, replace=False)):
            ref = "A" * int(rng.choice([1, 1, 1, 3, 40, 20_000 if rng.random() < 0.002 else 2]))
            recs.append(f"{contig}\t{p}\t.\t{ref}\tC\t{rng.uniform(10, 90):.2f}\tPASS\tDP={rng.integers(5, 60)}")
    return recs


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """A .vcf.gz the port's write_vcf wrote (and indexed), and its records."""
    tmp = tmp_path_factory.mktemp("torch_tabix")
    plain = tmp / "in.vcf"
    plain.write_text("\n".join([*HEADER, *_records(np.random.default_rng(3))]) + "\n")
    out = tmp / "out.vcf.gz"
    write_vcf(str(out), read_vcf(str(plain)))
    return out


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    """Lines of 64 bytes: every 65,280-byte block ends with a newline."""
    assert MAX_BLOCK_DATA % 64 == 0
    out = tmp_path_factory.mktemp("torch_tabix_aligned") / "aligned.vcf.gz"
    head = "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
    pad = "##" + "x" * (64 - len(head) % 64 - 3) + "\n"
    with BgzfWriter(str(out)) as fh:
        fh.write((head + pad).encode())
        for i in range(5000):
            line = f"chr1\t{1000 + 37 * i}\t.\tA\tC\t50\tPASS\tDP=1"
            fh.write((line + ";" + "X" * (63 - len(line) - 1) + "\n").encode())
    return out


@pytest.mark.parametrize("which", ["written", "aligned"])
def test_index_bytes_equal_reference(which, request, tmp_path):
    path = request.getfixturevalue(which)
    if which == "aligned":
        ttabix.build_tabix_index(str(path))
    assert len(block_spans(path.read_bytes())) > 3
    copy = tmp_path / "copy.vcf.gz"
    shutil.copyfile(path, copy)
    jtabix.build_tabix_index(str(copy))
    assert (tmp_path / "copy.vcf.gz.tbi").read_bytes() == (path.parent / (path.name + ".tbi")).read_bytes()


def _overlapping(path, chrom: str, beg: int, end: int) -> list[str]:
    out = []
    for ln in gzip.decompress(path.read_bytes()).decode().splitlines():
        if ln.startswith("#"):
            continue
        f = ln.split("\t")
        rb = int(f[1]) - 1
        if f[0] == chrom and rb < end and rb + max(len(f[3]), 1) > beg:
            out.append(ln)
    return out


@pytest.mark.parametrize("region", [("chr1", 0, 50_000), ("chr1", 1_000_000, 1_400_000), ("chr2", 123_456, 123_999),
                                    ("chr2", 1_990_000, 3_000_000), ("chrX", 0, 200_000), ("chr3", 0, 10)])
def test_region_reads_through_the_ports_index(written, region):
    want = _overlapping(written, *region)
    tbi = str(written) + ".tbi"
    assert list(jtabix.read_region_lines(str(written), *region, index=jtabix.TabixIndex.load(tbi))) == want
    assert list(ttabix.read_region_lines(str(written), *region, index=ttabix.TabixIndex.load(tbi))) == want
    assert list(ttabix.read_region_lines(str(written), *region)) == want
    assert region[0] == "chr3" or want


def test_reg2bin_agrees():
    rng = np.random.default_rng(9)
    beg = rng.integers(0, 1 << 29, 5000)
    end = beg + rng.choice([1, 2, 100, 1 << 14, 1 << 17, 1 << 20, 1 << 23, 1 << 26], 5000)
    for b, e in zip(beg.tolist(), end.tolist()):
        assert ttabix.reg2bin(b, e) == jtabix.reg2bin(b, e)
        assert ttabix._reg2bins(b, e) == jtabix._reg2bins(b, e)


def test_unsorted_records_write_no_index(tmp_path):
    recs = ["chr1\t500\t.\tA\tC\t50\tPASS\tDP=3", "chr1\t100\t.\tA\tC\t50\tPASS\tDP=3"]
    for name, body in (("pos", recs), ("contig", [recs[1], recs[0].replace("chr1\t500", "chr2\t5"),
                                                  recs[0]])):
        plain = tmp_path / f"{name}.vcf"
        plain.write_text("\n".join([*HEADER, *body]) + "\n")
        out = tmp_path / f"{name}.vcf.gz"
        (tmp_path / f"{name}.vcf.gz.tbi").write_bytes(b"stale")
        write_vcf(str(out), read_vcf(str(plain)))
        assert not (tmp_path / f"{name}.vcf.gz.tbi").exists()
        assert gzip.decompress(out.read_bytes()).decode() == plain.read_text()
