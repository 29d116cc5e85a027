"""The port's VCF read and write against the JAX package's default (native) path.

A table read and written back by the port must give the bytes of the JAX
package's ``read_vcf`` and ``write_vcf(verbatim_core=True)`` (the filter
pipeline's writeback: CHROM..QUAL spliced as read) on files with GATK-style
QUAL, CRLF line ends, empty lines and ``#`` lines among the records, a lone
``\\r`` inside a record, and bytes that are not UTF-8 in a header line; in
one block or many. A QUAL that was edited is rendered by ``format_qual``.
"""

import gzip

import numpy as np
import pytest

from variantcalling_tpu import native
from variantcalling_tpu.io import vcf as jvcf
from variantcalling_tpu_torch.io import vcf as tvcf

HEADER = (b"##fileformat=VCFv4.2\n##FILTER=<ID=PASS,Description=\"All filters passed\">\n"
          b"##INFO=<ID=DP,Number=1,Type=Integer,Description=\"Depth\">\n##contig=<ID=chr1,length=100000>\n"
          b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n")


def _records(n: int = 40) -> list[bytes]:
    rng = np.random.default_rng(9)
    quals = [b"69.40", b"24240.00", b".", b"12345.67", b"50", b"7.5e1", b"0.00"]
    return [b"chr1\t%d\t.\tA\tG\t%s\tPASS\tDP=%d\tGT:GQ\t0/1:%d" % (
        100 + 10 * i, quals[i % len(quals)], rng.integers(5, 60), rng.integers(1, 99)) for i in range(n)]


CASES = {
    "gatk_qual": HEADER + b"\n".join(_records()) + b"\n",
    "crlf": (HEADER + b"\n".join(_records()) + b"\n").replace(b"\n", b"\r\n"),
    "blank_and_comment_lines": HEADER + b"\n".join(_records()[:10]) + b"\n\n#note\n##late=1\n"
                               + b"\n".join(_records()[10:]) + b"\n",
    "lone_cr_and_no_final_newline": HEADER + b"\n".join(_records()[:-1])
                                    + b"\nchr1\t999\t.\tA\tC\t1.0\tPASS\tDP=3\r\tGT\t0/1",
    "latin1_header": HEADER.replace(b"##fileformat=VCFv4.2\n", b"##fileformat=VCFv4.2\n##source=caf\xe9\n")
                     + b"\n".join(_records()) + b"\n",
    "no_tail": HEADER.replace(b"\tFORMAT\tS1", b"") + b"\n".join(r.rsplit(b"\t", 2)[0] for r in _records()) + b"\n",
}


def _write_both(tmp_path, name: str, data: bytes, suffix: str) -> tuple[bytes, bytes, tvcf.VariantTable]:
    src = tmp_path / f"{name}{suffix}"
    src.write_bytes(gzip.compress(data) if suffix == ".vcf.gz" else data)
    jt, tt = jvcf.read_vcf(str(src)), tvcf.read_vcf(str(src))
    n = len(tt)
    filters = np.asarray(["PASS", "LOW_SCORE"] * n, dtype=object)[:n]
    score = np.round(np.linspace(0, 1, n), 4)
    jvcf.write_vcf(str(tmp_path / "ref.vcf"), jt, new_filters=filters, extra_info={"TREE_SCORE": score},
                   verbatim_core=True)
    tvcf.write_vcf(str(tmp_path / "port.vcf"), tt, new_filters=filters, extra_info={"TREE_SCORE": score})
    return (tmp_path / "port.vcf").read_bytes(), (tmp_path / "ref.vcf").read_bytes(), tt


@pytest.mark.skipif(not native.available(), reason="the JAX package's native engine is not built")
@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
@pytest.mark.parametrize("block", [1 << 24, 97])
@pytest.mark.parametrize("name", sorted(CASES))
def test_read_write_bytes_equal_the_reference(tmp_path, monkeypatch, name, block, suffix):
    monkeypatch.setattr(tvcf, "_READ_BYTES", block)
    got, want, table = _write_both(tmp_path, name, CASES[name], suffix)
    assert got == want
    assert len(table) == len(_records()) and table.qual_text is not None


def test_an_edited_qual_is_rendered_and_the_rest_kept(tmp_path):
    src = tmp_path / "in.vcf"
    src.write_bytes(CASES["gatk_qual"])
    table = tvcf.read_vcf(str(src))
    quals = list(table.qual_text)
    edited = table.qual.copy()
    edited[0], edited[2] = 70.25, 3.0  # "69.40" and "."
    table.qual = edited
    sub = table.subset(np.arange(len(table)) != 1)
    tvcf.write_vcf(str(tmp_path / "out.vcf"), sub)
    got = [ln.split("\t")[5] for ln in (tmp_path / "out.vcf").read_text().splitlines() if not ln.startswith("#")]
    assert got == ["70.25", "3"] + quals[3:]
    assert tvcf.format_qual(70.25) == jvcf.format_qual(70.25) == "70.25"
