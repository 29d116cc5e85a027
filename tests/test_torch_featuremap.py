"""The port's featuremap frame against the JAX package's pandas frame, on the CPU.

The same seeded featuremap VCFs through both ``featuremap_to_dataframe``:
every column in the same order with the same dtype, the same values and the
same NaN positions (tolerance 0), with and without ``--reference`` motifs,
through the native scan and with ``VCTPU_NO_NATIVE=1``; Integer, Float,
Flag and String INFO keys, absent keys, ``.`` INFO, ``.`` QUAL, ``.`` and
empty FILTER, multi-allelic ALT, records near a contig's ends and on a
contig missing from the FASTA. Then ``numeric_feature_columns``.
"""

import numpy as np
import pandas as pd
import pytest

from tests.fixtures import write_fasta
from variantcalling_tpu.io import featuremap as jfm
from variantcalling_tpu_torch.io import featuremap as tfm

HEADER = (
    "##fileformat=VCFv4.2\n"
    '##INFO=<ID=X_SCORE,Number=1,Type=Float,Description="s">\n'
    '##INFO=<ID=X_EDIST,Number=1,Type=Integer,Description="e">\n'
    '##INFO=<ID=X_MAPQ,Number=1,Type=Integer,Description="m">\n'
    '##INFO=<ID=X_READ_COUNT,Number=1,Type=Integer,Description="rc">\n'
    '##INFO=<ID=rq,Number=1,Type=Float,Description="rq">\n'
    '##INFO=<ID=RN,Number=1,Type=String,Description="read name">\n'
    '##INFO=<ID=DUP,Number=0,Type=Flag,Description="duplicate">\n'
    '##INFO=<ID=X_FC1,Number=.,Type=Float,Description="list">\n'
    "##contig=<ID=chr1,length=4000>\n##contig=<ID=chrU,length=500>\n"
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
)


def _write(path, seq: str, rng: np.random.Generator, n: int = 600) -> None:
    rows = []
    for i in range(n):
        chrom = "chrU" if i % 97 == 0 else "chr1"
        pos = int(rng.choice([1, 2, 3, len(seq) - 1, len(seq)])) if i % 50 == 0 else int(rng.integers(1, len(seq)))
        ref = seq[pos - 1] if chrom == "chr1" else "A"
        alt = "ACGT"[("ACGT".index(ref) + 1 + i % 3) % 4] + (",T" if i % 41 == 0 else "")
        parts = [f"X_SCORE={rng.normal(5, 2):.2f}", f"X_EDIST={rng.integers(0, 5)}", f"X_MAPQ={rng.integers(0, 61)}",
                 f"X_READ_COUNT={rng.integers(0, 40)}", f"rq={rng.uniform(0.5, 1):.3f}", f"RN=read{i}",
                 f"X_FC1={rng.integers(0, 9)},{rng.integers(0, 9)}"]
        if i % 7 == 0:
            parts.append("DUP")
        if i % 11 == 0:
            parts = [p for p in parts if not p.startswith(("X_MAPQ", "RN"))]
        if i % 13 == 0:
            parts[0] = "X_SCORE=."
        info = "." if i % 89 == 0 else ";".join(rng.permutation(parts).tolist())
        qual = "." if i % 17 == 0 else f"{rng.uniform(1, 90):.1f}"
        filt = {0: ".", 1: "", 2: "LowQual"}.get(i % 23, "PASS")
        rows.append(f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t{qual}\t{filt}\t{info}")
    path.write_text(HEADER + "\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("featuremap")
    rng = np.random.default_rng(31)
    seq = "".join(rng.choice(list("ACGT"), 4000))
    write_fasta(str(d / "ref.fa"), {"chr1": seq})
    fm = d / "fm.vcf"
    _write(fm, seq, rng)
    return str(fm), str(d / "ref.fa")


def assert_frame_equal(got, want: pd.DataFrame) -> None:
    """The port's Frame equals a pandas frame: columns, dtypes, values, NaN positions."""
    assert got.columns == [str(c) for c in want.columns]
    assert len(got) == len(want)
    for c in want.columns:
        g, w = np.asarray(got[c]), want[c].to_numpy()
        if w.dtype.kind in "OUS" or str(want[c].dtype) == "str":
            assert g.dtype == object, c
            assert g.tolist() == w.tolist(), c
        else:
            assert g.dtype == w.dtype, (c, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=c)


@pytest.mark.parametrize("engine", ["native", "plain"])
@pytest.mark.parametrize("motifs", [False, True], ids=["no_reference", "reference"])
@pytest.mark.parametrize("motif_length", [3, 1])
def test_frame_equals_the_reference(files, engine, motifs, motif_length, monkeypatch):
    if engine == "plain":
        monkeypatch.setenv("VCTPU_NO_NATIVE", "1")
    fm, ref = files
    fasta = ref if motifs else None
    got = tfm.featuremap_to_dataframe(fm, fasta, motif_length=motif_length)
    want = jfm.featuremap_to_dataframe(fm, fasta, motif_length=motif_length)
    assert_frame_equal(got, want)
    assert ("ref_motif" in got.columns) == motifs


def test_explicit_info_fields(files):
    fm, _ = files
    fields = ["RN", "X_SCORE", "NOT_IN_HEADER", "DUP"]
    assert_frame_equal(tfm.featuremap_to_dataframe(fm, info_fields=fields),
                       jfm.featuremap_to_dataframe(fm, info_fields=fields))


def test_numeric_feature_columns(files):
    fm, ref = files
    got, want = tfm.featuremap_to_dataframe(fm, ref), jfm.featuremap_to_dataframe(fm, ref)
    assert tfm.numeric_feature_columns(got) == jfm.numeric_feature_columns(want)
    assert "x_score" in tfm.numeric_feature_columns(got) and "rn" not in tfm.numeric_feature_columns(got)
    feats = tfm.numeric_feature_columns(got)
    np.testing.assert_array_equal(tfm.feature_matrix(got, feats), want[feats].to_numpy(np.float32))


def test_empty_featuremap(tmp_path):
    path = tmp_path / "empty.vcf"
    path.write_text(HEADER)
    write_fasta(str(tmp_path / "ref.fa"), {"chr1": "ACGT" * 100})
    got = tfm.featuremap_to_dataframe(str(path), str(tmp_path / "ref.fa"))
    want = jfm.featuremap_to_dataframe(str(path), str(tmp_path / "ref.fa"))
    assert got.columns == list(want.columns) and len(got) == 0
