"""The port's numpy parquet writer against pandas and pyarrow, on the CPU.

``io/parquet.write_parquet`` of a binned-coverage frame is read back by
``pd.read_parquet`` as the frame ``to_parquet`` round-trips (dtypes and
RangeIndex included), and its parquet schema has the pyarrow file's names,
physical types, logical types and definition levels. Through
``coverage_analysis full_analysis``: several contigs, a tail window, a window
longer than its contig and a contig with zero rows, against the JAX
package's parquet files.
"""

import numpy as np
import pandas as pd
import pyarrow.parquet as pq
import pytest

from tests import fixtures
from variantcalling_tpu.pipelines import coverage_analysis as jca
from variantcalling_tpu_torch.io import parquet
from variantcalling_tpu_torch.pipelines import coverage_analysis as tca


def _frame(contigs: dict[str, int], window: int, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    parts = []
    for c, n in contigs.items():
        k = -(-n // window)
        idx = np.arange(k, dtype=np.int64)
        parts.append((np.full(k, c.encode()), idx * window + 1, np.minimum((idx + 1) * window, n),
                      rng.random(k).astype(np.float32) * 40))
    return {"chrom": np.concatenate([p[0] for p in parts]), "chromStart": np.concatenate([p[1] for p in parts]),
            "chromEnd": np.concatenate([p[2] for p in parts]), "coverage": np.concatenate([p[3] for p in parts])}


def _schema(path) -> list:
    return [(c.name, c.physical_type, str(c.logical_type), c.max_definition_level) for c in pq.ParquetFile(path).schema]


@pytest.mark.parametrize("page_rows", [1 << 20, 7], ids=["one_page", "pages_of_7"])
@pytest.mark.parametrize("contigs,window", [
    ({"chr1": 1000, "chr2": 950, "chrX_alt": 1}, 100),  # several contigs, tail windows
    ({"chr1": 30}, 100),  # a window longer than its contig
    ({"chr1": 500, "chrEmpty": 0, "chr3": 120}, 50),  # a contig with zero rows
    ({}, 100),  # no rows at all
], ids=["contigs_and_tails", "long_window", "zero_row_contig", "empty"])
def test_frame_and_schema_equal_pyarrow(contigs, window, page_rows, tmp_path, monkeypatch):
    monkeypatch.setattr(parquet, "PAGE_ROWS", page_rows)
    cols = _frame(contigs, window, seed=len(contigs) + window) if contigs else {
        "chrom": np.empty(0, "S1"), "chromStart": np.empty(0, np.int64), "chromEnd": np.empty(0, np.int64),
        "coverage": np.empty(0, np.float32)}
    mine = tmp_path / "port.parquet"
    parquet.write_parquet(str(mine), cols)
    ref = pd.DataFrame({**cols, "chrom": pd.Series(np.char.decode(cols["chrom"]), dtype="str")})
    ref.to_parquet(tmp_path / "pandas.parquet")
    want = pd.read_parquet(tmp_path / "pandas.parquet")
    got = pd.read_parquet(mine)
    pd.testing.assert_frame_equal(got, want)
    assert isinstance(got.index, pd.RangeIndex) and got.index.start == 0 and len(got) == len(ref)
    assert _schema(mine) == _schema(tmp_path / "pandas.parquet")


def test_float64_and_unicode_columns(tmp_path):
    cols = {"name": np.array(["a", "ünï", "", "chr1"], dtype=object), "x": np.array([1.5, -2.0, np.inf, 0.0]),
            "n": np.arange(4, dtype=np.int64)}
    parquet.write_parquet(str(tmp_path / "x.parquet"), cols)
    got = pd.read_parquet(tmp_path / "x.parquet")
    assert got["name"].tolist() == cols["name"].tolist() and got["x"].tolist() == cols["x"].tolist()
    assert got["x"].dtype == np.float64 and got["n"].dtype == np.int64


@pytest.mark.parametrize("n,page_rows", [(0, 1 << 20), (1, 1 << 20), (13, 1 << 20), (1000, 77), (4096, 512)])
def test_bool_column_with_every_type(n, page_rows, tmp_path, monkeypatch):
    """pyarrow reads back a frame of bool, int64, float32, float64 and string
    columns equal to the written one: the booleans bit-packed a page at a
    time, whatever the page's length modulo 8."""
    monkeypatch.setattr(parquet, "PAGE_ROWS", page_rows)
    rng = np.random.default_rng(n)
    cols = {"label": rng.random(n) < 0.3, "pos": rng.integers(-5, 1 << 40, n).astype(np.int64),
            "score": rng.standard_normal(n).astype(np.float32), "af": rng.random(n),
            "chrom": np.array([f"chr{k}" for k in rng.integers(1, 23, n)], dtype=object)}
    cols["af"][::7] = np.nan
    parquet.write_parquet(str(tmp_path / "x.parquet"), cols)
    got = pq.read_table(tmp_path / "x.parquet").to_pandas()
    assert list(got.columns) == list(cols) and len(got) == n
    assert got["label"].dtype == bool and got["label"].tolist() == cols["label"].tolist()
    for name in ("pos", "score", "af"):
        assert got[name].dtype == cols[name].dtype
        np.testing.assert_array_equal(got[name].to_numpy(), cols[name])
    assert got["chrom"].tolist() == cols["chrom"].tolist()


def test_unsupported_column_raises(tmp_path):
    with pytest.raises(ValueError, match="no type"):
        parquet.write_parquet(str(tmp_path / "x.parquet"), {"b": np.zeros(3, np.int16)})
    with pytest.raises(ValueError, match="unequal"):
        parquet.write_parquet(str(tmp_path / "x.parquet"), {"a": np.zeros(3), "b": np.zeros(2)})


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    d = tmp_path_factory.mktemp("pq")
    rng = np.random.default_rng(8)
    contigs = {"chr1": 2500, "chr2": 730, "chrE": 0}
    reads = [{"contig": c, "pos": int(p), "cigar": [("M", 60)]}
             for c, n in (("chr1", 2500), ("chr2", 730)) for p in np.sort(rng.integers(0, n - 60, n // 6))]
    path = str(d / "r.bam")
    fixtures.write_bam(path, contigs, reads)
    return path


@pytest.mark.parametrize("windows", [["100", "1000"], ["7", "5000"]], ids=["tails", "window_past_contig"])
def test_full_analysis_parquets_equal_the_reference(bam, windows, tmp_path):
    assert tca.run(["full_analysis", "-i", bam, "-o", str(tmp_path / "p"), "-w", *windows, "--backend", "cpu"]) == 0
    assert jca.run(["full_analysis", "-i", bam, "-o", str(tmp_path / "r"), "-w", *windows]) == 0
    for w in windows:
        got, want = pd.read_parquet(tmp_path / f"p.w{w}.parquet"), pd.read_parquet(tmp_path / f"r.w{w}.parquet")
        pd.testing.assert_frame_equal(got, want)
        assert list(got["chrom"].unique()) == ["chr1", "chr2"]
        assert _schema(tmp_path / f"p.w{w}.parquet") == _schema(tmp_path / f"r.w{w}.parquet")
