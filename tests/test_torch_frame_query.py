"""The pandas replays of the report and QC chain against pandas itself, on the CPU.

``utils/frame_ops``: ``eval_query`` against ``DataFrame.eval(q).fillna(False)``
over a grid of queries on seeded columns with NaN (and the refusal of every
other expression, with the reference's ``ValueError`` text, and no ``eval``);
``read_csv`` against ``pd.read_csv`` (types, quoting, blanks, repeated
names, bools, and floats read as pandas' own converter reads them, which is
not always the nearest double); ``records_json`` against
``json.loads(df.to_json(orient="records"))`` (more than 10 decimals, past
1e16, below 1e-5, NaN, infinities, ints, bools, strings with ``/`` and
non-ASCII characters, array cells); ``value_counts``, ``astype_str`` and
``nan_mean``. ``io/bed.IntervalSet.subtract`` and ``total_length`` against
the JAX package's.
"""

import json

import numpy as np
import pandas as pd
import pytest

from variantcalling_tpu.io.bed import IntervalSet as JIntervalSet
from variantcalling_tpu_torch.io.bed import IntervalSet
from variantcalling_tpu_torch.utils import frame_ops as fo
from variantcalling_tpu_torch.utils.h5_utils import Frame

N = 400


@pytest.fixture(scope="module")
def columns():
    rng = np.random.default_rng(17)
    q = rng.random(N) * 60
    q[rng.random(N) < 0.2] = np.nan
    af = rng.random(N)
    af[rng.random(N) < 0.1] = np.nan
    return {"ML_QUAL": q, "X_LENGTH": rng.integers(50, 400, N).astype(float), "pos": rng.integers(1, 10_000, N),
            "X_EDIST": rng.integers(0, 8, N).astype(float), "AF": af, "rq": rng.random(N),
            "chrom": np.array(["chr1", "chr2", "chrX"] * (N // 3) + ["chr1"] * (N % 3), dtype=object)}


QUERIES = [
    "ML_QUAL >= 40", "ML_QUAL >= 40 and X_LENGTH < 200", "ML_QUAL > 10 or AF > 0.5", "not ML_QUAL > 30",
    "~(ML_QUAL > 30)", "(ML_QUAL > 10) & (AF < 0.5) | (pos > 5000)", "10 < ML_QUAL < 40", "0.1 <= AF <= 0.9",
    "X_EDIST in [2, 3]", "X_EDIST not in [0, 1, 7]", "pos in [1, 2, 3]", "ML_QUAL * 2 + AF > 50",
    "X_LENGTH / 10 - 5 > X_EDIST", "X_LENGTH % 7 == 0", "X_LENGTH // 100 == 1", "AF ** 2 < 0.1", "-ML_QUAL < -20",
    "chrom == 'chr1'", "chrom != 'chrX' and rq > 0.3", "chrom in ['chr2', 'chrX']", "ML_QUAL", "AF",
    "ML_QUAL != ML_QUAL", "ML_QUAL == ML_QUAL", "X_SCORE_MISSING > 1", "rq > 0.7 and not (AF < 0.2)",
    "(X_EDIST <= 4) and (X_LENGTH >= 100) and (ML_QUAL >= 20)", "+AF > 0.5", "AF > 0.5 == True",
]


@pytest.mark.parametrize("query", QUERIES)
def test_eval_query_matches_dataframe_eval(columns, query):
    cols = dict(columns)
    if "X_SCORE_MISSING" in query:  # a field the featuremap lacks is all NaN, as read_vcf reads it
        cols["X_SCORE_MISSING"] = np.full(N, np.nan)
    want = pd.DataFrame(cols).eval(query).fillna(False).astype(bool).to_numpy()
    got = fo.eval_query(cols, query, N)
    assert got.dtype == bool and np.array_equal(got, want)


@pytest.mark.parametrize("query", [
    "__import__('os').system('true')", "ML_QUAL.real > 1", "ML_QUAL[0] > 1", "lambda: 1", "(x := 1)",
    "[ML_QUAL]", "ML_QUAL if AF else rq", "foo > 1", "1 > 0", "X_EDIST in ML_QUAL", "X_EDIST in [AF]",
    "ML_QUAL > ", "open('x')", "{'a': 1}", "ML_QUAL is None",
])
def test_eval_query_refuses_other_expressions(columns, query):
    with pytest.raises(ValueError, match=r"^filter query .* failed: "):
        fo.eval_query(dict(columns), query, N)


def test_eval_query_never_evaluates_its_text(columns, tmp_path, monkeypatch):
    import builtins

    def no_eval(*a, **k):
        raise AssertionError("eval called")

    monkeypatch.setattr(builtins, "eval", no_eval)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError):
        fo.eval_query(dict(columns), "__import__('pathlib').Path('touched').touch()", N)
    assert not (tmp_path / "touched").exists()
    assert fo.eval_query(dict(columns), "ML_QUAL >= 40", N).sum() > 0


# -- read_csv -------------------------------------------------------------------------------------------------------

CSV_CASES = {
    "mixed": ('name,count,frac,flag,note,mixed,a,a\nalpha,1,0.5,True,"x, y",1,2,3\n"be""ta",2,,False,,2.5,4,5\n'
              'gamma,3,1e-3,true,plain,NA,6,7\n\ndelta,4,-2.25,FALSE,"quoted ""q""",x,8\n'),
    "missing": "x,y,z\n1,,a\n2,NaN,\n,3.5,null\n",
    "inf": "x,y\ninf,1\n-Infinity,2\n1e400,3\n",
    "numpy_only": "x\n1_0\n1.5\n",
    "bool_with_na": "b\nTrue\n\nFalse\n",
    "unicode": "k,v\nÜnï/code,1\nplain,2\n",
}


def _csv(tmp_path, text: str) -> str:
    path = tmp_path / "t.csv"
    path.write_text(text, encoding="utf-8")
    return str(path)


def _assert_columns(got: dict, want: pd.DataFrame) -> None:
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        g = got[c]
        assert g.dtype == (object if w.dtype == object or str(want[c].dtype) == "str" else w.dtype), c
        assert len(g) == len(w) and all(a == b or (a != a and b != b) for a, b in zip(g.tolist(), w.tolist())), c


@pytest.mark.parametrize("case", list(CSV_CASES))
def test_read_csv_matches_pandas(tmp_path, case):
    path = _csv(tmp_path, CSV_CASES[case])
    _assert_columns(fo.read_csv(path), pd.read_csv(path))


def test_read_csv_reads_floats_as_pandas_does(tmp_path):
    """pandas' default converter is not correctly rounded: about a quarter of
    these shortest texts read back one unit off, and the port's read the same."""
    rng = np.random.default_rng(3)
    vals = [repr(float(x)) for x in rng.random(3_000) * 10.0 ** rng.integers(-30, 30, 3_000)]
    vals += ["-0.0", "12345678901234567890.5", "1.5e-310", "1e-320", "  7.25 ", "+3.5", "1E5", "3.", "-.5", ".5",
             "123456789012345678901234567890"]
    path = _csv(tmp_path, "x\n" + "\n".join(vals) + "\n")
    want = pd.read_csv(path)["x"].to_numpy()
    got = fo.read_csv(path)["x"]
    assert got.dtype == np.float64 and np.array_equal(got, want)
    assert sum(float(v) != w for v, w in zip(vals, want)) > 100  # the converter really differs from strtod
    assert all(fo.precise_xstrtod(v) == w for v, w in zip(vals, want))


def test_read_csv_refuses_a_long_row(tmp_path):
    path = _csv(tmp_path, "a,b\n1,2,3\n")
    with pytest.raises(ValueError):
        fo.read_csv(path)


# -- records_json -------------------------------------------------------------------------------------------------

def test_records_json_matches_to_json():
    rng = np.random.default_rng(5)
    floats = [0.1, 1 / 3, 123456.123456789012, 1e17, -1e17, 1e16, 9.999999999999e15, 1.5e-6, 1e-16, -2.5e-12,
              0.99999999999, 0.0, -0.0, 12.5, 2.675, 5e-11, 1.5e-10, 2.5e-10, np.nan, np.inf, -np.inf]
    floats += list(rng.normal(size=300) * 10.0 ** rng.integers(-20, 20, 300))
    n = len(floats)
    df = pd.DataFrame({"f": floats, "f32": np.array(floats, dtype=np.float32), "i": rng.integers(-10**12, 10**12, n),
                       "b": rng.random(n) < 0.5,
                       "s": pd.Series([["a/b", "Ünï", None, "tab\tq\"x"][k % 4] for k in range(n)], dtype=object)})
    want = json.loads(df.to_json(orient="records"))
    frame = Frame({c: (df[c].to_numpy().astype(object) if c == "s" else df[c].to_numpy()) for c in df.columns})
    assert fo.records_json(frame) == want


def test_records_json_of_array_cells_and_empty_frames():
    cells = np.empty(2, dtype=object)
    cells[:] = [np.array([0.1234567890123, 2.0]), np.array([np.nan])]
    want = json.loads(pd.DataFrame({"r": cells}).to_json(orient="records"))
    assert fo.records_json(Frame({"r": cells})) == want
    assert fo.records_json(Frame({})) == json.loads(pd.DataFrame().to_json(orient="records"))
    assert fo.records_json(Frame({"x": np.zeros(0)})) == []


# -- the small replays ------------------------------------------------------------------------------------------------

def test_value_counts_has_one_home():
    from variantcalling_tpu_torch.pipelines import run_no_gt_report

    assert run_no_gt_report.value_counts is fo.value_counts
    values = np.array(list("abcabcaddee"), dtype=object)
    labels, counts = fo.value_counts(values)
    want = pd.Series(values).value_counts()
    assert labels == list(want.index) and counts.tolist() == want.tolist()


@pytest.mark.parametrize("dtype", ["float64", "float32", "int32", "bool", "object"])
def test_astype_str_matches_pandas(dtype):
    values = {"float64": np.array([0.1, np.nan, 1e16, 1 / 3, 1e-7, 123456789.0]),
              "float32": np.array([0.1, np.nan, 1 / 3, 2.5], dtype=np.float32),
              "int32": np.array([1, -2, 3], dtype=np.int32), "bool": np.array([True, False]),
              "object": np.array([(1, 2), None, "x", np.nan, 3], dtype=object)}[dtype]
    want = [None if v != v else v for v in pd.Series(values).astype(str).tolist()]
    assert fo.astype_str(values).tolist() == want


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
def test_nan_mean_matches_pandas(dtype):
    rng = np.random.default_rng(2)
    v = (rng.random(5_000) * 100).astype(dtype)
    if dtype != np.int64:
        v[::7] = np.nan
    want = pd.Series(v).mean()
    got = fo.nan_mean(v)
    assert got == want and f"{got:.2f}" == f"{want:.2f}"


# -- interval algebra ------------------------------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_subtract_and_total_length_match_the_reference(seed):
    rng = np.random.default_rng(seed)

    def sets(cls, n):
        chrom = np.array(rng.choice(["chr1", "chr2", "chr3"], n), dtype=object)
        start = rng.integers(0, 100_000, n)
        return chrom, start, start + rng.integers(1, 3_000, n)

    a, b = sets(None, 200), sets(None, 300)
    got = IntervalSet(a[0], a[1], a[2]).subtract(IntervalSet(b[0], b[1], b[2]))
    want = JIntervalSet(a[0], a[1], a[2]).subtract(JIntervalSet(b[0], b[1], b[2]))
    assert got.chrom.tolist() == want.chrom.tolist()
    assert np.array_equal(got.start, want.start) and np.array_equal(got.end, want.end)
    assert got.total_length() == want.total_length() > 0
    assert IntervalSet(a[0], a[1], a[2]).subtract(IntervalSet(a[0][:0], a[1][:0], a[2][:0])).total_length() == \
        IntervalSet(a[0], a[1], a[2]).merged().total_length()
