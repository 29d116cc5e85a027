"""The five methylation tools of the port against the JAX package's, on the CPU.

The same MethylDackel files through both CLIs: every h5 frame read back by
pandas equal (columns, dtypes, values; ``mean_methylation`` exact: the
float32 sums a coverage level added in row order, as XLA's CPU scatter-add
adds them), and the text outputs byte-equal. The reference divides
``coverage_stats``' means with ``np.divide(where=)`` and no ``out``, so its
rows without sites hold whatever memory was there; the port writes 0.0
there, and those rows are compared on their coverage and count only. The
cases of ``tests/unit/test_new_tools.py:110-163``, the ``track`` line, an
alt contig whose name holds a ``t`` (dropped, its columns then float64),
empty inputs and sites of zero coverage, and a seeded world.
"""

import numpy as np
import pandas as pd
import pytest

from tests.unit.test_new_tools import _bedgraph
from variantcalling_tpu.pipelines.methylation import concat_methyldackel_csvs as jconcat
from variantcalling_tpu.pipelines.methylation import process_mbias as jmbias
from variantcalling_tpu.pipelines.methylation import process_merge_context as jmerge
from variantcalling_tpu.pipelines.methylation import process_merge_context_no_cp_g as jnocpg
from variantcalling_tpu.pipelines.methylation import process_per_read as jper
from variantcalling_tpu.utils.h5_utils import list_keys as jlist_keys
from variantcalling_tpu.utils.h5_utils import read_hdf as jread_hdf
from variantcalling_tpu_torch import methyl as tmethyl
from variantcalling_tpu_torch import synthetic_featuremap as sfm
from variantcalling_tpu_torch.pipelines.methylation import concat_methyldackel_csvs as tconcat
from variantcalling_tpu_torch.pipelines.methylation import process_mbias as tmbias
from variantcalling_tpu_torch.pipelines.methylation import process_merge_context as tmerge
from variantcalling_tpu_torch.pipelines.methylation import process_merge_context_no_cp_g as tnocpg
from variantcalling_tpu_torch.pipelines.methylation import process_per_read as tper

CPU = ["--backend", "cpu"]


def assert_h5_equal(got: str, want: str) -> None:
    keys = jlist_keys(want)
    assert jlist_keys(got) == keys
    for key in keys:
        g, w = jread_hdf(got, key=key), jread_hdf(want, key=key)
        if key == "coverage_stats":  # the reference leaves the rows without sites uninitialised
            empty = w["n_sites"].to_numpy() == 0
            assert (g.loc[empty, "mean_methylation"] == 0).all()
            g, w = g[~empty], w[~empty]
        pd.testing.assert_frame_equal(g, w, check_exact=True, obj=key)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("methyl_world")
    return sfm.write_methyl_world(str(d), seed=9, length=600_000, n_cpg_sites=20_000, n_shards=3, n_chh=20_000,
                                  n_reads=20_000, n_alt_rows=30)


@pytest.mark.parametrize("tool", ["merge", "no_cpg"])
@pytest.mark.parametrize("which", ["cpg", "chh"])
def test_merge_context_equals_the_reference(world, tool, which, tmp_path):
    port, ref = {"merge": (tmerge, jmerge), "no_cpg": (tnocpg, jnocpg)}[tool]
    for mod, tag, extra in ((port, "t", CPU), (ref, "j", [])):
        assert mod.run(["--input", world[which], "--output", str(tmp_path / f"{tag}.h5"), "--merged_bedgraph",
                        str(tmp_path / f"{tag}.bedGraph"), *extra]) == 0
    assert_h5_equal(str(tmp_path / "t.h5"), str(tmp_path / "j.h5"))
    assert (tmp_path / "t.bedGraph").read_bytes() == (tmp_path / "j.bedGraph").read_bytes()


def test_concat_equals_the_reference(world, tmp_path):
    assert tconcat.run(["--inputs", *world["shards"], "--output", str(tmp_path / "t.csv")]) == 0
    assert jconcat.run(["--inputs", *world["shards"], "--output", str(tmp_path / "j.csv")]) == 0
    got = (tmp_path / "t.csv").read_bytes()
    assert got == (tmp_path / "j.csv").read_bytes()
    assert b".0\t" in got  # the alt contig's rows made start and end float64


@pytest.mark.parametrize("tolerance", ["0.05", "0.01", "0.5"])
def test_mbias_equals_the_reference(world, tolerance, tmp_path):
    for mod, tag in ((tmbias, "t"), (jmbias, "j")):
        assert mod.run(["--input", world["mbias"], "--output", str(tmp_path / f"{tag}.h5"),
                        "--tolerance", tolerance]) == 0
    assert_h5_equal(str(tmp_path / "t.h5"), str(tmp_path / "j.h5"))
    if tolerance == "0.05":
        bounds = jread_hdf(str(tmp_path / "t.h5"), key="inclusion_bounds")
        assert (bounds["inclusion_start"] == world["bias_5p"] + 1).all()
        assert (bounds["inclusion_end"] == 150 - world["bias_3p"]).all()


@pytest.mark.parametrize("min_sites", ["1", "5", "100"])
def test_per_read_equals_the_reference(world, min_sites, tmp_path):
    for mod, tag, extra in ((tper, "t", CPU), (jper, "j", [])):
        assert mod.run(["--input", world["per_read"], "--output", str(tmp_path / f"{tag}.h5"), "--min_sites",
                        min_sites, *extra]) == 0
    assert_h5_equal(str(tmp_path / "t.h5"), str(tmp_path / "j.h5"))


# -- the reference's cases, the quirks, empty inputs -----------------------------------------------------------------


def _both(tmp_path, port, ref, argv_of, cpu=True):
    for mod, tag, extra in ((port, "t", CPU if cpu else []), (ref, "j", [])):
        assert mod.run([*argv_of(tag), *extra]) == 0


def test_reference_merge_case(tmp_path):
    bg = str(tmp_path / "cpg.bedGraph")
    _bedgraph(bg, [("chr1", 100, 101, 80.0, 8, 2), ("chr1", 101, 102, 40.0, 2, 3), ("chr1", 500, 501, 0.0, 0, 10)])
    _both(tmp_path, tmerge, jmerge, lambda t: ["--input", bg, "--output", str(tmp_path / f"{t}.h5"),
                                               "--merged_bedgraph", str(tmp_path / f"{t}.bg")])
    assert_h5_equal(str(tmp_path / "t.h5"), str(tmp_path / "j.h5"))
    assert (tmp_path / "t.bg").read_bytes() == (tmp_path / "j.bg").read_bytes()
    assert jread_hdf(str(tmp_path / "t.h5"), key="summary").iloc[0]["n_sites"] == 2


def test_reference_mbias_and_concat_and_per_read_cases(tmp_path):
    src = tmp_path / "mbias.txt"
    src.write_text("Strand\tRead\tPosition\tnMethylated\tnUnmethylated\n"
                   + "".join(f"OT\t1\t{p}\t{2 if p <= 2 else 50}\t50\n" for p in range(1, 11)))
    _both(tmp_path, tmbias, jmbias, lambda t: ["--input", str(src), "--output", str(tmp_path / f"{t}m.h5")], False)
    assert_h5_equal(str(tmp_path / "tm.h5"), str(tmp_path / "jm.h5"))
    assert jread_hdf(str(tmp_path / "tm.h5"), key="inclusion_bounds").iloc[0]["inclusion_start"] == 3
    a, b = str(tmp_path / "a.bg"), str(tmp_path / "b.bg")
    _bedgraph(a, [("chr1", 10, 11, 50.0, 1, 1)])
    _bedgraph(b, [("chr1", 10, 11, 100.0, 3, 0), ("chr2", 5, 6, 0.0, 0, 2)])
    _both(tmp_path, tconcat, jconcat, lambda t: ["--inputs", a, b, "--output", str(tmp_path / f"{t}.csv")], False)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    pr = tmp_path / "pr.tsv"
    pr.write_text("".join(f"r{i}\tchr1\t{100 + i}\t{f}\t5\n" for i, f in enumerate([0.0, 0.5, 1.0, 1.0])))
    _both(tmp_path, tper, jper, lambda t: ["--input", str(pr), "--output", str(tmp_path / f"{t}p.h5")])
    assert_h5_equal(str(tmp_path / "tp.h5"), str(tmp_path / "jp.h5"))


@pytest.mark.parametrize("rows", [
    [],
    [("chr1_KI270762v1_alt", 5, 6, 50.0, 1, 1)],
    [("chr1", 100, 101, 80.0, 0, 0), ("chr1", 101, 102, 40.0, 0, 0), ("chr1", 102, 103, 40.0, 0, 0)],
    [("chr2", 7, 8, 3, 1, 2), ("chr1_KI270762v1_alt", 5, 6, 50.0, 1, 1), ("chr1", 100, 101, 80.0, 8, 2),
     ("chr1", 101, 102, 40.0, 2, 3), ("chr1", 102, 103, 40.0, 2, 3), ("chr10", 1, 2, 0, 0, 7)],
    [("1", 100, 101, 80.0, 8, 2), ("2", 101, 102, 40.0, 2, 3)],
    [("chr1", 100, 101, 80.0, 8, 2), ("chr1", 101, 102), ("chr1", 500, 501, 0.0, 0, 10), ("chr2", 7, 8, 50, 1, "")],
], ids=["empty", "alt_only", "zero_coverage", "alt_and_chains", "numeric_contigs", "missing_fields"])
def test_quirks_equal_the_reference(rows, tmp_path):
    bg = str(tmp_path / "in.bedGraph")
    _bedgraph(bg, rows)
    for port, ref in ((tmerge, jmerge), (tnocpg, jnocpg)):
        _both(tmp_path, port, ref, lambda t: ["--input", bg, "--output", str(tmp_path / f"{t}.h5"),
                                              "--merged_bedgraph", str(tmp_path / f"{t}.bg")])
        assert_h5_equal(str(tmp_path / "t.h5"), str(tmp_path / "j.h5"))
        assert (tmp_path / "t.bg").read_bytes() == (tmp_path / "j.bg").read_bytes()
    _both(tmp_path, tconcat, jconcat, lambda t: ["--inputs", bg, bg, "--output", str(tmp_path / f"{t}.csv")], False)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_empty_per_read_and_mbias_header_only(tmp_path):
    pr = tmp_path / "pr.tsv"
    pr.write_text("#read\tchrom\tpos\tmeth_fraction\tn_sites\n")
    _both(tmp_path, tper, jper, lambda t: ["--input", str(pr), "--output", str(tmp_path / f"{t}p.h5")])
    assert_h5_equal(str(tmp_path / "tp.h5"), str(tmp_path / "jp.h5"))
    mb = tmp_path / "mb.txt"
    mb.write_text("Strand\tRead\tPosition\tnMethylated\tnUnmethylated\n")
    _both(tmp_path, tmbias, jmbias, lambda t: ["--input", str(mb), "--output", str(tmp_path / f"{t}m.h5")], False)
    assert_h5_equal(str(tmp_path / "tm.h5"), str(tmp_path / "jm.h5"))


def test_ordered_bin_sums_add_in_row_order():
    """The per-level float32 sums are sequential in row order (not pairwise):
    a large value first then many small ones differ from the pairwise sum."""
    vals = np.concatenate([[1.0], np.full(10_000, 1e-8)]).astype(np.float32)
    bins = np.zeros(len(vals), dtype=np.int64)
    seq = np.float32(0)
    for v in vals:
        seq = np.float32(seq + v)
    assert tmethyl.ordered_bin_sums(vals, bins, 1)[0] == seq
