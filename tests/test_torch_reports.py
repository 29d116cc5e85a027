"""The report tools of the port against the JAX package's, on the CPU.

``run_no_gt_report`` (``full_analysis``, ``variant_eval``,
``somatic_analysis``), ``joint_calling_report`` and
``substitution_error_rate_report`` through both CLIs on the same seeded
files (``synthetic_reports``: a report world cut to 2 Mbp, a joint trio
callset with a dbSNP, a motif h5): every h5 frame equal (columns, dtypes,
values, index), the ``.all`` matrices byte-equal, the exposures under
``tests/torch_report_compare``'s bar (its counts checked), the HTML equal once
both sides' images are removed (as many drawn on each). Then the modules alone: the eval
tables, the hmer tables, the SNP motifs, the AF histogram with values planted
on its float32 edges and outside them, the pandas renderings the port
replays (``to_html``, ``value_counts``, the quicksort order, the groupby
sum), and the counts each world planted.
"""

import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from tests import torch_report_compare as rc
from tests.fixtures import write_fasta
from variantcalling_tpu.io.vcf import read_vcf as jread_vcf
from variantcalling_tpu.pipelines import joint_calling_report as jjoint
from variantcalling_tpu.pipelines import run_no_gt_report as jnogt
from variantcalling_tpu.pipelines import substitution_error_rate_report as jsub
from variantcalling_tpu.reports import no_gt_stats as jstats
from variantcalling_tpu.reports import variant_eval as jeval
from variantcalling_tpu_torch import synthetic, synthetic_reports
from variantcalling_tpu_torch.io.vcf import read_vcf
from variantcalling_tpu_torch.pipelines import joint_calling_report as tjoint
from variantcalling_tpu_torch.pipelines import run_no_gt_report as tnogt
from variantcalling_tpu_torch.pipelines import substitution_error_rate_report as tsub
from variantcalling_tpu_torch.reports import html as thtml
from variantcalling_tpu_torch.reports import no_gt_stats as tstats
from variantcalling_tpu_torch.reports import variant_eval as teval
from variantcalling_tpu_torch.utils import h5_utils as th5

CPU = ["--backend", "cpu"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("report_world")
    return synthetic_reports.write_report_world(str(d), seed=7, length=2_000_000, n_records=3_000,
                                                control_records=800, n_extra_dbsnp=3_000)


def _frame_of(df: pd.DataFrame) -> th5.Frame:
    """A pandas frame as the port's Frame: numpy columns, the index where it is not a plain range."""
    cols = {}
    for c in df.columns:
        v = df[c].to_numpy()
        cols[str(c)] = v.astype(object) if v.dtype.kind in "OUS" or str(df[c].dtype) == "str" else v
    idx = df.index
    plain = isinstance(idx, pd.RangeIndex) and idx.start == 0 and idx.step == 1
    return th5.Frame(cols, None if plain else idx.to_numpy())


def _assert_frames(got: th5.Frame, want: pd.DataFrame | th5.Frame, label: str = "") -> None:
    want = _frame_of(want) if isinstance(want, pd.DataFrame) else want
    problems = rc.frame_problems(got, want, label)
    assert not problems, "\n".join(problems)


# -- the CLIs -------------------------------------------------------------------------------------------


def _both(tmp_path: Path, jrun, trun, argv: list[str], out_flag: str, suffix: str = "",
          backend: bool = True) -> tuple[str, str]:
    out = {}
    for pkg, run in (("jax", jrun), ("torch", trun)):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        extra = CPU if backend and pkg == "torch" else []
        assert run([*argv, out_flag, str(d / "out") + suffix, *extra]) in (0, None)
        out[pkg] = str(d / "out")
    return out["torch"], out["jax"]


@pytest.mark.parametrize("callable_region", [False, True])
def test_full_analysis_against_jax(world, tmp_path, callable_region):
    argv = ["full_analysis", "--input_file", world["case"], "--dbsnp", world["dbsnp"], "--reference", world["fasta"]]
    if callable_region:
        argv += ["--callable_region", world["callable"]]
    got, want = _both(tmp_path, jnogt.run, tnogt.run, argv, "--output_prefix")
    rc.assert_same_h5(got + ".h5", want + ".h5")
    keys = th5.list_keys(got + ".h5")
    assert ("callable_size" in keys) == callable_region and len(keys) == 17 + callable_region


def test_full_analysis_finds_the_plant(world, tmp_path):
    prefix = str(tmp_path / "f")
    assert tnogt.run(["full_analysis", "--input_file", world["case"], "--dbsnp", world["dbsnp"], "--reference",
                      world["fasta"], "--output_prefix", prefix, *CPU]) == 0
    planted = world["planted"]["case"]
    for z in ("hete", "homo"):
        f = th5.read_hdf(prefix + ".h5", f"ins_del_{z}")
        assert np.array_equal(np.stack([f[c] for c in tstats.HMER_CLASSES]), planted["hmer"][z]), z
    assert int(th5.read_hdf(prefix + ".h5", "snp_motifs")["size"].sum()) == planted["n_snv_records"]
    assert np.array_equal(th5.read_hdf(prefix + ".h5", "dbs78_channels")["size"], planted["dbs"])
    id83 = th5.read_hdf(prefix + ".h5", "id83_channels")["size"]
    assert id83.sum() == planted["n_indels"] and np.array_equal(id83[:24], planted["id_1bp"])
    stats = th5.read_hdf(prefix + ".h5", "variants_statistics")
    assert int(stats["count"].sum()) == planted["records"]


@pytest.mark.parametrize("sample", [[], ["--sample_name", "case"], ["--sample_id", "0"]])
def test_variant_eval_against_jax(world, tmp_path, sample):
    argv = ["variant_eval", "--input_file", world["case"], "--dbsnp", world["dbsnp"], "--reference",
            world["fasta"], *sample]
    got, want = _both(tmp_path, jnogt.run, tnogt.run, argv, "--output_prefix")
    rc.assert_same_h5(got + ".h5", want + ".h5")
    assert len(th5.list_keys(got + ".h5")) == 9


@pytest.mark.parametrize("case", ["catalogs_controls", "sbs_only", "no_catalog"])
def test_somatic_analysis_against_jax(world, tmp_path, case):
    argv = ["somatic_analysis", "--input_file", world["case"], "--reference", world["fasta"]]
    if case != "no_catalog":
        argv += ["--signatures_file", world["catalog_SBS96"], "--signatures_metadata", world["metadata"]]
    if case == "catalogs_controls":
        argv += ["--id_signatures_file", world["catalog_ID83"], "--dbs_signatures_file", world["catalog_DBS78"],
                 "--control_vcfs", world["control1"], world["control2"]]
    got, want = {}, {}
    for pkg, run, store in (("jax", jnogt.run, want), ("torch", tnogt.run, got)):
        d = tmp_path / pkg
        d.mkdir()
        assert run([*argv, "--output_prefix", str(d / "case"), *(CPU if pkg == "torch" else [])]) == 0
        store["prefix"] = str(d / "case")
    if case == "no_catalog":
        for cat in ("SBS96", "ID83", "DBS78"):
            assert Path(f"{got['prefix']}.{cat}.all").read_bytes() == Path(f"{want['prefix']}.{cat}.all").read_bytes()
        assert not Path(got["prefix"] + ".h5").exists() and not Path(want["prefix"] + ".h5").exists()
        return
    counts = rc.compare_somatic(got["prefix"], want["prefix"])
    assert counts["rows"] >= 4 and counts["max_rel_err"] < rc.EXPOSURE_RTOL
    keys = th5.list_keys(got["prefix"] + ".h5")
    assert ("signature_control_comparison" in keys) == (case == "catalogs_controls")


def test_somatic_analysis_recovers_the_plant(world, tmp_path):
    prefix = str(tmp_path / "case")
    assert tnogt.run(["somatic_analysis", "--input_file", world["case"], "--reference", world["fasta"],
                      "--signatures_file", world["catalog_SBS96"], "--control_vcfs", world["control1"],
                      "--output_prefix", prefix, *CPU]) == 0
    planted = world["planted"]["case"]
    rows = [line.rstrip("\n").split("\t") for line in open(prefix + ".SBS96.all")]
    assert rows[0] == ["MutationType", "case", "control1"]
    assert np.array_equal([int(r[1]) for r in rows[1:]], planted["sbs"])
    assert np.array_equal([int(r[2]) for r in rows[1:]], world["planted"]["control1"]["sbs"])
    exp = th5.read_hdf(prefix + ".h5", "signature_exposures")
    case = {s: f for s, f, n in zip(exp["signature"], exp["fraction"], exp["sample"]) if n == "case"}
    sigs, weights = synthetic_reports.CASE_MIXTURE
    for k, w in zip(sigs, weights):
        assert abs(case.get(f"SBS{k + 1}", 0.0) - w) < 0.06, (k, case)
    assert sum(f for s, f in case.items() if int(s[3:]) - 1 not in sigs) < 0.1


@pytest.fixture(scope="module")
def joint_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("joint")
    trio = synthetic.write_trio_world(str(d), seed=5, length=1_000_000, n_sites=2_000, n_somatic=100)
    table = read_vcf(trio["trio"], drop_format=True)
    sites = list(zip(table.pos.tolist(), table.ref.tolist(), table.alt.tolist()))
    dbsnp = str(d / "dbsnp.vcf")
    synthetic_reports.write_dbsnp(dbsnp, 3, "chr20", 1_000_000, sites, n_extra=2_000)
    return {"vcf": trio["trio"], "dbsnp": dbsnp}


@pytest.mark.parametrize("dbsnp", [False, True])
def test_joint_calling_report_against_jax(joint_world, tmp_path, dbsnp):
    argv = ["--input_vcf", joint_world["vcf"]] + (["--dbsnp", joint_world["dbsnp"]] if dbsnp else [])
    out = {}
    for pkg, run in (("jax", jjoint.run), ("torch", tjoint.run)):
        d = tmp_path / pkg
        d.mkdir()
        assert run([*argv, "--h5_output", str(d / "r.h5"), "--html_output", str(d / "r.html"),
                    *(CPU if pkg == "torch" else [])]) == 0
        out[pkg] = d
    rc.assert_same_h5(str(out["torch"] / "r.h5"), str(out["jax"] / "r.h5"))
    assert th5.list_keys(str(out["torch"] / "r.h5")) == sorted(
        ["CountVariants", "TiTvVariantEvaluator", "IndelSummary", "IndelLengthHistogram", "af_spectrum", "per_sample"])
    got, n_got = rc.strip_images((out["torch"] / "r.html").read_text())
    want, n_want = rc.strip_images((out["jax"] / "r.html").read_text())
    assert n_got == n_want == 3 and got == want


def test_joint_calling_report_of_a_sites_only_vcf(world, tmp_path):
    """No samples: no AF spectrum and no per-sample rows, in both."""
    got, want = _both(tmp_path, jjoint.run, tjoint.run, ["--input_vcf", world["dbsnp"]], "--h5_output", ".h5")
    rc.assert_same_h5(got + ".h5", want + ".h5")


@pytest.mark.parametrize("seed,position", [(1, True), (2, True), (3, False)])
def test_substitution_error_rate_report_against_jax(tmp_path, seed, position):
    src = str(tmp_path / "motifs.h5")
    synthetic_reports.write_motif_h5(src, seed)
    argv = ["--h5_substitution_error_rate", src] + ([] if position else ["--position_key", "absent"])
    out = {}
    for pkg, run in (("jax", jsub.run), ("torch", tsub.run)):
        d = tmp_path / pkg
        d.mkdir()
        assert run([*argv, "--h5_output", str(d / "s.h5"), "--html_output", str(d / "s.html")]) == 0
        out[pkg] = d
    rc.assert_same_h5(str(out["torch"] / "s.h5"), str(out["jax"] / "s.h5"))
    keys = th5.list_keys(str(out["torch"] / "s.h5"))
    assert ("by_position" in keys) == position and {"folded_motifs", "by_mut_type", "asymmetry"} <= set(keys)
    assert len(th5.read_hdf(str(out["torch"] / "s.h5"), "folded_motifs")) == 96
    got, n_got = rc.strip_images((out["torch"] / "s.html").read_text())
    want, n_want = rc.strip_images((out["jax"] / "s.html").read_text())
    assert n_got == n_want == 3 + position and got == want


def test_substitution_report_takes_no_backend(tmp_path):
    src = str(tmp_path / "motifs.h5")
    synthetic_reports.write_motif_h5(src, 4)
    with pytest.raises(SystemExit):
        tsub.run(["--h5_substitution_error_rate", src, "--backend", "cpu"])


def test_substitution_report_without_counts(tmp_path):
    """A motif table with no count or base column: NaN strands, no rates, no asymmetry, in both."""
    src = str(tmp_path / "bare.h5")
    bases = list("ACGT")
    rows = [(r, a, left, right) for r in bases for a in bases if a != r for left in bases for right in "AC"]
    frame = th5.Frame({k: np.array([x[i] for x in rows], dtype=object)
                       for i, k in enumerate(("ref", "alt", "left_motif", "right_motif"))})
    th5.write_hdf(frame, src, "motif_1", mode="w")
    got, want = _both(tmp_path, jsub.run, tsub.run, ["--h5_substitution_error_rate", src], "--h5_output", ".h5",
                      backend=False)
    rc.assert_same_h5(got + ".h5", want + ".h5")


# -- the modules ----------------------------------------------------------------------------------------

HEADER = (
    "##fileformat=VCFv4.2\n"
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="g">\n'
    '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="a">\n'
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="d">\n'
    "##contig=<ID=chr1,length=10000>\n"
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
)


def test_eval_tables_of_the_unit_callset(tmp_path):
    """The shapes of the JAX package's own unit test, with a mixed record and no-calls."""
    vcf = tmp_path / "in.vcf"
    vcf.write_text(HEADER + "chr1\t10\t.\tA\tG\t50\tPASS\t.\tGT\t0/1\n" + "chr1\t20\t.\tA\tC\t50\tPASS\t.\tGT\t1/1\n"
                   + "chr1\t30\t.\tAT\tA\t50\tPASS\t.\tGT\t0/1\n" + "chr1\t40\t.\tA\tAGG\t50\tPASS\t.\tGT\t0/1\n"
                   + "chr1\t50\t.\tA\tG,T\t50\tPASS\t.\tGT\t1/2\n" + "chr1\t60\t.\tAC\tGT\t50\tPASS\t.\tGT\t./.\n"
                   + "chr1\t70\t.\tA\t.\t50\tPASS\t.\tGT\t0/0\n")
    dbsnp = tmp_path / "dbsnp.vcf"
    dbsnp.write_text("##fileformat=VCFv4.2\n##contig=<ID=chr1,length=10000>\n"
                     "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\nchr1\t10\trs1\tA\tC,G\t.\t.\t.\n")
    jt, tt = jread_vcf(str(vcf)), read_vcf(str(vcf))
    known = teval.dbsnp_membership(tt, str(dbsnp))
    assert np.array_equal(known, jeval.dbsnp_membership(jt, str(dbsnp))) and known.tolist()[0]
    for k in (None, known):
        want = jeval.compute_eval_tables(jt, known=k)
        got = teval.compute_eval_tables(tt, known=k)
        assert list(got) == list(want) == [
            "CompOverlap", "CountVariants", "TiTvVariantEvaluator", "IndelLengthHistogram", "IndelSummary",
            "MetricsCollection", "ValidationReport", "VariantSummary", "MultiallelicSummary"]
        for name in want:
            _assert_frames(got[name], want[name], name)


@pytest.mark.parametrize("seed", [0, 1])
def test_statistics_modules_against_jax(world, seed):
    """``_annotate``, the hmer tables, the SNP motifs (with and without the
    doublet exclusion) and the AF histogram on the world's callsets."""
    from variantcalling_tpu.reports import signatures as jsig

    path = world["case"] if seed == 0 else world["control1"]
    jt, tt = jread_vcf(path), read_vcf(path)
    jc, jw, jl, jn = jstats._annotate(jt, world["fasta"])
    tc, tw, tl, tn = tstats._annotate(tt, world["fasta"])
    assert np.array_equal(jw, tw) and np.array_equal(jl, tl) and np.array_equal(jn, tn)
    jid = jstats.insertion_deletion_statistics(jt, jc, jl, jn)
    tid = tstats.insertion_deletion_statistics(tt, tc, tl, tn)
    for z in ("homo", "hete"):
        want = jid[z].T.reset_index(names="hmer_len")
        _assert_frames(tstats.hmer_frame(tid[z]), want, z)
    _, paired = jsig.dbs78_matrix(jt, return_paired=True)
    for exclude in (None, paired):
        want = jstats.snp_statistics(jt, jc, jw, exclude=exclude).reset_index()
        _assert_frames(tstats.motif_frame(tstats.snp_statistics(tt, tc, tw, exclude=exclude)), want, "motifs")
    vt = tstats.variant_type_labels(tc, tl)
    assert np.array_equal(vt, jstats.variant_type_labels(jc, jl))
    af = tstats._compute_af(tt)
    assert np.array_equal(af, jstats._compute_af(jt), equal_nan=True)
    _assert_frames(tstats.allele_freq_hist(tt, vt, af=af), jstats.allele_freq_hist(jt, vt, af=af), "af_hist")


@pytest.mark.parametrize("nbins", [100, 7, 1])
def test_af_histogram_replays_jnp_histogram(nbins):
    """Values on every float32 edge, just beside them, below 0, past 1, NaN, and
    a type with no AF: the float32 counts and the int64 zeros of the reference."""
    edges = np.linspace(0, 1, nbins + 1)
    e32 = edges.astype(np.float32).astype(np.float64)
    vals = np.concatenate([edges, e32, np.nextafter(e32, 2), np.nextafter(e32, -1), [-0.5, -1e-9, 1.0, 1 + 1e-9, 2.0,
                                                                                          np.nan]])
    rng = np.random.default_rng(nbins)
    vals = np.concatenate([vals, rng.random(500), np.round(rng.random(300), 2)])
    vtype = np.where(np.arange(len(vals)) % 3 == 0, "snp", np.where(np.arange(len(vals)) % 3 == 1, "h-indel",
                                                                      "non-h-indel"))
    vtype = np.concatenate([vtype, ["empty"]])
    vals = np.concatenate([vals, [np.nan]])
    got = tstats.allele_freq_hist(None, vtype, nbins=nbins, af=vals)
    want = jstats.allele_freq_hist(None, vtype, nbins=nbins, af=vals)
    _assert_frames(got, want, "af_hist")
    assert got["snp"].dtype == np.float32 and got["empty"].dtype == np.int64


def test_fold_table_and_motif_index():
    assert np.array_equal(tstats._fold_table(), jstats._fold_table())
    assert tstats.motif_index_96() == list(jstats.motif_index_96())


@pytest.mark.parametrize("seed", range(6))
def test_value_counts_order(seed):
    """Count descending, ties in order of first appearance: pandas' order."""
    rng = np.random.default_rng(seed)
    labels = np.array(["snp", "h-indel", "non-h-indel", "x", "y"])[: 2 + seed % 4]
    values = labels[rng.integers(0, len(labels), 3 + 4 * seed)]
    if seed % 2:
        values = np.concatenate([values, labels])  # ties made likelier
    want = pd.Series(values).value_counts()
    types, counts = tnogt.value_counts(values)
    assert types == list(want.index) and counts.tolist() == want.tolist()


def _random_frame(rng, n: int) -> pd.DataFrame:
    vals = np.concatenate([rng.normal(0, 10.0 ** rng.integers(-8, 9, n)), [np.nan, np.inf, -0.0, 1234.5, 1e21]])[:n]
    df = pd.DataFrame({
        "name": [f"s<{i}>&" if i % 3 == 0 else f"sample  {i}" for i in range(n)],
        "count": rng.integers(-5, 10_000_000, n),
        "ratio": vals,
        "f32": vals.astype(np.float32),
        "flag": rng.random(n) < 0.5,
        "miss": [None if i % 4 == 0 else "v" for i in range(n)],
    })
    return df


@pytest.mark.parametrize("seed", range(4))
def test_html_tables_equal_pandas(seed):
    rng = np.random.default_rng(seed)
    df = _random_frame(rng, 12)
    if seed % 2:
        df = df[df["count"] % 2 == 0]  # a subset keeps its index
    if seed == 3:
        df = df.iloc[0:0]
    want = df.to_html(float_format=lambda x: "{:,.4g}".format(x), border=0)
    assert thtml.frame_to_html(_frame_of(df)) == want


def test_html_report_skips_and_counts_figures(tmp_path, monkeypatch):
    """A figure is embedded where matplotlib imports; one whose drawing fails,
    or any where matplotlib does not import (the card's machine), is skipped,
    recorded and counted. The rest of the document is the reference's."""
    from variantcalling_tpu_torch.utils import degrade

    def draw(plt):
        fig, ax = plt.subplots()
        ax.plot([0, 1], [1, 2])
        return fig

    rep = thtml.HtmlReport("T <1>")
    rep.add_params({"a": 1, "b<": "x&y"})
    rep.add_section("S")
    rep.add_table(th5.Frame({"x": np.arange(3)}))
    rep.add_text("t")
    degrade.clear_for_tests()
    thtml.add_figure_safe(rep, lambda plt: 1 / 0, "a figure")
    assert rep.figures_skipped == 1 and len(degrade.events_for(thtml.FIGURE_POINT)) == 1
    thtml.add_figure_safe(rep, draw, "a drawn figure")
    thtml.add_figure_safe(rep, lambda plt: None, "nothing to draw")
    assert rep.figures_skipped == 1 and rep.parts[-1].startswith('<img src="data:image/png;base64,')
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as on a machine without it
    thtml.add_figure_safe(rep, draw, "an undrawable figure")
    assert rep.figures_skipped == 2 and len(degrade.events_for(thtml.FIGURE_POINT)) == 2
    from variantcalling_tpu.reports.html import HtmlReport

    ref = HtmlReport("T <1>")
    ref.add_params({"a": 1, "b<": "x&y"})
    ref.add_section("S")
    ref.add_table(pd.DataFrame({"x": np.arange(3)}))
    ref.add_text("t")
    rep.write(str(tmp_path / "a.html"))
    ref.write(str(tmp_path / "b.html"))
    got, n_img = rc.strip_images((tmp_path / "a.html").read_text())
    assert n_img == 1 and got == (tmp_path / "b.html").read_text()


def test_substitution_helpers_replay_pandas():
    """The quicksort order of one-key ``sort_values`` (ties and NaN included)
    and the groupby sum, on values where order and compensation matter."""
    rng = np.random.default_rng(3)
    for n in (5, 17, 200, 1000):
        v = np.round(rng.normal(size=n), 1)
        v[rng.random(n) < 0.1] = np.nan
        for asc in (True, False):
            want = pd.DataFrame({"v": v}).sort_values("v", ascending=asc).index.to_numpy()
            assert np.array_equal(tsub.nargsort(v, ascending=asc), want)
    vals = np.concatenate([[1e16, 1.0, -1e16, 1.0], rng.normal(size=50) * 1e8, [np.nan]])
    groups = np.array(list("ab") * 28)[: len(vals)]
    want = pd.DataFrame({"g": groups, "v": vals}).groupby("g")["v"].sum()
    assert [tsub.kahan_sum(vals[groups == g]) for g in ("a", "b")] == want.tolist()


def test_statistics_run_on_the_named_device(world):
    """The device programs take the run's device: here the CPU, given as a torch.device."""
    tt = read_vcf(world["case"])
    cols, windows, hl, hn = tstats._annotate(tt, world["fasta"], torch.device("cpu"))
    assert tstats.snp_statistics(tt, cols, windows, device=torch.device("cpu")).sum() > 0
    tables = teval.compute_eval_tables(tt, device=torch.device("cpu"))
    assert int(tables["CountVariants"]["nVariantLoci"][0]) == len(tt)


def test_report_fixture_shape_of_the_unit_suite(tmp_path):
    """The JAX package's ``test_full_analysis_pipeline`` world through both CLIs."""
    seq = "ACGT" * 2500
    write_fasta(str(tmp_path / "ref.fa"), {"chr1": seq})
    rows = []
    for pos in range(100, 400, 10):
        ref = seq[pos - 1]
        alt = "ACGT"[("ACGT".index(ref) + 1) % 4]
        rows.append(f"chr1\t{pos}\t.\t{ref}\t{alt}\t50\tPASS\t.\tGT:AD:DP\t0/1:10,10:20")
    (tmp_path / "in.vcf").write_text(HEADER + "\n".join(rows) + "\n")
    (tmp_path / "dbsnp.vcf").write_text("##fileformat=VCFv4.2\n##contig=<ID=chr1,length=10000>\n"
                                        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    (tmp_path / "callable.bed").write_text("chr1\t0\t5000\n")
    argv = ["full_analysis", "--input_file", str(tmp_path / "in.vcf"), "--dbsnp", str(tmp_path / "dbsnp.vcf"),
            "--reference", str(tmp_path / "ref.fa"), "--callable_region", str(tmp_path / "callable.bed")]
    got, want = _both(tmp_path, jnogt.run, tnogt.run, argv, "--output_prefix")
    rc.assert_same_h5(got + ".h5", want + ".h5")
    assert int(th5.read_hdf(got + ".h5", "callable_size")["callable_size"][0]) == 5000
