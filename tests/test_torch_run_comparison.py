"""``run_comparison_pipeline``, ``vcfeval_flavors`` and the matcher of the port against the JAX package's, on the CPU.

Inputs made from a seed with numpy: the small SEC world
(``synthetic.write_sec_world``: a held-out callset on a 2 Mbp contig and
its truth, 2 % of the truth written in another form: shifted homopolymer
indels, split multi-allelic records, MNPs split into SNVs), and seeded
clusters for the matcher in the style of ``tests/unit/test_matcher_native.py``.
Bars: the matcher's flags equal the JAX package's specification (native
engine and Python, haplotype rescue on and off); every key of the
concordance h5 equal (read by the JAX package's ``read_hdf``: columns,
dtypes and values, floats exactly) and the BED bytes equal, over the
native tool, ``GC``, ``--disable_reinterpretation``, runs, annotations,
coverage bigWigs, ``--cmp_intervals``, ``--n_parts`` and an empty region;
every planted representation difference classified ``tp``; the
``vcfeval_flavors`` result files equal.
"""

import numpy as np
import pandas as pd
import pytest

from tests.unit.test_matcher_native import _random_side
from variantcalling_tpu.__main__ import main as jax_main
from variantcalling_tpu.comparison import matcher as jmatcher
from variantcalling_tpu.utils import h5_utils as jh5
from variantcalling_tpu_torch import native, synthetic
from variantcalling_tpu_torch.__main__ import main as torch_main
from variantcalling_tpu_torch.comparison import matcher as tmatcher
from variantcalling_tpu_torch.io.bigwig import write_bigwig
from variantcalling_tpu_torch.io.fasta import FastaReader
from variantcalling_tpu_torch.utils import h5_utils as th5

LENGTH = 2_000_000


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("cmp_world")
    w = synthetic.write_sec_world(str(d), seed=9, length=LENGTH, n_pool=1_500, n_samples=1, n_private=50,
                                  n_heldout=2_500)
    rng = np.random.default_rng(9)
    starts = np.sort(rng.choice(LENGTH - 50, 400, replace=False))
    with open(d / "runs.bed", "w") as fh:  # homopolymer-run-like intervals of 4-20 bp
        fh.write("".join(f"chr20\t{s}\t{s + int(k)}\n" for s, k in zip(starts, rng.integers(4, 21, 400))))
    with open(d / "cmp.bed", "w") as fh:
        fh.write(f"chr20\t0\t{LENGTH // 2}\tfirst_half\nchr20\t{LENGTH // 2 + 5000}\t{LENGTH}\tsecond_half\n")
    with open(d / "outside.bed", "w") as fh:
        fh.write("chr20\t0\t50\n")  # before the first variant
    depth = rng.poisson(30, LENGTH).astype(np.float32)
    write_bigwig(str(d / "hq.bw"), {"chr20": depth})
    write_bigwig(str(d / "all.bw"), {"chr20": depth + 2})
    # the held-out callset in two parts, for --n_parts
    lines = open(w["heldout"]).read().splitlines(keepends=True)
    head = [ln for ln in lines if ln.startswith("#")]
    recs = [ln for ln in lines if not ln.startswith("#")]
    for i, part in enumerate((recs[: len(recs) // 2], recs[len(recs) // 2:]), start=1):
        with open(d / f"parts.{i}.vcf", "w") as fh:
            fh.write("".join(head + part))
    return {**w, "runs": str(d / "runs.bed"), "cmp": str(d / "cmp.bed"), "outside": str(d / "outside.bed"),
            "hq_bw": str(d / "hq.bw"), "all_bw": str(d / "all.bw"), "parts": str(d / "parts")}


# -- the matcher --------------------------------------------------------------------------------


@pytest.mark.parametrize("rescue", [True, False], ids=["rescue", "exact_only"])
@pytest.mark.parametrize("seed", range(6))
def test_matcher_against_jax(seed, rescue):
    rng = np.random.default_rng(100 + seed)
    seq = "".join(rng.choice(list("ACGT"), 3_000))
    seq = seq[:1000] + "T" * 12 + seq[1012:]  # a homopolymer run inside the clusters
    calls, truth = _random_side(rng, seq, 220), _random_side(rng, seq, 200)
    want = jmatcher._match_contig_py(calls, truth, seq, rescue)
    for engine in ("native", "python"):
        if engine == "native":
            got = tmatcher._match_contig_native(calls, truth, seq, rescue)
            if not native.available():
                assert got is None
                continue
        else:
            got = tmatcher._match_contig_py(calls, truth, seq, rescue)
        for field in ("call_tp", "call_tp_gt", "truth_tp", "truth_tp_gt"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=f"{engine} {field}")
        np.testing.assert_array_equal(got.call_truth_idx >= 0, want.call_truth_idx >= 0)
        assert (got.fallback_clusters, got.fallback_variants) == (want.fallback_clusters, want.fallback_variants)


def test_match_contig_counts_the_native_engine(monkeypatch):
    side = tmatcher.make_side(np.array([17]), ["A"], [["G"]], np.array([[0, 1]], dtype=np.int8))
    seq = "ACGT" * 10
    native.reset_calls()
    assert tmatcher.match_contig(side, side, seq).call_tp.all()
    counts = dict(native.CALLS["match_contig_native"])
    assert (counts["native"], counts["plain"]) == ((1, 0) if native.available() else (0, 1))
    monkeypatch.setenv("VCTPU_NO_NATIVE", "1")
    assert tmatcher.match_contig(side, side, seq).call_tp.all()
    assert native.CALLS["match_contig_native"]["plain"] == counts["plain"] + 1


# -- run_comparison_pipeline ---------------------------------------------------------------------

CASES = {
    "native_annotated": lambda w: ["--annotate_intervals", w["exome"], "--runs_intervals", w["runs"], "--filter_runs",
                                   "--coverage_bw_high_quality", w["hq_bw"], "--coverage_bw_all_quality", w["all_bw"],
                                   "--cmp_intervals", w["cmp"]],
    "gc": lambda w: ["--concordance_tool", "GC"],
    "disable_reinterpretation": lambda w: ["--disable_reinterpretation", "--hpol_filter_length_dist", "6", "3",
                                           "--runs_intervals", w["runs"]],
    "no_native": lambda w: ["--annotate_intervals", w["exome"]],
    "n_parts": lambda w: ["--n_parts", "2"],
    "empty": lambda w: ["--cmp_intervals", w["outside"]],
}


def _run_both(world, tmp_path, case: str, monkeypatch) -> tuple[str, str]:
    extra = CASES[case](world)
    prefix = world["parts"] if case == "n_parts" else world["heldout"]
    base = ["--input_prefix", prefix, "--gtr_vcf", world["truth"], "--highconf_intervals", world["hcr"],
            "--reference", world["fasta"], *extra]
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    assert jax_main(["run_comparison_pipeline", *base, "--output_file", j + ".h5", "--output_interval", j + ".bed"]) == 0
    if case == "no_native":
        monkeypatch.setenv("VCTPU_NO_NATIVE", "1")
    native.reset_calls()
    assert torch_main(["run_comparison_pipeline", *base, "--output_file", t + ".h5", "--output_interval", t + ".bed",
                       "--backend", "cpu"]) == 0
    served = native.CALLS["match_contig_native"]
    if case == "no_native" or not native.available():
        assert served["native"] == 0 and served["plain"] >= 1
    elif case not in ("gc", "empty"):
        assert served["native"] >= 1 and served["plain"] == 0
    return j, t


@pytest.mark.parametrize("case", list(CASES))
def test_run_comparison_against_jax(world, tmp_path, monkeypatch, case):
    j, t = _run_both(world, tmp_path, case, monkeypatch)
    assert open(t + ".bed", "rb").read() == open(j + ".bed", "rb").read()
    keys = jh5.list_keys(j + ".h5")
    assert keys and jh5.list_keys(t + ".h5") == keys == th5.list_keys(t + ".h5")
    for key in keys:
        want, got = jh5.read_hdf(j + ".h5", key=key), jh5.read_hdf(t + ".h5", key=key)
        pd.testing.assert_frame_equal(got, want, check_exact=True)
        assert list(th5.read_hdf(t + ".h5", key=key).columns) == list(want.columns)
    if case == "empty":
        assert keys == ["all"] and len(jh5.read_hdf(t + ".h5", key="all")) == 0
        return
    df = jh5.read_hdf(t + ".h5", key="all")
    assert {"tp", "fp", "fn"} <= set(df["classify"])
    if case in ("native_annotated", "no_native", "n_parts"):
        planted = df[df["pos"].isin(world["repr_pos"]) & (df["call"] != "NA")]
        hcr = pd.read_csv(world["hcr"], sep="\t", header=None)
        assert len(planted) >= 0.4 * len(world["repr_pos"]) and set(planted["classify"]) == {"tp"}
        assert len(hcr)
    if case == "native_annotated":
        assert df["hpol_run"].any() and df["exome"].any() and df["coverage"].notna().all()


def test_training_prep_reads_the_port_concordance(world, tmp_path, monkeypatch):
    """The port's h5 is a training input: the port's ``training_prep_pipeline``
    on it writes the labels the JAX package's writes on the JAX package's h5."""
    j, t = _run_both(world, tmp_path, "native_annotated", monkeypatch)
    assert torch_main(["training_prep_pipeline", "--input_file", t + ".h5", "--output_prefix", t]) == 0
    assert jax_main(["training_prep_pipeline", "--input_file", j + ".h5", "--output_prefix", j]) == 0
    for key in jh5.list_keys(j + ".labels.h5"):
        pd.testing.assert_frame_equal(jh5.read_hdf(t + ".labels.h5", key), jh5.read_hdf(j + ".labels.h5", key))


def test_fasta_fetch_is_the_reference_text(world):
    from variantcalling_tpu.io.fasta import FastaReader as JFasta

    with FastaReader(world["fasta"]) as t, JFasta(world["fasta"]) as j:
        for lo, hi in ((0, 10), (55, 185), (LENGTH - 70, LENGTH + 30), (-5, 3), (100, 100)):
            assert t.fetch("chr20", lo, hi) == j.fetch("chr20", lo, hi)


# -- vcfeval_flavors -----------------------------------------------------------------------------


@pytest.mark.parametrize("penalty", ["2", "1", "0", "-1"])
@pytest.mark.parametrize("var_type", ["both", "snps", "indels"])
def test_vcfeval_flavors_against_jax(world, tmp_path, capsys, penalty, var_type):
    argv = ["-b", world["truth"], "-c", world["heldout"], "-t", world["fasta"], "-e", world["hcr"],
            "-p", penalty, "--var_type", var_type]
    jax_main(["vcfeval_flavors", *argv, "-o", str(tmp_path / "j")])
    want_out = capsys.readouterr().out
    assert torch_main(["vcfeval_flavors", *argv, "-o", str(tmp_path / "t"), "--backend", "cpu"]) == 0
    got_out = capsys.readouterr().out
    want = (tmp_path / "j" / "vcfeval_flavors_results.txt").read_bytes()
    assert (tmp_path / "t" / "vcfeval_flavors_results.txt").read_bytes() == want
    assert [ln for ln in got_out.splitlines() if ln.startswith(("type", "snps", "indels"))] == \
        [ln for ln in want_out.splitlines() if ln.startswith(("type", "snps", "indels"))]
    assert len(want.splitlines()) == (3 if var_type == "both" else 2)
