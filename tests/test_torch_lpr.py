"""The LPR pair of the port against the JAX package's, on the CPU.

``train_lib_prep_recalibration_model``: the labeled frame in row order
against pandas (``label_by_allele_frequency``), ``balance`` with each flag
(pandas' ``sample`` and group orders), the labeled parquet read back by
pyarrow equal to the reference's frame, the model held to
``tests/torch_worlds.forest_bar``; the port's and the reference's pickles
read across. ``filter_vcf_with_lib_prep_recalibration_model`` given one
model: the scored parquet equal to the reference's and the recalibrated VCF
byte-equal (with tied read scores, as forests give). The cases of
``tests/unit/test_lpr.py:46-63``.
"""

import gzip

import numpy as np
import pandas as pd
import pyarrow.parquet as pq
import pytest

from tests import torch_worlds
from tests.fixtures import strip_vctpu_header, write_fasta
from tests.test_torch_featuremap import assert_frame_equal
from variantcalling_tpu.io import featuremap as jfm
from variantcalling_tpu.pipelines.lpr import filter_vcf_with_lib_prep_recalibration_model as jfilter
from variantcalling_tpu.pipelines.lpr import train_lib_prep_recalibration_model as jtrain
from variantcalling_tpu_torch import synthetic_featuremap as sfm
from variantcalling_tpu_torch.io import featuremap as tfm
from variantcalling_tpu_torch.models import registry as tregistry
from variantcalling_tpu_torch.pipelines.lpr import filter_vcf_with_lib_prep_recalibration_model as tfilter
from variantcalling_tpu_torch.pipelines.lpr import train_lib_prep_recalibration_model as ttrain
from variantcalling_tpu_torch.utils.h5_utils import Frame

CPU = ["--backend", "cpu"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("lpr_world")
    return sfm.write_featuremap_world(str(d), seed=17, length=300_000, n_tp=200, n_fp=200, n_cfdna=200,
                                      n_signature=20, n_lpr_loci=240, lpr_reads=4_000, n_calls=1_500)


def _frame(df: pd.DataFrame) -> Frame:
    return Frame({c: df[c].to_numpy().astype(object) if str(df[c].dtype) in ("str", "object")
                  else df[c].to_numpy() for c in df.columns})


@pytest.mark.parametrize("tp_min_af,fp_max_af", [(0.9, 0.04), (0.3, 0.5), (2.0, -1.0)])
def test_labels_equal_pandas(world, tp_min_af, fp_max_af):
    want = jtrain.label_by_allele_frequency(jfm.featuremap_to_dataframe(world["lpr_featuremap"], world["fasta"]),
                                            tp_min_af, fp_max_af)
    got = ttrain.label_by_allele_frequency(tfm.featuremap_to_dataframe(world["lpr_featuremap"], world["fasta"]),
                                           tp_min_af, fp_max_af)
    assert_frame_equal(got, want.reset_index(drop=True))


def test_labels_with_zero_read_count_and_no_read_count():
    cols = {"chrom": np.array(["c"] * 5, dtype=object), "pos": np.array([1, 1, 2, 3, 3]),
            "ref": np.array(["A"] * 5, dtype=object), "alt": np.array(["C", "C", "G", "T", "T"], dtype=object),
            "x_read_count": np.array([2.0, 2.0, 0.0, np.nan, 40.0])}
    want = jtrain.label_by_allele_frequency(pd.DataFrame(cols), 0.9, 0.04)
    assert_frame_equal(ttrain.label_by_allele_frequency(Frame(cols), 0.9, 0.04), want.reset_index(drop=True))
    with pytest.raises(ValueError, match="X_READ_COUNT"):
        ttrain.label_by_allele_frequency(Frame({"chrom": cols["chrom"]}), 0.9, 0.04)


@pytest.mark.parametrize("by_motif,tp_fp", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("seed", [0, 5])
def test_balance_equals_pandas(world, by_motif, tp_fp, seed):
    labeled = jtrain.label_by_allele_frequency(
        jfm.featuremap_to_dataframe(world["lpr_featuremap"], world["fasta"]), 0.9, 0.04)
    want = jtrain.balance(labeled, by_motif, tp_fp, seed=seed)
    got = ttrain.balance(_frame(labeled), by_motif, tp_fp, seed=seed)
    assert_frame_equal(got, want.reset_index(drop=True))


def _train_argv(world, out, extra=()):
    return ["--out_dir", str(out), "--ref_fasta", world["fasta"], "--featuremap_vcf", world["lpr_featuremap"],
            "--n_trees", "10", "--depth", "4", *extra]


@pytest.mark.parametrize("calls,balanced", [(False, False), (True, False), (True, True)],
                         ids=["all", "calls", "balanced_calls"])
def test_training_against_the_reference(world, calls, balanced, tmp_path):
    argv = (["--calls_vcf", world["lpr_calls"]] if calls else []) + (
        ["--balance_tp_fp", "--balance_motifs"] if balanced else [])
    assert ttrain.run(_train_argv(world, tmp_path / "t", argv) + CPU) == 0
    assert jtrain.run(_train_argv(world, tmp_path / "j", argv)) == 0
    name = "labeled_featuremap_training_set.parquet"
    got, want = pq.read_table(tmp_path / "t" / name).to_pandas(), pd.read_parquet(tmp_path / "j" / name)
    assert list(got.columns) == list(want.columns)
    assert got.dtypes.to_dict() == want.dtypes.to_dict()
    pd.testing.assert_frame_equal(got, want)
    port = tregistry.load_models(str(tmp_path / "t" / "lib_prep_model.npz"))["lib_prep"]
    ref = tregistry.load_models(str(tmp_path / "j" / "lib_prep_model.npz"))["lib_prep"]
    x = tfm.feature_matrix(tfm.featuremap_to_dataframe(world["lpr_featuremap"]), port.feature_names)
    bar = torch_worlds.forest_bar(port, ref, np.nan_to_num(x))
    assert bar["held"], bar


@pytest.fixture(scope="module")
def model(world, tmp_path_factory):
    d = tmp_path_factory.mktemp("lpr_model")
    assert jtrain.run(_train_argv(world, d, ["--output_suffix", "_x"])) == 0
    return str(d / "lib_prep_model_x.npz")


@pytest.mark.parametrize("top_n", ["5", "1", "1000"])
def test_filter_equals_the_reference(world, model, top_n, tmp_path):
    argv = ["--ref_fasta", world["fasta"], "--lib_prep_model_file", model, "--calls_vcf", world["lpr_calls"],
            "--featuremap_vcf", world["lpr_featuremap"], "--top_n_reads", top_n, "--output_suffix", "_s"]
    assert tfilter.run(["--out_dir", str(tmp_path / "t"), *argv, *CPU]) == 0
    assert jfilter.run(["--out_dir", str(tmp_path / "j"), *argv]) == 0
    got = pq.read_table(tmp_path / "t" / "scored_alleles_s.parquet").to_pandas()
    want = pd.read_parquet(tmp_path / "j" / "scored_alleles_s.parquet")
    pd.testing.assert_frame_equal(got, want)
    vcf = "recalibrated_s.vcf.gz"
    a, b = ((tmp_path / s / vcf).read_bytes() for s in ("t", "j"))
    assert strip_vctpu_header(gzip.decompress(a)) == strip_vctpu_header(gzip.decompress(b))
    assert (tmp_path / "t" / (vcf + ".tbi")).read_bytes() == (tmp_path / "j" / (vcf + ".tbi")).read_bytes()
    assert b"LPR_SCORE=" in gzip.decompress(a)


def test_aggregate_with_ties_equals_pandas():
    """Tied read scores (a forest's leaves repeat) and NaN: pandas' unstable
    descending quicksort, ``head`` and compensated float32 mean."""
    rng = np.random.default_rng(4)
    n = 5_000
    keys = {"chrom": np.array(["chr1", "chr2"], dtype=object)[rng.integers(0, 2, n)],
            "pos": rng.integers(0, 300, n), "ref": np.array(["A"] * n, dtype=object),
            "alt": np.array(["C", "G"], dtype=object)[rng.integers(0, 2, n)]}
    scores = rng.choice(np.array([0.1, 0.25, 0.5, 0.9, 0.999, 1e-7], dtype=np.float32), n)
    scores[rng.random(n) < 0.01] = np.nan
    df = pd.DataFrame({**keys, "read_score": scores})
    for top_n in (1, 3, 5, 50):
        want = (df.sort_values("read_score", ascending=False).groupby(list(keys), sort=False).head(top_n)
                .groupby(list(keys), sort=False)["read_score"].agg(["mean", "count"])
                .rename(columns={"mean": "lpr_score", "count": "n_scored_reads"}).reset_index())
        got = tfilter.aggregate_top_reads(keys, scores, top_n)
        assert_frame_equal(got, want)


def test_reference_test_case(tmp_path, rng):
    """``tests/unit/test_lpr.py:46-63``: the featuremap frame and the round trip."""
    from tests.unit.test_lpr import _write_featuremap

    seq = "ACGT" * 25000
    write_fasta(str(tmp_path / "ref.fa"), {"chr1": seq})
    fm = tmp_path / "fm.vcf"
    _write_featuremap(fm, seq, rng)
    df = tfm.featuremap_to_dataframe(str(fm), str(tmp_path / "ref.fa"))
    assert len(df) == 240 and "rn" in df.columns and all(len(m) == 3 for m in df["ref_motif"])
    assert_frame_equal(df, jfm.featuremap_to_dataframe(str(fm), str(tmp_path / "ref.fa")))
    assert ttrain.run(["--out_dir", str(tmp_path / "o"), "--ref_fasta", str(tmp_path / "ref.fa"),
                       "--featuremap_vcf", str(fm), "--n_trees", "5", "--depth", "3", *CPU]) == 0
    labeled = pq.read_table(tmp_path / "o" / "labeled_featuremap_training_set.parquet").to_pandas()
    assert labeled["label"].sum() == 200 and (~labeled["label"]).sum() == 40
