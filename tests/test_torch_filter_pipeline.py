"""The port's filter_variants_pipeline CLI against the JAX package's, byte for byte.

The world is built like tests/system/test_filter_variants_pipeline.py; the
model pickle is written by the JAX package's ``registry.save_models`` and
loaded by the port. A second world is the port's synthetic xgboost one: a
bare xgboost JSON model with default_left routing over a callset where
some records lack SOR and GQ. Outputs must be identical outside the
``##vctpu_*`` provenance lines (``tests/fixtures.strip_vctpu_header``),
under every ``VCTPU_FOREST_STRATEGY`` the forest can be served by; for
``.vcf.gz`` the decompressed bytes are compared.
"""

import gzip
import pickle

import numpy as np
import pytest

from tests import fixtures
from variantcalling_tpu.featurize import featurize
from variantcalling_tpu.io.fasta import FastaReader
from variantcalling_tpu.io.vcf import read_vcf
from variantcalling_tpu.models import registry
from variantcalling_tpu.models.forest import from_sklearn
from variantcalling_tpu.pipelines import filter_variants as fvp
from variantcalling_tpu_torch import synthetic as tsynth
from variantcalling_tpu_torch.__main__ import main as torch_main
from variantcalling_tpu_torch.models.forest import FOREST_STRATEGY_ENV


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from sklearn.ensemble import GradientBoostingClassifier, RandomForestClassifier

    rng = np.random.default_rng(7)
    tmp = tmp_path_factory.mktemp("torch_fvp")
    contigs = {"chr1": 20000, "chr2": 10000}
    genome = fixtures.make_genome(rng, contigs)
    fasta_path = tmp / "ref.fa"
    fixtures.write_fasta(str(fasta_path), genome)
    recs = fixtures.synth_variants(rng, genome, 400)
    for r in recs:
        r["pl"] = [30, 0, 40]
        r["gq"] = int(rng.integers(10, 90))
        r["ad"] = [int(rng.integers(5, 30)), int(rng.integers(1, 30))]
    vcf_path = tmp / "calls.vcf.gz"
    fixtures.write_vcf(str(vcf_path), recs, contigs)
    (tmp / "runs.bed").write_text("chr1\t1000\t1015\nchr1\t5000\t5012\nchr2\t2000\t2005\n")
    (tmp / "LCR-test.bed").write_text("chr1\t0\t4000\nchr2\t8000\t10000\n")
    with open(tmp / "blacklist.pkl", "wb") as fh:
        pickle.dump([(recs[i]["chrom"], recs[i]["pos"]) for i in (3, 10, 50, 100, 200)], fh)

    table = read_vcf(str(vcf_path))
    fasta = FastaReader(str(fasta_path))
    fs = featurize(table, fasta)
    x = fs.matrix()
    y = (x[:, fs.feature_names.index("qual")] > 50).astype(int)
    rf = RandomForestClassifier(n_estimators=10, max_depth=5, random_state=0).fit(x, y)
    gbt = GradientBoostingClassifier(n_estimators=12, max_depth=3, random_state=0).fit(x, y)
    registry.save_models(str(tmp / "model.pkl"), {
        "rf_model_ignore_gt_incl_hpol_runs": from_sklearn(rf, feature_names=fs.feature_names),
        "xgb_model_ignore_gt_incl_hpol_runs": from_sklearn(gbt, feature_names=fs.feature_names),
    })
    return tmp


def _argv(w, out, model_name: str, extra: bool) -> list[str]:
    argv = ["--input_file", str(w / "calls.vcf.gz"), "--model_file", str(w / "model.pkl"),
            "--model_name", model_name, "--reference_file", str(w / "ref.fa"),
            "--output_file", str(out), "--backend", "cpu"]
    if extra:
        argv += ["--runs_file", str(w / "runs.bed"), "--annotate_intervals", str(w / "LCR-test.bed"),
                 "--blacklist", str(w / "blacklist.pkl"), "--blacklist_cg_insertions",
                 "--hpol_filter_length_dist", "10", "10"]
    return argv


def _read(path) -> bytes:
    data = open(path, "rb").read()
    return gzip.decompress(data) if str(path).endswith(".gz") else data


@pytest.mark.parametrize("suffix,model_name,extra", [
    (".vcf", "rf_model_ignore_gt_incl_hpol_runs", False),
    (".vcf.gz", "rf_model_ignore_gt_incl_hpol_runs", False),
    (".vcf", "rf_model_ignore_gt_incl_hpol_runs", True),
    (".vcf", "xgb_model_ignore_gt_incl_hpol_runs", True),
])
def test_port_cli_output_bytes_equal_reference(world, suffix, model_name, extra):
    ref_out = world / f"ref_{model_name}_{extra}{suffix}"
    port_out = world / f"port_{model_name}_{extra}{suffix}"
    assert fvp.run(_argv(world, ref_out, model_name, extra)) == 0
    assert torch_main(["filter_variants_pipeline", *_argv(world, port_out, model_name, extra)]) == 0
    ref_bytes, port_bytes = _read(ref_out), _read(port_out)
    if suffix == ".vcf.gz":
        assert open(port_out, "rb").read().endswith(bytes.fromhex(
            "1f8b08040000000000ff0600424302001b0003000000000000000000"))  # BGZF EOF block
    assert fixtures.strip_vctpu_header(port_bytes) == fixtures.strip_vctpu_header(ref_bytes)
    lines = port_bytes.decode().splitlines()
    assert "##vctpu_engine=torch-cpu" in lines and "##vctpu_forest_strategy=gather" in lines
    records = [ln for ln in lines if not ln.startswith("#")]
    n_in = sum(1 for ln in _read(world / "calls.vcf.gz").decode().splitlines() if not ln.startswith("#"))
    assert len(records) == n_in and all("TREE_SCORE=" in ln for ln in records)
    filters = {ln.split("\t")[6] for ln in records}
    assert {"PASS", "LOW_SCORE"} <= filters
    if extra:
        assert any("COHORT_FP" in f for f in filters) and any("HPOL_RUN" in f for f in filters)


def test_h5_blacklist_exits_2(world, tmp_path):
    h5 = tmp_path / "bl.h5"
    h5.write_bytes(b"")
    argv = _argv(world, tmp_path / "o.vcf", "rf_model_ignore_gt_incl_hpol_runs", False)
    assert torch_main(["filter_variants_pipeline", *argv, "--blacklist", str(h5)]) == 2
    assert not (tmp_path / "o.vcf").exists()


def test_threshold_model_pickle_exits_2(world, tmp_path):
    from variantcalling_tpu.models.threshold import ThresholdModel

    registry.save_models(str(tmp_path / "thr.pkl"), {"threshold_model_ignore_gt_incl_hpol_runs":
                                                     ThresholdModel(
        feature_names=["qual"], thresholds=np.zeros(1, np.float32), signs=np.ones(1, np.float32),
        scales=np.ones(1, np.float32))})
    argv = _argv(world, tmp_path / "o.vcf", "threshold_model_ignore_gt_incl_hpol_runs", False)
    argv[argv.index("--model_file") + 1] = str(tmp_path / "thr.pkl")
    assert torch_main(["filter_variants_pipeline", *argv]) == 2
    assert not (tmp_path / "o.vcf").exists()


@pytest.fixture(scope="module")
def xgb_world(tmp_path_factory):
    """The port's xgboost world at a small size, and the reference CLI's output on it."""
    d = tmp_path_factory.mktemp("torch_fvp_xgb")
    w = tsynth.write_world(str(d), seed=5, contig="chr20", length=40_000, n_variants=400, n_trees=6,
                           xgboost=True)
    argv = ["--input_file", w["vcf"], "--model_file", w["model"], "--model_name", w["model_name"],
            "--reference_file", w["fasta"], "--backend", "cpu"]
    assert fvp.run([*argv, "--output_file", str(d / "ref.vcf")]) == 0
    return d, argv, (d / "ref.vcf").read_bytes()


@pytest.mark.parametrize("strategy,recorded", [("auto", "gather"), ("gather", "gather"), ("gemm", "gemm"),
                                               ("wide", "wide")])
def test_port_cli_xgboost_world_bytes_equal_reference(xgb_world, monkeypatch, strategy, recorded):
    """Every strategy that serves a default_left forest writes the reference's
    bytes, and so does the reference itself under the same request."""
    d, argv, ref_bytes = xgb_world
    text = open(argv[1]).read()
    assert "GT:AD\t" in text and any("SOR=" not in ln for ln in text.splitlines() if not ln.startswith("#"))
    out, ref_out = d / f"port_{strategy}.vcf", d / f"ref_{strategy}.vcf"
    monkeypatch.setenv(FOREST_STRATEGY_ENV, strategy)
    assert fvp.run([*argv, "--output_file", str(ref_out)]) == 0
    assert fixtures.strip_vctpu_header(ref_out.read_bytes()) == fixtures.strip_vctpu_header(ref_bytes)
    assert torch_main(["filter_variants_pipeline", *argv, "--output_file", str(out)]) == 0
    port_bytes = out.read_bytes()
    assert fixtures.strip_vctpu_header(port_bytes) == fixtures.strip_vctpu_header(ref_bytes)
    lines = port_bytes.decode().splitlines()
    assert f"##vctpu_forest_strategy={recorded}" in lines
    filters = {ln.split("\t")[6] for ln in lines if not ln.startswith("#")}
    assert {"PASS", "LOW_SCORE"} <= filters


@pytest.mark.parametrize("strategy", ["pallas", "fastest"])
def test_unservable_or_malformed_strategy_exits_2(xgb_world, monkeypatch, tmp_path, strategy):
    """Explicit pallas cannot serve a default_left forest (nor can the reference's
    Pallas kernel); a malformed value is refused."""
    _, argv, _ = xgb_world
    monkeypatch.setenv(FOREST_STRATEGY_ENV, strategy)
    assert torch_main(["filter_variants_pipeline", *argv, "--output_file", str(tmp_path / "o.vcf")]) == 2
    assert not (tmp_path / "o.vcf").exists()


@pytest.mark.parametrize("strategy,recorded", [("auto", "gather"), ("gather", "gather"), ("gemm", "gemm"),
                                               ("wide", "wide"), ("pallas", "wide")])
def test_each_strategy_writes_reference_bytes(world, monkeypatch, strategy, recorded):
    name = "rf_model_ignore_gt_incl_hpol_runs"
    ref_out, port_out = world / f"ref_strategy_{strategy}.vcf", world / f"port_strategy_{strategy}.vcf"
    assert fvp.run(_argv(world, ref_out, name, True)) == 0
    monkeypatch.setenv(FOREST_STRATEGY_ENV, strategy)
    assert torch_main(["filter_variants_pipeline", *_argv(world, port_out, name, True)]) == 0
    port_bytes = _read(port_out)
    assert fixtures.strip_vctpu_header(port_bytes) == fixtures.strip_vctpu_header(_read(ref_out))
    assert f"##vctpu_forest_strategy={recorded}" in port_bytes.decode().splitlines()
