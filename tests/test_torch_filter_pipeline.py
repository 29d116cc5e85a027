"""The port's filter_variants_pipeline CLI against the JAX package's.

The world is built like tests/system/test_filter_variants_pipeline.py; the
model pickle is written by the JAX package's ``registry.save_models`` and
loaded by the port. A second world is the port's synthetic xgboost one: a
bare xgboost JSON model with default_left routing over a callset where
some records lack SOR and GQ. Forest outputs must be identical outside the
``##vctpu_*`` provenance lines (``tests/fixtures.strip_vctpu_header``),
under every ``VCTPU_FOREST_STRATEGY`` the forest can be served by, with
windows from the host gather and from the resident genome (the port's
``GENOME_RESIDENT_MIN_VARIANTS`` set to 0); for ``.vcf.gz`` the
decompressed bytes are compared, and the ``.tbi`` beside it equals the
reference's index of the same file. Threshold and DAN models (in one
pickle with the forest, saved by the JAX package) are held to 1e-6 and
1e-5: differing records are counted, printed and checked by
``tests/torch_vcf_compare.py``. ``VCTPU_MODEL_FAMILY``: a mismatch or a
malformed value exits 2; the family's header line.
"""

import dataclasses
import gzip
import logging
import pickle
import shutil

import numpy as np
import pytest

from tests import fixtures
from tests.torch_vcf_compare import differing_records
from variantcalling_tpu.featurize import BASE_FEATURES, featurize
from variantcalling_tpu.io.fasta import FastaReader
from variantcalling_tpu.io.vcf import read_vcf
from variantcalling_tpu.io import tabix as jtabix
from variantcalling_tpu.models import dan as jdan
from variantcalling_tpu.models import registry
from variantcalling_tpu.models.forest import from_sklearn
from variantcalling_tpu.models.threshold import ThresholdModel as JThresholdModel
from variantcalling_tpu.pipelines import filter_variants as fvp
from variantcalling_tpu_torch import synthetic as tsynth
from variantcalling_tpu_torch.__main__ import main as torch_main
from variantcalling_tpu_torch import featurize as tfeat
from variantcalling_tpu_torch.models.forest import FOREST_STRATEGY_ENV
from variantcalling_tpu_torch.models.registry import MODEL_FAMILY_ENV


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


def test_threshold_model_pickle_exits_2(world, tmp_path, monkeypatch):
    """A threshold model scores only through VCTPU_MODEL_FAMILY=auto: an explicit
    forest request against it exits 2 and writes nothing."""
    from variantcalling_tpu.models.threshold import ThresholdModel

    registry.save_models(str(tmp_path / "thr.pkl"), {"threshold_model_ignore_gt_incl_hpol_runs":
                                                     ThresholdModel(
        feature_names=["qual"], thresholds=np.zeros(1, np.float32), signs=np.ones(1, np.float32),
        scales=np.ones(1, np.float32))})
    argv = _argv(world, tmp_path / "o.vcf", "threshold_model_ignore_gt_incl_hpol_runs", False)
    argv[argv.index("--model_file") + 1] = str(tmp_path / "thr.pkl")
    monkeypatch.setenv(MODEL_FAMILY_ENV, "forest")
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


@pytest.fixture
def resident(monkeypatch, caplog):
    """Windows from the port's resident genome at any table size; a genome cache
    of the test's own, so that later tests keep the host gather."""
    monkeypatch.setattr(tfeat, "GENOME_RESIDENT_MIN_VARIANTS", 0)
    monkeypatch.setattr(tfeat, "_DEVICE_GENOME_CACHE", {})
    caplog.set_level(logging.INFO, logger="variantcalling_tpu_torch")
    return caplog


def _window_paths(caplog) -> list[str]:
    return [r.getMessage() for r in caplog.records if r.getMessage().startswith("window path ")]


@pytest.mark.parametrize("strategy,recorded", [("auto", "gather"), ("gather", "gather"), ("gemm", "gemm"),
                                               ("wide", "wide"), ("pallas", "wide")])
def test_resident_genome_writes_reference_bytes(world, monkeypatch, resident, strategy, recorded):
    """Everything but --blacklist_cg_insertions (which keeps host windows)."""
    def argv(out):
        return [*_argv(world, out, "rf_model_ignore_gt_incl_hpol_runs", False), "--runs_file",
                str(world / "runs.bed"), "--annotate_intervals", str(world / "LCR-test.bed"),
                "--blacklist", str(world / "blacklist.pkl")]

    ref_out, port_out = world / f"ref_resident_{strategy}.vcf", world / f"port_resident_{strategy}.vcf"
    assert fvp.run(argv(ref_out)) == 0
    monkeypatch.setenv(FOREST_STRATEGY_ENV, strategy)
    assert torch_main(["filter_variants_pipeline", *argv(port_out)]) == 0
    assert _window_paths(resident) == ["window path genome-resident"]
    port_bytes = port_out.read_bytes()
    assert fixtures.strip_vctpu_header(port_bytes) == fixtures.strip_vctpu_header(ref_out.read_bytes())
    assert f"##vctpu_forest_strategy={recorded}" in port_bytes.decode().splitlines()
    assert any("COHORT_FP" in ln or "HPOL_RUN" in ln for ln in port_bytes.decode().splitlines()[-400:])


@pytest.mark.parametrize("strategy,recorded", [("auto", "gather"), ("gemm", "gemm"), ("wide", "wide")])
def test_resident_genome_xgboost_world_bytes(xgb_world, monkeypatch, resident, tmp_path, strategy, recorded):
    d, argv, ref_bytes = xgb_world
    monkeypatch.setenv(FOREST_STRATEGY_ENV, strategy)
    assert torch_main(["filter_variants_pipeline", *argv, "--output_file", str(tmp_path / "o.vcf")]) == 0
    assert _window_paths(resident) == ["window path genome-resident"]
    port_bytes = (tmp_path / "o.vcf").read_bytes()
    assert fixtures.strip_vctpu_header(port_bytes) == fixtures.strip_vctpu_header(ref_bytes)
    assert f"##vctpu_forest_strategy={recorded}" in port_bytes.decode().splitlines()


def test_cg_insertions_keep_the_host_gather(world, resident, tmp_path):
    """--blacklist_cg_insertions reads windows on the host, whatever the table size."""
    argv = _argv(world, tmp_path / "o.vcf", "rf_model_ignore_gt_incl_hpol_runs", True)
    assert torch_main(["filter_variants_pipeline", *argv]) == 0
    assert _window_paths(resident) == ["window path host gather"]
    assert fvp.run(_argv(world, tmp_path / "r.vcf", "rf_model_ignore_gt_incl_hpol_runs", True)) == 0
    assert fixtures.strip_vctpu_header((tmp_path / "o.vcf").read_bytes()) == \
        fixtures.strip_vctpu_header((tmp_path / "r.vcf").read_bytes())


FAMILY_NAMES = {"threshold": "threshold_model_ignore_gt_incl_hpol_runs", "dan": "dan_model_ignore_gt_incl_hpol_runs"}
FAMILY_TOL = {"threshold": 1e-6, "dan": 1e-5}


@pytest.fixture(scope="module")
def family_pickle(world):
    """One pickle, saved by the JAX package, with a forest, a threshold model over
    qual and af, and a DAN (hidden 16) whose weights come from a numpy seed."""
    rng = np.random.default_rng(23)
    pdan = tsynth.synthetic_dan(rng, list(BASE_FEATURES), embed_dim=4, hidden=16, n_layers=2)
    jd = jdan.DanModel(cfg=jdan.DanConfig(**dataclasses.asdict(pdan.cfg)), params_np=pdan.params_np,
                       feature_names=pdan.feature_names, numeric_features=pdan.numeric_features,
                       pass_threshold=0.5, norm_mu=pdan.norm_mu, norm_sd=pdan.norm_sd)
    pthr = tsynth.synthetic_threshold(rng, list(BASE_FEATURES), used=("qual", "af"))
    jt = JThresholdModel(pthr.feature_names, pthr.thresholds, pthr.signs, pthr.scales, pthr.pass_threshold,
                         pthr.all_feature_names)
    models = registry.load_models(str(world / "model.pkl"))
    path = world / "families.pkl"
    registry.save_models(str(path), {"rf_model_ignore_gt_incl_hpol_runs": models["rf_model_ignore_gt_incl_hpol_runs"],
                                     FAMILY_NAMES["threshold"]: jt, FAMILY_NAMES["dan"]: jd})
    return path


def _family_argv(world, pickle_path, out, name: str) -> list[str]:
    argv = _argv(world, out, name, False)
    argv[argv.index("--model_file") + 1] = str(pickle_path)
    return argv


@pytest.mark.parametrize("family", ["threshold", "dan"])
@pytest.mark.parametrize("windows", ["host", "resident"])
def test_family_cli_matches_reference(world, family_pickle, monkeypatch, caplog, capsys, tmp_path, family, windows):
    name = FAMILY_NAMES[family]
    caplog.set_level(logging.INFO, logger="variantcalling_tpu_torch")
    if windows == "resident":
        monkeypatch.setattr(tfeat, "GENOME_RESIDENT_MIN_VARIANTS", 0)
        monkeypatch.setattr(tfeat, "_DEVICE_GENOME_CACHE", {})
    assert fvp.run(_family_argv(world, family_pickle, tmp_path / "ref.vcf", name)) == 0
    assert torch_main(["filter_variants_pipeline", *_family_argv(world, family_pickle, tmp_path / "port.vcf",
                                                                   name)]) == 0
    assert _window_paths(caplog) == [f"window path {'genome-resident' if windows == 'resident' else 'host gather'}"]
    port = (tmp_path / "port.vcf").read_bytes()
    pass_threshold = 0.5 if family == "dan" else 0.25
    n_diff = differing_records(port, (tmp_path / "ref.vcf").read_bytes(), pass_threshold, FAMILY_TOL[family])
    lines = port.decode().splitlines()
    n_rec = sum(not ln.startswith("#") for ln in lines)
    with capsys.disabled():
        print(f"\n{family} CLI ({windows} windows): {n_diff} of {n_rec} records differ from the reference's")
    assert n_diff <= n_rec // 100
    assert lines.count(f"##vctpu_model_family={family}") == 1 and "##vctpu_forest_strategy=torch" in lines
    filters = {ln.split("\t")[6] for ln in lines if not ln.startswith("#")}
    assert {"PASS", "LOW_SCORE"} <= filters


@pytest.mark.parametrize("request_,name,rc", [
    ("dan", "rf_model_ignore_gt_incl_hpol_runs", 2), ("forest", "dan_model_ignore_gt_incl_hpol_runs", 2),
    ("dan", "threshold_model_ignore_gt_incl_hpol_runs", 2), ("threshold", "threshold_model_ignore_gt_incl_hpol_runs", 2),
    ("banana", "rf_model_ignore_gt_incl_hpol_runs", 2), ("DAN", "dan_model_ignore_gt_incl_hpol_runs", 0),
    ("forest", "rf_model_ignore_gt_incl_hpol_runs", 0), ("", "threshold_model_ignore_gt_incl_hpol_runs", 0)])
def test_model_family_request(world, family_pickle, monkeypatch, tmp_path, request_, name, rc):
    """An explicit family the model is not of, or a malformed request, exits 2
    and writes nothing; a matching one (any case) or auto scores."""
    monkeypatch.setenv(MODEL_FAMILY_ENV, request_)
    out = tmp_path / "o.vcf"
    assert torch_main(["filter_variants_pipeline", *_family_argv(world, family_pickle, out, name)]) == rc
    assert out.exists() == (rc == 0)


def test_family_header_written_for_dan_and_stripped_for_forest(world, family_pickle, tmp_path):
    """A re-filtered input carries a stale family line: a forest run strips it,
    a DAN run replaces it."""
    stale = tmp_path / "stale.vcf"
    text = gzip.decompress((world / "calls.vcf.gz").read_bytes()).decode()
    stale.write_text(text.replace("##fileformat=VCFv4.2\n", "##fileformat=VCFv4.2\n##vctpu_model_family=threshold\n"))
    for name, want in (("rf_model_ignore_gt_incl_hpol_runs", []), (FAMILY_NAMES["dan"], ["##vctpu_model_family=dan"])):
        argv = _family_argv(world, family_pickle, tmp_path / "o.vcf", name)
        argv[argv.index("--input_file") + 1] = str(stale)
        assert torch_main(["filter_variants_pipeline", *argv]) == 0
        lines = (tmp_path / "o.vcf").read_text().splitlines()
        assert [ln for ln in lines if ln.startswith("##vctpu_model_family=")] == want


def test_vcf_gz_output_gets_the_reference_index(world, tmp_path):
    out = tmp_path / "o.vcf.gz"
    assert torch_main(["filter_variants_pipeline", *_argv(world, out, "rf_model_ignore_gt_incl_hpol_runs", True)]) == 0
    copy = tmp_path / "copy.vcf.gz"
    shutil.copyfile(out, copy)
    jtabix.build_tabix_index(str(copy))
    assert (tmp_path / "o.vcf.gz.tbi").read_bytes() == (tmp_path / "copy.vcf.gz.tbi").read_bytes()
    records = [ln for ln in gzip.decompress(out.read_bytes()).decode().splitlines()
               if not ln.startswith("#") and ln.startswith("chr2\t")]
    assert list(jtabix.read_region_lines(str(out), "chr2", 0, 10_000)) == records
