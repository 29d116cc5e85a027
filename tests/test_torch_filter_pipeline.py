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

A third world (``tests/torch_worlds.write_gatk_world``) writes QUAL as GATK
does ("69.40", "24240.00", "."), which the reference writes back verbatim:
the port's bytes must equal its bytes under every strategy, on both window
paths, into ``.vcf`` and ``.vcf.gz``; so on the world's CRLF copy (the
``##`` lines keep their ``\r``), with an h5 blacklist in either layout (and
exit 2 where the port's reader cannot read the file, or the frame has no
chrom and pos columns), and with and without the ``.venc`` genome sidecar.
"""

import dataclasses
import gzip
import logging
import os
import pickle
import shutil

import numpy as np
import pytest

from tests import fixtures, torch_worlds
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


def _save_family_pickle(forest_pickle, path):
    """One pickle, saved by the JAX package, with the forest of
    ``forest_pickle``, a threshold model over qual and af, and a DAN (hidden
    16) whose weights come from a numpy seed."""
    rng = np.random.default_rng(23)
    pdan = tsynth.synthetic_dan(rng, list(BASE_FEATURES), embed_dim=4, hidden=16, n_layers=2)
    jd = jdan.DanModel(cfg=jdan.DanConfig(**dataclasses.asdict(pdan.cfg)), params_np=pdan.params_np,
                       feature_names=pdan.feature_names, numeric_features=pdan.numeric_features,
                       pass_threshold=0.5, norm_mu=pdan.norm_mu, norm_sd=pdan.norm_sd)
    pthr = tsynth.synthetic_threshold(rng, list(BASE_FEATURES), used=("qual", "af"))
    jt = JThresholdModel(pthr.feature_names, pthr.thresholds, pthr.signs, pthr.scales, pthr.pass_threshold,
                         pthr.all_feature_names)
    models = registry.load_models(str(forest_pickle))
    registry.save_models(str(path), {"rf_model_ignore_gt_incl_hpol_runs": models["rf_model_ignore_gt_incl_hpol_runs"],
                                     FAMILY_NAMES["threshold"]: jt, FAMILY_NAMES["dan"]: jd})
    return path


@pytest.fixture(scope="module")
def family_pickle(world):
    return _save_family_pickle(world / "model.pkl", world / "families.pkl")


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


# -- GATK-style QUAL, CRLF input, h5 blacklists, the genome sidecar ---------

@pytest.fixture(scope="module")
def gatk_world(tmp_path_factory):
    """``tests/torch_worlds.write_gatk_world``, its threshold/DAN pickle, and a
    cache of the reference CLI's outputs (decompressed bytes, .tbi bytes)."""
    d = tmp_path_factory.mktemp("torch_fvp_gatk")
    w = torch_worlds.write_gatk_world(d)
    w["families"] = _save_family_pickle(d / "model.pkl", d / "families.pkl")
    w["ref"] = {}
    return w


def _gatk_argv(w, out, input_name="calls.vcf", model_name="rf_model_ignore_gt_incl_hpol_runs",
               blacklist=None, model_file="model.pkl") -> list[str]:
    d = w["dir"]
    argv = ["--input_file", str(d / input_name), "--model_file", str(d / model_file), "--model_name", model_name,
            "--reference_file", str(d / "ref.fa"), "--output_file", str(out), "--backend", "cpu"]
    return argv + (["--blacklist", str(d / blacklist)] if blacklist else [])


def _gatk_reference(w, **kw) -> bytes:
    """The reference CLI's output bytes (decompressed) for these arguments, run once."""
    key = tuple(sorted(kw.items()))
    if key not in w["ref"]:
        out = w["dir"] / f"ref_{len(w['ref'])}{'.vcf.gz' if kw.get('suffix') == '.vcf.gz' else '.vcf'}"
        args = {k: v for k, v in kw.items() if k != "suffix"}
        assert fvp.run(_gatk_argv(w, out, **args)) == 0
        w["ref"][key] = _read(out)
    return w["ref"][key]


def _qual_column(data: bytes) -> list[str]:
    return [ln.split("\t")[5] for ln in data.decode().splitlines() if ln and not ln.startswith("#")]


def _port_run(w, tmp_path, suffix, windows, monkeypatch, **kw) -> bytes:
    if windows == "resident":
        monkeypatch.setattr(tfeat, "GENOME_RESIDENT_MIN_VARIANTS", 0)
        monkeypatch.setattr(tfeat, "_DEVICE_GENOME_CACHE", {})
    out = tmp_path / f"port{suffix}"
    assert torch_main(["filter_variants_pipeline", *_gatk_argv(w, out, **kw)]) == 0
    if suffix == ".vcf.gz":  # the .tbi of the port's file equals the reference's index of it
        copy = tmp_path / "copy.vcf.gz"
        shutil.copyfile(out, copy)
        jtabix.build_tabix_index(str(copy))
        assert (tmp_path / "port.vcf.gz.tbi").read_bytes() == (tmp_path / "copy.vcf.gz.tbi").read_bytes()
    return _read(out)


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
@pytest.mark.parametrize("windows", ["host", "resident"])
@pytest.mark.parametrize("strategy", ["auto", "gather", "gemm", "wide", "pallas"])
@pytest.mark.parametrize("model_name", ["rf_model_ignore_gt_incl_hpol_runs", "xgb_model_ignore_gt_incl_hpol_runs"])
def test_gatk_qual_world_bytes_equal_reference(gatk_world, tmp_path, monkeypatch, suffix, windows, strategy,
                                               model_name):
    """QUAL written as read ("69.40", "24240.00", "."): the reference splices it
    verbatim, and so does the port, under every strategy and window path."""
    want = _gatk_reference(gatk_world, model_name=model_name, suffix=suffix)
    monkeypatch.setenv(FOREST_STRATEGY_ENV, strategy)
    got = _port_run(gatk_world, tmp_path, suffix, windows, monkeypatch, model_name=model_name)
    assert fixtures.strip_vctpu_header(got) == fixtures.strip_vctpu_header(want)
    quals = _qual_column(got)
    assert quals == _qual_column((gatk_world["dir"] / "calls.vcf").read_bytes())
    assert "." in quals and any(q.endswith("0") and "." in q for q in quals) \
        and any(float(q) >= 10_000 for q in quals if q != ".")


@pytest.mark.parametrize("input_name", ["calls_crlf.vcf", "calls_crlf.vcf.gz"])
@pytest.mark.parametrize("windows", ["host", "resident"])
def test_crlf_world_bytes_equal_reference(gatk_world, tmp_path, monkeypatch, input_name, windows):
    """A CRLF callset: the ``##`` lines keep their ``\\r``, the ``#CHROM`` line
    and the records lose it, in the reference's output and in the port's."""
    want = _gatk_reference(gatk_world, input_name=input_name, suffix=".vcf")
    got = _port_run(gatk_world, tmp_path, ".vcf", windows, monkeypatch, input_name=input_name)
    assert fixtures.strip_vctpu_header(got) == fixtures.strip_vctpu_header(want)
    lines = got.split(b"\n")
    assert b"##fileformat=VCFv4.2\r" in lines and lines[-1] == b""
    assert not any(ln.endswith(b"\r") for ln in lines if not ln.startswith(b"##"))
    lf = _gatk_reference(gatk_world, suffix=".vcf")
    assert [ln for ln in lines if not ln.startswith(b"#")] == [ln for ln in lf.split(b"\n") if not ln.startswith(b"#")]


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
@pytest.mark.parametrize("windows", ["host", "resident"])
@pytest.mark.parametrize("layout", ["vctpu", "pytables"])
def test_h5_blacklist_bytes_equal_reference(gatk_world, tmp_path, monkeypatch, suffix, windows, layout):
    """An h5 blacklist in either layout: the reference's bytes, the bytes of the
    same loci as a .bed, and every blacklisted record marked COHORT_FP."""
    h5 = f"blacklist_{layout}.h5"
    want = _gatk_reference(gatk_world, blacklist=h5, suffix=suffix)
    assert fixtures.strip_vctpu_header(_gatk_reference(gatk_world, blacklist="blacklist.bed", suffix=suffix)) == \
        fixtures.strip_vctpu_header(want)
    got = _port_run(gatk_world, tmp_path, suffix, windows, monkeypatch, blacklist=h5)
    assert fixtures.strip_vctpu_header(got) == fixtures.strip_vctpu_header(want)
    filters = [ln.split("\t")[6] for ln in got.decode().splitlines() if not ln.startswith("#")]
    assert sum(f.startswith("COHORT_FP") for f in filters) == gatk_world["blacklisted"] > 0


@pytest.mark.parametrize("case,feature", [("latest", "superblock version"), ("lzf", "filter 32000")])
def test_h5_blacklist_the_reader_cannot_read_exits_2(gatk_world, tmp_path, caplog, case, feature):
    import h5py

    h5 = tmp_path / "bl.h5"
    with h5py.File(h5, "w", libver="latest" if case == "latest" else "earliest") as f:
        g = f.create_group("bl")
        g.attrs["vctpu_frame"] = 1
        g.attrs["columns"], g.attrs["kinds"] = '["chrom", "pos"]', '{"chrom": "fstr", "pos": "i"}'
        g.create_dataset("chrom", data=np.asarray([b"chr1"] * 20))
        g.create_dataset("pos", data=np.arange(1, 21), **({"chunks": (8,), "compression": "lzf"}
                                                           if case == "lzf" else {}))
    caplog.set_level(logging.ERROR)
    argv = _gatk_argv(gatk_world, tmp_path / "o.vcf")
    assert torch_main(["filter_variants_pipeline", *argv, "--blacklist", str(h5)]) == 2
    assert not (tmp_path / "o.vcf").exists()
    assert any(feature in r.getMessage() and str(h5) in r.getMessage() for r in caplog.records)


def test_h5_blacklist_without_chrom_and_pos_fails_in_both(gatk_world, tmp_path, caplog):
    """The JAX package's writer stores a (chrom, pos) MultiIndex as tuple strings
    in ``__index__``: its reader then finds no chrom column (KeyError), and the
    port exits 2 saying so; neither writes an output."""
    import pandas as pd

    from variantcalling_tpu.utils.h5_utils import write_hdf

    h5 = tmp_path / "multi.h5"
    idx = pd.MultiIndex.from_tuples([("chr1", 100), ("chr2", 200)], names=["chrom", "pos"])
    write_hdf(pd.DataFrame({"score": [1.0, 2.0]}, index=idx), str(h5), "bl")
    argv = [*_gatk_argv(gatk_world, tmp_path / "o.vcf"), "--blacklist", str(h5)]
    with pytest.raises(KeyError, match="chrom"):
        fvp.run(argv)
    caplog.set_level(logging.ERROR)
    assert torch_main(["filter_variants_pipeline", *argv]) == 2
    assert not (tmp_path / "o.vcf").exists()
    assert any("no chrom or pos column" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("family", ["threshold", "dan"])
def test_family_gatk_qual_world_keeps_qual(gatk_world, tmp_path, family):
    """Threshold and DAN outputs: no record differs in QUAL (nor in any column
    but TREE_SCORE and FILTER, as ``torch_vcf_compare`` allows)."""
    kw = {"model_file": "families.pkl", "model_name": FAMILY_NAMES[family]}
    want = _gatk_reference(gatk_world, suffix=".vcf", **kw)
    assert torch_main(["filter_variants_pipeline", *_gatk_argv(gatk_world, tmp_path / "p.vcf", **kw)]) == 0
    got = (tmp_path / "p.vcf").read_bytes()
    pass_threshold = 0.5 if family == "dan" else 0.25
    differing_records(got, want, pass_threshold, FAMILY_TOL[family])
    assert _qual_column(got) == _qual_column(want) == _qual_column((gatk_world["dir"] / "calls.vcf").read_bytes())


@pytest.mark.parametrize("windows", ["host", "resident"])
def test_genome_sidecar_leaves_the_bytes_unchanged(gatk_world, tmp_path, monkeypatch, caplog, windows):
    """A fresh ``VCTPU_GENOME_CACHE_DIR``: the first run encodes and writes the
    sidecar, the second reads it (on the resident path: "sidecar" in
    ``GENOME_LOG``), ``VCTPU_GENOME_CACHE=0`` uses none; the reference's bytes
    every time."""
    want = fixtures.strip_vctpu_header(_gatk_reference(gatk_world, suffix=".vcf"))
    cache = tmp_path / "venc"
    monkeypatch.setenv("VCTPU_GENOME_CACHE_DIR", str(cache))
    caplog.set_level(logging.INFO, logger="variantcalling_tpu_torch")
    sources = []
    for run, setting in enumerate(("1", "1", "0")):
        monkeypatch.setenv("VCTPU_GENOME_CACHE", setting)
        caplog.clear()
        (tmp_path / str(run)).mkdir()
        got = _port_run(gatk_world, tmp_path / str(run), ".vcf", windows, monkeypatch)
        assert fixtures.strip_vctpu_header(got) == want
        assert len(os.listdir(cache)) == 1
        sources += [r.args[2] for r in caplog.records if r.msg == tfeat.GENOME_LOG]
    assert sources == (["encoded", "sidecar", "encoded"] if windows == "resident" else [])
