"""The port's threshold model against the JAX package's, to 1e-6.

- ``predict_score`` on the same numpy features, with models built by hand,
  by the reference's ``fit_threshold_model`` and ``default_somatic_model``,
  carried across by ``threshold_from_reference``;
- the standard mixed pickle (``rf_...`` and ``threshold_...`` models, saved
  by the JAX package) loads into the port, and each model scores as the
  reference's does;
- the ``--is_mutect`` CLI path (TLOD as ``tlod``) with the reference's
  ``default_somatic_model``, against the JAX package's CLI: records may
  differ only as ``tests/torch_vcf_compare.py`` allows, and are counted.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import fixtures
from tests.torch_vcf_compare import differing_records
from variantcalling_tpu.featurize import BASE_FEATURES
from variantcalling_tpu.models import forest as jforest
from variantcalling_tpu.models import registry as jregistry
from variantcalling_tpu.models import threshold as jthreshold
from variantcalling_tpu.pipelines import filter_variants as jfvp
from variantcalling_tpu.synthetic import synthetic_forest as jsynthetic_forest
from variantcalling_tpu_torch.__main__ import main as torch_main
from variantcalling_tpu_torch.engine import EngineError
from variantcalling_tpu_torch.models import convert, forest, registry, threshold

TOL = 1e-6
NAMES = [*BASE_FEATURES, "tlod"]


def _features(n: int = 2000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, size=(n, len(NAMES))).astype(np.float32)
    x[:, NAMES.index("qual")] = rng.uniform(10, 90, n)
    x[:, NAMES.index("tlod")] = rng.uniform(0, 15, n)
    return x


def _carry(ref) -> threshold.ThresholdModel:
    return convert.threshold_from_reference(ref.feature_names, ref.thresholds, ref.signs, ref.scales,
                                            ref.pass_threshold, ref.all_feature_names)


def _models():
    x = _features(seed=1)
    y = (x[:, NAMES.index("tlod")] > 6) & (x[:, NAMES.index("sor")] < 4)
    return {
        "hand": jthreshold.ThresholdModel(
            feature_names=["qual", "sor", "dp"], thresholds=np.asarray([40, 2, 5], np.float32),
            signs=np.asarray([1, -1, 1], np.float32), scales=np.asarray([5, 0.5, 2], np.float32),
            all_feature_names=list(NAMES)),
        "fit": jthreshold.fit_threshold_model(x, y.astype(np.float32), list(NAMES)),
        "somatic": jthreshold.default_somatic_model(list(NAMES)),
    }


@pytest.mark.parametrize("kind", ["hand", "fit", "somatic"])
def test_predict_score_matches_reference(kind):
    ref = _models()[kind]
    x = _features(seed=2)
    want = np.asarray(jthreshold.predict_score(ref, jnp.asarray(x), list(NAMES)))
    got = threshold.predict_score(_carry(ref), torch.from_numpy(x), list(NAMES)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert 0.0 <= got.min() < 0.25 < got.max() <= 1.0  # sharp fitted sigmoids reach 0 and 1


def test_columns_by_name_and_missing_column():
    model = _carry(_models()["hand"])
    x = _features(seed=3)
    perm = np.random.default_rng(4).permutation(len(NAMES))
    names_p = [NAMES[i] for i in perm]
    a = threshold.predict_score(model, torch.from_numpy(x), list(NAMES))
    b = threshold.predict_score(model, torch.from_numpy(np.ascontiguousarray(x[:, perm])), names_p)
    assert torch.equal(a, b)
    with pytest.raises(EngineError, match="sor"):
        threshold.make_score_predictor(model, [f for f in NAMES if f != "sor"], torch.device("cpu"))


def test_default_somatic_model_matches_reference():
    ref, port = jthreshold.default_somatic_model(NAMES), threshold.default_somatic_model(NAMES)
    for k in ("feature_names", "pass_threshold", "all_feature_names"):
        assert getattr(port, k) == getattr(ref, k)
    for k in ("thresholds", "signs", "scales"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k))


def test_mixed_standard_pickle_loads_both_families(tmp_path):
    """The pickle ``train_models_pipeline`` writes holds forests and threshold
    models side by side: the port loads the whole dict and scores each."""
    rf = jsynthetic_forest(np.random.default_rng(5), n_trees=6, depth=5, n_features=len(BASE_FEATURES))
    rf.feature_names = list(BASE_FEATURES)
    names = jregistry.standard_model_names()
    assert names == registry.standard_model_names()
    thr = jthreshold.ThresholdModel(feature_names=["qual", "sor"], thresholds=np.asarray([30, 2], np.float32),
                                    signs=np.asarray([1, -1], np.float32), scales=np.asarray([4, 1], np.float32),
                                    pass_threshold=0.3, all_feature_names=list(BASE_FEATURES))
    path = str(tmp_path / "models.pkl")
    jregistry.save_models(path, {n: (rf if n.startswith("rf_") else thr) for n in names})
    loaded = registry.load_models(path)
    assert sorted(loaded) == sorted(names)
    assert {registry.family_of(m) for m in loaded.values()} == {"forest", "threshold"} < set(registry.FAMILIES)
    x = _features(seed=6)[:, : len(BASE_FEATURES)].copy()
    port_rf = registry.load_model(path, "rf_model_ignore_gt_incl_hpol_runs")
    assert isinstance(port_rf, forest.FlatForest)
    np.testing.assert_array_equal(forest.predict_margin(port_rf, torch.from_numpy(x)).numpy(),
                                  np.asarray(jforest.predict_margin(rf, jnp.asarray(x))))
    port_thr = registry.load_model(path, "threshold_model_use_gt_excl_hpol_runs")
    assert isinstance(port_thr, threshold.ThresholdModel) and port_thr.pass_threshold == 0.3
    want = np.asarray(jthreshold.predict_score(thr, jnp.asarray(x), list(BASE_FEATURES)))
    got = threshold.predict_score(port_thr, torch.from_numpy(x), list(BASE_FEATURES)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    with pytest.raises(KeyError, match="no 'dan'-family model in this file"):
        registry.load_model(path, "dan_model_ignore_gt_incl_hpol_runs")


@pytest.fixture(scope="module")
def mutect_world(tmp_path_factory):
    """A somatic callset with TLOD in INFO, and the reference's default somatic
    model in a pickle the JAX package saved."""
    rng = np.random.default_rng(11)
    tmp = tmp_path_factory.mktemp("torch_mutect")
    contigs = {"chr1": 30000, "chr2": 12000}
    genome = fixtures.make_genome(rng, contigs)
    fixtures.write_fasta(str(tmp / "ref.fa"), genome)
    recs = fixtures.synth_variants(rng, genome, 500)
    for r in recs:
        tlod = float(np.round(rng.uniform(0, 14), 2))
        r["info"] = f"DP={int(rng.integers(10, 60))};SOR={rng.uniform(0, 5):.3f};TLOD={tlod:g}"
        r["gq"] = int(rng.integers(10, 90))
        r["ad"] = [int(rng.integers(5, 30)), int(rng.integers(1, 30))]
    fixtures.write_vcf(str(tmp / "calls.vcf"), recs, contigs, extra_info_defs=[
        '##INFO=<ID=SOR,Number=1,Type=Float,Description="Symmetric odds ratio">',
        '##INFO=<ID=TLOD,Number=1,Type=Float,Description="Tumor LOD">'])
    name = "threshold_model_ignore_gt_incl_hpol_runs"
    jregistry.save_models(str(tmp / "model.pkl"), {name: jthreshold.default_somatic_model([*BASE_FEATURES, "tlod"])})
    return tmp, name


def test_mutect_cli_matches_reference(mutect_world, capsys):
    tmp, name = mutect_world
    argv = ["--input_file", str(tmp / "calls.vcf"), "--model_file", str(tmp / "model.pkl"), "--model_name", name,
            "--reference_file", str(tmp / "ref.fa"), "--is_mutect", "--backend", "cpu"]
    assert jfvp.run([*argv, "--output_file", str(tmp / "ref.vcf")]) == 0
    assert torch_main(["filter_variants_pipeline", *argv, "--output_file", str(tmp / "port.vcf")]) == 0
    port = (tmp / "port.vcf").read_bytes()
    n_diff = differing_records(port, (tmp / "ref.vcf").read_bytes(), 0.25, TOL)
    lines = port.decode().splitlines()
    n_rec = sum(not ln.startswith("#") for ln in lines)
    with capsys.disabled():
        print(f"\nthreshold (--is_mutect) CLI: {n_diff} of {n_rec} records differ from the reference's")
    assert n_diff <= n_rec // 100
    assert "##vctpu_model_family=threshold" in lines and "##vctpu_forest_strategy=torch" in lines
    filters = {ln.split("\t")[6] for ln in lines if not ln.startswith("#")}
    assert {"PASS", "LOW_SCORE"} <= filters
