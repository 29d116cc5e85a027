"""The single-read SNV chain of the port against the JAX package's, on the CPU.

``srsnv_training`` (the port's native trainer against the JAX package's,
held to ``tests/torch_worlds.forest_bar``; the torch program of the card
against it too), ``srsnv_inference`` with one model pickle (the VCF
byte-equal outside ``##vctpu_*`` lines), the pickles read across the
packages, and ``mrd_analysis`` (frames equal: ``tumor_fraction`` and
``mrd_detected`` exact, the interval within a relative 1e-10 of scipy's),
the replays it rests on (``log1p``, ``sigmoid`` and ``jnp.linspace`` bit for
bit against XLA's CPU backend; ``beta.ppf`` and ``poisson.sf`` against scipy
over a grid of ``k`` and ``n``), and the cases of
``tests/unit/test_omics_packages.py:36-74``.
"""

import dataclasses
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from scipy import stats

from tests import torch_worlds
from tests.fixtures import strip_vctpu_header
from variantcalling_tpu.models import registry as jregistry
from variantcalling_tpu.pipelines import mrd_analysis as jmrd
from variantcalling_tpu.pipelines.srsnv import srsnv_inference as jinf
from variantcalling_tpu.pipelines.srsnv import srsnv_training as jtrain
from variantcalling_tpu.utils.h5_utils import read_hdf as jread_hdf
from variantcalling_tpu_torch import synthetic_featuremap as sfm
from variantcalling_tpu_torch.models import forest as tforest
from variantcalling_tpu_torch.models import registry as tregistry
from variantcalling_tpu_torch.ops import math as tm
from variantcalling_tpu_torch.pipelines import mrd_analysis as tmrd
from variantcalling_tpu_torch.pipelines.srsnv import srsnv_inference as tinf
from variantcalling_tpu_torch.pipelines.srsnv import srsnv_training as ttrain

CPU = ["--backend", "cpu"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("srsnv_world")
    return sfm.write_featuremap_world(str(d), seed=11, length=400_000, n_tp=1_500, n_fp=1_500, n_cfdna=6_000,
                                      n_signature=300, depth=30, tumor_fraction=2e-2, n_lpr_loci=120,
                                      lpr_reads=3_000, n_calls=1_000)


def _train(mod, world, out, extra=()):
    argv = ["--tp_featuremap", world["tp"], "--fp_featuremap", world["fp"], "--output_model", out,
            "--n_trees", "12", "--max_depth", "4", *extra]
    assert mod.run(argv) == 0
    with open(out, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def models(world, tmp_path_factory):
    d = tmp_path_factory.mktemp("srsnv_models")
    _train(ttrain, world, str(d / "port.pkl"), CPU)
    _train(jtrain, world, str(d / "ref.pkl"))
    return str(d / "port.pkl"), str(d / "ref.pkl")


def test_training_against_the_reference(world, models):
    """The port's CPU fit (the native trainer) against the JAX package's:
    ``forest_bar`` on the held-out scores; the same feature list."""
    port, ref = (tregistry.load_model(p, ttrain.MODEL_NAME) for p in models)
    jref = jregistry.load_model(models[1], jtrain.MODEL_NAME)
    assert port.feature_names == list(jref.feature_names) == ttrain.DEFAULT_FEATURES
    x, y, _ = ttrain.build_training_frame(world["tp"], world["fp"], None, None)
    jx, jy, _ = jtrain.build_training_frame(world["tp"], world["fp"], None, None)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    bar = torch_worlds.forest_bar(port, ref, x)
    assert bar["held"], bar
    assert ttrain._auc(y, tforest.predict_score(port, x, torch.device("cpu"))) > 0.9


def test_torch_program_against_the_native_fit(world, tmp_path, monkeypatch):
    """The torch program the card runs (``VCTPU_NATIVE_GBT=0``, the
    histograms' plain version) against the native trainer: ``forest_bar``."""
    monkeypatch.setenv("VCTPU_NATIVE_GBT", "0")
    _train(ttrain, world, str(tmp_path / "torch.pkl"), CPU)
    monkeypatch.delenv("VCTPU_NATIVE_GBT")
    _train(ttrain, world, str(tmp_path / "native.pkl"), CPU)
    a, b = (tregistry.load_model(str(tmp_path / f"{n}.pkl"), ttrain.MODEL_NAME) for n in ("torch", "native"))
    x, _, _ = ttrain.build_training_frame(world["tp"], world["fp"], None, None)
    bar = torch_worlds.forest_bar(a, b, x)
    assert bar["held"], bar


def test_pickles_read_across_the_packages(models):
    port, ref = models
    a = jregistry.load_model(port, jtrain.MODEL_NAME)
    b = tregistry.load_model(ref, ttrain.MODEL_NAME)
    c = tregistry.load_model(port, ttrain.MODEL_NAME)
    assert type(a).__module__.startswith("variantcalling_tpu.") and isinstance(b, tforest.FlatForest)
    for name in ("feature", "threshold", "left", "right", "value"):
        np.testing.assert_array_equal(getattr(a, name), getattr(c, name))
    assert a.base_score == c.base_score and a.aggregation == c.aggregation


@pytest.mark.parametrize("which", ["tp", "fp", "cfdna"])
@pytest.mark.parametrize("model", [0, 1], ids=["port_pickle", "reference_pickle"])
def test_inference_bytes_equal_the_reference(world, models, which, model, tmp_path):
    pkl = models[model]
    out_t, out_j = str(tmp_path / "port.vcf"), str(tmp_path / "ref.vcf")
    assert tinf.run(["--featuremap", world[which], "--model", pkl, "--output_featuremap", out_t, *CPU]) == 0
    assert jinf.run(["--featuremap", world[which], "--model", pkl, "--output_featuremap", out_j]) == 0
    got, want = (strip_vctpu_header(open(p, "rb").read()) for p in (out_t, out_j))
    assert got == want
    assert b"ML_QUAL=" in got


def test_inference_on_gz_with_reference_motifs(world, models, tmp_path):
    """A ``.vcf.gz`` output (and its ``.tbi``), ``--reference`` given."""
    out_t, out_j = str(tmp_path / "port.vcf.gz"), str(tmp_path / "ref.vcf.gz")
    args = ["--featuremap", world["tp"], "--model", models[0], "--reference", world["fasta"]]
    assert tinf.run([*args, "--output_featuremap", out_t, *CPU]) == 0
    assert jinf.run([*args, "--output_featuremap", out_j]) == 0
    got, want = (strip_vctpu_header(gzip.decompress(open(p, "rb").read())) for p in (out_t, out_j))
    assert got == want
    assert open(out_t + ".tbi", "rb").read() == open(out_j + ".tbi", "rb").read()


def test_missing_feature_and_no_card(world, models, tmp_path):
    with pytest.raises(SystemExit, match="lacks model features"):
        tinf.run(["--featuremap", world["signature"], "--model", models[0], "--output_featuremap",
                  str(tmp_path / "x.vcf"), *CPU])
    if not torch.cuda.is_available():
        assert tinf.run(["--featuremap", world["tp"], "--model", models[0], "--output_featuremap",
                         str(tmp_path / "x.vcf")]) == 2
        assert ttrain.run(["--tp_featuremap", world["tp"], "--fp_featuremap", world["fp"], "--output_model",
                           str(tmp_path / "m.pkl")]) == 2


def test_separation_as_the_reference_test(world, models, tmp_path):
    """``tests/unit/test_omics_packages.py:36``: TP reads score far above FP reads."""
    from variantcalling_tpu_torch.io.vcf import read_vcf

    med = {}
    for which in ("tp", "fp"):
        out = str(tmp_path / f"{which}.vcf")
        assert tinf.run(["--featuremap", world[which], "--model", models[0], "--output_featuremap", out, *CPU]) == 0
        med[which] = np.median(read_vcf(out).info_field("ML_QUAL"))
    assert med["tp"] > med["fp"] + 10


# -- mrd_analysis --------------------------------------------------------------------------------------------------


def _mrd_frames(world, scored, out_t, out_j, extra=()):
    base = ["--signature_vcf", world["signature"], "--featuremap", scored, "--coverage_per_locus", "30", *extra]
    assert tmrd.run([*base, "--output_h5", out_t, *CPU]) == 0
    assert jmrd.run([*base, "--output_h5", out_j]) == 0
    return jread_hdf(out_t, key="mrd_summary"), jread_hdf(out_j, key="mrd_summary")


def _assert_mrd_equal(got: pd.DataFrame, want: pd.DataFrame) -> None:
    assert list(got.columns) == list(want.columns)
    assert got.dtypes.to_dict() == want.dtypes.to_dict()
    for c in want.columns:
        if c in ("tf_ci_low", "tf_ci_high"):
            np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(), rtol=1e-10, atol=0)
        else:
            assert got[c].tolist() == want[c].tolist(), c


@pytest.mark.parametrize("which", ["cfdna", "control"])
@pytest.mark.parametrize("threshold", ["40", "0", "61"])
def test_mrd_frames_equal_the_reference(world, models, which, threshold, tmp_path):
    scored = str(tmp_path / "scored.vcf")
    assert tinf.run(["--featuremap", world[which], "--model", models[0], "--output_featuremap", scored, *CPU]) == 0
    got, want = _mrd_frames(world, scored, str(tmp_path / "t.h5"), str(tmp_path / "j.h5"),
                            ["--ml_qual_threshold", threshold])
    _assert_mrd_equal(got, want)


def test_mrd_counting_of_the_unscored_map(world, tmp_path):
    """An unscored featuremap: ML_QUAL absent, every read at a locus counts (NaN passes)."""
    got = tmrd.count_supporting_reads(world["signature"], world["cfdna"], 40.0)
    assert got == jmrd.count_supporting_reads(world["signature"], world["cfdna"], 40.0)
    assert got[0] == 300 and got[1] > 0


@pytest.mark.parametrize("n_loci,n_support,coverage,bg", [
    (1000, 500, 1000.0, 1e-7), (1000, 0, 1000.0, 1e-7), (2000, 60, 30.0, 1e-6), (2000, 0, 30.0, 1e-6),
    (10, 300, 30.0, 1e-6), (1, 1, 1.0, 0.0), (5, 3, 0.2, 1e-3), (300, 17, 30.0, 0.0), (50, 2500, 50.0, 1e-6),
    (10_000, 3, 100.0, 1e-9)])
def test_estimate_tumor_fraction(n_loci, n_support, coverage, bg):
    got = tmrd.estimate_tumor_fraction(n_loci, n_support, coverage, bg, device="cpu")
    want = jmrd.estimate_tumor_fraction(n_loci, n_support, coverage, bg)
    assert list(got) == list(want)
    for k in want:
        if k in ("tf_ci_low", "tf_ci_high"):
            assert got[k] == pytest.approx(want[k], rel=1e-10, abs=0), k
        else:
            assert got[k] == want[k] and type(got[k]) is type(want[k]), k


def test_mrd_cases_of_the_reference_tests():
    """``tests/unit/test_omics_packages.py:60-74``."""
    r = tmrd.estimate_tumor_fraction(1000, 500, 1000.0, background_rate=1e-7, device="cpu")
    assert 5e-4 < r["tumor_fraction"] < 2e-3 and r["mrd_detected"]
    assert r["tf_ci_low"] < r["tumor_fraction"] < r["tf_ci_high"]
    r0 = tmrd.estimate_tumor_fraction(1000, 0, 1000.0, background_rate=1e-7, device="cpu")
    assert not r0["mrd_detected"] and r0["tumor_fraction"] < 1e-5


@pytest.mark.parametrize("n", [1, 2, 7, 30, 113, 1000, 60_000, 3_000_000])
def test_clopper_pearson_against_scipy(n):
    ks = sorted(k for k in {1, 2, 3, n // 3, n // 2, n - 1, n, *range(1, min(n, 12) + 1)} if 1 <= k <= n)
    for k in ks:
        for q in (0.025, 0.975, 0.5, 1e-6):
            want = stats.beta.ppf(q, k, n - k + 1)
            assert tmrd.clopper_pearson_quantile(q, k, n) == pytest.approx(want, rel=1e-10, abs=1e-300), (q, k, n)


def test_clopper_pearson_where_scipy_drifts():
    """At 10^8 trials scipy's ``beta.ppf(0.975, 4, n - 3)`` is 6.8e-10 off the
    exact quantile (a 120-step bisection over the binomial tail in 40-digit
    arithmetic); the replay holds the exact value to 1e-14."""
    mp = pytest.importorskip("mpmath")
    mp.mp.dps = 40
    n, k, q = 100_000_000, 4, 0.975

    def tail(x):
        return 1 - mp.fsum(mp.binomial(n, j) * x ** j * (1 - x) ** (n - j) for j in range(k))

    x0 = stats.beta.ppf(q, k, n - k + 1)
    lo, hi = mp.mpf(x0) * 0.9, mp.mpf(x0) * 1.1
    for _ in range(120):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if tail(mid) < q else (lo, mid)
    exact = float(mid)
    assert tmrd.clopper_pearson_quantile(q, k, n) == pytest.approx(exact, rel=1e-14, abs=0)
    assert abs(x0 - exact) / exact > 1e-10


@pytest.mark.parametrize("mu", [0.0, 1e-300, 1e-12, 1e-6, 0.06, 1.0, 7.5, 300.0, 6e4])
def test_poisson_sf_against_scipy(mu):
    for k in (-1, 0, 1, 2, 5, 30, 400):
        want = stats.poisson.sf(k, mu)
        got = tmrd.poisson_sf(k, mu)
        assert got == pytest.approx(want, rel=1e-10, abs=1e-300), (k, mu)


# -- the float32 replays -------------------------------------------------------------------------------------------


def test_log1p_f32_bit_for_bit():
    """``ops/math.log1p_f32`` against ``jnp.log1p`` on XLA's CPU backend: a dense
    grid of (-1, 1], its neighbourhood of 0, and the MRD grid's ``-p``."""
    grid = np.linspace(-1, 1, 2_000_001, dtype=np.float64).astype(np.float32)[1:]
    small = np.concatenate([-np.logspace(-30, 0, 20_000), np.logspace(-30, 0, 20_000)]).astype(np.float32)
    grid = np.concatenate([grid, small, np.nextafter(np.float32(-1), np.float32(0), dtype=np.float32)[None]])
    for bg in (0.0, 1e-6, 1e-7, 1e-3):
        tf = np.append(np.arange(4000, dtype=np.float32) * np.float32(1.0 / np.float32(4000)), np.float32(1))
        p = np.clip(tf / np.float32(2) + np.float32(bg), np.float32(1e-12), np.float32(1 - 1e-12))
        grid = np.concatenate([grid, -p])
    got = tm.log1p_f32(torch.from_numpy(grid)).numpy()
    want = np.asarray(jax.jit(jnp.log1p)(grid))
    np.testing.assert_array_equal(got, want)


def test_sigmoid_f32_bit_for_bit():
    z = np.concatenate([np.random.default_rng(3).standard_normal(500_000) * 8, np.linspace(-100, 100, 100_001)])
    z = z.astype(np.float32)
    np.testing.assert_array_equal(tm.sigmoid_f32(torch.from_numpy(z)).numpy(),
                                  np.asarray(jax.jit(jax.nn.sigmoid)(z)))


@pytest.mark.parametrize("num", [4001, 101, 2, 1])
def test_linspace_grid_and_argmax(num):
    tf = tmrd.likelihood_argmax(0, 10, 0.0, num, torch.device("cpu"))
    assert tf == float(np.asarray(jnp.linspace(0.0, 1.0, num))[0])
    if num > 1:
        want = np.asarray(jnp.linspace(0.0, 1.0, num))
        div = num - 1
        got = np.append(np.arange(div, dtype=np.float32) * np.float32(1.0 / np.float32(div)), np.float32(1))
        np.testing.assert_array_equal(got, want)


def test_predict_score_finalize_as_xla(models, world):
    """The jitted finalize (division by a constant as a product with the
    reciprocal) and the eager one, against the JAX package's on a mean forest."""
    from variantcalling_tpu.models import forest as jforest

    forest = tregistry.load_model(models[0], ttrain.MODEL_NAME)
    jf = jregistry.load_model(models[0], jtrain.MODEL_NAME)
    x, _, _ = ttrain.build_training_frame(world["tp"], world["fp"], None, None)
    np.testing.assert_array_equal(tforest.predict_score(forest, x, torch.device("cpu")),
                                  np.asarray(jforest.predict_score(jf, jnp.asarray(x))))
    mean_t = dataclasses.replace(forest, aggregation="mean")
    mean_j = dataclasses.replace(jf, aggregation="mean")
    np.testing.assert_array_equal(tforest.predict_score(mean_t, x, torch.device("cpu"), jit=True),
                                  np.asarray(jax.jit(jforest.make_predictor(mean_j, x.shape[1]))(x)))
    np.testing.assert_array_equal(tforest.predict_score(mean_t, x, torch.device("cpu")),
                                  np.asarray(jforest.predict_score(mean_j, jnp.asarray(x))))
