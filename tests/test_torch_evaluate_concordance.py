"""``evaluate_concordance`` of the port against the JAX package's CLI, on the CPU.

Concordance worlds made from a seed with numpy and written by the JAX
package's ``write_hdf``: NaN scores, all-NaN scores, no score column,
``--ignore_genotype``, ``--use_for_group_testing``, ``--output_bed``,
categories with no calls, frames without an ``indel`` column (REF/ALT
lengths), one dataset key, another score key, frames without
``classify_gt``, other ignored filters. Bars: ``.stats.csv``,
``.thresholds.csv`` and the BED files byte-equal (tolerance 0); the
``.h5``'s frames equal through both packages' ``read_hdf`` (every column,
dtypes included, the ragged curves element for element). Also the curve
(``utils/stats_utils.precision_recall_curve``) against the reference's on
hypothesis-drawn labels, scores and fn masks, bit for bit, and the tally
on the device it is given.
"""

import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from variantcalling_tpu.__main__ import main as jax_main
from variantcalling_tpu.utils import h5_utils as jh5
from variantcalling_tpu.utils import stats_utils as jstats
from variantcalling_tpu_torch.__main__ import main as torch_main
from variantcalling_tpu_torch.utils import h5_utils as th5
from variantcalling_tpu_torch.utils import stats_utils as tstats


def _frame(rng, n: int, chrom: str, max_hmer: int = 15) -> pd.DataFrame:
    cls = rng.choice(["tp", "fp", "fn"], n, p=[0.6, 0.3, 0.1]).astype(object)
    cls_gt = cls.copy()
    flip = rng.random(n) < 0.05
    cls_gt[flip & (cls == "tp")] = "fp"
    score = np.round(rng.random(n), 3)  # ties, as a forest's scores have them
    score[cls == "fn"] = np.nan
    score[rng.random(n) < 0.03] = np.nan
    indel = rng.random(n) < 0.35
    alt = np.where(indel, "AT", "G").astype(object)
    alt[rng.random(n) < 0.1] = "C,T"
    return pd.DataFrame({
        "chrom": [chrom] * n, "pos": np.sort(rng.choice(10_000_000, n, replace=False)) + 1,
        "ref": ["A"] * n, "alt": alt,
        "classify": cls, "classify_gt": cls_gt,
        "filter": rng.choice(["PASS", "LOW_SCORE", "HPOL_RUN", "LOW_SCORE;HPOL_RUN", "."], n).astype(object),
        "tree_score": score, "qual": rng.uniform(0, 100, n),
        "indel": indel, "hmer_indel_length": np.where(indel, rng.integers(0, max_hmer + 1, n), 0),
        "grp": rng.choice(["alpha", "beta", "gamma,delta"], n).astype(object),
    })


def _world(path, world: str, seed: int = 3) -> list[str]:
    """Write ``path`` (keys chr1 and chr2) and return the world's extra CLI arguments."""
    rng = np.random.default_rng(seed)
    frames = {c: _frame(rng, n, c, max_hmer=10 if world == "empty_categories" else 15)
              for c, n in (("chr1", 900), ("chr2", 500))}
    for df in frames.values():
        if world == "nan_scores":
            df["tree_score"] = np.nan
        elif world == "no_score":
            del df["tree_score"]
        elif world == "no_indel_column":
            del df["indel"]
        elif world == "single_classify":
            del df["classify_gt"]
        elif world == "empty_categories":
            df.loc[df["indel"], "classify"] = "fn"  # every indel a miss: no calls there
            df.loc[df["indel"], "classify_gt"] = "fn"
    for i, (key, df) in enumerate(frames.items()):
        jh5.write_hdf(df, str(path), key=key, mode="w" if i == 0 else "a")
    return {"ignore_genotype": ["--ignore_genotype"], "group_testing": ["--use_for_group_testing", "grp"],
            "output_bed": ["--output_bed"], "dataset_key": ["--dataset_key", "chr2", "--output_bed"],
            "score_key": ["--score_key", "QUAL"], "ignore_filters": ["--ignore_filters", "LOW_SCORE,HPOL_RUN"],
            }.get(world, [])


def _assert_same_frames(a: pd.DataFrame, b: pd.DataFrame) -> None:
    assert list(a.columns) == list(b.columns) and len(a) == len(b)
    for c in a.columns:
        x, y = a[c].to_numpy(), b[c].to_numpy()
        assert x.dtype == y.dtype, c
        if x.dtype == object and len(x) and isinstance(y[0], np.ndarray):
            assert all(u.dtype == v.dtype and np.array_equal(u, v, equal_nan=True) for u, v in zip(x, y)), c
        else:
            assert list(x) == list(y) or np.array_equal(x, y, equal_nan=True), c


def _assert_same_port_frames(a: th5.Frame, b: th5.Frame) -> None:
    assert a.columns == b.columns and len(a) == len(b)
    for c in a.columns:
        x, y = a[c], b[c]
        assert x.dtype == y.dtype, c
        if x.dtype == object and len(x) and isinstance(y[0], np.ndarray):
            assert all(np.array_equal(u, v, equal_nan=True) for u, v in zip(x, y)), c
        else:
            assert list(x) == list(y) or np.array_equal(x, y, equal_nan=True), c


WORLDS = ["plain", "nan_scores", "no_score", "ignore_genotype", "group_testing", "output_bed", "empty_categories",
          "no_indel_column", "dataset_key", "score_key", "single_classify", "ignore_filters"]


@pytest.mark.parametrize("world", WORLDS)
def test_outputs_equal_the_reference(world, tmp_path):
    h5 = tmp_path / "concordance.h5"
    extra = _world(h5, world)
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert torch_main(["evaluate_concordance", "--input_file", str(h5), "--output_prefix", port, *extra,
                       "--backend", "cpu"]) == 0
    assert jax_main(["evaluate_concordance", "--input_file", str(h5), "--output_prefix", ref, *extra]) == 0
    for suffix in (".stats.csv", ".thresholds.csv"):
        want = open(ref + suffix, "rb").read()
        assert open(port + suffix, "rb").read() == want, suffix
    beds = ("_fp.bed", "_fn.bed", "_tp.bed") if "--output_bed" in extra else ()
    for suffix in beds:
        want = open(ref + suffix, "rb").read()
        assert want and open(port + suffix, "rb").read() == want, suffix
    keys = ["optimal_recall_precision", "recall_precision_curve"]
    assert jh5.list_keys(port + ".h5") == jh5.list_keys(ref + ".h5") == keys
    assert th5.list_keys(port + ".h5") == keys
    for key in keys:
        _assert_same_frames(jh5.read_hdf(port + ".h5", key), jh5.read_hdf(ref + ".h5", key))
        _assert_same_port_frames(th5.read_hdf(port + ".h5", key), th5.read_hdf(ref + ".h5", key))
    curve = th5.read_hdf(port + ".h5", "recall_precision_curve")
    if world == "empty_categories":
        assert any(len(p) == 0 for p in curve["predictions"])
    if world in ("plain", "group_testing"):
        assert all(len(p) > 0 for p in curve["predictions"])


def test_missing_score_column_warns(tmp_path, caplog):
    h5 = tmp_path / "concordance.h5"
    _world(h5, "no_score")
    caplog.set_level("WARNING")
    assert torch_main(["evaluate_concordance", "--input_file", str(h5), "--output_prefix", str(tmp_path / "p"),
                       "--backend", "cpu"]) == 0
    assert "No tree_score field in comparison hdf input" in caplog.text


def test_backend_gpu_without_a_card_exits_2(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    h5 = tmp_path / "concordance.h5"
    _world(h5, "plain")
    assert torch_main(["evaluate_concordance", "--input_file", str(h5), "--output_prefix",
                       str(tmp_path / "p")]) == 2
    assert not (tmp_path / "p.h5").exists()


@settings(max_examples=150, deadline=None)
@given(st.integers(0, 120), st.integers(0, 2**32 - 1), st.sampled_from([3, 20, 1000]),
       st.sampled_from(["ties", "floats", "constant"]), st.floats(0, 1))
def test_precision_recall_curve_equals_the_reference(n, seed, min_counts, scores_kind, fn_share):
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.6).astype(int)
    scores = {"ties": np.round(rng.random(n), 1), "floats": rng.random(n), "constant": np.ones(n)}[scores_kind]
    fn_mask = rng.random(n) < fn_share
    got = tstats.precision_recall_curve(labels, scores, fn_mask, min_class_counts_to_output=min_counts)
    want = jstats.precision_recall_curve(labels, scores, fn_mask, min_class_counts_to_output=min_counts)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w, equal_nan=True)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 200), st.integers(0, 2**32 - 1))
def test_binary_clf_curve_equals_the_reference(n, seed):
    rng = np.random.default_rng(seed)
    y, s = rng.random(n) < 0.5, np.round(rng.random(n), 2)
    for g, w in zip(tstats.binary_clf_curve(y, s), jstats.binary_clf_curve(y, s)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("group_column", [None, "grp"])
def test_recall_precision_curve_frame_equals_the_reference(group_column):
    from variantcalling_tpu.concordance import concordance_utils as jcu
    from variantcalling_tpu_torch.concordance import concordance_utils as tcu

    df = _frame(np.random.default_rng(8), 1500, "chr1")
    want = jcu.calc_recall_precision_curve(df, "classify_gt", ["HPOL_RUN"], group_column)
    got = tcu.calc_recall_precision_curve(th5.Frame({c: df[c].to_numpy() for c in df.columns}), "classify_gt",
                                          ["HPOL_RUN"], group_column)
    _assert_same_port_frames(got, th5.Frame({c: want[c].to_numpy() for c in want.columns}))
    assert got["threshold"].dtype == np.float64
