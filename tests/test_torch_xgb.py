"""The port's xgboost ingest against the JAX package's, array for array.

On the worlds of ``tests/unit/test_xgb_ingest.py`` (a two-tree model with
default_left, recycled node ids, cyclic pointers, unsupported boosters and
objectives) and on the port's synthetic xgboost JSON dump: the forests
``from_xgboost_json`` builds are equal field for field, the weights carried
across with ``convert.forest_from_reference`` equal the port's own parse,
and the registry loads what the reference's loads.
"""

import copy
import json
import pickle

import numpy as np
import pytest
import torch

from tests.unit.test_xgb_ingest import _model_json, _probe_matrix, _ref_predict, _two_tree_model, _xgb_tree
from variantcalling_tpu.models import registry as jregistry
from variantcalling_tpu.models import xgb as jxgb
from variantcalling_tpu_torch import synthetic as tsynth
from variantcalling_tpu_torch.models import forest as tforest
from variantcalling_tpu_torch.models import registry as tregistry
from variantcalling_tpu_torch.models import xgb as txgb
from variantcalling_tpu_torch.models.convert import REFERENCE_ARRAYS, forest_from_reference

META = ("max_depth", "aggregation", "base_score", "feature_names", "pass_threshold")


def _recycled_ids_model():
    t = _xgb_tree(left=[3, 2, -1, 1, -1, -1, -1], right=[4, 6, -1, 5, -1, -1, -1],
                  cond=[0.5, 0.5, 0.7, 0.5, -0.1, 0.3, -0.9], sidx=[0, 2, 0, 1, 0, 0, 0],
                  default_left=[0, 1, 0, 0, 0, 0, 0])
    return _model_json([t], base_score=0.5)


def _synthetic_model():
    rng = np.random.default_rng(21)
    forest = tsynth.filter_forest(rng, n_trees=5, depth=7)
    return forest, tsynth.xgboost_json(forest, rng.random(forest.feature.shape) < 0.5, 0.62)


MODELS = {"two_tree": _two_tree_model, "recycled_ids": _recycled_ids_model,
          "synthetic_5x64": lambda: _synthetic_model()[1]}


def assert_forests_equal(got: tforest.FlatForest, want) -> None:
    for k in REFERENCE_ARRAYS:
        g, w = getattr(got, k), getattr(want, k)
        assert (g is None) == (w is None), k
        if w is not None:
            w = np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g, w), k
    for k in META:
        assert getattr(got, k) == getattr(want, k), k


@pytest.mark.parametrize("name", sorted(MODELS))
def test_from_xgboost_json_equals_reference(name):
    model = MODELS[name]()
    want = jxgb.from_xgboost_json(model)
    assert want.default_left is not None
    for source in (model, json.dumps(model), json.dumps(model).encode()):
        assert_forests_equal(txgb.from_xgboost_json(source), want)
    # the reference's arrays carried across equal the port's own parse
    carried = forest_from_reference({k: np.asarray(getattr(want, k)) for k in REFERENCE_ARRAYS},
                                    **{k: getattr(want, k) for k in META})
    assert_forests_equal(carried, want)


def test_from_xgboost_json_reads_a_path(tmp_path):
    path = tmp_path / "m.json"
    path.write_text(json.dumps(_two_tree_model()))
    assert_forests_equal(txgb.from_xgboost_json(str(path), feature_names=["a", "b", "c"], pass_threshold=0.3),
                         jxgb.from_xgboost_json(str(path), feature_names=["a", "b", "c"], pass_threshold=0.3))


def test_synthetic_dump_inverts_ingest():
    """``synthetic.xgboost_json`` is the inverse of ``from_xgboost_json``: the
    parsed forest walks like the original (same nodes, thresholds, leaves)."""
    forest, model = _synthetic_model()
    parsed = txgb.from_xgboost_json(model)
    n = parsed.feature.shape[1]
    internal = forest.feature[:, :n] != tforest.LEAF
    np.testing.assert_array_equal(parsed.feature, forest.feature[:, :n])
    np.testing.assert_array_equal(parsed.threshold[internal], forest.threshold[:, :n][internal])
    np.testing.assert_array_equal(parsed.value[~internal], forest.value[:, :n][~internal])
    for k in ("left", "right"):
        np.testing.assert_array_equal(getattr(parsed, k), getattr(forest, k)[:, :n])
    assert parsed.feature_names == forest.feature_names and parsed.max_depth == forest.max_depth
    assert parsed.base_score == pytest.approx(np.log(0.62 / 0.38), abs=1e-9)
    assert parsed.default_left[~internal].sum() == 0 and parsed.default_left[internal].any()


def test_xgb_margins_follow_xgboost_rules():
    """Strict ``x < cond`` at exact thresholds and NaN default branches, through
    the port's walk and its per-tree plain version, against the reference's
    independent per-record traversal."""
    model = _two_tree_model()
    forest = txgb.from_xgboost_json(model)
    x = _probe_matrix(np.random.default_rng(0))
    margin = tforest.predict_margin(forest, torch.from_numpy(x))
    expect = _ref_predict(model, x)
    np.testing.assert_allclose(tforest.finalize_margin(margin.numpy(), forest), expect, atol=1e-6)
    gemm = tforest.predict_margin_gemm(tforest.to_gemm(forest, 3), torch.from_numpy(x))
    assert torch.equal(gemm, margin)


def test_cyclic_child_pointers_raise():
    t = _xgb_tree(left=[1, 0, -1], right=[2, 2, -1], cond=[0.5, 0.5, 0.1], sidx=[0, 1, 0],
                  default_left=[0, 0, 0])
    for parse in (txgb.from_xgboost_json, jxgb.from_xgboost_json):
        with pytest.raises(ValueError, match="cyclic"):
            parse(_model_json([t]))


@pytest.mark.parametrize("edit,match", [
    (lambda m: m["learner"]["gradient_booster"].__setitem__("name", "dart"), "dart"),
    (lambda m: m["learner"]["learner_model_param"].__setitem__("num_class", "3"), "binary"),
    (lambda m: m["learner"]["learner_model_param"].__setitem__("num_class", "2"), "softprob"),
    (lambda m: m["learner"]["objective"].__setitem__("name", "rank:ndcg"), "logistic"),
    (lambda m: m["learner"]["gradient_booster"]["model"].__setitem__("trees", []), "no trees"),
    (lambda m: m["learner"]["gradient_booster"]["model"]["trees"][0].__setitem__("categories_nodes", [0]),
     "categorical"),
])
def test_unsupported_models_raise(edit, match):
    model = copy.deepcopy(_two_tree_model())
    edit(model)
    for parse in (txgb.from_xgboost_json, jxgb.from_xgboost_json):
        with pytest.raises(ValueError, match=match):
            parse(model)


def test_registry_loads_bare_json_and_pickled_dict(tmp_path):
    model = _two_tree_model()
    jpath = tmp_path / "model.json"
    jpath.write_text(json.dumps(model))
    ppath = tmp_path / "model.pkl"
    with open(ppath, "wb") as fh:
        pickle.dump(model, fh)  # the parsed JSON dict pickled whole
    named = tmp_path / "named.pkl"
    with open(named, "wb") as fh:
        pickle.dump({"xgb_model_ignore_gt_incl_hpol_runs": model}, fh)  # a name -> JSON dict map
    for path, name in ((jpath, "model"), (ppath, "model"), (named, "xgb_model_ignore_gt_incl_hpol_runs")):
        assert_forests_equal(tregistry.load_model(str(path), name), jregistry.load_model(str(path), name))


class _FakeBooster:
    """Stands in for an xgboost Booster: the registry's xgboost test is by module."""

    __module__ = "xgboost.core"

    def __init__(self, model: dict):
        self.model = model

    def save_raw(self, raw_format: str = "json") -> bytearray:
        assert raw_format == "json"
        return bytearray(json.dumps(self.model).encode())


def test_xgboost_objects_convert_through_their_json_dump():
    booster = _FakeBooster(_two_tree_model())
    assert txgb.looks_like_xgboost(booster) and jxgb.looks_like_xgboost(booster)
    assert_forests_equal(txgb.from_xgboost(booster), jxgb.from_xgboost(booster))
    assert_forests_equal(tregistry._coerce(booster), jregistry._coerce(booster))
    with pytest.raises(TypeError):
        txgb.from_xgboost(object())


def test_xgboost_pickle_without_xgboost_raises_clearly(tmp_path):
    path = tmp_path / "booster.pkl"
    path.write_bytes(b"cxgboost.core\nBooster\n)\x81.")  # what pickling a Booster names
    with pytest.raises(ModuleNotFoundError, match="save the model as JSON"):
        tregistry.load_models(str(path))
