"""``train_models_pipeline`` of the port against the JAX package's CLI, on the CPU.

Same inputs through both CLIs (``--backend cpu`` for the port): a labeled
concordance h5 (plain, ``--exome_weight 2``, ``--mutect``,
``--list_of_contigs_to_read``, ``--evaluate_concordance``) and a callset in
VCF mode (``--reference``, ``--runs_intervals``, ``--annotate_intervals``,
``--blacklist``). Bars (ISSUE's tentpole §4): with the native trainer, the
default on the CPU, every array of every model equal (tolerance 0); with
``VCTPU_NATIVE_GBT=0`` (the torch program against the JAX package's jitted
fit) features equal, thresholds to 1e-6, values to 1e-2 / 1e-5; the
threshold models equal; ``training_results`` and
``optimal_recall_precision`` read by the JAX package's ``read_hdf`` as frames
equal to its own. ``--resume`` from a partial pickle written by either
package, in either package. A model the port trains filters the callset
through both packages' filter CLIs to the same bytes, and its pickle loads
in a process where ``torch`` and the port cannot be imported.
"""

import io
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from tests import fixtures, torch_worlds
from variantcalling_tpu.__main__ import main as jax_main
from variantcalling_tpu.models import boosting as jb
from variantcalling_tpu.models import registry as jreg
from variantcalling_tpu.utils import h5_utils as jh5
from variantcalling_tpu_torch.__main__ import main as torch_main
from variantcalling_tpu_torch.models import boosting as tb
from variantcalling_tpu_torch.models import registry as treg
from variantcalling_tpu_torch.pipelines import train_models as ttm

SMALL = ["--n_trees", "8", "--tree_depth", "4"]


@pytest.fixture(scope="module")
def h5_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("tm_h5")
    return torch_worlds.write_training_h5_world(d / "concordance.h5", seed=21, n_rows=4000, chr20_rows=600,
                                                mutect=True)


@pytest.fixture(scope="module")
def vcf_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("tm_vcf")
    return torch_worlds.write_training_vcf_world(d, seed=22, n_variants=2500, n_trees=4, depth=3)


def _vcf_args(w) -> list[str]:
    return ["--input_file", w["vcf"], "--reference", w["fasta"], "--runs_intervals", w["runs"],
            "--annotate_intervals", w["annotate"], "--blacklist", w["blacklist"]]


def _run_both(tmp_path, argv: list[str], env: dict | None = None, monkeypatch=None) -> tuple[str, str]:
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert torch_main(["train_models_pipeline", *argv, "--output_file_prefix", port, "--backend", "cpu"]) == 0
    assert jax_main(["train_models_pipeline", *argv, "--output_file_prefix", ref]) == 0
    return port, ref


def _assert_models(port: str, ref: str, exact: bool = True, ordered: bool = True) -> dict:
    """``ordered=False``: a resumed run puts the checkpoint's models first."""
    got, want = jreg.load_models(port + ".pkl"), jreg.load_models(ref + ".pkl")
    assert (list(got) if ordered else sorted(got)) == (list(want) if ordered else sorted(want)) and len(want) == 8
    for name, w in want.items():
        g = got[name]
        assert type(g) is type(w) and type(g).__module__.startswith("variantcalling_tpu.models."), name
        if name.startswith("rf") and not exact:
            np.testing.assert_array_equal(g.feature, w.feature, err_msg=name)
            np.testing.assert_allclose(g.threshold, w.threshold, rtol=1e-6, err_msg=name)
            np.testing.assert_allclose(g.value, w.value, rtol=1e-2, atol=1e-5, err_msg=name)
            for field in ("left", "right", "max_depth", "aggregation", "base_score", "feature_names"):
                assert np.array_equal(getattr(g, field), getattr(w, field)), (name, field)
            continue
        for field in w.__dataclass_fields__:
            a, b = getattr(g, field), getattr(w, field)
            assert (np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b), (name, field)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, (name, field)
    return got


def _assert_frames(port: str, ref: str, keys=("training_results",)) -> None:
    assert jh5.list_keys(port + ".h5") == jh5.list_keys(ref + ".h5") == sorted(keys)
    for key in keys:
        pd.testing.assert_frame_equal(jh5.read_hdf(port + ".h5", key), jh5.read_hdf(ref + ".h5", key))


@pytest.mark.parametrize("extra", [[], ["--exome_weight", "2", "--exome_weight_annotation", "exome"],
                                   ["--mutect"], ["--list_of_contigs_to_read", "chr1", "chr20"]])
def test_h5_mode_equals_the_reference(h5_world, tmp_path, extra):
    port, ref = _run_both(tmp_path, ["--input_file", h5_world, *SMALL, "--evaluate_concordance", *extra])
    models = _assert_models(port, ref)
    _assert_frames(port, ref, ("optimal_recall_precision", "training_results"))
    assert not os.path.exists(port + ".partial.pkl") and not os.path.exists(port + ".partial.meta.json")
    names = models["rf_model_ignore_gt_incl_hpol_runs"].feature_names
    assert "exome_target" in names and ("tlod" in names) and names[:3] == ["qual", "dp", "sor"]
    if "--mutect" in extra:
        assert models["threshold_model_use_gt_incl_hpol_runs"].feature_names == ["tlod", "sor"]


def test_torch_program_meets_the_native_vs_jit_bar(h5_world, tmp_path, monkeypatch):
    port, ref = _run_both(tmp_path, ["--input_file", h5_world, *SMALL, "--evaluate_concordance"],
                          env={"VCTPU_NATIVE_GBT": "0"}, monkeypatch=monkeypatch)
    _assert_models(port, ref, exact=False)
    _assert_frames(port, ref, ("optimal_recall_precision", "training_results"))


@pytest.fixture(scope="module")
def bar_world(tmp_path_factory):
    """A world where one forest of the default grid parts from the native
    trainer's at a near-tie (30,000 rows, chr20 held out)."""
    return torch_worlds.write_training_h5_world(tmp_path_factory.mktemp("tm_bar") / "c.h5", seed=6, n_rows=30_000,
                                                chr20_rows=5000)


def test_the_card_program_meets_the_forest_bar_against_the_native_trainer(bar_world, tmp_path, monkeypatch):
    """The torch program the card runs (``VCTPU_NATIVE_GBT=0`` on the CPU)
    against the JAX package's default CPU fit, its native float32 trainer,
    at the default grid: every forest meets ``torch_worlds.forest_bar`` on
    the held-out chr20 rows (TREE_SCORE to one unit of its fourth decimal
    where the splits are equal; mean gap and FILTER share where a forest
    parts at a near-tie, as the JAX package's own jit fit parts from its
    native trainer)."""
    argv = ["--input_file", bar_world, "--evaluate_concordance"]
    port, ref = _run_both(tmp_path, argv, env={"VCTPU_NATIVE_GBT": "0"}, monkeypatch=monkeypatch)
    got, want = treg.load_models(port + ".pkl"), treg.load_models(ref + ".pkl")
    import torch

    x, _, _, _, _, _, contig = ttm._ingest(ttm.parse_args([*argv, "--output_file_prefix", "x"]), torch.device("cpu"))
    held = x[contig == "chr20"]
    bars = {name: torch_worlds.forest_bar(got[name], want[name], held) for name in want if name.startswith("rf")}
    assert len(bars) == 4 and all(b["held"] for b in bars.values()), bars
    assert not all(b["splits_equal"] for b in bars.values()), "the world no longer parts at a near-tie"
    assert all(b["rows"] == len(held) > 4000 for b in bars.values())


def test_vcf_mode_equals_the_reference(vcf_world, tmp_path):
    port, ref = _run_both(tmp_path, [*_vcf_args(vcf_world), *SMALL, "--evaluate_concordance",
                                     "--evaluate_concordance_contig", "chr20"])
    models = _assert_models(port, ref)
    _assert_frames(port, ref, ("optimal_recall_precision", "training_results"))
    assert models["rf_model_ignore_gt_incl_hpol_runs"].feature_names[-1] == "LCR-test"
    results = jh5.read_hdf(port + ".h5", "training_results")
    incl, excl = results["n"][0], results["n"][2]
    assert incl > excl  # the runs intervals hold some of the labeled records


def test_degenerate_cells_are_skipped_as_the_reference_skips_them(vcf_world, tmp_path):
    """Every labeled record on the held-out contig: no cell trains, the
    pickle holds no model, the results frame is empty."""
    port, ref = _run_both(tmp_path, [*_vcf_args(vcf_world), *SMALL, "--evaluate_concordance",
                                     "--list_of_contigs_to_read", "chr20"])
    assert treg.load_models(port + ".pkl") == {} == jreg.load_models(ref + ".pkl")
    _assert_frames(port, ref)


def _count_fits(monkeypatch, module) -> list:
    calls = []
    real = module.fit

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, "fit", counted)
    return calls


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_from_a_partial_pickle_of_either_package(h5_world, tmp_path, monkeypatch, writer):
    """A partial pickle of two forests and one threshold model, written by
    ``writer`` with the run's fingerprint: the port and the JAX package each
    fit only the other cells and write the full run's pickle and results."""
    argv = ["--input_file", h5_world, *SMALL]
    full_port, full_ref = _run_both(tmp_path, argv)
    full = jreg.load_models(full_ref + ".pkl")
    keep = ["rf_model_ignore_gt_incl_hpol_runs", "threshold_model_ignore_gt_incl_hpol_runs",
            "rf_model_use_gt_excl_hpol_runs"]
    args = ttm.parse_args([*argv, "--output_file_prefix", "x"])
    for prefix, fit_module, cli in ((str(tmp_path / "resumed_port"), tb, torch_main),
                                    (str(tmp_path / "resumed_ref"), jb, jax_main)):
        if writer == "port":
            treg.save_models(prefix + ".partial.pkl", {k: treg.load_models(full_port + ".pkl")[k] for k in keep})
        else:
            jreg.save_models(prefix + ".partial.pkl", {k: full[k] for k in keep})
        with open(prefix + ".partial.meta.json", "w") as fh:
            json.dump(ttm._fingerprint(args), fh)
        calls = _count_fits(monkeypatch, fit_module)
        extra = ["--backend", "cpu"] if cli is torch_main else []
        assert cli(["train_models_pipeline", *argv, "--resume", "--output_file_prefix", prefix, *extra]) == 0
        assert len(calls) == 2  # the two forests the partial pickle lacks
        monkeypatch.undo()
        assert not os.path.exists(prefix + ".partial.pkl")
        _assert_models(prefix, full_ref, ordered=False)
        _assert_frames(prefix, full_ref)


def test_resume_refits_under_another_fingerprint(h5_world, tmp_path, monkeypatch):
    prefix = str(tmp_path / "p")
    argv = ["--input_file", h5_world, *SMALL, "--backend", "cpu"]
    assert torch_main(["train_models_pipeline", *argv, "--output_file_prefix", prefix]) == 0
    os.replace(prefix + ".pkl", prefix + ".partial.pkl")
    fp = ttm._fingerprint(ttm.parse_args([*argv, "--output_file_prefix", prefix]))
    with open(prefix + ".partial.meta.json", "w") as fh:
        json.dump({**fp, "n_trees": 99}, fh)
    calls = _count_fits(monkeypatch, tb)
    assert torch_main(["train_models_pipeline", *argv, "--resume", "--output_file_prefix", prefix]) == 0
    assert len(calls) == 4


def test_port_model_filters_to_the_reference_bytes(vcf_world, tmp_path):
    """The forest the port trains filters the callset through the port's and
    the JAX package's filter CLIs to the same bytes."""
    prefix = str(tmp_path / "trained")
    assert torch_main(["train_models_pipeline", *_vcf_args(vcf_world), *SMALL, "--output_file_prefix", prefix,
                       "--backend", "cpu"]) == 0
    from variantcalling_tpu.pipelines import filter_variants as jfvp

    outs = {}
    for name, cli in (("port", lambda a: torch_main(["filter_variants_pipeline", *a, "--backend", "cpu"])),
                      ("ref", jfvp.run)):
        for model in ("rf_model_ignore_gt_incl_hpol_runs", "threshold_model_use_gt_excl_hpol_runs"):
            out = tmp_path / f"{name}_{model}.vcf"
            assert cli(["--input_file", vcf_world["vcf"], "--model_file", prefix + ".pkl", "--model_name", model,
                        "--reference_file", vcf_world["fasta"], "--output_file", str(out),
                        "--runs_file", vcf_world["runs"], "--annotate_intervals", vcf_world["annotate"]]) == 0
            outs[name, model] = fixtures.strip_vctpu_header(out.read_bytes())
    for model in ("rf_model_ignore_gt_incl_hpol_runs", "threshold_model_use_gt_excl_hpol_runs"):
        assert outs["port", model] == outs["ref", model], model
    records = [ln for ln in outs["port", "rf_model_ignore_gt_incl_hpol_runs"].decode().splitlines()
               if not ln.startswith("#")]
    assert {ln.split("\t")[6] for ln in records} >= {"PASS", "LOW_SCORE"}


def pickle_globals(data: bytes) -> set[tuple[str, str]]:
    """The (module, name) of every global a pickle names, read by an
    unpickler that resolves only numpy's and builtins' and stands in for the
    rest."""
    seen = set()

    class StandIn:
        pass

    class Recorder(pickle.Unpickler):
        def find_class(self, module, name):
            seen.add((module, name))
            if module.split(".")[0] in ("numpy", "builtins", "copyreg"):
                return super().find_class(module, name)
            return StandIn

    Recorder(io.BytesIO(data)).load()
    return seen


_LOAD_WITHOUT_TORCH = """
import sys
sys.modules["torch"] = None
sys.modules["variantcalling_tpu_torch"] = None
from variantcalling_tpu.models.registry import load_models
models = load_models(sys.argv[1])
print({k: type(v).__module__ + "." + type(v).__name__ for k, v in models.items()})
print(models["rf_model_ignore_gt_incl_hpol_runs"].value.dtype, len(models))
"""


def test_pickle_loads_in_the_jax_package_without_torch(h5_world, tmp_path):
    """A subprocess where ``torch`` and the port cannot be imported loads the
    port's pickle through the JAX package's ``load_models`` into its own
    classes; the pickle's globals are the reference's model classes, numpy
    and builtins only."""
    prefix = str(tmp_path / "p")
    assert torch_main(["train_models_pipeline", "--input_file", h5_world, *SMALL, "--output_file_prefix", prefix,
                       "--backend", "cpu"]) == 0
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": os.getcwd()}
    proc = subprocess.run([sys.executable, "-c", _LOAD_WITHOUT_TORCH, prefix + ".pkl"], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "'rf_model_ignore_gt_incl_hpol_runs': 'variantcalling_tpu.models.forest.FlatForest'" in proc.stdout
    assert "'threshold_model_use_gt_excl_hpol_runs': 'variantcalling_tpu.models.threshold.ThresholdModel'" \
        in proc.stdout and "float32 8" in proc.stdout
    globs = pickle_globals(open(prefix + ".pkl", "rb").read())
    assert {m for m, _ in globs} <= {"variantcalling_tpu.models.forest", "variantcalling_tpu.models.threshold",
                                     "numpy", "numpy._core.multiarray", "numpy.core.multiarray", "builtins"}
    assert ("variantcalling_tpu.models.forest", "FlatForest") in globs
    assert ("variantcalling_tpu.models.threshold", "ThresholdModel") in globs


def test_dan_and_threshold_models_pickle_under_the_reference_names(tmp_path):
    from variantcalling_tpu_torch import synthetic

    path = str(tmp_path / "fam.pkl")
    treg.save_models(path, {})
    synthetic.add_family_models(path, seed=3, embed_dim=4, hidden=8)
    models = jreg.load_models(path)
    assert {type(m).__module__ for m in models.values()} == {"variantcalling_tpu.models.dan",
                                                              "variantcalling_tpu.models.threshold"}
    dan = models[synthetic.DAN_MODEL_NAME]
    assert type(dan.cfg).__module__ == "variantcalling_tpu.models.dan" and dan.cfg.hidden == 8
    port = treg.load_models(path)[synthetic.DAN_MODEL_NAME]
    assert all(np.array_equal(port.params_np[k], v) if isinstance(v, np.ndarray) else True
               for k, v in dan.params_np.items())


def test_backend_gpu_without_a_card_exits_2(h5_world, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert torch_main(["train_models_pipeline", "--input_file", h5_world, *SMALL, "--output_file_prefix",
                       str(tmp_path / "p")]) == 2
    assert not os.path.exists(tmp_path / "p.pkl")


@pytest.mark.parametrize("group_column,ignored", [(None, ["HPOL_RUN"]), (None, None), ("grp", ["LOW_SCORE"])])
def test_accuracy_metrics_equal_the_reference(group_column, ignored):
    """``calc_accuracy_metrics`` (the ``optimal_recall_precision`` frame):
    the same rows as the JAX package's, dtypes included."""
    from variantcalling_tpu.concordance import concordance_utils as jcu
    from variantcalling_tpu_torch.concordance import concordance_utils as tcu
    from variantcalling_tpu_torch.utils.h5_utils import Frame

    rng = np.random.default_rng(4)
    n = 3000
    cols = {"indel": rng.random(n) < 0.3, "hmer_indel_length": rng.integers(0, 15, n).astype(np.float32),
            "classify_gt": rng.choice(["tp", "fp", "fn"], n).astype(object),
            "filter": rng.choice(["PASS", "LOW_SCORE", "HPOL_RUN", "LOW_SCORE;HPOL_RUN", "."], n).astype(object),
            "grp": rng.choice(["a", "b", "c"], n).astype(object)}
    cols["classify_gt"][::97] = None
    want = jcu.calc_accuracy_metrics(pd.DataFrame(cols), "classify_gt", ignored, group_column)
    got = tcu.calc_accuracy_metrics(Frame(cols), "classify_gt", ignored, group_column, device="cpu")
    assert got.columns == list(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        assert (c == "group" or got[c].dtype == w.dtype) and list(got[c]) == list(w), c


@pytest.mark.parametrize("device", ["cpu", "torch.device"])
def test_accuracy_metrics_tally_on_the_device_they_are_given(device, monkeypatch):
    """``calc_accuracy_metrics`` hands every input of the tally to the device it
    is given (a backend name or a ``torch.device``) and gets the JAX package's
    counts back; the tally is masked int64 sums, no matrix product."""
    import torch

    from variantcalling_tpu.concordance import concordance_utils as jcu
    from variantcalling_tpu_torch.concordance import concordance_utils as tcu
    from variantcalling_tpu_torch.ops import concordance as tops
    from variantcalling_tpu_torch.utils.h5_utils import Frame

    rng = np.random.default_rng(12)
    n = 5000
    cols = {"indel": rng.random(n) < 0.3, "hmer_indel_length": rng.integers(0, 15, n),
            "classify_gt": rng.choice(["tp", "fp", "fn"], n).astype(object),
            "filter": rng.choice(["PASS", "LOW_SCORE", "HPOL_RUN"], n).astype(object)}
    seen = []
    tally = tops.grouped_confusion

    def spy(*tensors):
        seen.extend(t.device for t in tensors)
        out = tally(*tensors)
        seen.append(out.device)
        assert out.dtype == torch.int64
        return out

    def no_matmul(*a, **k):
        raise AssertionError("the tally ran a matrix product")

    monkeypatch.setattr(tcu, "grouped_confusion", spy)
    monkeypatch.setattr(torch.Tensor, "__matmul__", no_matmul)
    monkeypatch.setattr(torch, "matmul", no_matmul)
    dev = torch.device("cpu") if device == "torch.device" else device
    got = tcu.calc_accuracy_metrics(Frame(cols), "classify_gt", ["HPOL_RUN"], device=dev)
    assert len(seen) == 6 and all(d == torch.device("cpu") for d in seen)
    want = jcu.calc_accuracy_metrics(pd.DataFrame(cols), "classify_gt", ["HPOL_RUN"])
    for c in ("tp", "fp", "fn"):
        assert got[c].dtype == np.int64 and list(got[c]) == list(want[c]), c


def test_grouped_confusion_counts_are_exact_int64():
    """Overlapping groups, filtered tps turned fns: the counts equal a float64
    product of the one-hot classes, as int64."""
    import torch

    from variantcalling_tpu_torch.ops import concordance as tops

    rng = np.random.default_rng(13)
    n = 20_000
    masks = torch.from_numpy(rng.random((5, n)) < 0.4)
    tp = torch.from_numpy(rng.random(n) < 0.5)
    fp = ~tp & torch.from_numpy(rng.random(n) < 0.5)
    fn = ~tp & ~fp
    pf = torch.from_numpy(rng.random(n) < 0.8)
    got = tops.grouped_confusion(masks, tp, fp, fn, pf)
    want = masks.double() @ tops.effective_classes(tp, fp, fn, pf).double()
    assert got.dtype == torch.int64 and torch.equal(got, want.long())
    assert tops.grouped_confusion(masks[:0], tp, fp, fn, pf).shape == (0, 3)


@pytest.mark.parametrize("resident", [False, True])
def test_featurize_matrix_equals_the_reference(vcf_world, monkeypatch, resident):
    """``featurize.featurize`` (the whole-table entry of VCF mode) gives the
    reference's matrix, windows from the host gather or from the genome
    resident on the run's device (the threshold set to 0)."""
    import torch

    from variantcalling_tpu import featurize as jfeat
    from variantcalling_tpu.io import bed as jbed
    from variantcalling_tpu.io.fasta import FastaReader as JFasta
    from variantcalling_tpu.io.vcf import read_vcf as jread
    from variantcalling_tpu_torch import featurize as tfeat
    from variantcalling_tpu_torch.io.bed import read_intervals
    from variantcalling_tpu_torch.io.fasta import FastaReader
    from variantcalling_tpu_torch.io.vcf import read_vcf

    if resident:
        monkeypatch.setattr(tfeat, "GENOME_RESIDENT_MIN_VARIANTS", 0)
        monkeypatch.setattr(tfeat, "_DEVICE_GENOME_CACHE", {})
    with FastaReader(vcf_world["fasta"]) as fasta:
        got = tfeat.featurize(read_vcf(vcf_world["vcf"]), fasta,
                              annotate_intervals={"LCR-test": read_intervals(vcf_world["annotate"])},
                              device=torch.device("cpu"))
    with JFasta(vcf_world["fasta"]) as fasta:
        want = jfeat.featurize(jread(vcf_world["vcf"]), fasta,
                               annotate_intervals={"LCR-test": jbed.read_intervals(vcf_world["annotate"])})
    assert got.feature_names == want.feature_names
    np.testing.assert_array_equal(got.matrix(), want.matrix())
    assert (tfeat._genome_key(fasta, tfeat.WINDOW_RADIUS, torch.device("cpu")) in tfeat._DEVICE_GENOME_CACHE) \
        == resident
