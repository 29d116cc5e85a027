"""``train_dan`` of the port against ``variantcalling_tpu.pipelines.train_dan``, on the CPU.

On the reference's own fixture (``tests/unit/test_somatic_and_dan.py``'s
``_training_h5``: one frame, hidden 32, embed 4, 30 steps): ``norm_mu`` and
``norm_sd`` byte-equal, the same feature lists, config and model name (the
weights differ: the two packages cannot draw the same initial numbers).
The port's pickle loads in the JAX package and scores through its filter
CLI to the port's own filter output within the DAN rule
(``tests/torch_vcf_compare.py``, 1e-5). The journaled ingest cache, in
``keys`` and ``rows`` mode, written by one package and resumed by the other
(in both directions, with no unit featurized again); an identity change
restarts it. Multi-rank env and a VCF input exit 2; two ``--backend cpu``
runs, and two resumed pairs, write byte-equal pickles.
"""

import os

import numpy as np
import pytest

from tests import torch_worlds
from tests.torch_vcf_compare import differing_records
from tests.unit.test_somatic_and_dan import _training_h5
from variantcalling_tpu.__main__ import main as jax_main
from variantcalling_tpu.models import registry as jreg
from variantcalling_tpu.pipelines import train_dan as jtd
from variantcalling_tpu_torch.__main__ import main as torch_main
from variantcalling_tpu_torch.pipelines import train_dan as ttd

SMALL = ["--n_steps", "30", "--batch_size", "256", "--hidden", "32", "--embed_dim", "4"]


@pytest.fixture(scope="module")
def fixture_h5(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dan_fixture") / "conc.h5")
    _training_h5(path, np.random.default_rng(42))
    return path


@pytest.fixture(scope="module")
def keys_h5(tmp_path_factory):
    """Three frame keys (chr1, chr2, chr20): the ingest's ``keys`` mode."""
    d = tmp_path_factory.mktemp("dan_keys")
    return torch_worlds.write_training_h5_world(d / "concordance.h5", seed=31, n_rows=1500, chr20_rows=300)


def _port(argv: list[str]) -> int:
    return torch_main(["train_dan", *argv, "--backend", "cpu"])


def test_cli_matches_the_reference(fixture_h5, tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert _port(["--input_file", fixture_h5, *SMALL, "--output_file_prefix", port]) == 0
    assert jtd.run(["--input_file", fixture_h5, *SMALL, "--output_file_prefix", ref]) == 0
    assert ttd.MODEL_NAME == jtd.MODEL_NAME
    got, want = jreg.load_models(port + ".pkl"), jreg.load_models(ref + ".pkl")
    assert list(got) == list(want) == [jtd.MODEL_NAME]
    g, w = got[jtd.MODEL_NAME], want[jtd.MODEL_NAME]
    assert type(g) is type(w) and type(g.cfg) is type(w.cfg) and g.cfg == w.cfg
    assert g.norm_mu.tobytes() == w.norm_mu.tobytes() and g.norm_sd.tobytes() == w.norm_sd.tobytes()
    assert g.norm_mu.dtype == w.norm_mu.dtype == np.float32
    assert g.feature_names == w.feature_names and g.numeric_features == w.numeric_features == ["qual", "dp", "sor"]
    assert list(g.params_np) == list(w.params_np)
    assert all(g.params_np[k].shape == w.params_np[k].shape and g.params_np[k].dtype == w.params_np[k].dtype
               for k in w.params_np)
    assert g.pass_threshold == w.pass_threshold


@pytest.fixture(scope="module")
def scoring_world(tmp_path_factory):
    from variantcalling_tpu_torch import synthetic

    d = tmp_path_factory.mktemp("dan_score")
    return synthetic.write_world(str(d), seed=5, length=40_000, n_variants=400, n_trees=4)


def test_port_pickle_scores_through_the_jax_filter(fixture_h5, scoring_world, tmp_path):
    """The pickle of the port's ``train_dan`` through the JAX package's filter
    CLI and through the port's (``--backend cpu``): the DAN rule at 1e-5."""
    prefix = str(tmp_path / "dan")
    assert _port(["--input_file", fixture_h5, *SMALL, "--output_file_prefix", prefix]) == 0
    w = scoring_world
    common = ["filter_variants_pipeline", "--input_file", w["vcf"], "--model_file", prefix + ".pkl",
              "--model_name", ttd.MODEL_NAME, "--reference_file", w["fasta"]]
    assert jax_main([*common, "--output_file", str(tmp_path / "ref.vcf")]) == 0
    assert torch_main([*common, "--output_file", str(tmp_path / "port.vcf"), "--backend", "cpu"]) == 0
    ref, port = (tmp_path / "ref.vcf").read_bytes(), (tmp_path / "port.vcf").read_bytes()
    assert b"TREE_SCORE=" in ref
    differing_records(port, ref, 0.5, 1e-5)


def _no_reads(monkeypatch, module) -> list:
    """Make ``module._read_unit`` record its calls and fail them."""
    calls = []

    def refuse(*args, **kwargs):
        calls.append(args[1])
        raise AssertionError("a cached unit was featurized again")

    monkeypatch.setattr(module, "_read_unit", refuse)
    return calls


@pytest.mark.parametrize("mode", ["keys", "rows"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ingest_cache_resumes_across_packages(writer, mode, fixture_h5, keys_h5, tmp_path, monkeypatch):
    """One package fills the cache, the other resumes every unit of it (its
    ``_read_unit`` made to fail) to the same training set: equal
    ``norm_mu``/``norm_sd`` bytes and feature lists."""
    h5 = keys_h5 if mode == "keys" else fixture_h5
    cache = str(tmp_path / "cache")
    argv = ["--input_file", h5, *SMALL, "--ingest_cache_dir", cache, "--ingest_chunk_rows", "200"]
    first, second = str(tmp_path / "first"), str(tmp_path / "second")
    if writer == "port":
        assert _port([*argv, "--output_file_prefix", first]) == 0
        _no_reads(monkeypatch, jtd)
        assert jtd.run([*argv, "--output_file_prefix", second]) == 0
    else:
        assert jtd.run([*argv, "--output_file_prefix", first]) == 0
        _no_reads(monkeypatch, ttd)
        assert _port([*argv, "--output_file_prefix", second]) == 0
    units = sorted(n for n in os.listdir(cache) if n.startswith("chunk_"))
    assert units == [f"chunk_{i:06d}.npz" for i in range(3)]
    a = jreg.load_model(first + ".pkl", ttd.MODEL_NAME)
    b = jreg.load_model(second + ".pkl", ttd.MODEL_NAME)
    assert a.norm_mu.tobytes() == b.norm_mu.tobytes() and a.norm_sd.tobytes() == b.norm_sd.tobytes()
    assert a.feature_names == b.feature_names


@pytest.mark.parametrize("change", ["contigs", "exome_weight", "input_touched"])
def test_an_identity_change_restarts_the_ingest(change, keys_h5, tmp_path, monkeypatch, caplog):
    h5 = str(tmp_path / "conc.h5")
    with open(keys_h5, "rb") as src, open(h5, "wb") as dst:
        dst.write(src.read())
    cache = str(tmp_path / "cache")
    argv = ["--input_file", h5, *SMALL, "--ingest_cache_dir", cache, "--output_file_prefix", str(tmp_path / "p")]
    assert _port(argv) == 0
    extra = {"contigs": ["--list_of_contigs_to_read", "chr1", "chr20"],
             "exome_weight": ["--exome_weight", "2", "--exome_weight_annotation", "exome"],
             "input_touched": []}[change]
    if change == "input_touched":
        st = os.stat(h5)
        os.utime(h5, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    read = []
    original = ttd._read_unit

    def counting(args, unit, mode, frame):
        read.append(unit)
        return original(args, unit, mode, frame)

    monkeypatch.setattr(ttd, "_read_unit", counting)
    caplog.set_level("INFO")
    assert _port([*argv, *extra]) == 0
    assert read == ["chr1", "chr2", "chr20"]
    assert "ingest cache identity changed" in caplog.text
    read.clear()
    assert _port([*argv, *extra]) == 0  # the restarted cache now resumes whole
    assert read == []


@pytest.mark.parametrize("env", [{"VCTPU_RANK": "1", "VCTPU_NUM_PROCESSES": "2"},
                                 {"VCTPU_RANK": "0", "VCTPU_NUM_PROCESSES": "4"},
                                 {"VCTPU_SPAN": "0:1000:1"}])
def test_a_multi_rank_env_exits_2(env, fixture_h5, tmp_path, monkeypatch, caplog):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert _port(["--input_file", fixture_h5, *SMALL, "--output_file_prefix", str(tmp_path / "p")]) == 2
    assert "A7" in caplog.text and not (tmp_path / "p.pkl").exists()


def test_one_rank_of_one_trains(fixture_h5, tmp_path, monkeypatch):
    monkeypatch.setenv("VCTPU_RANK", "0")
    monkeypatch.setenv("VCTPU_NUM_PROCESSES", "1")
    assert _port(["--input_file", fixture_h5, *SMALL, "--output_file_prefix", str(tmp_path / "p")]) == 0


def test_a_vcf_input_exits_2(scoring_world, tmp_path, caplog):
    assert _port(["--input_file", scoring_world["vcf"], *SMALL, "--output_file_prefix", str(tmp_path / "p")]) == 2
    assert "concordance h5" in caplog.text and not (tmp_path / "p.pkl").exists()


def test_backend_gpu_without_a_card_exits_2(fixture_h5, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert torch_main(["train_dan", "--input_file", fixture_h5, *SMALL, "--output_file_prefix",
                       str(tmp_path / "p")]) == 2
    assert not (tmp_path / "p.pkl").exists()


def test_two_cpu_runs_write_equal_pickles(fixture_h5, tmp_path):
    for name in ("a", "b"):
        assert _port(["--input_file", fixture_h5, *SMALL, "--output_file_prefix", str(tmp_path / name)]) == 0
    assert (tmp_path / "a.pkl").read_bytes() == (tmp_path / "b.pkl").read_bytes()


def test_resume_from_a_checkpoint(fixture_h5, tmp_path, caplog):
    """20 steps, then 40 on the same checkpoint dir (resumed from step 19 and
    the cache), twice: the two resumed pairs write equal pickles; the
    newest two checkpoints are kept."""
    caplog.set_level("INFO")
    for pair in ("a", "b"):
        ck = str(tmp_path / f"ck_{pair}")
        argv = ["--input_file", fixture_h5, *SMALL[2:], "--checkpoint_dir", ck, "--checkpoint_every", "10",
                "--output_file_prefix", str(tmp_path / pair)]
        assert _port([*argv, "--n_steps", "20"]) == 0
        caplog.clear()
        assert _port([*argv, "--n_steps", "40"]) == 0
        assert "resumed from checkpoint step 19" in caplog.text
        assert "ingest resumed 1/1 chunks from cache" in caplog.text
        assert sorted(n for n in os.listdir(ck) if n.endswith(".npz")) == [
            "dan_ckpt_step_000000029.npz", "dan_ckpt_step_000000039.npz"]
    assert (tmp_path / "a.pkl").read_bytes() == (tmp_path / "b.pkl").read_bytes()
