"""The per-request scopes of the serving daemon, the host coverage reduce and the predictor cache, on the CPU.

- ``knobs.scope``: an override and its restore, ``None`` masking the
  environment, nested scopes, an unknown name refused at entry, a malformed
  value refused at the first read, invisible to a sibling thread;
  ``faults.scope``: fires only in its scope, invisible to a sibling thread,
  an empty spec a no-op; ``cancellation``: a token's scope and check. Each
  scope also reaches the work handed to the port's IO pool and to its stage
  pipeline's threads, as the reference's scopes reach its own.
- ``ops/coverage.host_coverage_stats``, native and plain (``VCTPU_NO_NATIVE=1``),
  with and without ``from_diffs``: means, histogram and percentiles equal to
  the JAX package's.
- The predictor cache of ``pipelines/filter_variants``: one build for two
  runs of one model, its own entry for a run scoped to ``gemm`` and to
  ``wide``, at most 8 entries under concurrent inserts, one build for many
  concurrent requests of one key.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from tests.conftest import assert_no_stream_leaks
from variantcalling_tpu.ops import coverage as jcoverage
from variantcalling_tpu_torch import knobs, native
from variantcalling_tpu_torch.engine import EngineError
from variantcalling_tpu_torch.ops import coverage as tcoverage
from variantcalling_tpu_torch.parallel.pipeline import IoPool, StagePipeline
from variantcalling_tpu_torch.pipelines import filter_variants as fv
from variantcalling_tpu_torch.utils import cancellation, faults

CARRIERS = ("inline", "io_pool", "stage_pipeline")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("VCTPU_CHUNK_RETRIES", raising=False)
    monkeypatch.delenv("VCTPU_IO_RETRIES", raising=False)
    faults.reset()
    yield
    faults.reset()
    assert_no_stream_leaks()


def _carry(carrier: str, fn):
    """``fn()`` run inline, as a task of an IO pool, or as a stage of a
    two-thread stage pipeline, from the calling context; its result, or its
    exception re-raised."""
    if carrier == "inline":
        return fn()
    if carrier == "io_pool":
        pool = IoPool(2, name="vctpu-io-scopetest")
        try:
            return pool.submit(fn).result(10)
        finally:
            pool.shutdown()
    pipe = StagePipeline([lambda _item: fn()], threads=2, timeout=30)
    return list(pipe.run(iter([0])))[0]


# -- knobs.scope ---------------------------------------------------------------


@pytest.mark.parametrize("carrier", CARRIERS)
def test_knob_scope_overrides_and_restores(monkeypatch, carrier):
    monkeypatch.setenv("VCTPU_CHUNK_RETRIES", "3")
    read = lambda: knobs.get_int("VCTPU_CHUNK_RETRIES")  # noqa: E731
    assert _carry(carrier, read) == 3
    with knobs.scope({"VCTPU_CHUNK_RETRIES": "0"}):
        assert _carry(carrier, read) == 0
        assert knobs.source("VCTPU_CHUNK_RETRIES") == "scope"
    assert _carry(carrier, read) == 3 and knobs.source("VCTPU_CHUNK_RETRIES") == "env"


@pytest.mark.parametrize("carrier", CARRIERS)
def test_knob_scope_none_masks_the_environment(monkeypatch, carrier):
    monkeypatch.setenv("VCTPU_IO_THREADS", "7")
    with knobs.scope({"VCTPU_IO_THREADS": None}):
        assert _carry(carrier, lambda: knobs.raw("VCTPU_IO_THREADS")) is None
        default = knobs.REGISTRY["VCTPU_IO_THREADS"].default
        assert _carry(carrier, lambda: knobs.get_int("VCTPU_IO_THREADS")) == default
        assert knobs.source("VCTPU_IO_THREADS") == "scope"
    assert knobs.get_int("VCTPU_IO_THREADS") == 7


@pytest.mark.parametrize("carrier", CARRIERS)
def test_knob_scopes_nest(carrier):
    with knobs.scope({"VCTPU_CHUNK_RETRIES": "5"}):
        with knobs.scope(VCTPU_IO_RETRIES="9"):
            assert _carry(carrier, lambda: (knobs.get_int("VCTPU_CHUNK_RETRIES"),
                                            knobs.get_int("VCTPU_IO_RETRIES"))) == (5, 9)
        assert knobs.source("VCTPU_IO_RETRIES") == "default"
        assert _carry(carrier, lambda: knobs.get_int("VCTPU_CHUNK_RETRIES")) == 5
    assert knobs.source("VCTPU_CHUNK_RETRIES") == "default"


def test_knob_scope_unknown_name_raises_at_entry():
    with pytest.raises(KeyError, match="VCTPU_NO_SUCH_KNOB"):
        knobs.scope({"VCTPU_NO_SUCH_KNOB": "1"})


@pytest.mark.parametrize("carrier", CARRIERS)
def test_knob_scope_malformed_value_raises_at_read(carrier):
    with knobs.scope({"VCTPU_CHUNK_RETRIES": "banana"}):
        with pytest.raises(EngineError, match="VCTPU_CHUNK_RETRIES"):
            _carry(carrier, lambda: knobs.get_int("VCTPU_CHUNK_RETRIES"))
        with pytest.raises(EngineError):
            knobs.validate_all()
    knobs.validate_all()


def test_knob_scope_invisible_to_a_sibling_thread():
    seen = {}
    gate = threading.Barrier(2, timeout=10)

    def reader():
        gate.wait()  # the scope is open in the main thread now
        seen["sibling"] = knobs.get_int("VCTPU_CHUNK_RETRIES")

    t = threading.Thread(target=reader)
    t.start()
    with knobs.scope({"VCTPU_CHUNK_RETRIES": "0"}):
        gate.wait()
        t.join(timeout=10)
        assert knobs.get_int("VCTPU_CHUNK_RETRIES") == 0
    assert not t.is_alive() and seen["sibling"] == knobs.REGISTRY["VCTPU_CHUNK_RETRIES"].default


# -- faults.scope --------------------------------------------------------------


def _chunk_check():
    faults.check("pipeline.chunk")
    return "clean"


@pytest.mark.parametrize("carrier", CARRIERS)
def test_fault_scope_fires_only_in_its_scope(carrier):
    with faults.scope("pipeline.chunk:1"):
        with pytest.raises(RuntimeError, match="chunk scoring"):
            _carry(carrier, _chunk_check)
        assert _carry(carrier, _chunk_check) == "clean"  # its one firing spent
    with faults.scope("pipeline.chunk:0"):  # unlimited
        for _ in range(2):
            with pytest.raises(RuntimeError):
                _carry(carrier, _chunk_check)
    assert _carry(carrier, _chunk_check) == "clean"  # outside: disarmed


def test_fault_scope_invisible_to_a_sibling_thread():
    results = {}
    gate = threading.Barrier(2, timeout=10)

    def sibling():
        gate.wait()
        try:
            results["sibling"] = _chunk_check()
        except RuntimeError:
            results["sibling"] = "fired"

    t = threading.Thread(target=sibling)
    t.start()
    with faults.scope("pipeline.chunk:0"):
        gate.wait()
        t.join(timeout=10)
        with pytest.raises(RuntimeError):
            _chunk_check()
    assert not t.is_alive() and results["sibling"] == "clean"


def test_fault_scope_empty_spec_is_a_no_op():
    with faults.scope(""):
        assert _chunk_check() == "clean" and not faults._ACTIVE


def test_fault_should_fire_and_disarm():
    faults.arm("native.build", times=2)
    assert [faults.should_fire("native.build") for _ in range(3)] == [True, True, False]
    faults.arm("io.commit", times=None)
    faults.disarm("io.commit")
    faults.check("io.commit")
    assert faults.fired("io.commit") == 0


# -- cancellation ------------------------------------------------------------------


@pytest.mark.parametrize("carrier", CARRIERS)
def test_cancellation_token_scope_and_check(carrier):
    token = cancellation.CancelToken()
    check = lambda: cancellation.check("t") or "running"  # noqa: E731
    with cancellation.scope(token):
        assert _carry(carrier, check) == "running"  # not tripped yet
        assert _carry(carrier, cancellation.current) is token
        token.cancel("request deadline expired")
        token.cancel("a later reason")  # the first reason wins
        with pytest.raises(cancellation.CancelledError, match="deadline expired"):
            _carry(carrier, check)
    assert _carry(carrier, check) == "running" and cancellation.current() is None


# -- host_coverage_stats -------------------------------------------------------------


@pytest.mark.parametrize("window", [1, 97, 1000])
@pytest.mark.parametrize("from_diffs", [False, True])
@pytest.mark.parametrize("engine", ["native", "plain"])
def test_host_coverage_stats_equal_the_reference(monkeypatch, engine, from_diffs, window):
    if engine == "native" and not native.available():
        pytest.skip("the native engine cannot be built here")
    if engine == "plain":
        monkeypatch.setenv("VCTPU_NO_NATIVE", "1")
    rng = np.random.default_rng(window)
    depth = rng.integers(0, 1300, size=200_003).astype(np.int32)
    depth[:500] = 0
    data = np.diff(depth, prepend=0).astype(np.int32) if from_diffs else depth
    qs = np.asarray([0.0, 0.05, 0.5, 0.95, 1.0], dtype=np.float32)
    native.reset_calls()
    got = tcoverage.host_coverage_stats(data, window, qs=qs, from_diffs=from_diffs)
    assert native.CALLS["coverage_stats"]["native" if engine == "native" else "plain"] == 1
    want = jcoverage.host_coverage_stats(data, window, qs=qs, from_diffs=from_diffs)
    assert set(got) == set(want) == {"means", "hist", "percentiles"}
    for key in want:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key


def test_host_coverage_stats_empty_and_small_max_depth():
    for depth, window, max_depth in ((np.zeros(0, np.int32), 10, 1000), (np.arange(50, dtype=np.int32), 7, 20)):
        got = tcoverage.host_coverage_stats(depth, window, max_depth=max_depth)
        want = jcoverage.host_coverage_stats(depth, window, max_depth=max_depth)
        assert all(np.array_equal(got[k], want[k]) for k in want)


# -- the predictor cache -----------------------------------------------------------


@pytest.fixture(scope="module")
def small_world(tmp_path_factory):
    from variantcalling_tpu_torch import synthetic

    d = tmp_path_factory.mktemp("scopes_world")
    return synthetic.write_world(str(d), seed=5, length=60_000, n_variants=600, n_trees=6, depth=4)


def _run_loaded(world, model, fasta, out):
    import argparse

    args = argparse.Namespace(
        input_file=world["vcf"], model_file=world["model"], model_name=world["model_name"],
        reference_file=world["fasta"], output_file=str(out), runs_file=None, blacklist=None,
        blacklist_cg_insertions=False, hpol_filter_length_dist=[10, 10], flow_order="TGCA", is_mutect=False,
        annotate_intervals=[], limit_to_contig=None, backend="cpu")
    assert fv.run_loaded(args, model, fasta, {}, None, torch.device("cpu")) == 0
    return out.read_bytes()


def test_predictor_built_once_for_two_runs_and_apart_by_strategy(small_world, tmp_path):
    from variantcalling_tpu_torch.io.fasta import FastaReader
    from variantcalling_tpu_torch.models import registry

    model = registry.load_model(small_world["model"], small_world["model_name"])
    with FastaReader(small_world["fasta"]) as fasta:
        before = fv.predictor_cache_stats()
        first = _run_loaded(small_world, model, fasta, tmp_path / "a.vcf")
        second = _run_loaded(small_world, model, fasta, tmp_path / "b.vcf")
        after = fv.predictor_cache_stats()
        assert first == second
        assert after["misses"] - before["misses"] == 1 and after["hits"] > before["hits"]
        for strategy, want in (("gemm", "gemm"), ("wide", "wide"), ("gemm", "gemm")):
            with knobs.scope({"VCTPU_FOREST_STRATEGY": strategy}):
                got = _run_loaded(small_world, model, fasta, tmp_path / f"{strategy}.vcf")
            assert f"##vctpu_forest_strategy={want}".encode() in got
        # gemm and wide each built their own entry, once
        assert fv.predictor_cache_stats()["misses"] - after["misses"] == 2


def _threshold_models(n: int, names: list[str]):
    from variantcalling_tpu_torch.models.threshold import ThresholdModel

    return [ThresholdModel(feature_names=names, thresholds=np.asarray([i, 1.0], np.float32),
                           signs=np.asarray([1.0, -1.0], np.float32), scales=np.ones(2, np.float32),
                           pass_threshold=0.5) for i in range(n)]


def _insert_at_once(models, names) -> list:
    """``predictor_for`` of each of ``models`` from its own thread, all released
    at once under a short switch interval; the errors raised."""
    barrier = threading.Barrier(len(models), timeout=30)
    errors = []

    def insert(model):
        try:
            barrier.wait()
            program, finalize = fv.predictor_for(model, names, fv.TORCH_PROGRAM, torch.device("cpu"))
            assert finalize is None and program(torch.zeros((2, 2))).shape == (2,)
        except Exception as e:  # noqa: BLE001 — relayed to the test thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=insert, args=(m,)) for m in models]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    return errors


def test_predictor_cache_builds_once_for_concurrent_requests_of_one_key():
    names = ["qual", "sor"]
    model = _threshold_models(1, names)[0]
    before = fv.predictor_cache_stats()
    assert not _insert_at_once([model] * 16, names)
    after = fv.predictor_cache_stats()
    assert after["misses"] - before["misses"] == 1 and after["hits"] - before["hits"] == 15


def test_predictor_cache_bounded_under_concurrent_inserts():
    names = ["qual", "sor"]
    models = _threshold_models(12, names)
    before = fv.predictor_cache_stats()["misses"]
    assert not _insert_at_once(models, names)
    stats = fv.predictor_cache_stats()
    assert stats["entries"] == fv.PREDICTOR_CACHE_MAX and stats["misses"] - before == len(models)
