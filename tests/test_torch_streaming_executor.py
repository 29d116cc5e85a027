"""The streaming executor's parts, against their contracts and the JAX package's.

- ``utils/faults.parse_spec`` gives the reference's tuples on a table of
  specs;
- ``parallel/pipeline``: :class:`StagePipeline` keeps order on the serial
  and threaded paths, relays an error of a stage and of the source, bounds
  the items in flight, trips its watchdog on an injected
  ``pipeline.stage_hang`` (and, supervised, re-dispatches the wedged chunk
  once), and joins every thread; ``imap_ordered`` keeps order with at most
  its window in flight; ``retry_transient`` and ``retry_chunk`` count their
  attempts and let contract errors through;
- ``io/bgzf.BgzfChunkCompressor`` writes :class:`BgzfWriter`'s bytes at
  any chunk size, with and without a pool;
- ``io/chunk_cache``: the LRU bound, a corrupt entry, the
  ``cache.entry_read`` and ``cache.entry_write`` faults;
- ``io/journal``: a torn last line is dropped, an out-of-order one voids
  the journal;
- the thread-safety repairs: the kernel launch counts, the engine's call
  counts and the scorer's sent bytes stay exact under 8 threads with a
  short switch interval, and 8 concurrent first calls build one resident
  genome, which a lease keeps from eviction.

Every test runs under ``tests.conftest.assert_no_stream_leaks`` (no
``vctpu-``/``pipe-``/``genome-prefetch`` thread, no sidecar file left) and
resets the armed faults.
"""

import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tests.conftest import assert_no_stream_leaks
from variantcalling_tpu.utils import faults as jfaults
from variantcalling_tpu_torch import featurize as tfeat
from variantcalling_tpu_torch import native
from variantcalling_tpu_torch.engine import EngineError
from variantcalling_tpu_torch.io import bgzf, chunk_cache, journal
from variantcalling_tpu_torch.io.fasta import FastaReader
from variantcalling_tpu_torch.models import forest_cuda
from variantcalling_tpu_torch.parallel import pipeline
from variantcalling_tpu_torch.utils import degrade, faults


@pytest.fixture(autouse=True)
def _no_leaks(tmp_path):
    yield
    faults.reset()
    assert_no_stream_leaks([tmp_path])


@pytest.fixture
def switchy():
    """A short interpreter switch interval, so that a lost update shows."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _hammer(fn, threads: int = 8, calls: int = 2000) -> None:
    workers = [threading.Thread(target=lambda: [fn() for _ in range(calls)]) for _ in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=60)
    assert not any(w.is_alive() for w in workers)


@pytest.mark.parametrize("spec", [
    "", "io.chunk_read", "io.chunk_read:2", "pipeline.stage_hang@30", "io.writeback:0+3", "io.commit:-1",
    "native.build", "native.build:2", "io.chunk_read:x@y+z", "no.such.point:3,io.commit",
    " io.shard_compress:1@0.5+2 , cache.entry_read:4 ", "cache.entry_write@0.01,pipeline.chunk:0",
])
def test_parse_spec_equals_the_reference(spec):
    assert faults.parse_spec(spec) == jfaults.parse_spec(spec)
    assert set(faults.POINTS) >= {"io.chunk_read", "io.shard_decompress", "io.shard_compress", "pipeline.chunk",
                                  "pipeline.stage", "pipeline.stage_hang", "io.writeback", "io.commit",
                                  "cache.entry_read", "cache.entry_write"}


def test_faults_fire_their_budget_after_free_passes():
    faults.arm("io.writeback", times=2, after=1)
    faults.check("io.writeback")  # the free pass
    for _ in range(2):
        with pytest.raises(OSError):
            faults.check("io.writeback")
    faults.check("io.writeback")
    assert faults.fired("io.writeback") == 2


def test_a_fault_scope_fires_in_its_context_and_follows_the_pipeline():
    seen = []

    def stage(x):
        try:
            faults.check("io.commit")
        except OSError:
            seen.append(x)
        return x

    with faults.scope("io.commit:2+1"):
        assert list(pipeline.StagePipeline([stage], threads=3, timeout=30).run(range(6))) == list(range(6))
    assert seen == [1, 2]
    faults.check("io.commit")  # the scope is closed: nothing armed


@pytest.mark.parametrize("threads", [1, 4])
def test_stage_pipeline_keeps_source_order(threads):
    def jitter(x):
        time.sleep(0.002 * (x % 3))
        return x * 10

    pipe = pipeline.StagePipeline([jitter, lambda x: x + 1], threads=threads, timeout=30)
    assert list(pipe.run(range(40))) == [x * 10 + 1 for x in range(40)]
    assert pipe.unjoined == []


@pytest.mark.parametrize("threads", [1, 4])
def test_a_stage_error_reaches_the_consumer(threads):
    def boom(x):
        if x == 7:
            raise ValueError("chunk 7")
        return x

    got = []
    with pytest.raises(ValueError, match="chunk 7"):
        for item in pipeline.StagePipeline([boom], threads=threads, timeout=30).run(range(20)):
            got.append(item)
    assert got == list(range(7))


@pytest.mark.parametrize("threads", [1, 4])
def test_a_source_error_reaches_the_consumer(threads):
    def source():
        yield from range(5)
        raise OSError("the source died")

    with pytest.raises(OSError, match="source died"):
        list(pipeline.StagePipeline([lambda x: x], threads=threads, timeout=30).run(source()))


def test_items_in_flight_are_bounded():
    pulled, consumed, ahead = [0], [0], []

    def source():
        for i in range(60):
            pulled[0] += 1
            ahead.append(pulled[0] - consumed[0])
            yield i

    pipe = pipeline.StagePipeline([lambda x: x, lambda x: x], queue_depth=2, threads=4, timeout=30)
    for _ in pipe.run(source()):
        time.sleep(0.002)
        consumed[0] += 1
    # three queues of two, an item in each of the two stages, one in the
    # feed's hand, one in the consumer's
    assert max(ahead) <= 3 * 2 + 2 + 2


def test_watchdog_names_the_hung_stage_and_joins_every_thread():
    faults.arm("pipeline.stage_hang", times=None, seconds=60)
    t0 = time.monotonic()
    pipe = pipeline.StagePipeline([lambda x: x], threads=4, timeout=0.5)
    with pytest.raises(pipeline.StageTimeoutError, match=r"stage 0 \(<lambda>\) busy"):
        list(pipe.run(range(5)))
    assert time.monotonic() - t0 < 10
    assert pipe.unjoined == []


def test_supervised_watchdog_redispatches_the_wedged_chunk_once():
    faults.arm("pipeline.stage_hang", times=1, seconds=60)
    pipe = pipeline.StagePipeline([lambda x: x * 2], threads=4, timeout=0.5, recover=True)
    assert list(pipe.run(range(6))) == [0, 2, 4, 6, 8, 10]
    assert pipe.watchdog_retried and pipe.unjoined == []


def test_imap_ordered_keeps_order_and_its_window():
    pool = pipeline.IoPool(4)
    live, peak, lock = [0], [0], threading.Lock()

    def work(x):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        time.sleep(0.001 * ((7 * x) % 5))
        with lock:
            live[0] -= 1
        if x == 33:
            raise KeyError(x)
        return x * x

    try:
        got = []
        with pytest.raises(KeyError):
            for v in pipeline.imap_ordered(pool, work, range(50), window=3):
                got.append(v)
        assert got == [x * x for x in range(33)] and peak[0] <= 3
    finally:
        pool.shutdown()
    assert pool.unjoined == []


def test_retry_transient_counts_its_attempts(monkeypatch):
    calls = []

    def flaky(fails):
        def fn():
            calls.append(1)
            if len(calls) <= fails:
                raise OSError("transient")
            return "done"
        return fn

    assert pipeline.retry_transient(flaky(2), "t", attempts=3, backoff_s=0) == "done" and len(calls) == 3
    calls.clear()
    with pytest.raises(OSError):
        pipeline.retry_transient(flaky(2), "t", attempts=2, backoff_s=0)
    assert len(calls) == 2
    calls.clear()

    def bad():
        calls.append(1)
        raise ValueError("not transient")

    with pytest.raises(ValueError):
        pipeline.retry_transient(bad, "t", attempts=5, backoff_s=0)
    assert len(calls) == 1
    monkeypatch.setenv("VCTPU_IO_RETRIES", "4")
    monkeypatch.setenv("VCTPU_IO_BACKOFF_S", "0")
    calls.clear()
    with pytest.raises(OSError):
        pipeline.retry_transient(flaky(10), "t")
    assert len(calls) == 5


def test_retry_chunk_counts_and_lets_contract_errors_through(monkeypatch):
    monkeypatch.setenv("VCTPU_CHUNK_RETRIES", "2")
    finals = []

    def fails_twice():
        finals.append(pipeline.on_final_attempt())
        if len(finals) < 3:
            raise RuntimeError("flaky")
        return 7

    assert pipeline.retry_chunk(fails_twice, "c", seq=3) == 7 and finals == [False, False, True]
    assert pipeline.on_final_attempt()
    for exc in (EngineError("config"), pipeline.StageTimeoutError("hung"), pipeline.LadderEscalation("sticky")):
        calls = []

        def raiser(exc=exc):
            calls.append(1)
            raise exc

        with pytest.raises(type(exc)):
            pipeline.retry_chunk(raiser, "c")
        assert len(calls) == 1


@pytest.mark.parametrize("chunk", [1, 700, 65_280, 65_281, 200_000])
@pytest.mark.parametrize("pooled", [False, True])
def test_chunk_compressor_writes_the_serial_writers_bytes(tmp_path, chunk, pooled):
    rng = np.random.default_rng(chunk)
    payload = rng.integers(0, 4, 300_000).astype(np.uint8).tobytes().replace(b"\x00", b"ACGT\t")
    serial = tmp_path / "serial.gz"
    with bgzf.BgzfWriter(str(serial)) as w:
        w.write(payload)
    pool = pipeline.IoPool(3) if pooled else None
    try:
        comp = bgzf.BgzfChunkCompressor(pool=pool)
        parts = [comp.add(payload[i:i + chunk]) for i in range(0, len(payload), chunk)]
        assert b"".join(parts) + comp.finish() == serial.read_bytes()
    finally:
        if pool is not None:
            pool.shutdown()


@pytest.mark.parametrize("sizes", [(100, 300_000), (65_279, 140_000, 7), (1, 65_280, 65_281, 200_000)])
def test_bgzf_writer_bytes_do_not_depend_on_the_write_sizes(tmp_path, sizes):
    """A large write after a carry (the carry topped up to one block, the rest
    deflated uncopied) cuts the stream into the blocks one write cuts."""
    payload = np.random.default_rng(len(sizes)).integers(0, 4, sum(sizes)).astype(np.uint8).tobytes()
    one, parts = tmp_path / "one.gz", tmp_path / "parts.gz"
    with bgzf.BgzfWriter(str(one)) as w:
        w.write(payload)
    with bgzf.BgzfWriter(str(parts)) as w:
        lo = 0
        for size in sizes:
            w.write(memoryview(payload)[lo: lo + size])
            lo += size
    assert parts.read_bytes() == one.read_bytes()
    assert len(bgzf.block_spans(one.read_bytes())) == -(-len(payload) // bgzf.MAX_BLOCK_DATA) + 1


def test_scan_and_inflate_spans_read_a_bgzf_file(tmp_path):
    data = bytes(range(256)) * 2000
    path = tmp_path / "x.gz"
    with bgzf.BgzfWriter(str(path)) as w:
        w.write(data)
    raw = path.read_bytes()
    spans = bgzf.scan_block_spans(raw)
    assert [s[:2] for s in spans] == bgzf.block_spans(raw) and sum(s[2] for s in spans) == len(data)
    groups = bgzf.group_spans(spans, 100_000)
    assert b"".join(bgzf.inflate_spans(raw, g) for g in groups) == data and len(groups) > 1
    import gzip

    assert bgzf.scan_block_spans(gzip.compress(data)) is None


def test_disk_store_bound_corruption_and_faults(tmp_path):
    degrade.clear_for_tests()
    store = chunk_cache.DiskStore(str(tmp_path / "cache"), bound=3 * (1000 + 24))
    for i in range(5):
        store.put(f"k{i}", bytes([i]) * 1000, 10, i)
        time.sleep(0.01)  # distinct mtimes: LRU order
    assert store.stats()["entries"] == 3 and store.get("k0") is None and store.get("k4") == (bytes([4]) * 1000, 10, 4)
    path = tmp_path / "cache" / "k3.vcc"
    path.write_bytes(path.read_bytes()[:-1] + b"\x00")
    assert store.get("k3") is None and not path.exists()
    faults.arm("cache.entry_read")
    assert store.get("k4") is None and degrade.events_for("chunk_cache.entry_read")
    assert store.get("k4") is not None
    faults.arm("cache.entry_write")
    with pytest.raises(OSError):
        store.put("k9", b"x", 1, 1)
    assert store.get("k9") is None and not list((tmp_path / "cache").glob(".vcc_tmp_*"))


def test_session_publishes_the_committed_prefix_only(tmp_path, monkeypatch):
    monkeypatch.setenv("VCTPU_CACHE", "1")
    monkeypatch.setenv("VCTPU_CACHE_DIR", str(tmp_path / "cache"))
    session = chunk_cache.open_session({"model": "m"})
    keys = [session.key_of(np.frombuffer(f"chunk {i}\n".encode(), np.uint8)) for i in range(3)]
    for i, k in enumerate(keys):
        session.stage(i, k, np.frombuffer(f"body {i}".encode(), np.uint8), 1, 0)
    session.publish_up_to(1)
    assert session.get(keys[0]) == (b"body 0", 1, 0) and session.get(keys[2]) is None
    session.discard()
    session.publish_up_to(2)
    assert session.get(keys[2]) is None and session.stats()["published"] == 2
    faults.arm("cache.entry_write")
    degrade.clear_for_tests()
    session.stage(3, "x", b"y", 1, 1)
    session.publish_up_to(3)  # dropped, with a degradation; never raised
    assert degrade.events_for("chunk_cache.entry_write") and session.get("x") is None


def test_memory_store_is_byte_bounded():
    store = chunk_cache.MemoryStore(bound=25)
    for i in range(4):
        store.put(f"k{i}", b"0123456789", 1, 0)
    assert store.stats() == {"entries": 2, "bytes": 20} and store.get("k0") is None


def test_journal_drops_a_torn_last_line_and_distrusts_disorder(tmp_path):
    out = str(tmp_path / "out.vcf")
    j = journal.ChunkJournal(out)
    j.begin({"input": "x"})
    for seq in range(3):
        j.append(seq, 10, 5, 100, 7)
    j.close()
    path = tmp_path / "out.vcf.journal"
    path.write_text(path.read_text() + '{"seq": 3, "rec')
    meta, entries = journal.ChunkJournal.load(out)
    assert meta["input"] == "x" and [e["seq"] for e in entries] == [0, 1, 2]
    lines = path.read_text().splitlines()
    path.write_text("\n".join([lines[0], lines[2], lines[1]]) + "\n")
    assert journal.ChunkJournal.load(out) is None
    path.unlink()


def test_launch_counts_stay_exact_under_8_threads(switchy):
    saved = forest_cuda.LAUNCHES, forest_cuda.TREE_STEP_LAUNCHES
    forest_cuda.LAUNCHES = forest_cuda.TREE_STEP_LAUNCHES = 0
    try:
        _hammer(lambda: (forest_cuda._count_launch("LAUNCHES"), forest_cuda._count_launch("TREE_STEP_LAUNCHES")))
        assert forest_cuda.LAUNCHES == forest_cuda.TREE_STEP_LAUNCHES == 8 * 2000
    finally:
        forest_cuda.LAUNCHES, forest_cuda.TREE_STEP_LAUNCHES = saved


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is absent: the engine cannot be built")
def test_engine_call_counts_stay_exact_under_8_threads(switchy):
    buf = np.frombuffer(b"chr1\t10\t.\tA\tC\t50\tPASS\tDP=3\n" * 20, dtype=np.uint8)
    assert native.vcf_parse(buf, 0) is not None
    native.reset_calls()
    _hammer(lambda: (native.vcf_parse(buf, 0), native.note_plain("vcf_assemble")), calls=300)
    assert native.CALLS["vcf_parse"]["native"] == 8 * 300 and native.CALLS["vcf_assemble"]["plain"] == 8 * 300


def test_scorer_sent_bytes_stay_exact_under_8_threads(switchy):
    from variantcalling_tpu_torch.models.threshold import ThresholdModel
    from variantcalling_tpu_torch.pipelines.filter_variants import FusedScorer

    model = ThresholdModel(["qual"], np.asarray([30.0], np.float32), np.asarray([1.0], np.float32),
                           np.asarray([5.0], np.float32), 0.5, ["qual"])
    scorer = FusedScorer(model, ["qual"], "torch", "TGCA", torch.device("cpu"))
    a = np.zeros(37, dtype=np.uint8)
    _hammer(lambda: scorer._send(a), calls=500)
    assert scorer.sent_bytes == 8 * 500 * 37


def test_one_resident_genome_for_8_concurrent_first_calls(tmp_path, monkeypatch):
    from variantcalling_tpu_torch import synthetic

    w = synthetic.write_world(str(tmp_path / "w"), seed=3, n_variants=50, n_trees=2, depth=3,
                              contigs=[("chr1", 20_000), ("chr2", 10_000)])
    monkeypatch.setattr(tfeat, "_DEVICE_GENOME_CACHE", {})
    monkeypatch.setenv("VCTPU_GENOME_CACHE", "0")
    builds, build = [], tfeat._build_device_genome

    def slow_build(*args):
        builds.append(1)
        time.sleep(0.2)  # every caller arrives while the first build runs
        return build(*args)

    monkeypatch.setattr(tfeat, "_build_device_genome", slow_build)
    fasta = FastaReader(w["fasta"])
    got = []
    workers = [threading.Thread(target=lambda: got.append(tfeat.device_genome(fasta, torch.device("cpu"))))
               for _ in range(8)]
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=60)
    assert len(builds) == 1 and len(got) == 8 and all(g is got[0] for g in got)

    # a leased genome survives a build of another key past the cache's size
    monkeypatch.setattr(tfeat, "_DEVICE_GENOME_MAX", 1)
    with tfeat.lease_genome(fasta, torch.device("cpu")):
        tfeat.device_genome(fasta, torch.device("cpu"), radius=5)
        assert tfeat._genome_key(fasta, tfeat.WINDOW_RADIUS, torch.device("cpu")) in tfeat._DEVICE_GENOME_CACHE
    tfeat.device_genome(fasta, torch.device("cpu"), radius=6)  # unleased now: evicted
    assert tfeat._genome_key(fasta, tfeat.WINDOW_RADIUS, torch.device("cpu")) not in tfeat._DEVICE_GENOME_CACHE
    assert not tfeat._DEVICE_GENOME_LEASES
