"""The port's elastic pods (``parallel/elastic``) against the JAX package's.

World: ``tests/torch_worlds.write_pod_world`` in 16 KiB chunks, on the CPU.

- The spans: ``initial_spans``, the ``VCTPU_SPAN`` wire format, its errors
  and the span plan ``resolve`` gives are the reference's; every path
  (segment, lease) is the reference's spelling.
- The lease is single-claimant: of eight threads racing one (span,
  generation), one wins, and a lease either package claimed refuses the
  other's claim.
- An elastic pod (in process, one span after another) writes the port's
  single-rank bytes exactly, into ``.vcf`` and ``.vcf.gz``, and the same bytes
  as the JAX package's span pod.
- A worker killed mid-span: its journal handed over at the last ``in_end``
  (``handoff_journal``), the adopter resumes every journaled chunk under
  ``VCTPU_RESUME_VERIFY=full`` and recomputes none; the merged plan equals
  the single-rank run. The handoff refuses a missing journal, an empty one,
  a missing partial, and a partial a live process owns.
- The chunk cache hits across a steal seam (its keys ignore the partition).
- ``merge_spans`` refuses gapped and overlapping plans as the reference does.
- The ``Coordinator`` with fake children, the reference's unit cases: a clean
  pod, a death re-offered under the next generation, a span given up with
  exit 7, a configuration error failing fast with 2, a clean exit without a
  marker taken as a death, the deadline (exit 5), a stuck straggler stolen,
  shedding under load, a winning shadow claimant promoted, a journaled death
  re-cut at its watermark, a late join refused during the merge.
"""

import argparse
import glob
import itertools
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from tests import torch_worlds
from tests.conftest import assert_no_stream_leaks
from tests.test_torch_rank_plan import CHUNK, _argv, _leftovers, _ns, _read
from variantcalling_tpu import engine as jengine
from variantcalling_tpu.engine import EngineError as JEngineError
from variantcalling_tpu.io.fasta import FastaReader as JFastaReader
from variantcalling_tpu.models.registry import load_model as jload_model
from variantcalling_tpu.parallel import elastic as jelastic
from variantcalling_tpu.parallel import rank_plan as jrp
from variantcalling_tpu.utils import faults as jfaults
from variantcalling_tpu_torch.__main__ import main as torch_main
from variantcalling_tpu_torch.engine import EngineError
from variantcalling_tpu_torch.io import journal
from variantcalling_tpu_torch.io import vcf as tvcf
from variantcalling_tpu_torch.io.fasta import FastaReader
from variantcalling_tpu_torch.models import registry as tregistry
from variantcalling_tpu_torch.parallel import elastic
from variantcalling_tpu_torch.parallel import rank_plan as trp
from variantcalling_tpu_torch.pipelines import filter_variants as tfv
from variantcalling_tpu_torch.utils import faults

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is absent: the engine cannot be built")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return torch_worlds.write_pod_world(tmp_path_factory.mktemp("elastic_world"))


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path, request):
    monkeypatch.setenv("VCTPU_STREAM_CHUNK_BYTES", str(CHUNK))
    monkeypatch.setenv("VCTPU_IO_BACKOFF_S", "0")
    monkeypatch.setenv("VCTPU_THREADS", "2")
    monkeypatch.setenv("VCTPU_IO_THREADS", "2")
    for k in ("VCTPU_STREAM", "VCTPU_CACHE", "VCTPU_RESUME", "VCTPU_RESUME_VERIFY", "VCTPU_FAULTS", "VCTPU_RANK",
              "VCTPU_NUM_PROCESSES", "VCTPU_SPAN"):
        monkeypatch.delenv(k, raising=False)
    faults.reset()
    yield
    faults.reset()
    jfaults.reset()
    jengine.reset_for_tests()
    dirs = [tmp_path] + ([request.getfixturevalue("world")["dir"]] if "world" in request.fixturenames else [])
    assert_no_stream_leaks(dirs)


def _span_plan(span: elastic.Span) -> trp.RankPlan:
    return trp.RankPlan(ranks=1, rank=0, source="span", reason="test", span=(span.lo, span.hi), gen=span.gen)


def _run_span(world, inp, out, span: elastic.Span, seal: bool = True) -> dict:
    """One span worker's body in process: its segment computed (and sealed)."""
    model = tregistry.load_model(world["model"], world["model_name"])
    plan = _span_plan(span)
    seg = elastic.span_segment_path(str(out), span.lo, span.hi)
    with FastaReader(world["fasta"]) as fasta:
        ctx = tfv.FilterContext(model, fasta, torch.device("cpu"), rank_plan=plan)
        stats = tfv.run_streaming(_ns(inp, seg), ctx)
    if seal:
        trp.write_marker(seg, trp.segment_identity(_ns(inp, out), plan, ctx.engine), stats)
    return stats


def _single(world, inp, out) -> bytes:
    assert torch_main(["filter_variants_pipeline", *_argv(world, inp, out)]) == 0
    return Path(out).read_bytes()


# -- spans and their spelling ------------------------------------------------------------------------------------


@pytest.mark.parametrize("h,total,n", [(366, 64195, 3), (10, 10, 2), (0, 7, 8), (517, 200_813, 4), (5, 6, 1)])
def test_initial_spans_equal_the_references(h, total, n):
    assert [(s.lo, s.hi, s.gen) for s in elastic.initial_spans(h, total, n)] == \
        [(s.lo, s.hi, s.gen) for s in jelastic.initial_spans(h, total, n)]


def test_initial_spans_refuse_an_empty_pod():
    for mod in (elastic, jelastic):
        with pytest.raises(ValueError):
            mod.initial_spans(10, 20, 0)


@pytest.mark.parametrize("value", ["366:64195:2", "0:0:0", "", "1:2", "a:b:c", "1:2:3:4", "5:4:0", "-1:2:0",
                                   "1:2:-1"])
def test_span_env_answers_as_the_reference(value):
    def outcome(mod, error):
        try:
            parsed = mod.parse_span_env(value)
        except error as e:
            return "error", str(e).split(" — ")[0]
        return parsed, mod.span_env(mod.Span(*parsed))

    assert outcome(elastic, EngineError) == outcome(jelastic, JEngineError)


def test_paths_are_the_references():
    out = "/x/o.vcf.gz"
    seg = elastic.span_segment_path(out, 517, 9000)
    assert seg == jelastic.span_segment_path(out, 517, 9000) == "/x/o.vcf.gz.span517-9000.seg"
    assert elastic.lease_path(seg, 3) == jelastic.lease_path(seg, 3)
    assert trp.segment_path(out, 1, 4) == jrp.segment_path(out, 1, 4)
    assert trp.marker_path(seg) == jrp.marker_path(seg)


# -- the single-claimant lease ---------------------------------------------------------------------------------------


def test_one_claimant_wins_a_lease_race(tmp_path):
    seg = str(tmp_path / "out.vcf.span0-100.seg")
    wins: list[bool] = []
    barrier = threading.Barrier(8)

    def race():
        barrier.wait()
        wins.append(elastic.claim_lease(seg, 0))

    threads = [threading.Thread(target=race) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert sum(wins) == 1 and len(wins) == 8
    assert not jelastic.claim_lease(seg, 0)  # the reference's claim sees the port's lease
    assert jelastic.claim_lease(seg, 1)  # a re-offer is a fresh generation
    assert not elastic.claim_lease(seg, 1)


def test_a_lost_lease_raises_before_anything_is_read(tmp_path):
    out = str(tmp_path / "out.vcf")
    seg = elastic.span_segment_path(out, 10, 20)
    assert elastic.claim_lease(seg, 0)
    plan = trp.RankPlan(ranks=1, rank=0, source="span", reason="test", span=(10, 20), gen=0)
    with pytest.raises(elastic.LeaseLost, match="lease already claimed"):
        trp.run_scaleout(argparse.Namespace(input_file="/nonexistent", output_file=out), None, plan=plan)


# -- the elastic pod, in process ------------------------------------------------------------------------------------


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
def test_an_elastic_pod_writes_the_single_rank_bytes(world, tmp_path, suffix):
    inp = world["vcf"] if suffix == ".vcf" else world["vcf_gz"]
    want = _single(world, inp, tmp_path / f"single{suffix}")
    h, total = tvcf.scan_record_region(inp)
    spans = elastic.initial_spans(h, total, 3)
    out = tmp_path / f"pod{suffix}"
    assert sum(_run_span(world, inp, out, s)["n"] for s in spans) == world["n"]
    stats = elastic.merge_spans(str(out), spans)
    assert stats["n"] == world["n"] and stats["spans"] == 3
    assert out.read_bytes() == want and b"##vctpu_ranks=" not in _read(out)
    if suffix == ".vcf.gz":
        assert Path(f"{out}.tbi").read_bytes() == Path(f"{tmp_path}/single{suffix}.tbi").read_bytes()
    assert _leftovers(out) == []
    # the JAX package's span pod on the same spans: the same records
    model, fasta = jload_model(world["model"], world["model_name"]), JFastaReader(world["fasta"])
    ref = tmp_path / f"ref{suffix}"
    for s in spans:
        plan = jrp.RankPlan(ranks=1, rank=0, source="span", reason="test", span=(s.lo, s.hi), gen=s.gen)
        assert jrp.run_scaleout(_ns(inp, ref), model, fasta, {}, None, engine=jengine.resolve_for_run(),
                                plan=plan) == 0
    jelastic.merge_spans(str(ref), [jelastic.Span(s.lo, s.hi, s.gen) for s in spans])
    from tests.fixtures import strip_vctpu_header

    assert strip_vctpu_header(_read(ref)) == strip_vctpu_header(_read(out))


def test_a_handed_over_journal_is_adopted_without_recompute(world, tmp_path, monkeypatch):
    inp = world["vcf"]
    want = _single(world, inp, tmp_path / "single.vcf")
    h, total = tvcf.scan_record_region(inp)
    out = tmp_path / "pod.vcf"
    left, right = elastic.initial_spans(h, total, 2)
    # worker A: the header and two chunks land, then every writeback fails
    faults.arm("io.writeback", times=None, after=3)
    with pytest.raises(OSError, match="injected fault"):
        _run_span(world, inp, out, left, seal=False)
    faults.reset()
    seg_a = elastic.span_segment_path(str(out), left.lo, left.hi)
    chunks, end = elastic.journal_progress(seg_a)
    assert chunks >= 1 and end is not None and left.lo < end < left.hi
    # the coordinator's re-cut: [lo, end) adopted, [end, hi) fresh
    adopt, rest = elastic.Span(left.lo, end, left.gen + 1), elastic.Span(end, left.hi, 0)
    seg_b = elastic.span_segment_path(str(out), adopt.lo, adopt.hi)
    assert elastic.handoff_journal(seg_a, seg_b, (adopt.lo, adopt.hi))
    assert not os.path.exists(journal.journal_path(seg_a)) and not glob.glob(seg_a + ".partial*")
    assert journal.ChunkJournal.load(seg_b)[0]["config"]["span"] == [adopt.lo, adopt.hi]
    monkeypatch.setenv("VCTPU_RESUME_VERIFY", "full")
    stats = _run_span(world, inp, out, adopt)
    assert stats["resumed_chunks"] == stats["chunks"] == chunks
    monkeypatch.delenv("VCTPU_RESUME_VERIFY")
    n = stats["n"] + _run_span(world, inp, out, rest)["n"] + _run_span(world, inp, out, right)["n"]
    assert n == world["n"]
    elastic.merge_spans(str(out), [adopt, rest, right])
    assert out.read_bytes() == want
    assert _leftovers(out) == []


def test_the_handoff_refuses_what_it_cannot_adopt_safely(tmp_path):
    old = str(tmp_path / "o.vcf.span0-100.seg")
    new = str(tmp_path / "o.vcf.span0-50.seg")
    assert not elastic.handoff_journal(old, new, (0, 50))  # no journal
    token = journal.new_partial_token()
    j = journal.ChunkJournal(old)
    j.begin({"config": {"span": [0, 100]}, "partial": token})
    j.close()
    assert not elastic.handoff_journal(old, new, (0, 50))  # no entries
    j = journal.ChunkJournal(old)
    j.begin({"config": {"span": [0, 100]}, "partial": token})
    j.append(0, 10, 5, 64, 123, in_end=40)
    j.close()
    assert not elastic.handoff_journal(old, new, (0, 50))  # the partial is gone
    Path(journal.partial_path(old, token)).write_bytes(b"x" * 64)
    journal.claim_token(token)  # a live writer (this process) owns the partial
    try:
        assert not elastic.handoff_journal(old, new, (0, 50))
    finally:
        journal.release_token(token)
    live = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:  # ... and so does another live process
        other = f"{live.pid}-{os.urandom(4).hex()}"
        j = journal.ChunkJournal(old)
        j.begin({"config": {"span": [0, 100]}, "partial": other})
        j.append(0, 10, 5, 64, 123, in_end=40)
        j.close()
        Path(journal.partial_path(old, other)).write_bytes(b"x" * 64)
        assert not elastic.handoff_journal(old, new, (0, 50))
    finally:
        live.kill()
        live.wait()
    os.remove(journal.partial_path(old, other))
    j = journal.ChunkJournal(old)
    j.begin({"config": {"span": [0, 100]}, "partial": token})
    j.append(0, 10, 5, 64, 123, in_end=40)
    j.close()
    assert elastic.handoff_journal(old, new, (0, 50))
    meta, entries = journal.ChunkJournal.load(new)
    assert meta["config"]["span"] == [0, 50] and entries[0]["in_end"] == 40
    assert elastic.journal_progress(new) == (1, 40) and elastic.journal_progress(old) == (0, None)
    os.remove(journal.partial_path(new, token))
    os.remove(journal.journal_path(new))


def test_the_cache_hits_across_a_steal_seam(world, tmp_path, monkeypatch):
    inp = world["vcf"]
    monkeypatch.setenv("VCTPU_CACHE", "1")
    monkeypatch.setenv("VCTPU_CACHE_DIR", str(tmp_path / "store"))
    h, total = tvcf.scan_record_region(inp)
    left, right = elastic.initial_spans(h, total, 2)
    cold_out = tmp_path / "cold.vcf"
    cold = [_run_span(world, inp, cold_out, s) for s in (left, right)]
    assert all(s["cache"]["hits"] == 0 and s["cache"]["misses"] > 0 for s in cold)
    elastic.merge_spans(str(cold_out), [left, right])
    r = tvcf.VcfChunkReader(inp, chunk_bytes=CHUNK, io_threads=1, span_targets=(left.lo, left.hi))
    n_chunks = sum(1 for _ in r.iter_raw())
    seam = r.chunk_end(n_chunks // 2 - 1)
    assert left.lo < seam < left.hi
    warm_out = tmp_path / "warm.vcf"
    plan = [elastic.Span(left.lo, seam), elastic.Span(seam, left.hi), right]
    warm = [_run_span(world, inp, warm_out, s) for s in plan]
    assert all(s["cache"]["misses"] == 0 and s["cache"]["hits"] > 0 for s in warm)
    assert sum(s["cache"]["hits"] for s in warm) == sum(s["cache"]["misses"] for s in cold)
    elastic.merge_spans(str(warm_out), plan)
    assert warm_out.read_bytes() == cold_out.read_bytes()


@pytest.mark.parametrize("plan", [[(0, 10), (20, 30)], [(0, 15), (10, 30)], []])
def test_merge_spans_refuses_gapped_plans_as_the_reference(tmp_path, plan):
    msgs = []
    for mod, rp in ((elastic, trp), (jelastic, jrp)):
        with pytest.raises(rp.MergeError) as e:
            mod.merge_spans(str(tmp_path / "m.vcf"), [mod.Span(lo, hi) for lo, hi in plan])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and os.listdir(tmp_path) == []


# -- the coordinator, with fake children -------------------------------------------------------------------------------


class _FakeProc:
    _pids = itertools.count(40_000)

    def __init__(self, rc=0, delay=0.0, on_exit=None):
        self.pid = next(self._pids)
        self._rc = rc
        self._t0 = time.monotonic()
        self._delay = delay
        self._on_exit = on_exit
        self._fired = False
        self.killed = False

    def poll(self):
        if self.killed:
            return -9
        if time.monotonic() - self._t0 < self._delay:
            return None
        if not self._fired:
            self._fired = True
            if self._on_exit is not None:
                self._on_exit()
        return self._rc

    def kill(self):
        self.killed = True

    def wait(self, timeout=None):
        return self.poll()


def _seal(out, span):
    """What a worker that completed leaves: its segment and marker."""
    seg = elastic.span_segment_path(out, span.lo, span.hi)
    Path(seg).write_bytes(b"#h\n")
    trp.write_marker(seg, {"k": 1}, {"n": 0, "n_pass": 0})


def _coord(out, spans, spawn, **kw):
    kw.setdefault("poll_s", 0.005)
    kw.setdefault("steal_check_s", 0.01)
    kw.setdefault("grace_s", 0.05)
    return elastic.Coordinator(out, spans, spawn, **kw)


def test_coordinator_completes_a_clean_pod(tmp_path):
    out = str(tmp_path / "p.vcf")
    spans = [elastic.Span(0, 50), elastic.Span(50, 100)]
    states = []
    c = _coord(out, spans, lambda span, slot: _FakeProc(on_exit=lambda: _seal(out, span)), on_state=states.append)
    assert c.run() == 0
    assert c.spans == spans and c.transitions.count("join") == 2 and c.transitions.count("leave") == 2
    assert states[-1] == [] and len(states[0]) == 1


def test_coordinator_reoffers_a_death_under_the_next_generation(tmp_path):
    out = str(tmp_path / "p.vcf")
    seen: list[int] = []

    def spawn(span, slot):
        seen.append(span.gen)
        return _FakeProc(rc=-9) if span.gen == 0 else _FakeProc(on_exit=lambda: _seal(out, span))

    c = _coord(out, [elastic.Span(0, 100)], spawn)
    assert c.run() == 0 and seen == [0, 1] and "reassign" in c.transitions


def test_coordinator_gives_up_with_a_distinct_exit(tmp_path):
    c = _coord(str(tmp_path / "p.vcf"), [elastic.Span(0, 100)], lambda span, slot: _FakeProc(rc=1), max_attempts=2)
    assert c.run() == elastic.EXIT_SPAN_FAILED == 7
    assert "give_up" in c.transitions and c.transitions.count("join") == 3


def test_coordinator_fails_fast_on_a_configuration_error(tmp_path):
    other = _FakeProc(delay=999)
    c = _coord(str(tmp_path / "p.vcf"), [elastic.Span(0, 50), elastic.Span(50, 100)],
               lambda span, slot: _FakeProc(rc=2) if span.lo == 0 else other)
    assert c.run() == elastic.EXIT_USAGE == 2 and other.killed


def test_coordinator_takes_a_clean_exit_without_a_marker_as_a_death(tmp_path):
    out = str(tmp_path / "p.vcf")
    calls = itertools.count()
    c = _coord(out, [elastic.Span(0, 100)],
               lambda span, slot: _FakeProc(rc=0) if next(calls) == 0 else _FakeProc(on_exit=lambda: _seal(out,
                                                                                                             span)))
    assert c.run() == 0 and "reassign" in c.transitions


def test_coordinator_deadline_exits_5(tmp_path):
    proc = _FakeProc(delay=999)
    c = _coord(str(tmp_path / "p.vcf"), [elastic.Span(0, 100)], lambda span, slot: proc, timeout_s=0.15)
    assert c.run() == elastic.EXIT_TIMEOUT == 5 and proc.killed


def test_coordinator_steals_a_stuck_straggler(tmp_path):
    out = str(tmp_path / "p.vcf")
    spans = [elastic.Span(0, 50), elastic.Span(50, 100), elastic.Span(100, 150)]
    stole: list[elastic.Span] = []

    def spawn(span, slot):
        if span.lo == 100 and span.gen == 0:
            return _FakeProc(delay=999)  # no progress
        if span.gen > 0:
            stole.append(span)
        return _FakeProc(delay=0.02, on_exit=lambda: _seal(out, span))

    c = _coord(out, spans, spawn, steal_factor=2.0)
    assert c.run() == 0 and "steal" in c.transitions and stole and stole[0].gen == 1
    assert [(s.lo, s.hi) for s in c.spans] == [(s.lo, s.hi) for s in spans]


def test_coordinator_sheds_under_host_pressure(tmp_path):
    out = str(tmp_path / "p.vcf")
    alive = {"n": 0, "peak": 0}

    def spawn(span, slot):
        alive["n"] += 1
        alive["peak"] = max(alive["peak"], alive["n"])

        def done():
            alive["n"] -= 1
            _seal(out, span)

        return _FakeProc(delay=0.03, on_exit=done)

    c = _coord(out, [elastic.Span(i * 10, i * 10 + 10) for i in range(3)], spawn, max_load=4.0, min_ranks=1,
               load_fn=lambda: (16.0, 0.0, 0.0))
    assert c.run() == 0 and "shed" in c.transitions and alive["peak"] == 1


def test_coordinator_promotes_a_winning_shadow_claimant(tmp_path):
    out = str(tmp_path / "p.vcf")
    procs: list[_FakeProc] = []

    def spawn(span, slot):
        p = (_FakeProc(delay=0.03, on_exit=lambda: _seal(out, span)) if slot is None
             else _FakeProc(rc=elastic.EXIT_LEASE_LOST, delay=0.01))
        procs.append(p)
        return p

    c = _coord(out, [elastic.Span(0, 100)], spawn, chaos="steal_race")
    assert c.run() == 0 and c.claim_lost == 1 and len(procs) == 2 and "claim_lost" in c.transitions


def test_coordinator_recuts_a_journaled_death_at_its_watermark(tmp_path):
    """A worker that dies after journaling two chunks: its prefix [0, 40) is
    handed over and adopted (gen + 1), the rest [40, 100) offered fresh."""
    out = str(tmp_path / "p.vcf")
    seg = elastic.span_segment_path(out, 0, 100)
    token = journal.new_partial_token()

    def die_journaled():
        j = journal.ChunkJournal(seg)
        j.begin({"config": {"span": [0, 100]}, "partial": token})
        j.append(0, 1, 1, 8, 1, in_end=20)
        j.append(1, 1, 1, 8, 1, in_end=40)
        j.close()
        Path(journal.partial_path(seg, token)).write_bytes(b"x" * 16)

    offered: list[tuple] = []

    def spawn(span, slot):
        offered.append((span.lo, span.hi, span.gen))
        if span.lo == 0 and span.hi == 100:
            return _FakeProc(rc=-9, on_exit=die_journaled)

        def seal():
            new = elastic.span_segment_path(out, span.lo, span.hi)
            for p in glob.glob(new + ".partial*") + [journal.journal_path(new)]:
                if os.path.exists(p):
                    os.remove(p)
            _seal(out, span)

        return _FakeProc(on_exit=seal)

    c = _coord(out, [elastic.Span(0, 100)], spawn)
    assert c.run() == 0 and "recut" in c.transitions
    assert offered == [(0, 100, 0), (0, 40, 1), (40, 100, 0)]
    assert [(s.lo, s.hi) for s in c.spans] == [(0, 40), (40, 100)]


def test_a_late_join_during_the_merge_is_refused(tmp_path):
    out = str(tmp_path / "p.vcf")

    def spawn(span, slot):
        seg = elastic.span_segment_path(out, span.lo, span.hi)
        if slot is None:  # the late duplicate: the lease on disk refuses it
            return _FakeProc(rc=0 if elastic.claim_lease(seg, span.gen) else elastic.EXIT_LEASE_LOST)
        assert elastic.claim_lease(seg, span.gen)
        return _FakeProc(on_exit=lambda: _seal(out, span))

    c = _coord(out, [elastic.Span(0, 100)], spawn)
    assert c.run() == 0
    assert c.chaos_join_during_merge(wait_s=5) and c.join_refused == 1
    elastic.discard_span_files(out)
    assert os.listdir(tmp_path) == []
