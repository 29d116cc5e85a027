"""Elastic pod membership: mobile spans, leases, work stealing and the
coordinator.

Counterpart of ``variantcalling_tpu/parallel/elastic.py``. A static pod
(``parallel/rank_plan``) fixes N at launch: a killed rank is relaunched by
hand, and one slow rank holds up the merge. Here the partition itself moves,
and the merged output stays byte-equal to the single-rank run however the
membership went:

- **Spans, not ranks.** A unit of work is an absolute target interval
  ``[lo, hi)`` of the decompressed record region (:class:`Span`). The
  reader maps targets through the one cut rule (``VcfChunkReader
  (span_targets=)``: the smallest line start at or after the target), so
  any monotone sequence of targets tiles the record region and the span
  segments in order are the serial record stream. :func:`initial_spans`
  seeds a pod with the rank fractions ``r/N``.
- **Single-claimant leases.** Each offered (span, generation) has one lease
  file made with ``O_CREAT | O_EXCL`` (:func:`claim_lease`), so of the
  workers offered one span exactly one renders it; the others raise
  :class:`LeaseLost` and exit :data:`EXIT_LEASE_LOST` (6), which the
  coordinator takes as benign. A re-offer bumps the generation.
- **Re-cut at the journal watermark.** Each journaled chunk records
  ``in_end``, the absolute decompressed end of its input, always a line
  start. A dead or stolen span is split there: the journaled prefix ``[lo,
  C)`` becomes a span whose journal is handed over as it is
  (:func:`handoff_journal`; its adopter resumes, skips every chunk and
  commits without recomputing), the rest ``[C, hi)`` is cut anew. Chunk
  boundaries are a function of (input bytes, chunk_bytes, span start), so
  the adopter's boundaries are the dead worker's.
- **The coordinator** (:class:`Coordinator`): a polling state machine over
  child processes. It reaps exits, re-offers dead spans, kills and re-cuts
  stragglers whose journal progress falls behind the median of their
  siblings' (``steal_factor``), grows the pool toward ``max_ranks`` when
  re-cuts queue more spans than workers, and sheds while the host's load
  average is above ``max_load``. Each membership change is one
  ``membership`` obs event and one log line. Every tick progresses,
  re-offers, sheds or meets the pod's deadline (exit 5); a span that keeps
  dying fails the pod with :data:`EXIT_SPAN_FAILED` (7).

Span workers run as single-rank plans (no ``##vctpu_ranks=`` line) and
:func:`merge_spans` re-carries the BGZF block carry across every seam
through the classic merge's splice, so the committed output is the
single-rank run's bytes, not merely equal outside the headers.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass

from variantcalling_tpu_torch import obs
from variantcalling_tpu_torch.engine import EngineError

log = logging.getLogger(__name__)

#: worker exit code: lost the single-claimant lease race — benign to the
#: coordinator (exactly one sibling holds the span)
EXIT_LEASE_LOST = 6
#: pod exit code: a span died more than ``max_attempts`` times — the
#: failure is loud and distinct, never a hang or a silent gap
EXIT_SPAN_FAILED = 7
#: pod exit code for the global deadline (the launcher's classic value)
EXIT_TIMEOUT = 5
#: deterministic configuration errors propagate the worker's exit 2
EXIT_USAGE = 2

SPAN_ENV = "VCTPU_SPAN"


class LeaseLost(RuntimeError):
    """Another worker already claimed this (span, generation) lease —
    exit ``EXIT_LEASE_LOST``, compute nothing."""


@dataclass(frozen=True)
class Span:
    """One mobile unit of pod work: absolute decompressed-byte targets
    ``[lo, hi)`` into the record region, plus the lease generation it
    is currently offered under. Targets, not line offsets — the reader
    advances each to the next line start, so adjacent spans always
    share their seam exactly."""

    lo: int
    hi: int
    gen: int = 0

    def label(self) -> str:
        return f"[{self.lo},{self.hi})"


def span_segment_path(out_path: str, lo: int, hi: int) -> str:
    """An elastic span's staged segment, next to the destination like
    the classic ``.rank{r}of{N}.seg`` — the span spelling carries the
    target interval so a re-cut never collides with its parent."""
    return f"{out_path}.span{int(lo)}-{int(hi)}.seg"


def span_env(span: Span) -> str:
    """The ``VCTPU_SPAN`` wire format: ``lo:hi:gen``."""
    return f"{span.lo}:{span.hi}:{span.gen}"


def parse_span_env(value: str) -> tuple[int, int, int]:
    """Parse ``lo:hi:gen``; malformed values are configuration errors
    (exit 2), never a guess."""
    parts = str(value).split(":")
    try:
        lo, hi, gen = (int(p) for p in parts)
    except ValueError:
        raise EngineError(
            f"VCTPU_SPAN={value!r} is malformed — expected lo:hi:gen "
            "(three integers; podrun --elastic sets it)") from None
    if lo < 0 or hi < lo or gen < 0:
        raise EngineError(
            f"VCTPU_SPAN={value!r} is out of range — need "
            "0 <= lo <= hi and gen >= 0")
    return lo, hi, gen


def initial_spans(header_end: int, total: int, n: int) -> list[Span]:
    """Seed a pod with the classic rank fractions: target ``i/n`` of the
    record body for each seam — EXACTLY the targets the static rank
    partition uses, so an elastic pod that never re-cuts produces the
    same segments as ``--ranks n``."""
    if n <= 0:
        raise ValueError(f"need at least one span, got n={n}")
    header_end = int(header_end)
    body = max(0, int(total) - header_end)
    cuts = [header_end + body * i // n for i in range(n + 1)]
    return [Span(cuts[i], cuts[i + 1], 0) for i in range(n)]


# ---------------------------------------------------------------------------
# the single-claimant lease
# ---------------------------------------------------------------------------


def lease_path(seg_path: str, gen: int) -> str:
    return f"{seg_path}.lease.g{int(gen)}"


def claim_lease(seg_path: str, gen: int) -> bool:
    """Claim the (span, generation) lease: ``O_CREAT | O_EXCL``, atomic
    on every POSIX filesystem we target — exactly one claimant per
    offer, however many workers race. The file stays on disk for the
    pod's lifetime (the coordinator sweeps it with the segments), so a
    late duplicate — e.g. a join landing during the merge — is refused
    by the same mechanism."""
    try:
        fd = os.open(lease_path(seg_path, gen),
                     os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
    except FileExistsError:
        return False
    with os.fdopen(fd, "w", encoding="utf-8") as fh:
        json.dump({"pid": os.getpid(), "gen": int(gen)}, fh)
        fh.write("\n")
    return True


def discard_span_files(out_path: str) -> None:
    """Remove every span segment + marker + lease + journal/partial next
    to ``out_path`` (post-merge sweep; chaos between-leg cleanup)."""
    import glob

    for p in glob.glob(glob.escape(str(out_path)) + ".span*-*.seg*"):
        try:
            os.remove(p)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# journal progress + the re-cut handoff
# ---------------------------------------------------------------------------


def journal_progress(seg_path: str) -> tuple[int, int | None]:
    """``(journaled_chunks, last_in_end)`` of a span segment's journal —
    the coordinator's progress probe and the re-cut point. ``(0, None)``
    when there is no journal, no entries, or the writer predates the
    ``in_end`` field (degrades to whole-span re-assignment)."""
    from variantcalling_tpu_torch.io import journal as journal_mod

    loaded = journal_mod.ChunkJournal.load(seg_path)
    if loaded is None:
        return 0, None
    _, entries = loaded
    if not entries:
        return 0, None
    end = entries[-1].get("in_end")
    return len(entries), (int(end) if end is not None else None)


def handoff_journal(old_seg: str, new_seg: str,
                    new_span: tuple[int, int]) -> bool:
    """Hand a dead worker's journal + partial to the adopted prefix span
    ``new_span``: rename the partial next to the new segment path,
    rewrite the journal with ``config.span`` pinned to the NEW interval
    (the resume identity must describe what the adopter was leased), and
    drop the old journal. The adopter then resumes normally — identity
    match, CRC verification (``VCTPU_RESUME_VERIFY=full`` included),
    skip every chunk, commit — recomputing nothing.

    Returns False (degrade to whole-span re-assignment, which loses only
    compute, never bytes) when the journal is missing/empty, the partial
    is gone, or a LIVE process still owns the partial — a handoff must
    never steal a running writer's file."""
    from variantcalling_tpu_torch.io import journal as journal_mod

    loaded = journal_mod.ChunkJournal.load(old_seg)
    if loaded is None:
        return False
    meta, entries = loaded
    if not entries:
        return False
    token = meta.get("partial") or None
    if token is not None and journal_mod.token_in_use(token):
        return False
    old_part = journal_mod.partial_path(old_seg, token)
    if not os.path.exists(old_part):
        return False
    cfg = meta.get("config")
    if isinstance(cfg, dict):
        meta = dict(meta, config=dict(
            cfg, span=[int(new_span[0]), int(new_span[1])]))
    # order is crash-safe: after the partial rename the OLD journal
    # points at a missing partial (resume degrades to fresh), and until
    # the NEW journal lands the new segment has no journal at all —
    # either interruption costs recompute, never bytes
    os.replace(old_part, journal_mod.partial_path(new_seg, token))
    j = journal_mod.ChunkJournal(new_seg)
    j.begin(meta)
    for e in entries:
        j.append(int(e["seq"]), int(e["records"]), int(e["pass"]),
                 int(e["body_len"]), int(e["crc"]), in_end=e.get("in_end"))
    j.close()
    try:
        os.remove(journal_mod.journal_path(old_seg))
    except OSError:
        pass
    return True


# ---------------------------------------------------------------------------
# the span-plan committer
# ---------------------------------------------------------------------------


def merge_spans(out_path: str, spans: list[Span],
                cleanup: bool = True) -> dict:
    """The span-plan commit: splice however many seams the final plan
    has, through the same verified core as the classic rank merge
    (``rank_plan.splice_segments`` — marker/identity/header checks, one
    BGZF compressor re-carrying the block carry across every seam).
    Refuses non-contiguous plans: adjacent spans must share their
    target seam exactly, or some bytes would be dropped or doubled."""
    from variantcalling_tpu_torch.parallel import rank_plan as rank_plan_mod

    out_path = str(out_path)
    ordered = sorted(spans, key=lambda s: (s.lo, s.hi))
    for a, b in zip(ordered, ordered[1:]):
        if a.hi != b.lo:
            raise rank_plan_mod.MergeError(
                f"span plan is not contiguous: {a.label()} then "
                f"{b.label()} — refusing to splice a gapped or "
                "overlapping partition")
    segs = [(f"span {s.label()}", span_segment_path(out_path, s.lo, s.hi))
            for s in ordered]
    total, markers = rank_plan_mod.splice_segments(out_path, segs)
    stats = {
        "spans": len(ordered),
        "bytes": total,
        "n": sum(int((m.get("stats") or {}).get("n") or 0)
                 for m in markers),
        "n_pass": sum(int((m.get("stats") or {}).get("n_pass") or 0)
                      for m in markers),
    }
    if obs.active():
        obs.event("journal", "span_merge", spans=len(ordered), bytes=total,
                  records=stats["n"])
    if cleanup:
        discard_span_files(out_path)
    log.info("merged %d span segments -> %s (%d records, %d bytes "
                "uncompressed)", len(ordered), out_path, stats["n"], total)
    return stats


# ---------------------------------------------------------------------------
# membership telemetry
# ---------------------------------------------------------------------------


def emit_membership(action: str, span: Span | None = None,
                    **fields) -> None:
    """One membership transition: a log line always, a ``membership``
    obs event when a stream is open (``vctpu obs summary`` rolls the
    actions up next to the recovery ladder)."""
    detail = " ".join(f"{k}={v}" for k, v in fields.items() if v is not None)
    log.info("membership: %s %s %s", action,
                span.label() if span is not None else "pod", detail)
    if obs.active():
        obs.event("membership", span.label() if span is not None else "pod",
                  action=action,
                  **{k: v for k, v in fields.items() if v is not None})


# ---------------------------------------------------------------------------
# the pod coordinator
# ---------------------------------------------------------------------------


@dataclass
class _Assignment:
    """One span's place in the coordinator's plan."""

    span: Span
    state: str = "pending"  # pending | running | done | failed
    slot: int | None = None  # initial worker index (per-worker env hooks)
    proc: object = None
    attempts: int = 0
    started: float = 0.0
    finished: float = 0.0
    steal_pending: bool = False  # killed for stealing, reap in flight
    exit_reason: str | None = None


class Coordinator:
    """The elastic pod state machine (``parallel/podrun --elastic``).

    Owns a plan of span assignments and a set of direct child workers
    produced by the injectable ``spawn(span, slot)`` callable (a real
    ``subprocess.Popen`` under podrun; any object with ``pid`` /
    ``poll()`` / ``kill()`` in tests). :meth:`run` polls until the plan
    is fully done, then returns an exit code; the final (possibly
    re-cut) plan is :attr:`spans`, ready for :func:`merge_spans`.

    Membership policy:

    - a worker that EXITS NONZERO (or is killed) has its span re-offered
      under the next lease generation; when its journal recorded
      progress, the span is first re-cut at the last ``in_end`` so the
      journaled prefix is adopted instead of recomputed;
    - a worker whose journal progress rate falls behind
      ``1/steal_factor`` of the sibling median — or that shows NO
      progress long after the sibling rates say it should have
      finished — is killed and re-cut (work stealing);
    - exit ``EXIT_LEASE_LOST`` is benign (the lease kept the span
      single-claimant); exit 2 is a deterministic configuration error
      and fails the pod immediately with 2;
    - a span exceeding ``max_attempts`` deaths fails the pod with
      ``EXIT_SPAN_FAILED`` — loud, never a hang;
    - the pool grows toward ``max_ranks`` whenever re-cuts queue more
      pending spans than running workers, and sheds (no new joins, down
      to ``min_ranks``) while the 1-minute load average exceeds
      ``max_load`` — the autoscaler's signals are the journals'
      progress telemetry plus host pressure.
    """

    def __init__(self, out_path: str, spans: list[Span], spawn, *,
                 max_ranks: int | None = None, min_ranks: int = 1,
                 steal_factor: float = 4.0, grace_s: float = 1.5,
                 poll_s: float = 0.05, steal_check_s: float = 0.5,
                 max_attempts: int = 3, timeout_s: float | None = None,
                 max_load: float | None = None, load_fn=None,
                 chaos: str | None = None, on_state=None):
        self.out = str(out_path)
        self._spawn_fn = spawn
        self._plan = [_Assignment(span=s, slot=i)
                      for i, s in enumerate(spans)]
        self.max_ranks = max_ranks if max_ranks is not None else len(spans)
        self.min_ranks = max(1, int(min_ranks))
        self.steal_factor = float(steal_factor)
        self.grace_s = float(grace_s)
        self.poll_s = float(poll_s)
        self.steal_check_s = float(steal_check_s)
        self.max_attempts = int(max_attempts)
        self.timeout_s = timeout_s
        self.max_load = max_load
        self._load_fn = load_fn
        self.chaos = chaos
        self._on_state = on_state
        self._shadows: list[dict] = []  # chaos duplicate claimants
        self._chaos_fired = False
        self._shed_active = False
        self._last_steal_check = 0.0
        self.claim_lost = 0
        self.join_refused = 0
        self.transitions: list[str] = []

    # -- public surface ----------------------------------------------------

    @property
    def spans(self) -> list[Span]:
        """The current plan, in merge order."""
        return [a.span for a in self._plan]

    def run(self) -> int:
        """Drive the pod to completion; 0 when every span committed."""
        deadline = (time.monotonic() + self.timeout_s
                    if self.timeout_s else None)
        try:
            while True:
                rc = self._reap()
                if rc is not None:
                    self._kill_all()
                    return rc
                if any(a.state == "failed" for a in self._plan):
                    self._kill_all()
                    return EXIT_SPAN_FAILED
                if all(a.state == "done" for a in self._plan):
                    return 0
                if deadline is not None and time.monotonic() > deadline:
                    log.error("elastic pod: deadline exceeded — "
                                 "killing %d live workers",
                                 sum(1 for a in self._plan
                                     if a.state == "running"))
                    self._kill_all()
                    return EXIT_TIMEOUT
                self._check_stragglers()
                self._spawn_pending()
                time.sleep(self.poll_s)
        except KeyboardInterrupt:
            self._kill_all()
            raise

    def chaos_join_during_merge(self, wait_s: float = 120.0) -> bool:
        """Chaos hook: offer a completed span to a late joiner right
        before the merge — the lease generation already on disk must
        refuse it (worker exits ``EXIT_LEASE_LOST``)."""
        done = [a for a in self._plan if a.state == "done"]
        if not done:
            return False
        a = done[-1]
        proc = self._spawn_fn(a.span, None)
        self._event("join", a.span, pid=getattr(proc, "pid", None),
                    duplicate=1)
        deadline = time.monotonic() + wait_s
        while proc.poll() is None and time.monotonic() < deadline:
            time.sleep(self.poll_s)
        if proc.poll() is None:
            proc.kill()
            return False
        if proc.poll() == EXIT_LEASE_LOST:
            self.join_refused += 1
            self._event("join_refused", a.span, reason="merge in progress")
            return True
        return False

    # -- internals ---------------------------------------------------------

    def _event(self, action: str, span: Span | None, **fields) -> None:
        self.transitions.append(action)
        emit_membership(action, span, **fields)

    def _seg(self, a: _Assignment) -> str:
        return span_segment_path(self.out, a.span.lo, a.span.hi)

    def _notify_state(self) -> None:
        if self._on_state is None:
            return
        self._on_state([
            {"span": [a.span.lo, a.span.hi], "gen": a.span.gen,
             "pid": getattr(a.proc, "pid", None)}
            for a in self._plan if a.state == "running"])

    def _spawn(self, a: _Assignment) -> None:
        a.state = "running"
        a.started = time.monotonic()
        a.steal_pending = False
        a.proc = self._spawn_fn(a.span, a.slot)
        self._event("join", a.span, gen=a.span.gen,
                    pid=getattr(a.proc, "pid", None),
                    attempt=a.attempts)
        if self.chaos == "steal_race" and not self._chaos_fired:
            # offer the SAME (span, generation) to a duplicate claimant:
            # the lease must yield exactly one winner, whichever worker
            # reaches the O_EXCL open first
            self._chaos_fired = True
            sh = self._spawn_fn(a.span, None)
            self._shadows.append({"span": a.span, "proc": sh})
            self._event("join", a.span, gen=a.span.gen,
                        pid=getattr(sh, "pid", None), duplicate=1)
        self._notify_state()

    def _take_shadow(self, span: Span):
        for sh in self._shadows:
            if sh["span"].lo == span.lo and sh["span"].hi == span.hi:
                self._shadows.remove(sh)
                return sh["proc"]
        return None

    def _reap(self) -> int | None:
        from variantcalling_tpu_torch.parallel import rank_plan as rank_plan_mod

        for a in self._plan:
            if a.state != "running":
                continue
            rc = a.proc.poll()
            if rc is None:
                continue
            if rc == 0:
                if rank_plan_mod.load_marker(self._seg(a)) is None:
                    # exited clean without sealing its segment — treat
                    # as a death, the marker is the completion contract
                    self._requeue(a, "exit 0 without a .done marker")
                    continue
                a.state = "done"
                a.finished = time.monotonic()
                self._event("leave", a.span, gen=a.span.gen,
                            pid=getattr(a.proc, "pid", None),
                            reason="complete")
                self._notify_state()
            elif rc == EXIT_LEASE_LOST:
                self.claim_lost += 1
                self._event("claim_lost", a.span, gen=a.span.gen,
                            pid=getattr(a.proc, "pid", None))
                winner = self._take_shadow(a.span)
                if winner is not None:
                    # the duplicate claimant won the race — it is now
                    # the span's worker; keep waiting on it
                    a.proc = winner
                    self._notify_state()
                else:
                    self._requeue(a, "lease lost")
            elif rc == EXIT_USAGE:
                # deterministic configuration error: every re-offer
                # would die the same way — fail the pod with the
                # worker's own code
                self._event("leave", a.span, gen=a.span.gen,
                            reason="config error")
                return EXIT_USAGE
            else:
                reason = a.exit_reason or (
                    f"killed by signal {-rc}" if rc < 0 else f"exit {rc}")
                self._requeue(a, reason)
        for sh in list(self._shadows):
            rc = sh["proc"].poll()
            if rc is None or rc == 0:
                continue  # still racing, or won and completed the span
            self._shadows.remove(sh)
            if rc == EXIT_LEASE_LOST:
                self.claim_lost += 1
                self._event("claim_lost", sh["span"],
                            gen=sh["span"].gen,
                            pid=getattr(sh["proc"], "pid", None))
        return None

    def _requeue(self, a: _Assignment, reason: str) -> None:
        self._event("leave", a.span, gen=a.span.gen,
                    pid=getattr(a.proc, "pid", None), reason=reason)
        a.attempts += 1
        a.proc = None
        a.exit_reason = None
        if a.attempts > self.max_attempts:
            a.state = "failed"
            self._event("give_up", a.span, attempts=a.attempts)
            log.error("elastic pod: span %s failed %d times — giving "
                         "up (exit %d)", a.span.label(), a.attempts,
                         EXIT_SPAN_FAILED)
            return
        seg = self._seg(a)
        chunks, end = journal_progress(seg)
        if chunks > 0 and end is not None and a.span.lo < end < a.span.hi:
            # re-cut at the journal watermark: the journaled prefix is a
            # complete sub-span (every in_end is a line start, and chunk
            # boundaries re-derive identically from the same span
            # start), adoptable without recompute; the suffix is fresh
            adopt = Span(a.span.lo, end, a.span.gen + 1)
            rest = Span(end, a.span.hi, 0)
            if handoff_journal(seg, span_segment_path(self.out, adopt.lo,
                                                      adopt.hi),
                               (adopt.lo, adopt.hi)):
                i = self._plan.index(a)
                self._plan[i:i + 1] = [
                    _Assignment(span=adopt, attempts=a.attempts),
                    _Assignment(span=rest, attempts=a.attempts),
                ]
                self._event("recut", a.span, at=end,
                            adopted_chunks=chunks)
                self._notify_state()
                return
        # whole-span re-offer under the next generation; any journal
        # stays in place, so the replacement resumes instead of
        # recomputing the journaled prefix
        a.span = Span(a.span.lo, a.span.hi, a.span.gen + 1)
        a.state = "pending"
        self._event("reassign", a.span, gen=a.span.gen)
        self._notify_state()

    def _check_stragglers(self) -> None:
        if self.steal_factor <= 0:
            return
        now = time.monotonic()
        if now - self._last_steal_check < self.steal_check_s:
            return
        self._last_steal_check = now
        rates = [
            (a.span.hi - a.span.lo) / max(a.finished - a.started, 1e-6)
            for a in self._plan
            if a.state == "done" and a.span.hi > a.span.lo
            and a.finished > a.started]
        probes = []
        for a in self._plan:
            if a.state != "running" or a.steal_pending:
                continue
            elapsed = now - a.started
            if elapsed < self.grace_s:
                continue
            _, end = journal_progress(self._seg(a))
            done_b = max(0, (end if end is not None else a.span.lo)
                         - a.span.lo)
            probes.append((a, done_b, elapsed))
            if done_b > 0:
                rates.append(done_b / elapsed)
        if len(rates) < 2:
            return  # stealing needs a sibling rate to compare against
        median = sorted(rates)[len(rates) // 2]
        if median <= 0:
            return
        for a, done_b, elapsed in probes:
            total_b = a.span.hi - a.span.lo
            if total_b <= 0:
                continue
            slow = done_b > 0 and (done_b / elapsed) \
                < median / self.steal_factor
            stuck = done_b == 0 and elapsed > self.grace_s \
                + self.steal_factor * (total_b / median)
            if not (slow or stuck):
                continue
            a.steal_pending = True
            a.exit_reason = "straggler (stolen)"
            self._event("steal", a.span, gen=a.span.gen,
                        pid=getattr(a.proc, "pid", None),
                        done_bytes=done_b,
                        rate=round(done_b / elapsed, 1),
                        median=round(median, 1))
            try:
                a.proc.kill()
            except OSError:
                pass

    def _spawn_pending(self) -> None:
        pending = [a for a in self._plan if a.state == "pending"]
        if not pending:
            return
        running = sum(1 for a in self._plan if a.state == "running")
        cap = self.max_ranks
        load = self._load()
        if self.max_load is not None and load is not None \
                and load > self.max_load:
            shed_cap = max(self.min_ranks, running)
            if shed_cap < cap and not self._shed_active:
                self._shed_active = True
                self._event("shed", None, load=round(load, 2),
                            cap=shed_cap)
            cap = shed_cap
        else:
            self._shed_active = False
        for a in pending:
            if running >= cap:
                break
            self._spawn(a)
            running += 1

    def _load(self) -> float | None:
        fn = self._load_fn
        if fn is None:
            fn = getattr(os, "getloadavg", None)
            if fn is None:
                return None
        try:
            return float(fn()[0])
        except (OSError, ValueError, TypeError, IndexError):
            return None

    def _kill_all(self) -> None:
        procs = [a.proc for a in self._plan
                 if a.state == "running" and a.proc is not None]
        procs += [sh["proc"] for sh in self._shadows]
        for p in procs:
            try:
                p.kill()
            except OSError:
                pass
        for p in procs:
            wait = getattr(p, "wait", None)
            if wait is None:
                continue
            try:
                wait(timeout=5)
            except Exception:  # noqa: BLE001 — a best-effort reap of workers already killed
                pass
