"""Rank-partitioned scale-out of the streaming filter, and ``merge-ranks``.

Counterpart of ``variantcalling_tpu/parallel/rank_plan.py``. N processes
run the filter, each over its own contiguous span of one VCF, and a
seam-aware merge joins their outputs into bytes equal to the single-rank
run's (outside the ``##vctpu_ranks=`` line). The pieces:

- :class:`RankPlan`: the run's rank layout, resolved once
  (:func:`resolve`) from ``VCTPU_RANK``/``VCTPU_NUM_PROCESSES`` (the pod
  launcher's spelling, ``parallel/podrun``) or ``VCTPU_SPAN`` (an elastic
  worker's leased interval, ``parallel/elastic``), recorded as the
  ``##vctpu_ranks=n=N`` header line and pinned into each rank's journal
  identity.
- The partition rule: each rank takes targets at ``r/N`` of the record
  bytes, each advanced to the next line start
  (``io/vcf.VcfChunkReader(rank_span=)``), so ranks share no state and their
  outputs in rank order are the serial record stream. A BGZF input is read
  from the member that holds a rank's first byte.
- Rank segments: rank r runs the unchanged streaming executor into
  ``<out>.rank{r}of{N}.seg`` (plain text even for a ``.gz`` output) with its
  own journal, so a killed rank resumes from its journal and finished ranks
  skip through their ``.done`` markers.
- The rank-sequenced commit (:func:`merge_ranks`): every segment and marker
  checked, then ``header + body_0 + body_1 + ...`` written through a
  run-unique partial and ``os.replace``; a ``.gz`` output goes through ONE
  ``io/bgzf.BgzfChunkCompressor``, so the 65,280-byte block carry crosses
  the seams as a serial writer's does, and gets its ``.tbi``.

The reference's third source of a plan, an initialized ``jax.distributed``
runtime whose rank 0 merges after a barrier, has no counterpart yet: the
port's collectives (``torch.distributed``) are ``ROADMAP.md`` A7c. Here
every launched worker stages its segment and the launcher (or
``merge-ranks``) commits.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import re
import sys
import time
import zlib
from dataclasses import dataclass

from variantcalling_tpu_torch import knobs, obs
from variantcalling_tpu_torch.engine import EngineError

log = logging.getLogger(__name__)

RANKS_HEADER_KEY = "vctpu_ranks"

#: decompressed bytes a merge copies at a time (bounds the merge's memory)
_MERGE_BLOCK = 8 << 20

#: a worker's last line: its rank, its seconds in :func:`run_scaleout`, and the
#: forest kernels' launches in its process (a launcher reads each worker's own)
SCALEOUT_LOG = "rank %d/%d: done in %.3f s; forest kernel launches in this process: wide %d, tree_step %d"


class MergeError(RuntimeError):
    """A merge precondition failed (a segment missing, invalid or from
    another configuration): ``merge-ranks`` exits 3, not 2."""


@dataclass(frozen=True)
class RankPlan:
    """The run's rank layout.

    ``source``: ``env`` (the pod launcher), ``span`` (an elastic worker) or
    ``single``. An elastic worker leased the absolute targets ``span =
    (lo, hi)`` of the decompressed record region runs as a single-rank plan
    (``ranks=1``) with a span-bounded reader, so its segment carries no
    ``##vctpu_ranks=`` line and the merged bytes equal the single-rank run's
    whatever the final span plan. ``gen``: the lease generation the span was
    offered under."""

    ranks: int
    rank: int
    source: str
    reason: str
    span: tuple | None = None
    gen: int = 0

    def header_line(self) -> str:
        # n only, never the rank: every rank's segment must carry the same
        # header bytes, or the merge cannot check that the ranks agree
        return f"##{RANKS_HEADER_KEY}=n={self.ranks}"


def resolve() -> RankPlan:
    """This process's rank layout, resolved once a run.

    ``VCTPU_SPAN`` (``lo:hi:gen``, the elastic launcher's spelling) first:
    one leased span of an elastic pod. Then ``VCTPU_RANK`` with
    ``VCTPU_NUM_PROCESSES``: one rank of a static pod. Else the single plan.
    Both spellings at once, a rank without a count, or a rank out of range
    are configuration errors (:class:`EngineError`, exit 2), never clamped.
    The reference's ``jax.distributed`` source is not a source here: a
    ``torch.distributed`` one comes with the collectives (A7c)."""
    s = knobs.get_str("VCTPU_SPAN")
    r = knobs.get_int("VCTPU_RANK")
    if s:
        if r is not None:
            raise EngineError(
                "VCTPU_SPAN and VCTPU_RANK are both set — a worker is either one leased span of an elastic pod "
                "or one rank of a static pod, never both")
        from variantcalling_tpu_torch.parallel import elastic

        lo, hi, gen = elastic.parse_span_env(s)
        return RankPlan(ranks=1, rank=0, source="span", reason="VCTPU_SPAN (elastic launcher)", span=(lo, hi),
                        gen=gen)
    if r is not None:
        n = knobs.get_int("VCTPU_NUM_PROCESSES")
        if n is None:
            raise EngineError(
                "VCTPU_RANK is set but VCTPU_NUM_PROCESSES is not — a rank-partitioned launch needs both "
                "(python -m variantcalling_tpu_torch.parallel.podrun sets them)")
        if r >= n:
            raise EngineError(f"VCTPU_RANK={r} is out of range for VCTPU_NUM_PROCESSES={n} (ranks are 0-based)")
        return RankPlan(ranks=n, rank=r, source="env", reason="VCTPU_RANK/VCTPU_NUM_PROCESSES (local launcher)")
    return RankPlan(ranks=1, rank=0, source="single", reason="single process")


def log_plan(plan: RankPlan) -> None:
    """Announce a multi-rank or span plan (a log line and an obs ``resolve``
    event); a single plan stays silent."""
    if plan.span is not None:
        log.info("span plan: [%d,%d) gen %d (%s)", plan.span[0], plan.span[1], plan.gen, plan.reason)
        if obs.active():
            obs.event("resolve", "span_plan", value=f"[{plan.span[0]},{plan.span[1]})", gen=plan.gen,
                      source=plan.source, reason=plan.reason)
        return
    if plan.ranks <= 1:
        return
    log.info("rank plan: rank %d of %d (%s)", plan.rank, plan.ranks, plan.reason)
    if obs.active():
        obs.event("resolve", "rank_plan", value=plan.ranks, rank=plan.rank, source=plan.source, reason=plan.reason)


# -- rank segments: paths and completion markers ------------------------------


def segment_path(out_path: str, rank: int, ranks: int) -> str:
    """Rank ``rank``'s segment beside the destination: plain text whatever
    the destination's container (the merge compresses once)."""
    return f"{out_path}.rank{rank}of{ranks}.seg"


def marker_path(seg_path: str) -> str:
    return seg_path + ".done"


def discover_ranks(out_path: str) -> int | None:
    """N from the ``<out>.rank*of*.seg`` files on disk (``merge-ranks``
    without ``--ranks``); None when there are none, :class:`MergeError` when
    they disagree on N."""
    ns = set()
    for p in glob.glob(glob.escape(str(out_path)) + ".rank*of*.seg"):
        m = re.search(r"\.rank(\d+)of(\d+)\.seg$", p)
        if m:
            ns.add(int(m.group(2)))
    if not ns:
        return None
    if len(ns) > 1:
        raise MergeError(
            f"segments next to {out_path} disagree on the rank count ({sorted(ns)}) — stale leftovers of a "
            "different launch; remove them or pass --ranks explicitly")
    return ns.pop()


def contig_spans(path: str, n: int, header_end: int | None = None, total: int | None = None,
                 slack: float = 0.2) -> list[tuple[int, int]]:
    """A contig-aware span plan over the record region of a plain-text VCF:
    cuts at about equal byte targets advanced to the next line start (the
    rank rule), each then moved forward to a contig boundary when one lies
    within ``slack`` of the span size, so a contig's records land on one
    worker. A cut only ever moves forward to another line start, so the
    spans still tile the record region."""
    if header_end is None or total is None:
        from variantcalling_tpu_torch.io import vcf as vcf_mod

        header_end, total = vcf_mod.scan_record_region(path)
    body = total - header_end
    if body <= 0 or n <= 1:
        return [(header_end, total)]
    n = min(n, body)
    budget = max(1, int(body / n * slack))
    cuts: list[int] = []
    with open(path, "rb") as fh:
        for i in range(1, n):
            cut = _line_start(fh, header_end + (body * i) // n, total)
            cuts.append(_snap_to_contig(fh, cut, total, budget))
    edges = [header_end] + sorted(set(cuts)) + [total]
    return [(lo, hi) for lo, hi in zip(edges, edges[1:]) if hi > lo]


def _line_start(fh, target: int, total: int) -> int:
    """``target`` advanced to the next line start at or after it."""
    if target <= 0:
        return 0
    fh.seek(target - 1)
    off = target - 1
    while off < total:
        block = fh.read(min(1 << 16, total - off))
        if not block:
            break
        nl = block.find(b"\n")
        if nl >= 0:
            return min(off + nl + 1, total)
        off += len(block)
    return total


def _snap_to_contig(fh, cut: int, total: int, budget: int) -> int:
    """A line-start cut moved forward to the first contig change within
    ``budget`` bytes; the plain cut where the contig runs past the budget."""
    fh.seek(cut)
    scanned = 0
    first_contig = None
    pos = cut
    while pos < total and scanned <= budget:
        line = fh.readline()
        if not line:
            break
        contig = line.split(b"\t", 1)[0]
        if first_contig is None:
            first_contig = contig
        elif contig != first_contig:
            return pos
        pos += len(line)
        scanned += len(line)
    return cut


def segment_identity(args, plan: RankPlan, engine_name: str | None = None) -> dict:
    """What a completed segment is valid for: the input, the model, every
    scoring flag (``io/identity.scoring_fields``, the journal's and the
    cache's fields), the rank layout or leased span, and the engine
    selection (the resolved engine and the strategy asked for). A relaunch
    under any other configuration recomputes."""
    from variantcalling_tpu_torch.io import identity as identity_mod

    ident = identity_mod.scoring_fields(args)
    ident["input"] = identity_mod.file_sig(args.input_file)
    ident["ranks"] = [plan.rank, plan.ranks]
    if plan.span is not None:
        # valid for exactly the leased interval: a re-cut span recomputes (or
        # adopts a handed-over journal); the merge masks ranks and span
        ident["span"] = [int(plan.span[0]), int(plan.span[1])]
    ident["engine"] = engine_name
    ident["forest_strategy"] = knobs.raw("VCTPU_FOREST_STRATEGY") or "auto"
    ident["mesh_devices"] = None  # the reference's key: the port scores on one device, whatever is asked
    return ident


def write_marker(seg_path: str, identity: dict, stats: dict) -> None:
    """Record a segment's completion atomically: its identity, length,
    whole-segment CRC and run counts."""
    doc = {
        "identity": identity,
        "bytes": os.path.getsize(seg_path),
        "crc32": _file_crc(seg_path),
        "stats": {k: stats.get(k) for k in ("n", "n_pass", "chunks")},
    }
    tmp = marker_path(seg_path) + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, marker_path(seg_path))


def _file_crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as fh:
        while True:
            block = fh.read(_MERGE_BLOCK)
            if not block:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(block, crc)


def load_marker(seg_path: str) -> dict | None:
    try:
        with open(marker_path(seg_path), encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def valid_segment(seg_path: str, identity: dict) -> dict | None:
    """The completed-segment skip check: the marker there, its identity
    equal, the segment's length the marker's; ``VCTPU_RESUME_VERIFY=full``
    also re-reads the segment against its CRC. The recorded counts, or None
    (recompute)."""
    doc = load_marker(seg_path)
    if doc is None or doc.get("identity") != identity:
        return None
    try:
        size = os.path.getsize(seg_path)
    except OSError:
        return None
    if size != doc.get("bytes"):
        return None
    if knobs.get_str("VCTPU_RESUME_VERIFY") == "full" and _file_crc(seg_path) != doc.get("crc32"):
        log.info("rank segment %s: CRC mismatch (full verify) — recomputing", seg_path)
        return None
    stats = doc.get("stats")
    return stats if isinstance(stats, dict) else {}


def discard_segments(out_path: str) -> None:
    """Remove every rank segment and marker beside ``out_path``."""
    for p in glob.glob(glob.escape(str(out_path)) + ".rank*of*.seg*"):
        try:
            os.remove(p)
        except OSError:
            pass


# -- the rank-sequenced commit --------------------------------------------------


def _header_len(path: str) -> int:
    """The byte length of ``path``'s header (its leading ``#`` lines): where
    a segment's record body starts."""
    size = os.path.getsize(path)
    cap = 1 << 20
    with open(path, "rb") as fh:
        while True:
            fh.seek(0)
            head = fh.read(min(cap, size))
            end = 0
            torn = False
            while end < len(head):
                if head[end:end + 1] != b"#":
                    return end
                nl = head.find(b"\n", end)
                if nl < 0:
                    torn = True  # a header line crosses the read window
                    break
                end = nl + 1
            if not torn and cap >= size:
                return end  # a header-only segment (an empty span)
            if cap >= size:
                raise MergeError(f"{path}: unterminated header line — truncated segment")
            cap *= 8


def merge_ranks(out_path: str, ranks: int | None = None, cleanup: bool = True) -> dict:
    """Merge every rank's segment into the destination: ``header + body_0 +
    ... + body_{N-1}`` (:func:`splice_segments`), then sweep the segments
    (``cleanup``). ``ranks`` None: N from the segments on disk. Raises
    :class:`MergeError` when a segment is missing, its marker absent or
    stale, or the ranks disagree. Returns the counts."""
    out_path = str(out_path)
    if ranks is None:
        ranks = discover_ranks(out_path)
        if ranks is None:
            raise MergeError(f"no rank segments found next to {out_path}")
    segs = [(f"rank {r}/{ranks}", segment_path(out_path, r, ranks)) for r in range(ranks)]
    total, markers = splice_segments(out_path, segs)
    stats = {
        "ranks": ranks,
        "bytes": total,
        "n": sum(int((m.get("stats") or {}).get("n") or 0) for m in markers),
        "n_pass": sum(int((m.get("stats") or {}).get("n_pass") or 0) for m in markers),
    }
    if obs.active():
        obs.event("journal", "rank_merge", ranks=ranks, bytes=total, records=stats["n"])
    if cleanup:
        discard_segments(out_path)
    log.info("merged %d rank segments -> %s (%d records, %d bytes uncompressed)", ranks, out_path, stats["n"],
             total)
    return stats


def splice_segments(out_path: str, segs: list[tuple[str, str]]) -> tuple[int, list[dict]]:
    """The splice :func:`merge_ranks` and ``elastic.merge_spans`` share.
    Checks every ``(label, path)`` segment (present, sealed by its marker,
    its length the marker's), that all were made under one configuration
    but for the partition fields (``ranks`` and ``span``), and that their
    header bytes are equal; then writes ``header + body_0 + ... + body_k``
    into ``out_path`` through a run-unique partial and ``os.replace``. A
    ``.gz`` destination goes through one :class:`BgzfChunkCompressor` across
    every seam and gets its ``.tbi``. Returns ``(uncompressed bytes,
    markers)``."""
    if not segs:
        raise MergeError(f"empty segment plan for {out_path}")
    markers = []
    for label, seg in segs:
        if not os.path.exists(seg):
            raise MergeError(
                f"{label} segment missing: {seg} — that worker has not completed (relaunch it; finished workers "
                "skip via their .done markers)")
        doc = load_marker(seg)
        if doc is None:
            raise MergeError(f"{label} completion marker missing/unreadable ({marker_path(seg)}) — the segment "
                             "may be mid-write")
        if os.path.getsize(seg) != doc.get("bytes"):
            raise MergeError(f"{label} segment length disagrees with its marker — torn or concurrently-written "
                             "segment")
        markers.append(doc)
    idents = {json.dumps(dict(m.get("identity") or {}, ranks=None, span=None), sort_keys=True) for m in markers}
    if len(idents) > 1:
        raise MergeError("segments were produced under DIFFERENT configurations (identity mismatch across "
                         "markers) — refusing to splice them")

    header_lens = [_header_len(seg) for _, seg in segs]
    with open(segs[0][1], "rb") as fh:
        header = fh.read(header_lens[0])
    for i in range(1, len(segs)):
        with open(segs[i][1], "rb") as fh:
            if fh.read(header_lens[i]) != header:
                raise MergeError(f"{segs[i][0]} segment header differs from {segs[0][0]}'s — cross-worker "
                                 "configuration drift; refusing to splice")

    from variantcalling_tpu_torch.io import journal as journal_mod
    from variantcalling_tpu_torch.io.bgzf import BgzfChunkCompressor

    gz = out_path.endswith(".gz")
    comp = BgzfChunkCompressor() if gz else None
    token = journal_mod.new_partial_token()
    journal_mod.claim_token(token)
    part = journal_mod.partial_path(out_path, token)
    total = 0
    try:
        with open(part, "wb") as sink:
            sink.write(comp.add(header) if gz else header)
            total += len(header)
            for i, (_, seg) in enumerate(segs):
                with open(seg, "rb") as fh:
                    fh.seek(header_lens[i])
                    while block := fh.read(_MERGE_BLOCK):
                        total += len(block)
                        sink.write(comp.add(block) if gz else block)
            if gz:
                sink.write(comp.finish())
        os.replace(part, out_path)  # the merge's one atomic commit
    except BaseException:
        journal_mod.release_token(token)
        try:
            os.remove(part)
        except OSError:
            pass
        raise
    journal_mod.release_token(token)
    if gz:
        from variantcalling_tpu_torch.io.vcf import write_tabix

        write_tabix(out_path)
    return total, markers


# -- one rank's run ---------------------------------------------------------------


def scaleout_eligible(args) -> bool:
    """Can this job run rank-partitioned? The streaming executor's gate, but
    for the one-process requirement (a rank is one of N processes)."""
    from variantcalling_tpu_torch.pipelines.filter_variants import streaming_eligible

    return streaming_eligible(getattr(args, "limit_to_contig", None), allow_multiprocess=True)


def run_scaleout(args, ctx, plan: RankPlan | None = None) -> int:
    """One rank's share of a partitioned filter run over the loaded
    ``ctx`` (``filter_variants.FilterContext``): compute this rank's segment,
    or skip it when a valid ``.done`` marker shows an earlier launch did,
    and seal it. The merge is the launcher's (``parallel/podrun``) or a
    later ``merge-ranks``: env-launched workers share no collective to wait
    on. An elastic worker claims its (span, generation) lease before
    anything else and raises ``elastic.LeaseLost`` when another holds it."""
    from variantcalling_tpu_torch.models import forest_cuda
    from variantcalling_tpu_torch.pipelines import filter_variants as fv

    t0 = time.perf_counter()
    plan = plan or resolve()
    out_path = str(args.output_file)
    if plan.span is not None:
        from variantcalling_tpu_torch.parallel import elastic

        seg = elastic.span_segment_path(out_path, plan.span[0], plan.span[1])
        # claimed before any compute or skip check, so two workers offered
        # one (span, generation) never both render it
        if not elastic.claim_lease(seg, plan.gen):
            raise elastic.LeaseLost(f"span [{plan.span[0]},{plan.span[1]}) generation {plan.gen}: lease already "
                                    f"claimed ({elastic.lease_path(seg, plan.gen)})")
    else:
        seg = segment_path(out_path, plan.rank, plan.ranks)
    identity = segment_identity(args, plan, ctx.engine)
    prior = valid_segment(seg, identity)
    if prior is not None:
        log.info("rank %d/%d: segment already complete (%s records) — skipping compute", plan.rank, plan.ranks,
                 prior.get("n", "?"))
        if obs.active():
            obs.event("journal", "segment_skip", rank=plan.rank, ranks=plan.ranks, records=prior.get("n"))
    else:
        args2 = argparse.Namespace(**vars(args))
        args2.output_file = seg
        stats = fv.run_streaming(args2, ctx)
        write_marker(seg, identity, stats)
        log.info("rank %d/%d: wrote segment %s (%d records, %d PASS)", plan.rank, plan.ranks, seg, stats["n"],
                 stats["n_pass"])
    log.info("rank %d/%d: segment staged; the launcher commits the merge (podrun, or `merge-ranks %s`)",
             plan.rank, plan.ranks, out_path)
    log.info(SCALEOUT_LOG, plan.rank, plan.ranks, time.perf_counter() - t0, forest_cuda.LAUNCHES,
             forest_cuda.TREE_STEP_LAUNCHES)
    return 0


# -- ``merge-ranks``: the standalone commit -----------------------------------------


def run(argv: list[str]) -> int:
    """The ``merge-ranks`` tool: merge staged rank segments into the output.
    Exit 0 on a committed merge, 2 on a usage error, 3 when the segments
    cannot be merged (a rank missing, a stale marker, drift between ranks),
    so a launcher can tell "relaunch the ranks" from "fix the invocation"."""
    ap = argparse.ArgumentParser(
        prog="vctpu merge-ranks",
        description="rank-sequenced commit: merge <out>.rankNofM.seg segments into the final output")
    ap.add_argument("output_file", help="the FINAL destination path the workers targeted")
    ap.add_argument("--ranks", type=int, default=None,
                    help="expected rank count (default: inferred from the segments on disk)")
    ap.add_argument("--keep-segments", action="store_true",
                    help="keep the per-rank segments + markers after the merge (default: swept)")
    args = ap.parse_args(argv)
    if args.ranks is not None and args.ranks <= 0:
        print("error: --ranks must be positive", file=sys.stderr)
        return 2
    try:
        stats = merge_ranks(args.output_file, ranks=args.ranks, cleanup=not args.keep_segments)
    except MergeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    print(f"wrote {args.output_file}: {stats['n']} variants, {stats['n_pass']} PASS from {stats['ranks']} rank "
          "segments")
    return 0
