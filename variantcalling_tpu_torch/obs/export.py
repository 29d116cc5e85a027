"""Exporters: obs JSONL -> Chrome trace-event JSON (Perfetto) or a
terminal summary.

Counterpart of ``variantcalling_tpu/obs/export.py``, the same module; its
one difference is the scoring-cost line of :func:`format_bottleneck`,
which reads the forest kernel's counted work on the H100
(``roofline_vps_h100``, :func:`obs.profile.record_scoring_cost`).

The Chrome trace-event format (the ``traceEvents`` array Perfetto and
``chrome://tracing`` both load) is also what ``torch.profiler`` exports
for the device trace (``VCTPU_OBS_JAXPROF``), so the host-side obs
stream and the card's kernels load side by side in one Perfetto session
("Open trace file" twice).

Mapping:

- ``span``       -> ``ph: "X"`` complete events (``ts`` = span start in
  µs since run start, ``dur`` = µs), one track per recording thread;
- ``degrade`` / ``fault`` / ``retry`` / ``journal`` / ``resolve`` /
  ``stage`` -> ``ph: "i"`` instant events (thread scope);
- ``heartbeat``  -> ``ph: "C"`` counter tracks (records, chunks, vps);
- manifest/tool  -> ``ph: "M"`` process/thread name metadata.

Every emitted event carries ``pid``/``tid``/``ph``/``ts``; the list is
sorted by ``ts`` so consumers that stream it see a monotonically
consistent timeline.
"""

from __future__ import annotations

import glob
import json
import re

from variantcalling_tpu_torch.obs.schema import SCHEMA_VERSION

#: event kinds rendered as instant markers on their thread's track
_INSTANT_KINDS = ("degrade", "fault", "retry", "journal", "resolve", "stage")

#: envelope fields not repeated into a trace event's args
_ENVELOPE = ("v", "seq", "ts", "t", "kind", "name", "pid", "tid")


class ObsLogError(ValueError):
    """The file is not a readable obs run log."""


def read_events(path: str, continuation: bool = False) -> list[dict]:
    """Parse one obs JSONL file; raises :class:`ObsLogError` on garbage
    (missing file surfaces as OSError for the CLI to map to exit 2).

    A malformed or non-event FINAL line is DROPPED, not raised: an
    in-flight or crashed run's last line is routinely a partial write,
    and every reader (summary/bottleneck/diff/export/tail) must tolerate
    it — mid-file garbage still raises. ``continuation=True`` marks a
    rotation segment (``.segN``): an empty file is then legal (a run
    killed right after rotating) and returns ``[]``.
    """
    events: list[dict] = []
    # streaming parse with ONE line of lookahead: a bad line is held as
    # pending and only raised when a LATER non-empty line proves it was
    # mid-file garbage — at EOF the held line is the torn tail and drops
    pending_error: str | None = None
    with open(path, encoding="utf-8") as fh:
        for i, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            if pending_error is not None:
                raise ObsLogError(pending_error)
            try:
                event = json.loads(line)
            except ValueError as e:
                pending_error = f"{path}:{i}: not JSON: {e}"
                continue
            if not isinstance(event, dict) or "kind" not in event:
                pending_error = f"{path}:{i}: not an obs event"
                continue
            events.append(event)
    if not events:
        if continuation:
            return []
        raise ObsLogError(f"{path}: empty obs log")
    version = events[0].get("v")
    if version != SCHEMA_VERSION:
        raise ObsLogError(f"{path}: schema version {version!r} != "
                          f"{SCHEMA_VERSION} (regenerate or upgrade)")
    return events


def _numbered_siblings(path: str, suffix: str) -> list[tuple[int, str]]:
    """``(N, <path>.<suffix>N)`` sibling files in N order (rotation
    segments and rank logs share the discovery shape)."""
    out: list[tuple[int, str]] = []
    for p in glob.glob(glob.escape(path) + f".{suffix}*"):
        m = re.match(rf".*\.{suffix}(\d+)$", p)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def read_log(path: str) -> list[dict]:
    """One recording process's full stream: the base file plus any
    ``.segN`` rotation segments (``VCTPU_OBS_MAX_MB``), concatenated in
    rotation order — ``seq`` keeps counting across segments, so the
    result is the same ordered stream an uncapped run would have
    written."""
    events = read_events(path)
    for _, seg in _numbered_siblings(path, "seg"):
        events.extend(read_events(seg, continuation=True))
    return events


def read_run(path: str) -> list[dict]:
    """Read one RUN: the given log (merged across its rotation segments)
    plus any ``.rankN`` sibling logs a multi-host run wrote next to it,
    merged into one timeline.

    Rank 0's path is the base path; every rank N > 0 wrote
    ``<path>.rankN`` (obs._rank_suffixed), each with its own optional
    ``.segN`` rotation segments. With rank siblings present every event
    gains a ``rank`` field and its Perfetto ``pid`` becomes the rank, so
    the exported trace shows one process track per rank; a single-rank
    run returns exactly :func:`read_log` (no ``rank`` field, OS pid
    preserved).
    """
    siblings = _numbered_siblings(path, "rank")
    events = read_log(path)
    if siblings:
        merged: list[dict] = []
        for rank, rank_path in [(0, path)] + sorted(siblings):
            rank_events = events if rank == 0 else read_log(rank_path)
            for e in rank_events:
                e = dict(e, rank=rank)
                e["pid"] = rank  # rank as Perfetto pid: one track per rank
                merged.append(e)
        merged.sort(key=lambda e: (e.get("ts", 0), e.get("rank", 0),
                                   e.get("seq", 0)))
        return merged
    # the serving fabric's spelling of the same shape: the router's log
    # is the base path, backend H wrote <path>.backendH next to it
    # (a serving fabric) — merge the tiers into one timeline, the
    # backend id as the Perfetto pid (0 = the router's track)
    backends = _numbered_siblings(path, "backend")
    if not backends:
        return events
    merged = []
    for n, b_path in [(0, path)] + sorted(backends):
        for e in (events if n == 0 else read_log(b_path)):
            e = dict(e, backend=n)
            e["pid"] = n
            merged.append(e)
    merged.sort(key=lambda e: (e.get("ts", 0), e.get("backend", 0),
                               e.get("seq", 0)))
    return merged


def _args_of(event: dict) -> dict:
    return {k: v for k, v in event.items() if k not in _ENVELOPE}


def _last_t(events: list[dict]) -> float:
    """Run-relative offset of the last event — the wall-clock stand-in
    for an in-flight log whose ``run_end`` has not landed yet."""
    return max((float(e.get("t", 0.0)) for e in events
                if isinstance(e.get("t"), (int, float))), default=0.0)


def to_chrome_trace(events: list[dict]) -> dict:
    """The ``{"traceEvents": [...]}`` object Perfetto loads."""
    trace: list[dict] = []
    manifest = next((e for e in events if e.get("kind") == "manifest"), None)
    pids = {e.get("pid", 0) for e in events}
    tool = (manifest or {}).get("tool", "vctpu")
    threads: dict[tuple, str] = {}
    for e in events:
        key = (e.get("pid", 0), e.get("tid", 0))
        name = e.get("thread") if e.get("kind") == "span" else None
        if key not in threads or (name and threads[key] == "thread"):
            threads[key] = name or "thread"
    ranked = any("rank" in e for e in events)
    fabric = not ranked and any("backend" in e for e in events)
    for pid in sorted(pids):
        # rank-merged timelines use the rank AS the pid (read_run), so
        # the process track is labeled by rank; fabric-merged timelines
        # use the backend id (0 = the router tier)
        if fabric:
            name = f"{tool} (router)" if pid == 0 \
                else f"{tool} (backend {pid})"
        else:
            name = f"{tool} (rank {pid})" if ranked else tool
        trace.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                      "ts": 0, "args": {"name": name}})
    for (pid, tid), name in sorted(threads.items()):
        trace.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                      "ts": 0, "args": {"name": name}})

    # causal trace spans: ph X slices like ordinary spans, PLUS flow
    # arrows (ph s/f pairs) along every parent link — Perfetto then draws
    # the chunk DAG (megabatch fan-in included) across thread tracks
    # index keyed by (pid, span_id): on a rank-merged timeline the pid
    # IS the rank and every rank allocated its own s<N> sequence, so a
    # bare-id index would draw flow arrows across unrelated ranks' spans
    span_index: dict[tuple, dict] = {}
    for e in events:
        if e.get("kind") == "trace" and isinstance(e.get("span_id"), str):
            span_index[(e.get("pid", 0), e["span_id"])] = e
    flow_id = 0

    for e in events:
        kind = e.get("kind")
        pid, tid = e.get("pid", 0), e.get("tid", 0)
        t_us = float(e.get("t", 0.0)) * 1e6
        if kind == "span":
            dur_us = float(e.get("dur", 0.0)) * 1e6
            trace.append({"name": e.get("name", "span"), "ph": "X", "cat": "span",
                          "ts": max(0.0, t_us - dur_us), "dur": dur_us,
                          "pid": pid, "tid": tid, "args": _args_of(e)})
        elif kind == "trace":
            dur_us = float(e.get("dur", 0.0)) * 1e6
            start_us = max(0.0, t_us - dur_us)
            trace.append({"name": e.get("name", "trace"), "ph": "X",
                          "cat": "trace", "ts": start_us, "dur": dur_us,
                          "pid": pid, "tid": tid, "args": _args_of(e)})
            for parent_id in e.get("parents", ()):
                parent = span_index.get((pid, parent_id))
                if parent is None:
                    continue
                flow_id += 1
                p_end = float(parent.get("t", 0.0)) * 1e6
                p_dur = float(parent.get("dur", 0.0)) * 1e6
                flow = {"name": "chunk", "cat": "trace.flow", "id": flow_id}
                # the s/f pair binds to the slice CONTAINING its ts: put
                # the start just inside the parent slice's end and the
                # finish at the child slice's start
                trace.append(dict(flow, ph="s",
                                  ts=max(p_end - p_dur, p_end - 1.0),
                                  pid=parent.get("pid", 0),
                                  tid=parent.get("tid", 0)))
                trace.append(dict(flow, ph="f", bp="e",
                                  ts=min(start_us + 1.0, t_us),
                                  pid=pid, tid=tid))
        elif kind in _INSTANT_KINDS:
            trace.append({"name": f"{kind}:{e.get('name', '')}", "ph": "i",
                          "cat": kind, "s": "t", "ts": t_us,
                          "pid": pid, "tid": tid, "args": _args_of(e)})
        elif kind == "heartbeat":
            for track in ("records", "chunks", "vps"):
                if track in e:
                    trace.append({"name": track, "ph": "C", "ts": t_us,
                                  "pid": pid, "tid": tid,
                                  "args": {track: e[track]}})
    trace.sort(key=lambda ev: (ev["ts"], 0 if ev["ph"] == "M" else 1))
    return {
        "traceEvents": trace,
        "displayTimeUnit": "ms",
        "otherData": {"tool": tool, "schema_version": SCHEMA_VERSION,
                      "source": "variantcalling_tpu obs"},
    }


def summarize(events: list[dict]) -> dict:
    """Terminal roll-up: per-stage time, throughput, degradations,
    slowest chunks, final metrics."""
    manifest = next((e for e in events if e.get("kind") == "manifest"), None)
    run_end = next((e for e in reversed(events)
                    if e.get("kind") == "run_end"), None)
    metrics = next((e for e in reversed(events)
                    if e.get("kind") == "metrics"), None)

    stages: dict[str, dict] = {}
    chunk_spans: list[dict] = []
    for e in events:
        if e.get("kind") != "span":
            continue
        name = e.get("name", "span")
        dur = float(e.get("dur", 0.0))
        s = stages.setdefault(name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
        s["count"] += 1
        s["total_s"] += dur
        s["max_s"] = max(s["max_s"], dur)
        if "chunk" in e:
            chunk_spans.append(e)
    for s in stages.values():
        s["total_s"] = round(s["total_s"], 6)
        s["mean_s"] = round(s["total_s"] / s["count"], 6)
        s["max_s"] = round(s["max_s"], 6)

    degradations: dict[str, int] = {}
    faults: dict[str, int] = {}
    recoveries: dict[str, int] = {}
    membership: dict[str, int] = {}
    for e in events:
        if e.get("kind") == "degrade":
            degradations[e.get("name", "?")] = \
                degradations.get(e.get("name", "?"), 0) + 1
        elif e.get("kind") == "fault":
            faults[e.get("name", "?")] = faults.get(e.get("name", "?"), 0) + 1
        elif e.get("kind") == "recovery":
            # recovery-ladder actions (chunk_retry / watchdog_retry /
            # megabatch_shrink / megabatch_split / quarantine /
            # dp_degrade) — docs/robustness.md
            recoveries[e.get("name", "?")] = \
                recoveries.get(e.get("name", "?"), 0) + 1
        elif e.get("kind") == "membership":
            # elastic pod transitions (join / leave / steal / recut /
            # reassign / shed / claim_lost / join_refused) — rolled up
            # by ACTION, the span label stays in the raw stream
            # (docs/scaleout.md "Elastic membership")
            membership[e.get("action", "?")] = \
                membership.get(e.get("action", "?"), 0) + 1

    # chunk-cache roll-up (docs/caching.md): the final metrics snapshot
    # carries the cache.hit / cache.miss / cache.bytes_saved counters the
    # filter pipeline maintains; a stream with no cache traffic (cache
    # off, or predating the cache) rolls up to None, not zeros
    cache = None
    m_counters = (_args_of(metrics).get("counters") or {}) if metrics else {}
    c_hits = int(m_counters.get("cache.hit", 0))
    c_misses = int(m_counters.get("cache.miss", 0))
    if c_hits or c_misses:
        cache = {"hits": c_hits, "misses": c_misses,
                 "bytes_saved": int(m_counters.get("cache.bytes_saved", 0)),
                 "hit_rate": round(c_hits / (c_hits + c_misses), 4)}

    slowest = sorted(chunk_spans, key=lambda e: -float(e.get("dur", 0.0)))[:5]
    heartbeats = [e for e in events if e.get("kind") == "heartbeat"]
    # multi-rank merged timelines (read_run): each rank reported its own
    # progress — total records is the SUM of every rank's last heartbeat
    # (fabric-merged timelines spell the reporter "backend")
    last_hb_by_rank: dict = {}
    for e in heartbeats:
        last_hb_by_rank[(e.get("rank", 0), e.get("backend", 0))] = e
    records = sum(e.get("records", 0) for e in last_hb_by_rank.values()) \
        if last_hb_by_rank else None
    ranks = sorted({e.get("rank", 0) for e in events})
    # no run_end == the run is still writing (or died by SIGKILL):
    # report honestly as in-flight with the last event's offset standing
    # in for the duration — a reader must never stack-trace on it
    dur = float(run_end.get("dur", 0.0)) if run_end else _last_t(events)

    return {
        "run": {
            "tool": (manifest or {}).get("tool"),
            "version": (manifest or {}).get("version"),
            "status": run_end.get("status") if run_end else "in-flight",
            "in_flight": run_end is None,
            "duration_s": round(dur, 3) if dur is not None else None,
            "events": len(events),
            "ranks": len(ranks),
        },
        "stages": dict(sorted(stages.items())),
        "throughput": {
            "records": records,
            "records_per_s": round(records / dur) if records and dur else None,
        },
        "degradations": degradations,
        "faults": faults,
        "recoveries": recoveries,
        "membership": membership,
        "cache": cache,
        "slowest_chunks": [{"name": e.get("name"), "chunk": e.get("chunk"),
                            "dur_s": round(float(e.get("dur", 0.0)), 6)}
                           for e in slowest],
        "metrics": _args_of(metrics) if metrics else {},
    }


# ---------------------------------------------------------------------------
# bottleneck attribution (obs v2): who is the limiting stage?
# ---------------------------------------------------------------------------


def bottleneck(events: list[dict]) -> dict:
    """Roll the ``profile`` events up into a per-stage wall-clock
    attribution and NAME the limiting stage.

    Source of truth is the ``profile``/``stage`` + ``profile``/``pipeline``
    events the streaming executor emits (work vs queue-wait vs
    backpressure-wait per stage); a log without them (a serial run
    predating profiling, or ``VCTPU_OBS_PROFILE=0``) falls back to
    depth-0 trace spans — work attribution only, waits unknown. Every
    stage's ``work/wait_in/wait_out/other`` percentages sum to ~100% of
    the pipeline wall clock (``other`` = the stage thread's untracked
    time: startup, teardown, span bookkeeping). The limiting stage is
    the one with the largest work share — in a pipelined executor its
    work IS the wall clock floor, so it is the stage to shrink.
    """
    stage_events = [e for e in events
                    if e.get("kind") == "profile" and e.get("name") == "stage"]
    pipe_events = [e for e in events
                   if e.get("kind") == "profile" and e.get("name") == "pipeline"]
    run_end = next((e for e in reversed(events)
                    if e.get("kind") == "run_end"), None)

    stages: dict[str, dict] = {}
    if stage_events:
        source = "profile"
        wall = sum(float(e.get("wall_s", 0.0)) for e in pipe_events) or \
            (float(run_end.get("dur", 0.0)) if run_end else _last_t(events))
        records = sum(int(e.get("records", 0)) for e in pipe_events)
        # parallel host-IO pools profile one stage PER WORKER
        # (parse.w0, inflate.w1, ...) and the mesh-sharded scoring path
        # one PER DEVICE (score.d0, score.d1, ...;
        # docs/streaming_executor.md): merge each family into one row
        # and remember its lane count — the percentage denominator
        # becomes lanes × wall, so a stage's work/wait/other fractions
        # still sum to ~100% of ITS capacity and the table keeps reading
        # as fractions of wall-clock. Device families additionally carry
        # ``devices`` (a device lane is hardware, not a host thread).
        worker_re = re.compile(r"^(.+)\.([wd])(\d+)$")
        for e in stage_events:  # several pipelines in one stream: sum
            name = e.get("stage", "?")
            m = worker_re.match(name)
            base = m.group(1) if m else name
            s = stages.setdefault(base, {
                "work_s": 0.0, "wait_in_s": 0.0, "wait_out_s": 0.0,
                "items": 0, "bytes_in": 0, "bytes_out": 0,
                "stage_records": 0, "_workers": set()})
            if m:
                s["_workers"].add(m.group(2) + m.group(3))
                if m.group(2) == "d":
                    s["_device_family"] = True
            s["work_s"] += float(e.get("work_s", 0.0))
            s["wait_in_s"] += float(e.get("wait_in_s", 0.0))
            s["wait_out_s"] += float(e.get("wait_out_s", 0.0))
            s["items"] += int(e.get("items", 0))
            s["bytes_in"] += int(e.get("bytes_in", 0))
            s["bytes_out"] += int(e.get("bytes_out", 0))
            s["stage_records"] += int(e.get("records", 0)) if m else 0
        for s in stages.values():
            s["workers"] = max(1, len(s.pop("_workers")))
            if s.pop("_device_family", False):
                s["devices"] = s["workers"]  # device lanes, not host threads
    else:
        # fallback: depth-0 spans (serial runs, profiling off) — honest
        # about what it is: work only, waits unattributable. An in-flight
        # log (no run_end) uses the last event's offset as the wall.
        source = "spans"
        records = 0
        wall = float(run_end.get("dur", 0.0)) if run_end else _last_t(events)
        for e in events:
            if e.get("kind") != "span" or e.get("depth", 0) != 0:
                continue
            s = stages.setdefault(e.get("name", "span"), {
                "work_s": 0.0, "wait_in_s": 0.0, "wait_out_s": 0.0,
                "items": 0, "bytes_in": 0, "bytes_out": 0})
            s["work_s"] += float(e.get("dur", 0.0))
            s["items"] += 1

    for s in stages.values():
        k = s.get("workers", 1)
        capacity = wall * k  # a k-worker family can spend k×wall working
        tracked = s["work_s"] + s["wait_in_s"] + s["wait_out_s"]
        s["other_s"] = max(0.0, capacity - tracked) if source == "profile" \
            else 0.0
        for key in ("work", "wait_in", "wait_out", "other"):
            s[f"{key}_pct"] = round(100.0 * s[f"{key}_s"] / capacity, 1) \
                if capacity > 0 else 0.0
            s[f"{key}_s"] = round(s[f"{key}_s"], 6)
        n_rec = s.pop("stage_records", 0) or records
        if n_rec and s["work_s"] > 0:
            # standalone throughput: what the stage (all its workers
            # together) sustains while busy
            s["vps"] = round(n_rec / (s["work_s"] / k))

    # the limiting stage is the largest per-capacity work share: a
    # k-worker family's wall-clock floor is work_s / k, so families rank
    # by normalized work (== work_pct ranking)
    def _norm_work(s: dict) -> float:
        return s["work_s"] / s.get("workers", 1)

    limiting = max(stages, key=lambda n: _norm_work(stages[n])) \
        if stages else None
    out = {
        "source": source,
        "wall_s": round(wall, 6),
        "records": records or None,
        "e2e_vps": round(records / wall) if records and wall > 0 else None,
        "limiting_stage": limiting,
        "limiting_work_pct": stages[limiting]["work_pct"] if limiting else None,
        "stages": dict(sorted(stages.items(),
                              key=lambda kv: -_norm_work(kv[1]))),
    }
    cost = [e for e in events if e.get("kind") == "profile"
            and e.get("name") == "cost_analysis"]
    if cost:
        out["cost_analysis"] = _args_of(cost[-1])
    res = [e for e in events if e.get("kind") == "profile"
           and e.get("name") == "resources"]
    if res:
        out["resources"] = _args_of(res[-1])
    return out


def render_bottleneck(b: dict) -> str:
    """Human-readable attribution table (``vctpu obs bottleneck``)."""
    lines = []
    if b["limiting_stage"] is not None:
        lines.append(f"limiting stage: {b['limiting_stage']} "
                     f"({b['limiting_work_pct']:.1f}% of {b['wall_s']:.3f}s "
                     f"wall working)")
    else:
        lines.append("no stage attribution in this log")
    if b.get("e2e_vps"):
        lines.append(f"throughput: {b['records']} records, "
                     f"{b['e2e_vps']}/s end to end")
    if b["stages"]:
        def label(n: str, s: dict) -> str:
            k = s.get("workers", 1)
            return f"{n} x{k}" if k > 1 else n  # merged IO-pool family

        labels = {n: label(n, s) for n, s in b["stages"].items()}
        width = max(len(v) for v in labels.values())
        lines.append(f"  {'stage':<{width}}  {'work%':>6} {'wait-in%':>8} "
                     f"{'wait-out%':>9} {'other%':>6} {'work_s':>9} "
                     f"{'v/s-alone':>10}  bytes")
        for name, s in b["stages"].items():
            byt = []
            if s.get("bytes_in"):
                byt.append(f"{s['bytes_in'] / (1 << 20):.1f}MB in")
            if s.get("bytes_out"):
                byt.append(f"{s['bytes_out'] / (1 << 20):.1f}MB out")
            lines.append(
                f"  {labels[name]:<{width}}  {s['work_pct']:>6.1f} "
                f"{s['wait_in_pct']:>8.1f} {s['wait_out_pct']:>9.1f} "
                f"{s['other_pct']:>6.1f} {s['work_s']:>9.3f} "
                f"{s.get('vps', '-'):>10}  {' '.join(byt)}")
    if b["source"] == "spans":
        lines.append("(span fallback: work attribution only — rerun with "
                     "VCTPU_OBS=1 + profiling for wait attribution)")
    ca = b.get("cost_analysis")
    if ca and ca.get("flops_per_variant"):
        lines.append(f"scoring program ({ca.get('strategy')}): "
                     f"{ca['flops_per_variant']:.0f} operations/variant "
                     f"counted for the forest kernel; H100 bound "
                     f"{ca.get('roofline_vps_h100', 0)} v/s")
    res = b.get("resources")
    if res:
        lines.append(f"watermarks: rss {res.get('rss_peak_mb')} MB peak, "
                     f"host cpu {res.get('cpu_peak_pct')}% peak "
                     f"({res.get('samples')} samples)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# run diff (regression sentry): A vs baseline B with explicit noise bands
# ---------------------------------------------------------------------------

#: default per-metric tolerance (fraction) for `vctpu obs diff`
DIFF_TOLERANCE = 0.08


def diff_runs(candidate: list[dict], baseline: list[dict],
              tolerance: float = DIFF_TOLERANCE) -> dict:
    """Compare a candidate run against a baseline run with an explicit
    noise band; the sentry half of `vctpu obs diff A B`.

    Regressions (beyond ``tolerance``, a fraction): wall clock up,
    end-to-end throughput down, or any shared stage's work seconds up.
    Improvements are reported, never fatal. Returns the report dict;
    ``report["regressed"]`` drives the CLI exit code.
    """
    cand, base = bottleneck(candidate), bottleneck(baseline)
    checks: list[dict] = []

    def check(metric: str, new, old, higher_is_better: bool) -> None:
        if not new or not old:
            return
        ratio = new / old
        if higher_is_better:
            regressed = ratio < 1 - tolerance
        else:
            regressed = ratio > 1 + tolerance
        checks.append({"metric": metric, "candidate": new, "baseline": old,
                       "delta_pct": round(100.0 * (ratio - 1), 2),
                       "tolerance_pct": round(100.0 * tolerance, 2),
                       "regressed": regressed})

    check("wall_s", cand["wall_s"], base["wall_s"], higher_is_better=False)
    check("e2e_vps", cand.get("e2e_vps"), base.get("e2e_vps"),
          higher_is_better=True)
    for name in sorted(set(cand["stages"]) & set(base["stages"])):
        check(f"stage.{name}.work_s", cand["stages"][name]["work_s"],
              base["stages"][name]["work_s"], higher_is_better=False)
    return {
        "tolerance_pct": round(100.0 * tolerance, 2),
        "limiting_stage": {"candidate": cand["limiting_stage"],
                           "baseline": base["limiting_stage"]},
        "checks": checks,
        "regressed": any(c["regressed"] for c in checks),
    }


def render_diff(report: dict) -> str:
    lines = [f"obs diff (noise band ±{report['tolerance_pct']}%):"]
    for c in report["checks"]:
        mark = "REGRESSED" if c["regressed"] else "ok"
        lines.append(f"  {c['metric']:<28} {c['baseline']:>12} -> "
                     f"{c['candidate']:>12}  {c['delta_pct']:+7.2f}%  {mark}")
    ls = report["limiting_stage"]
    if ls["candidate"] != ls["baseline"]:
        lines.append(f"  limiting stage moved: {ls['baseline']} -> "
                     f"{ls['candidate']}")
    lines.append("result: " + ("REGRESSION beyond the noise band"
                               if report["regressed"] else
                               "within the noise band"))
    return "\n".join(lines)


def render_summary(summary: dict) -> str:
    """Human-readable roll-up (``vctpu obs summary`` without ``--json``)."""
    run = summary["run"]
    lines = [f"run: {run.get('tool')} v{run.get('version')} — "
             f"{run.get('status')} in {run.get('duration_s')}s "
             f"({run.get('events')} events)"]
    if summary["stages"]:
        lines.append("stages (total / mean / max seconds):")
        width = max(len(n) for n in summary["stages"])
        for name, s in summary["stages"].items():
            lines.append(f"  {name:<{width}}  x{s['count']:<5} "
                         f"{s['total_s']:>9.3f} {s['mean_s']:>9.4f} "
                         f"{s['max_s']:>9.4f}")
    tp = summary["throughput"]
    if tp.get("records"):
        lines.append(f"throughput: {tp['records']} records"
                     + (f" ({tp['records_per_s']}/s)"
                        if tp.get("records_per_s") else ""))
    if summary.get("cache"):
        c = summary["cache"]
        lines.append(f"chunk cache: {c['hits']} hit / {c['misses']} miss "
                     f"({c['hit_rate']:.0%} hit rate), "
                     f"{c['bytes_saved']} rendered bytes replayed")
    if summary["degradations"]:
        lines.append("degradations: " + ", ".join(
            f"{k} x{v}" for k, v in sorted(summary["degradations"].items())))
    if summary["faults"]:
        lines.append("injected faults: " + ", ".join(
            f"{k} x{v}" for k, v in sorted(summary["faults"].items())))
    if summary.get("recoveries"):
        lines.append("recovery actions: " + ", ".join(
            f"{k} x{v}" for k, v in sorted(summary["recoveries"].items())))
    if summary.get("membership"):
        lines.append("membership transitions: " + ", ".join(
            f"{k} x{v}" for k, v in sorted(summary["membership"].items())))
    if summary["slowest_chunks"]:
        lines.append("slowest chunks: " + ", ".join(
            f"{c['name']}#{c['chunk']} {c['dur_s']:.3f}s"
            for c in summary["slowest_chunks"]))
    return "\n".join(lines)
