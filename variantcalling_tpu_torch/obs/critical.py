"""Critical-path engine: which per-chunk edges actually gate latency?

Counterpart of ``variantcalling_tpu/obs/critical.py``, the same module.
``obs bottleneck`` answers "which stage works the most" — a per-stage
*fraction* of a finished run. It cannot say which per-chunk EDGE (parse,
score, render, commit, the waits between them) sits on the latency
critical path, which is what has to be known before fusing anything.

This module reconstructs the per-chunk span DAG from the causal
``trace`` events (docs/observability.md "Causal chunk tracing"), walks
the end-to-end critical path of every chunk, and aggregates which edges
dominate p50/p95 chunk latency:

- a **work** edge is a stage span's own duration (``<stage>.work``);
- a **wait** edge is the gap between the critical parent's end and the
  span's start (``<stage>.wait``) — the time the chunk sat in a queue,
  a megabatch pack buffer, or a retry/backoff window. In the stage
  profiler's vocabulary: from the waiting stage's side this is queue-wait; from
  the producing stage's side the same seconds are backpressure — the
  per-stage ``wait_in``/``wait_out`` split in ``obs bottleneck`` names
  the direction, this module names the chunks it cost.

At megabatch fan-in (one dispatch span, many chunk parents) the critical
parent is the LATEST-arriving member — the chunk the dispatch actually
waited for. The per-stage work sums are reconciled against the
``profile``-event attribution so the two views cannot silently drift
(``reconciliation`` in the roll-up).
"""

from __future__ import annotations

from variantcalling_tpu_torch.obs import export as export_mod


def _rank_key(e: dict, ident) -> str | None:
    """Scope an id to its rank on a merged multi-rank timeline
    (``export.read_run`` tags every event with ``rank``): each rank's
    writer allocated its own ``t<N>``/``s<N>`` sequences, so bare ids
    COLLIDE across ranks — two ranks' chunk DAGs would silently fuse.
    Single-rank logs keep the bare id (no ``rank`` field)."""
    if not isinstance(ident, str):
        return None
    return f"r{e['rank']}:{ident}" if "rank" in e else ident


def span_records(events: list[dict]) -> dict[str, dict]:
    """``span_id -> normalized span record`` for every ``trace`` event
    (start/end derived from the envelope ``t`` = emission time ≈ span
    end). On a rank-merged timeline every id is rank-scoped — parent
    links never cross ranks (ranks share no chunks)."""
    spans: dict[str, dict] = {}
    for e in events:
        if e.get("kind") != "trace":
            continue
        sid = _rank_key(e, e.get("span_id"))
        if sid is None:
            continue
        end = float(e.get("t", 0.0))
        dur = max(0.0, float(e.get("dur", 0.0)))
        traces = e.get("traces")
        spans[sid] = {
            "id": sid,
            "name": e.get("name", "?"),
            "trace": _rank_key(e, e.get("trace_id")),
            "traces": ([_rank_key(e, t) for t in traces]
                       if traces else None),
            "start": end - dur,
            "end": end,
            "dur": dur,
            "parents": [k for k in (_rank_key(e, p)
                                    for p in e.get("parents", ()))
                        if k is not None],
        }
    return spans


def chunk_paths(events: list[dict]) -> list[dict]:
    """One critical path per chunk: ``{trace, latency_s, edges}`` where
    ``edges`` alternates wait/work in execution order.

    The terminal span of a chunk is its latest span (by end time) —
    normally the sequenced commit. The walk follows parent links
    backwards; at fan-in the critical parent is the latest-ending one
    (the arrival the span actually waited for), and the gap to it is the
    wait edge."""
    spans = span_records(events)
    terminal: dict[str, dict] = {}
    for s in spans.values():
        for tid in (s["traces"] or (s["trace"],)):
            if not isinstance(tid, str):
                continue
            cur = terminal.get(tid)
            if cur is None or s["end"] > cur["end"]:
                terminal[tid] = s
    paths: list[dict] = []
    for tid, term in sorted(terminal.items(), key=lambda kv: kv[1]["end"]):
        edges: list[dict] = []
        cur = term
        seen: set[str] = set()
        while cur["id"] not in seen:
            seen.add(cur["id"])
            edges.append({"edge": f"{cur['name']}.work", "kind": "work",
                          "stage": cur["name"], "s": cur["dur"]})
            parents = [spans[p] for p in cur["parents"] if p in spans]
            if not parents:
                break
            parent = max(parents, key=lambda s: s["end"])
            edges.append({"edge": f"{cur['name']}.wait", "kind": "wait",
                          "stage": cur["name"],
                          "s": max(0.0, cur["start"] - parent["end"]),
                          # absolute (run-relative) interval: the join
                          # key the sampler's wait-edge reconciliation
                          # overlaps CPU-sample windows against
                          "t0": parent["end"],
                          "t1": max(parent["end"], cur["start"])})
            cur = parent
        edges.reverse()
        paths.append({"trace": tid,
                      "latency_s": max(0.0, term["end"] - cur["start"]),
                      "edges": edges})
    return paths


def _aggregate_edges(paths: list[dict]) -> dict[str, dict]:
    total: dict[str, dict] = {}
    for p in paths:
        for e in p["edges"]:
            d = total.setdefault(e["edge"], {"kind": e["kind"],
                                             "stage": e["stage"],
                                             "total_s": 0.0, "count": 0})
            d["total_s"] += e["s"]
            d["count"] += 1
    grand = sum(d["total_s"] for d in total.values())
    for d in total.values():
        d["share_pct"] = round(100.0 * d["total_s"] / grand, 1) \
            if grand > 0 else 0.0
        d["mean_s"] = round(d["total_s"] / d["count"], 6) if d["count"] else 0.0
        d["total_s"] = round(d["total_s"], 6)
    return dict(sorted(total.items(), key=lambda kv: -kv[1]["total_s"]))


def _quantile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def critical_path(events: list[dict]) -> dict:
    """The roll-up behind ``vctpu obs critical-path``: per-chunk latency
    quantiles, the edge composition over ALL chunks and over the p95
    latency tail, the dominant edges, and the reconciliation of
    trace-derived per-stage work against the ``profile``-event
    attribution (``obs bottleneck``)."""
    paths = chunk_paths(events)
    if not paths:
        return {"chunks": 0, "source": "none",
                "note": "no trace events in this log — rerun with "
                        "VCTPU_OBS=1 (tracing is on by default; "
                        "VCTPU_OBS_TRACE=0 opts out)"}
    lat = sorted(p["latency_s"] for p in paths)
    p50 = _quantile(lat, 0.5)
    p95 = _quantile(lat, 0.95)
    tail = [p for p in paths if p["latency_s"] >= p95] or paths[-1:]
    edges = _aggregate_edges(paths)
    p95_edges = _aggregate_edges(tail)
    out = {
        "chunks": len(paths),
        "source": "trace",
        "latency_p50_s": round(p50, 6),
        "latency_p95_s": round(p95, 6),
        "edges": edges,
        "dominant_edge": next(iter(edges), None),
        "p95_chunks": len(tail),
        "p95_edges": p95_edges,
        "dominant_p95_edge": next(iter(p95_edges), None),
    }

    # reconciliation with the profile-event attribution: per-stage work
    # summed over UNIQUE spans (a fan-in dispatch counts once here even
    # though it sits on many chunks' paths) vs the bottleneck work_s.
    # Device families (score.dN) book the dispatch wall once PER LANE in
    # the profile rows, so the comparable number is work_s / devices.
    b = export_mod.bottleneck(events)
    if b.get("stages") and b.get("source") == "profile":
        per_stage: dict[str, float] = {}
        for s in span_records(events).values():
            per_stage[s["name"]] = per_stage.get(s["name"], 0.0) + s["dur"]
        recon: dict[str, dict] = {}
        for name, trace_work in sorted(per_stage.items()):
            prof = b["stages"].get(name)
            if prof is None:
                continue
            prof_work = prof["work_s"] / prof.get("devices", 1)
            entry = {"trace_work_s": round(trace_work, 6),
                     "profile_work_s": round(prof_work, 6)}
            if prof_work > 0:
                entry["delta_pct"] = round(
                    100.0 * (trace_work - prof_work) / prof_work, 1)
            recon[name] = entry
        out["reconciliation"] = recon
        out["bottleneck_limiting_stage"] = b.get("limiting_stage")

    # obs v3 reconciliation: when the run carried the continuous CPU
    # profiler, answer "what were the cores DOING during the dominant
    # wait edges" by overlap-joining CPU-sample windows against the wait
    # intervals collected above
    from variantcalling_tpu_torch.obs import sampler as sampler_mod

    wait_edges = [name for name, d in p95_edges.items()
                  if d["kind"] == "wait"][:3]
    if wait_edges and any(e.get("kind") == "sample" for e in events):
        intervals: dict[str, list[tuple[float, float]]] = {}
        for p in paths:
            for e in p["edges"]:
                if e["kind"] == "wait" and e["edge"] in wait_edges \
                        and e["s"] > 0 and "t0" in e:
                    intervals.setdefault(e["edge"], []).append(
                        (e["t0"], e["t1"]))
        wait_cpu = sampler_mod.explain_waits(events, intervals)
        if wait_cpu:
            out["wait_cpu"] = wait_cpu
    return out


def compact(cp: dict) -> dict:
    """The compact roll-up the bench ``e2e`` row commits next to its
    ``attribution`` blob (the full edge table stays in the obs log)."""
    if cp.get("chunks", 0) == 0:
        return {"chunks": 0}
    out = {
        "chunks": cp["chunks"],
        "latency_p50_s": cp["latency_p50_s"],
        "latency_p95_s": cp["latency_p95_s"],
        "dominant_edge": cp["dominant_edge"],
        "dominant_p95_edge": cp["dominant_p95_edge"],
        "p95_edge_share_pct": {
            name: d["share_pct"]
            for name, d in list(cp["p95_edges"].items())[:5]},
    }
    # the "cores were running X" answer for the dominant wait edge
    # (obs v3 reconciliation) rides into the committed bench row
    dom = cp.get("dominant_p95_edge")
    wc = (cp.get("wait_cpu") or {}).get(dom)
    if wc:
        out["dominant_p95_wait_cpu"] = {
            "edge": dom,
            "frames": wc["frames"][:3],
        }
    return out


def render(cp: dict) -> str:
    """Human-readable roll-up (``vctpu obs critical-path``)."""
    if cp.get("chunks", 0) == 0:
        return cp.get("note", "no trace events in this log")
    lines = [f"critical path over {cp['chunks']} chunk trace(s): "
             f"latency p50 {cp['latency_p50_s']:.4f}s, "
             f"p95 {cp['latency_p95_s']:.4f}s",
             f"dominant edge (all chunks): {cp['dominant_edge']}; "
             f"dominant p95 edge ({cp['p95_chunks']} tail chunk(s)): "
             f"{cp['dominant_p95_edge']}"]
    width = max(len(n) for n in cp["edges"])
    lines.append(f"  {'edge':<{width}}  {'kind':<5} {'share%':>7} "
                 f"{'total_s':>9} {'mean_s':>9}  p95-share%")
    for name, d in cp["edges"].items():
        tail_share = cp["p95_edges"].get(name, {}).get("share_pct", 0.0)
        lines.append(f"  {name:<{width}}  {d['kind']:<5} "
                     f"{d['share_pct']:>7.1f} {d['total_s']:>9.3f} "
                     f"{d['mean_s']:>9.4f}  {tail_share:>9.1f}")
    recon = cp.get("reconciliation")
    if recon:
        lines.append("reconciliation vs `obs bottleneck` work seconds "
                     "(trace vs profile):")
        for name, r in recon.items():
            delta = r.get("delta_pct")
            lines.append(f"  {name:<{width}}  {r['trace_work_s']:>9.3f} vs "
                         f"{r['profile_work_s']:>9.3f}"
                         + (f"  ({delta:+.1f}%)" if delta is not None else ""))
    if cp.get("bottleneck_limiting_stage"):
        lines.append(f"bottleneck limiting stage: "
                     f"{cp['bottleneck_limiting_stage']}")
    wait_cpu = cp.get("wait_cpu")
    if wait_cpu:
        lines.append("cores were running (CPU samples joined against the "
                     "wait intervals — obs v3 continuous profiler):")
        for edge, wc in wait_cpu.items():
            frames = ", ".join(f"{f['frame']} {f['share_pct']}%"
                               for f in wc["frames"])
            lines.append(f"  during {edge} ({wc['wait_s']:.3f}s waited): "
                         f"{frames}")
    return "\n".join(lines)
