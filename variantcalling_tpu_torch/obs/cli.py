"""CLI: ``python -m variantcalling_tpu_torch obs
<export|summary|bottleneck|critical-path|flame|cpuledger|diff|tail|prom>``
— counterpart of ``variantcalling_tpu/obs/cli.py``, the same tool (its
usage still says ``vctpu obs``, so both print the same text). Open any obs run log in Perfetto, roll it up in the terminal, name
the limiting stage or the dominant critical-path edge, export the
continuous profiler's samples as a flame graph (``flame``; ``--diff``
ranks per-frame CPU-share deltas between two runs), print the measured
cpu-budget ledger (``cpuledger``), diff two runs with a noise band,
tail an in-flight run, or render a Prometheus text exposition.

Multi-rank runs and size-capped rotation segments are merged
transparently: every subcommand reads the given log PLUS any ``.rankN``
sibling logs and ``.segN`` rotation segments (one timeline, rank as the
Perfetto pid — docs/observability.md "Multi-host runs" / "Log rotation").
Every reader tolerates an IN-FLIGHT log — a truncated final line is
dropped and a missing ``run_end`` reports status ``in-flight`` instead
of stack-tracing (``tail --follow`` is built on exactly that).

Exit codes follow the repo-wide CLI contract: 0 success, 2 usage error /
unreadable or malformed log (argparse's own usage failures also exit 2).
``diff`` additionally exits 1 when the candidate regresses beyond the
noise band.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.obs import critical as critical_mod
from variantcalling_tpu_torch.obs import export as export_mod
from variantcalling_tpu_torch.obs import prom as prom_mod
from variantcalling_tpu_torch.obs import sampler as sampler_mod
from variantcalling_tpu_torch.utils.jsonio import emit_json


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="vctpu obs",
        description="inspect/export obs run telemetry (docs/observability.md)")
    sub = ap.add_subparsers(dest="command", required=True)

    exp = sub.add_parser("export",
                         help="convert a run log to a Perfetto-loadable "
                              "Chrome trace-event file")
    exp.add_argument("log", help="obs run log (JSONL)")
    exp.add_argument("--format", default="perfetto", choices=["perfetto"],
                     help="output format (perfetto == Chrome trace events)")
    exp.add_argument("-o", "--output", default=None,
                     help="output path (default: <log>.trace.json)")

    summ = sub.add_parser("summary",
                          help="terminal roll-up: per-stage time, throughput, "
                               "degradations, slowest chunks")
    summ.add_argument("log", help="obs run log (JSONL)")
    summ.add_argument("--json", action="store_true",
                      help="emit the summary as JSON")

    bott = sub.add_parser("bottleneck",
                          help="per-stage work/wait attribution: name the "
                               "limiting stage (obs v2 profile events)")
    bott.add_argument("log", help="obs run log (JSONL)")
    bott.add_argument("--json", action="store_true",
                      help="emit the attribution as JSON")

    crit = sub.add_parser("critical-path",
                          help="per-chunk critical-path attribution from "
                               "the causal trace DAG: which work/wait "
                               "edges dominate p50/p95 chunk latency")
    crit.add_argument("log", help="obs run log (JSONL)")
    crit.add_argument("--json", action="store_true",
                      help="emit the roll-up as JSON")

    fl = sub.add_parser("flame",
                        help="export the continuous profiler's samples "
                             "(VCTPU_OBS_CPUPROF) as speedscope JSON + "
                             "collapsed stacks; --diff ranks per-frame "
                             "CPU-share deltas between two runs")
    fl.add_argument("log", nargs="+",
                    help="obs run log (two logs with --diff: "
                         "CANDIDATE BASELINE)")
    fl.add_argument("--diff", action="store_true",
                    help="compare two logs: ranked per-frame CPU "
                         "self-share delta report (attribution, not a "
                         "gate — always exits 0 on a readable pair)")
    fl.add_argument("-o", "--output", default=None,
                    help="speedscope output path "
                         "(default <log>.speedscope.json)")
    fl.add_argument("--collapsed", default=None,
                    help="also write collapsed-stack text here "
                         "(default <log>.collapsed.txt)")
    fl.add_argument("--top", type=int, default=20,
                    help="--diff: frames to report (default %(default)s)")
    fl.add_argument("--json", action="store_true",
                    help="--diff: emit the delta report as JSON")

    cl = sub.add_parser("cpuledger",
                        help="measured cpu-budget ledger from the "
                             "continuous profiler's samples: cpu-s (and "
                             "cpu-s per 1M variants) per stage")
    cl.add_argument("log", help="obs run log (JSONL)")
    cl.add_argument("--json", action="store_true",
                    help="emit the ledger as JSON")

    tail = sub.add_parser("tail",
                          help="progress/SLO view of an (in-flight) run "
                               "log; --follow keeps reading as it grows")
    tail.add_argument("log", help="obs run log (JSONL; may be growing)")
    tail.add_argument("--follow", action="store_true",
                      help="poll the log until run_end (Ctrl-C to stop)")
    tail.add_argument("--interval-s", type=float, default=None,
                      help="--follow poll interval (default: the "
                           "VCTPU_OBS_TAIL_POLL_S knob, 1.0s)")
    tail.add_argument("--json", action="store_true",
                      help="emit the (non-follow) tail state as JSON")

    pr = sub.add_parser("prom",
                        help="Prometheus text exposition of the run's "
                             "latest metrics state (in-flight snapshots "
                             "included)")
    pr.add_argument("log", help="obs run log (JSONL)")
    pr.add_argument("-o", "--output", default=None,
                    help="write atomically to this textfile-collector "
                         "path instead of stdout")

    diff = sub.add_parser("diff",
                          help="compare a candidate run against a baseline "
                               "run with an explicit noise band; exit 1 on "
                               "regression")
    diff.add_argument("candidate", help="candidate obs run log")
    diff.add_argument("baseline", help="baseline obs run log")
    diff.add_argument("--tolerance-pct", type=float,
                      default=100.0 * export_mod.DIFF_TOLERANCE,
                      help="noise band as a percentage (default %(default)s)")
    diff.add_argument("--json", action="store_true",
                      help="emit the diff report as JSON")
    return ap


def _load(path: str) -> list[dict]:
    # read_run merges .rankN siblings AND .segN rotation segments
    return export_mod.read_run(path)


def tail_state(events: list[dict]) -> dict:
    """The compact progress/SLO view ``vctpu obs tail`` renders: run
    status, last heartbeat, recovery counts, and the freshest rolling
    quantiles (from the last periodic snapshot or final metrics)."""
    summary = export_mod.summarize(events)
    snap = next((e for e in reversed(events)
                 if e.get("kind") in ("snapshot", "metrics")), None)
    rolling = {}
    if snap is not None:
        for name, h in (snap.get("histograms") or {}).items():
            r = h.get("rolling") if isinstance(h, dict) else None
            if isinstance(r, dict) and r.get("count"):
                rolling[name] = {k: r.get(k)
                                 for k in ("window_s", "count", "p50",
                                           "p95", "p99")}
    # multi-rank merged timelines: each rank reported its own progress —
    # SUM the per-rank last heartbeats (the summarize() rule), so the
    # progress line and the summary's record total cannot contradict
    last_hb_by_rank: dict = {}
    for e in events:
        if e.get("kind") == "heartbeat":
            last_hb_by_rank[e.get("rank", 0)] = e
    progress: dict = {}
    if last_hb_by_rank:
        hbs = list(last_hb_by_rank.values())
        for key in ("chunks", "records", "records_pass"):
            vals = [hb[key] for hb in hbs if key in hb]
            if vals:
                progress[key] = sum(vals)
        for key in ("vps", "pct", "eta_s"):  # rate/pct don't sum: report
            vals = [hb[key] for hb in hbs if key in hb]  # the mean
            if vals:
                progress[key] = round(sum(vals) / len(vals), 2)
    return {
        "run": summary["run"],
        "progress": progress,
        "recoveries": summary.get("recoveries", {}),
        "degradations": summary.get("degradations", {}),
        "rolling": rolling,
        "snapshots": sum(1 for e in events if e.get("kind") == "snapshot"),
    }


def render_tail(state: dict) -> str:
    run = state["run"]
    lines = [f"run: {run.get('tool')} — {run.get('status')} "
             f"({run.get('events')} events, {run.get('duration_s')}s)"]
    p = state["progress"]
    if p:
        bits = [f"chunks={p.get('chunks')}", f"records={p.get('records')}"]
        if "vps" in p:
            bits.append(f"vps={p['vps']}")
        if "pct" in p:
            bits.append(f"pct={p['pct']}")
        if "eta_s" in p:
            bits.append(f"eta_s={p['eta_s']}")
        lines.append("progress: " + " ".join(bits))
    for name, r in sorted(state["rolling"].items()):
        lines.append(f"rolling[{name}] (last ~{r.get('window_s')}s, "
                     f"n={r.get('count')}): p50={r.get('p50')} "
                     f"p95={r.get('p95')} p99={r.get('p99')}")
    if state["recoveries"]:
        lines.append("recovery actions: " + ", ".join(
            f"{k} x{v}" for k, v in sorted(state["recoveries"].items())))
    return "\n".join(lines)


def _render_live_event(e: dict) -> str | None:
    """One follow-mode line per interesting event (None = stay quiet)."""
    kind = e.get("kind")
    if kind == "heartbeat":
        bits = [f"chunks={e.get('chunks')}", f"records={e.get('records')}"]
        for key in ("vps", "pct", "eta_s"):
            if key in e:
                bits.append(f"{key}={e[key]}")
        return "heartbeat: " + " ".join(bits)
    if kind == "recovery":
        extra = f" trace={e['trace_id']}" if "trace_id" in e else ""
        return f"recovery: {e.get('name')}{extra}"
    if kind == "degrade":
        return f"degrade: {e.get('name')} ({e.get('fallback')})"
    if kind == "snapshot":
        # headline: the busiest rolling histogram, whatever the tool
        # named its stages (the same generic rule tail_state applies)
        best_name, best = None, None
        for name, h in (e.get("histograms") or {}).items():
            r = h.get("rolling") if isinstance(h, dict) else None
            if isinstance(r, dict) and r.get("count"):
                if best is None or r["count"] > best["count"]:
                    best_name, best = name, r
        if best is not None:
            return (f"snapshot: rolling {best_name} p95={best.get('p95')} "
                    f"(n={best['count']})")
        return "snapshot: metrics"
    if kind == "run_end":
        return f"run_end: {e.get('status')} after {e.get('dur')}s"
    return None


def _follow(path: str, interval_s: float) -> int:
    """Poll a growing JSONL (tolerating a partially-written final line),
    printing live lines until ``run_end`` lands. A size-capped run
    rotates to ``.segN`` — when the current file stops growing and the
    next segment exists, the tail switches to it. A log that does not
    exist YET is waited for (announced once — the run may not have
    started); any other unreadable-path error exits 2 like every other
    subcommand."""
    import errno

    current = path
    seg = 0
    offset = 0
    buf = ""
    announced_wait = False
    while True:
        try:
            with open(current, encoding="utf-8") as fh:
                fh.seek(offset)
                chunk = fh.read()
                offset = fh.tell()
        except OSError as e:
            if e.errno != errno.ENOENT:
                print(f"error: {e}", file=sys.stderr)
                return 2
            if not announced_wait:
                # a silent spin on a typo'd path would look like a hung
                # run: say what is being waited for, once
                print(f"waiting for {current} (no such file yet)",
                      file=sys.stderr)
                announced_wait = True
            time.sleep(interval_s)
            continue
        buf += chunk
        *complete, buf = buf.split("\n")
        for line in complete:
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except ValueError:
                continue  # torn line mid-file: the writer will re-land it
            out = _render_live_event(e)
            if out:
                print(out, flush=True)
            if e.get("kind") == "run_end":
                return 0
        if not chunk:
            # the current file stopped growing: a size-capped writer may
            # have rotated to the next segment(s) since the last poll —
            # advance WITHOUT sleeping (and without re-reading anything
            # already consumed; each segment is read once, from 0)
            nxt = f"{path}.seg{seg + 1}"
            if os.path.exists(nxt):
                seg += 1
                current, offset, buf = nxt, 0, ""
                continue
            time.sleep(interval_s)


def _flame(args) -> int:
    """``vctpu obs flame`` / ``flame --diff`` (obs v3). Exit 2 when a
    log is unreadable OR holds no ``sample`` events (an export of
    nothing must fail loudly, not write an empty artifact)."""
    if args.diff:
        if len(args.log) != 2:
            print("flame --diff takes exactly two logs: CANDIDATE "
                  "BASELINE", file=sys.stderr)
            return 2
        try:
            candidate, baseline = _load(args.log[0]), _load(args.log[1])
        except (OSError, export_mod.ObsLogError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        for path, events in ((args.log[0], candidate),
                             (args.log[1], baseline)):
            if not any(e.get("kind") == "sample" for e in events):
                print(f"error: {path} holds no sample events — rerun "
                      "with VCTPU_OBS=1 VCTPU_OBS_CPUPROF=1",
                      file=sys.stderr)
                return 2
        report = sampler_mod.diff_folds(candidate, baseline, top=args.top)
        if args.json:
            emit_json(report)
        else:
            print(sampler_mod.render_diff(report))
        return 0
    if len(args.log) != 1:
        print("flame takes one log (two only with --diff)",
              file=sys.stderr)
        return 2
    log = args.log[0]
    try:
        events = _load(log)
    except (OSError, export_mod.ObsLogError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    scope = sampler_mod.to_speedscope(events, name=os.path.basename(log))
    if scope is None:
        print(f"error: {log} holds no sample events — rerun with "
              "VCTPU_OBS=1 VCTPU_OBS_CPUPROF=1", file=sys.stderr)
        return 2
    out_path = args.output or f"{log}.speedscope.json"
    collapsed_path = args.collapsed or f"{log}.collapsed.txt"
    lines = sampler_mod.collapsed_lines(events)
    try:
        with open(out_path, "w", encoding="utf-8") as fh:
            json.dump(scope, fh)  # compact: profiles get big
            fh.write("\n")
        with open(collapsed_path, "w", encoding="utf-8") as fh:
            fh.write("\n".join(lines) + "\n")
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    n = sum(sum(p["weights"]) for p in scope["profiles"])
    print(f"wrote {out_path} ({n} samples, "
          f"{len(scope['shared']['frames'])} frames — open in "
          "https://speedscope.app) and "
          f"{collapsed_path} ({len(lines)} collapsed stacks)")
    return 0


def run(argv: list[str]) -> int:
    args = get_parser().parse_args(argv)
    if args.command == "tail" and args.follow:
        interval = args.interval_s if args.interval_s is not None \
            else knobs.get_float("VCTPU_OBS_TAIL_POLL_S")
        try:
            return _follow(args.log, interval)
        except KeyboardInterrupt:
            return 0
    if args.command == "flame":
        return _flame(args)
    try:
        if args.command == "diff":
            candidate = _load(args.candidate)
            baseline = _load(args.baseline)
        else:
            events = _load(args.log)
    except (OSError, export_mod.ObsLogError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.command == "cpuledger":
        ledger = sampler_mod.cpuledger(events)
        if ledger is None:
            print(f"error: {args.log} holds no sample events — rerun "
                  "with VCTPU_OBS=1 VCTPU_OBS_CPUPROF=1", file=sys.stderr)
            return 2
        if args.json:
            emit_json(ledger)
        else:
            print(sampler_mod.render_cpuledger(ledger))
        return 0
    if args.command == "critical-path":
        cp = critical_mod.critical_path(events)
        if args.json:
            emit_json(cp)
        else:
            print(critical_mod.render(cp))
        return 0
    if args.command == "tail":
        state = tail_state(events)
        if args.json:
            emit_json(state)
        else:
            print(render_tail(state))
        return 0
    if args.command == "prom":
        text = prom_mod.events_to_prom(events)
        if args.output:
            try:
                prom_mod.write_textfile(args.output, text)
            except OSError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
            print(f"wrote {args.output}")
        else:
            sys.stdout.write(text)
        return 0
    if args.command == "export":
        out_path = args.output or f"{args.log}.trace.json"
        trace = export_mod.to_chrome_trace(events)
        try:
            import json

            with open(out_path, "w", encoding="utf-8") as fh:
                json.dump(trace, fh)  # compact: trace files get big
                fh.write("\n")
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"wrote {out_path}: {len(trace['traceEvents'])} trace events "
              "(open in https://ui.perfetto.dev)")
        return 0
    if args.command == "bottleneck":
        b = export_mod.bottleneck(events)
        if args.json:
            emit_json(b)
        else:
            print(export_mod.render_bottleneck(b))
        return 0
    if args.command == "diff":
        report = export_mod.diff_runs(candidate, baseline,
                                      tolerance=args.tolerance_pct / 100.0)
        if args.json:
            emit_json(report)
        else:
            print(export_mod.render_diff(report))
        return 1 if report["regressed"] else 0
    summary = export_mod.summarize(events)
    if args.json:
        emit_json(summary)
    else:
        print(export_mod.render_summary(summary))
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
