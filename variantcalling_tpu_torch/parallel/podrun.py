"""podrun: the port's local launcher of rank-partitioned filter pods.

Counterpart of the reference's ``tools/podrun.py``. It starts N worker
processes of ``python -m variantcalling_tpu_torch filter_variants_pipeline``,
each one rank of a ``parallel/rank_plan.RankPlan`` through
``VCTPU_RANK``/``VCTPU_NUM_PROCESSES`` (no collective: the ranks share
the input file and the final commit only), waits for them, and, once every
rank has staged its segment, runs the rank-sequenced merge in process (the
``merge_ranks`` that ``merge-ranks`` runs)::

    python -m variantcalling_tpu_torch.parallel.podrun --ranks 4 -- \\
        --input_file calls.vcf.gz --model_file model.pkl --model_name m \\
        --reference_file ref.fa --output_file out.vcf.gz

Workers are started with ``subprocess`` (never forked from a process that
holds a CUDA context), in the caller's working directory, with this
checkout first on their ``PYTHONPATH``. Each runs on the card unless the
forwarded arguments say ``--backend cpu``; on one card every worker shares
it, and a worker that finds no card exits 2, as does the pod.

``--elastic`` runs an elastic pod instead (``parallel/elastic``): workers are
leased absolute byte spans (``VCTPU_SPAN``), and the ``Coordinator``
re-offers a dead worker's span (re-cut at its journal's watermark, the
journaled prefix adopted, not recomputed), steals from stragglers, grows the
pool toward ``--max-ranks`` and sheds under host load. The merged bytes are
the single-rank run's whatever the final span plan.

Exit codes, one a failure class:

- ``0``: every worker completed and the merge committed;
- ``2``: a usage or configuration error (bad flags, no ``--output_file``,
  forwarded arguments with ``--fabric``, a fabric tier that did not come up);
- ``3``: classic pods only: a worker was killed by a signal; the merge is
  skipped and the destination untouched (a relaunch resumes that rank from
  its journal and skips finished ranks through their ``.done`` markers);
- ``4``: the workers completed but the merge failed;
- ``5``: the pod timed out (the workers left are terminated);
- ``7``: elastic pods: a span died more often than its attempts allow;
- else: the first failing worker's own exit code (1, 2, ...). A worker
  exits 6 when it loses a span's lease race; the coordinator absorbs it.

While the pod runs, ``<out>.podrun.json`` maps workers to pids (written
atomically, removed at the end); an elastic pod's says ``"mode":
"elastic"`` and gives each worker's ``span`` and ``gen``. Each worker's
output goes to ``<out>.rank{r}.podlog`` (elastic:
``<out>.span{lo}-{hi}.g{gen}.podlog``), removed on success unless
``--keep-logs``.

``--fabric`` starts the serving fabric instead of a batch pod
(``serve/router``, ``serve/backend``): ``--ranks`` backend daemons
(``serve --fabric-backend``, each on an ephemeral port, on the card) and one
router (``serve --fabric``) in front of them, then stays up until SIGTERM or
SIGINT and drains the fleet, the router first. Its files hang off ``--base``
(default ``./fabric``): ``<base>.backendH.{ready,status,podlog}``,
``<base>.router.{ready,status,podlog}``, and the obs streams in the sibling
layout the ``obs`` tool merges into one timeline, the router's at
``<base>.obs.jsonl`` and backend H's at ``<base>.obs.jsonl.backendH``.
:func:`start_fabric` and :func:`stop_fabric` are the same launcher as a
library (``backend="cpu"`` puts the backends on the CPU).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import time

#: the checkout root: the workers import the port from it
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EXIT_USAGE = 2
EXIT_KILLED = 3
EXIT_MERGE = 4
EXIT_TIMEOUT = 5


def state_path(out_path: str) -> str:
    return str(out_path) + ".podrun.json"


def _dump_state(out_path: str, doc: dict) -> None:
    tmp = state_path(out_path) + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, state_path(out_path))


def _write_state(out_path: str, ranks: int, procs) -> None:
    _dump_state(out_path, {"ranks": ranks, "workers": [{"rank": r, "pid": p.pid} for r, p in enumerate(procs)],
                           "launcher_pid": os.getpid()})


def _flag_of(fwd: list[str], flag: str) -> str | None:
    for i, a in enumerate(fwd):
        if a == flag:
            return fwd[i + 1] if i + 1 < len(fwd) else None
        if a.startswith(flag + "="):
            return a.split("=", 1)[1]
    return None


def _parse_worker_env(specs: list[str]) -> dict[int, list[tuple[str, str]]]:
    """``IDX:KEY=VAL`` overrides for initial worker IDX (a replacement the
    coordinator starts gets none)."""
    out: dict[int, list[tuple[str, str]]] = {}
    for spec in specs:
        try:
            idx, kv = spec.split(":", 1)
            key, val = kv.split("=", 1)
            out.setdefault(int(idx), []).append((key, val))
        except ValueError:
            raise SystemExit(f"podrun: bad --worker-env {spec!r} (want IDX:KEY=VAL)") from None
    return out


def _worker_env(**extra: str) -> dict[str, str]:
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def _spawn_worker(fwd: list[str], env: dict[str, str], log: str, mode: str = "wb") -> subprocess.Popen:
    fh = open(log, mode)
    try:
        return subprocess.Popen([sys.executable, "-m", "variantcalling_tpu_torch", "filter_variants_pipeline", *fwd],
                                env=env, stdout=fh, stderr=subprocess.STDOUT)
    finally:
        fh.close()  # the child holds the descriptor; the launcher only reads the file back


def _remove(paths) -> None:
    for p in paths:
        try:
            os.remove(p)
        except OSError:
            pass


# -- the serving fabric ------------------------------------------------------------


#: seconds a tier may take to drain after SIGTERM before it is killed
_FABRIC_STOP_S = 45.0


class FabricHandle:
    """A running local serving fabric (:func:`start_fabric`): the router and
    backend processes, their addresses and the files they write."""

    def __init__(self, base: str):
        self.base = base
        self.router = None  # subprocess.Popen
        self.router_address = None
        self.backends: list = []  # subprocess.Popen, backend H at index H - 1
        self.backend_addresses: list[str] = []
        self.logs: list[str] = []


def _wait_ready(ready_file: str, proc, deadline: float, what: str) -> dict:
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"podrun fabric: {what} exited rc={proc.returncode} before becoming ready")
        try:
            with open(ready_file, encoding="utf-8") as fh:
                return json.load(fh)
        except (OSError, ValueError):
            time.sleep(0.05)
    raise RuntimeError(f"podrun fabric: {what} not ready in time")


def _spawn_tier(cmd: list[str], env: dict[str, str], log: str) -> subprocess.Popen:
    fh = open(log, "wb")
    try:
        return subprocess.Popen([sys.executable, "-m", "variantcalling_tpu_torch", "serve", *cmd], env=env,
                                stdout=fh, stderr=subprocess.STDOUT)
    finally:
        fh.close()


def start_fabric(base: str, n_backends: int = 2, timeout: float = 90.0, env: dict | None = None,
                 backend_env: dict | None = None, router_env: dict | None = None,
                 backend: str = "gpu") -> FabricHandle:
    """Start the local serving fabric: ``n_backends`` ``serve
    --fabric-backend`` daemons on ephemeral ports, on ``backend`` (the card
    unless the caller asks for the CPU), then one ``serve --fabric`` router
    over them. Every tier is a ``subprocess`` (never a fork of a process that
    holds a CUDA context) with this checkout first on its ``PYTHONPATH``. The
    files hang off ``base``: ``.backendH.{ready,status,podlog}``,
    ``.router.*``, the router's obs stream at ``<base>.obs.jsonl`` and backend
    H's at ``<base>.obs.jsonl.backendH``. Raises ``RuntimeError`` (the fleet
    stopped) if a tier does not come up within ``timeout``."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    h = FabricHandle(base)
    try:
        readies = []
        for i in range(1, n_backends + 1):
            ready = f"{base}.backend{i}.ready"
            _remove([ready, f"{base}.backend{i}.status"])
            cmd = ["--fabric-backend", "--port", "0", "--backend", backend, "--ready-file", ready,
                   "--status-file", f"{base}.backend{i}.status", "--obs-log", f"{base}.obs.jsonl.backend{i}"]
            h.logs.append(f"{base}.backend{i}.podlog")
            h.backends.append(_spawn_tier(cmd, dict(env, **(backend_env or {})), h.logs[-1]))
            readies.append(ready)
        deadline = time.monotonic() + timeout
        h.backend_addresses = [_wait_ready(r, p, deadline, f"backend {i + 1}")["address"]
                               for i, (r, p) in enumerate(zip(readies, h.backends))]

        ready = f"{base}.router.ready"
        _remove([ready, f"{base}.router.status"])
        cmd = ["--fabric", "--port", "0", "--backends", ",".join(h.backend_addresses), "--ready-file", ready,
               "--status-file", f"{base}.router.status", "--obs-log", f"{base}.obs.jsonl"]
        h.logs.append(f"{base}.router.podlog")
        h.router = _spawn_tier(cmd, dict(env, **(router_env or {})), h.logs[-1])
        h.router_address = _wait_ready(ready, h.router, time.monotonic() + timeout, "router")["address"]
    except Exception:
        stop_fabric(h)
        raise
    return h


def stop_fabric(h: FabricHandle) -> dict:
    """Drain the fleet, the router first (SIGTERM: the graceful drain, exit
    0), and collect each tier's shutdown report: ``{"router": {...},
    "backends": {H: {...}}}``, each the exit code and the ``--status-file``
    document (its leaked threads among them) where one was written."""

    def stop_one(proc, status_file):
        if proc is None:
            return None
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=_FABRIC_STOP_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=_FABRIC_STOP_S)
        doc = {"rc": proc.returncode}
        try:
            with open(status_file, encoding="utf-8") as fh:
                doc.update(json.load(fh))
        except (OSError, ValueError):
            pass
        return doc

    report: dict = {"router": stop_one(h.router, f"{h.base}.router.status"), "backends": {}}
    for i, p in enumerate(h.backends, start=1):
        report["backends"][i] = stop_one(p, f"{h.base}.backend{i}.status")
    return report


def _run_fabric(args) -> int:
    import signal

    base = args.base or "fabric"
    try:
        h = start_fabric(base, n_backends=args.ranks, timeout=args.timeout)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return EXIT_USAGE
    _dump_state(base, {"mode": "fabric", "router": {"pid": h.router.pid, "address": h.router_address},
                       "workers": [{"backend": i, "pid": p.pid, "address": a}
                                   for i, (p, a) in enumerate(zip(h.backends, h.backend_addresses), start=1)],
                       "launcher_pid": os.getpid()})
    print(f"podrun: fabric up: router {h.router_address} over {args.ranks} backends {h.backend_addresses}",
          flush=True)

    stop = {"sig": None}

    def _sig(signum, frame):
        stop["sig"] = signum

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    try:
        while stop["sig"] is None:
            if h.router.poll() is not None:
                print(f"podrun: router exited rc={h.router.returncode}", file=sys.stderr)
                break
            time.sleep(0.2)
    finally:
        report = stop_fabric(h)
        _remove([state_path(base)])
    leaked = [w for w, doc in [("router", report["router"])]
              + [(f"backend{i}", d) for i, d in report["backends"].items()] if doc and doc.get("leaked")]
    if leaked:
        print(f"podrun: fabric drain leaked threads in {leaked}", file=sys.stderr)
        return 1
    print("podrun: fabric drained", flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # the coordinator's membership lines, as the CLI logs
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    fwd: list[str] = []
    if "--" in argv:
        split = argv.index("--")
        argv, fwd = argv[:split], argv[split + 1:]
    ap = argparse.ArgumentParser(
        prog="python -m variantcalling_tpu_torch.parallel.podrun",
        description="spawn N rank-partitioned filter workers + the rank-sequenced merge")
    ap.add_argument("--ranks", type=int, required=True,
                    help="worker process count (N); elastic pods seed N initial spans")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="whole-pod wall bound in seconds (default %(default)s)")
    ap.add_argument("--no-merge", action="store_true",
                    help="stage the segments only; commit later with `merge-ranks <out>`")
    ap.add_argument("--keep-logs", action="store_true", help="keep per-worker logs even on success")
    ap.add_argument("--elastic", action="store_true",
                    help="elastic membership: leased spans + the coordinator state machine (re-assign on death, "
                         "straggler stealing, autoscaling)")
    ap.add_argument("--min-ranks", type=int, default=1,
                    help="elastic: never shed below this many workers (default %(default)s)")
    ap.add_argument("--max-ranks", type=int, default=None, help="elastic: pool growth bound (default: --ranks)")
    ap.add_argument("--steal-factor", type=float, default=4.0,
                    help="elastic: steal when a worker's journal rate falls below median/FACTOR (0 disables; "
                         "default %(default)s)")
    ap.add_argument("--grace", type=float, default=1.5,
                    help="elastic: seconds before a worker is eligible for stealing (default %(default)s)")
    ap.add_argument("--max-load", type=float, default=None,
                    help="elastic: shed (no new joins, down to --min-ranks) while loadavg exceeds this "
                         "(default: no shedding)")
    ap.add_argument("--worker-env", action="append", default=[], metavar="IDX:KEY=VAL",
                    help="extra env for initial worker IDX (repeatable)")
    ap.add_argument("--chaos", choices=("steal_race", "join_during_merge"), default=None,
                    help="elastic fault injection for the chaos harness")
    ap.add_argument("--fabric", action="store_true",
                    help="serving-fabric mode: spawn --ranks backend daemons + 1 router and stay resident until "
                         "SIGTERM")
    ap.add_argument("--base", default=None,
                    help="fabric: artifact base path (ready/status/obs/log files hang off it; default ./fabric)")
    args = ap.parse_args(argv)
    if args.ranks <= 0:
        print("podrun: --ranks must be positive", file=sys.stderr)
        return EXIT_USAGE
    if args.fabric:
        if fwd:
            print("podrun: --fabric takes no forwarded CLI arguments (clients bring the requests)", file=sys.stderr)
            return EXIT_USAGE
        return _run_fabric(args)
    if not fwd:
        print("podrun: pass the filter CLI arguments after `--`", file=sys.stderr)
        return EXIT_USAGE
    out_path = _flag_of(fwd, "--output_file")
    if not out_path:
        print("podrun: the forwarded arguments must include --output_file (the merge target)", file=sys.stderr)
        return EXIT_USAGE
    try:
        worker_env = _parse_worker_env(args.worker_env)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return EXIT_USAGE
    if args.elastic:
        return _run_elastic(args, fwd, out_path, worker_env)
    if args.chaos:
        print("podrun: --chaos requires --elastic", file=sys.stderr)
        return EXIT_USAGE
    return _run_classic(args, fwd, out_path, worker_env)


def _run_classic(args, fwd: list[str], out_path: str, worker_env: dict[int, list[tuple[str, str]]]) -> int:
    """N ranks side by side, then the merge in process."""
    procs: list[subprocess.Popen] = []
    logs: list[str] = []
    for r in range(args.ranks):
        env = _worker_env(VCTPU_RANK=str(r), VCTPU_NUM_PROCESSES=str(args.ranks))
        env.pop("VCTPU_SPAN", None)
        for k, v in worker_env.get(r, []):
            env[k] = v
        logs.append(f"{out_path}.rank{r}.podlog")
        procs.append(_spawn_worker(fwd, env, logs[-1]))
    _write_state(out_path, args.ranks, procs)
    print(f"podrun: spawned {args.ranks} workers (pids {[p.pid for p in procs]}) -> {out_path}", flush=True)

    deadline = time.monotonic() + args.timeout
    timed_out = False
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                timed_out = True
                for p in procs:
                    if p.poll() is None:
                        p.terminate()
                break
            time.sleep(0.05)
        _wait_all(procs)
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        _wait_all(procs)
        print("podrun: interrupted — workers terminated; segments + journals kept for resume", file=sys.stderr)
        return 130

    rcs = [p.returncode for p in procs]
    for r, rc in enumerate(rcs):
        if rc != 0:
            tail = b""
            try:
                with open(logs[r], "rb") as fh:
                    tail = fh.read()[-2000:]
            except OSError:
                pass
            print(f"podrun: rank {r} exited rc={rc}\n{tail.decode(errors='replace')}", file=sys.stderr)
    _remove([state_path(out_path)])
    if timed_out:
        print(f"podrun: pod timed out after {args.timeout:.0f}s — segments + journals kept for resume",
              file=sys.stderr)
        return EXIT_TIMEOUT
    if any(rc is not None and rc < 0 for rc in rcs):
        # a signal-killed worker's segment is incomplete: no merge, the
        # destination stays as it was, a relaunch resumes from the journals
        print(f"podrun: worker(s) signal-killed (rcs={rcs}) — merge skipped; relaunch to resume", file=sys.stderr)
        return EXIT_KILLED
    if any(rcs):
        return next(rc for rc in rcs if rc)

    if args.no_merge:
        print(f"podrun: {args.ranks} segments staged (--no-merge); commit with `merge-ranks {out_path}`",
              flush=True)
    else:
        from variantcalling_tpu_torch.parallel import rank_plan as rank_plan_mod

        try:
            stats = rank_plan_mod.merge_ranks(out_path, args.ranks)
        except rank_plan_mod.MergeError as e:
            print(f"podrun: merge failed: {e}", file=sys.stderr)
            return EXIT_MERGE
        print(f"podrun: wrote {out_path}: {stats['n']} variants, {stats['n_pass']} PASS from {stats['ranks']} ranks",
              flush=True)
    if not args.keep_logs:
        _remove(logs)
    return 0


def _wait_all(procs) -> None:
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=30)


def _run_elastic(args, fwd: list[str], out_path: str, worker_env: dict[int, list[tuple[str, str]]]) -> int:
    """The elastic pod: the record region scanned, the initial span plan
    seeded, the coordinator handed a subprocess spawner, then the final
    (maybe re-cut) plan merged."""
    from variantcalling_tpu_torch import obs
    from variantcalling_tpu_torch.io import vcf as vcf_mod
    from variantcalling_tpu_torch.parallel import elastic
    from variantcalling_tpu_torch.parallel import rank_plan as rank_plan_mod

    inp = _flag_of(fwd, "--input_file")
    if not inp:
        print("podrun: --elastic needs --input_file in the forwarded arguments (the span plan partitions it)",
              file=sys.stderr)
        return EXIT_USAGE
    try:
        header_end, total = vcf_mod.scan_record_region(inp)
    except Exception as e:  # noqa: BLE001 — refused with exit 2, never carried on
        print(f"podrun: cannot span-partition {inp}: {e}", file=sys.stderr)
        return EXIT_USAGE
    spans = elastic.initial_spans(header_end, total, args.ranks)

    run = obs.start_run("podrun", default_path=out_path + ".podrun.obs.jsonl")
    logs: list[str] = []

    def spawn(span, slot):
        env = _worker_env(VCTPU_SPAN=elastic.span_env(span))
        # a leased span is the whole partition: a leaked rank would make the
        # worker refuse the two spellings (exit 2)
        env.pop("VCTPU_RANK", None)
        env.pop("VCTPU_NUM_PROCESSES", None)
        if obs.enabled():
            # one obs stream a worker attempt; the coordinator's holds the membership
            env["VCTPU_OBS_PATH"] = f"{out_path}.span{span.lo}-{span.hi}.g{span.gen}.obs.jsonl"
        if slot is not None:
            for k, v in worker_env.get(slot, []):
                env[k] = v
        log = f"{out_path}.span{span.lo}-{span.hi}.g{span.gen}.podlog"
        logs.append(log)
        return _spawn_worker(fwd, env, log, "ab")

    def on_state(workers):
        _dump_state(out_path, {"mode": "elastic", "ranks": args.ranks, "workers": workers,
                               "launcher_pid": os.getpid()})

    coord = elastic.Coordinator(
        out_path, spans, spawn, max_ranks=args.max_ranks if args.max_ranks else args.ranks,
        min_ranks=args.min_ranks, steal_factor=args.steal_factor, grace_s=args.grace, timeout_s=args.timeout,
        max_load=args.max_load, chaos=args.chaos, on_state=on_state)
    print(f"podrun: elastic pod, {len(spans)} initial spans (max {coord.max_ranks} workers) -> {out_path}",
          flush=True)
    try:
        rc = coord.run()
    except KeyboardInterrupt:
        obs.end_run(run, status="interrupted")
        print("podrun: interrupted — workers terminated; segments + journals kept for resume", file=sys.stderr)
        return 130

    if args.chaos == "steal_race":
        print(f"podrun: chaos steal_race: claim_lost={coord.claim_lost}", flush=True)
    _remove([state_path(out_path)])
    if rc != 0:
        _print_worker_tails(logs)
        obs.end_run(run, status=f"rc={rc}")
        print(f"podrun: elastic pod failed rc={rc} — segments + journals kept for resume", file=sys.stderr)
        return rc

    if args.chaos == "join_during_merge":
        if coord.chaos_join_during_merge():
            print("podrun: chaos join_during_merge: join_refused", flush=True)
        else:
            obs.end_run(run, status="chaos_failed")
            print("podrun: chaos join_during_merge: duplicate claimant was NOT refused", file=sys.stderr)
            return 1

    if args.no_merge:
        obs.end_run(run)
        print(f"podrun: {len(coord.spans)} span segments staged (--no-merge)", flush=True)
        return 0
    try:
        stats = elastic.merge_spans(out_path, coord.spans)
    except rank_plan_mod.MergeError as e:
        obs.end_run(run, status="merge_failed")
        print(f"podrun: merge failed: {e}", file=sys.stderr)
        return EXIT_MERGE
    obs.end_run(run)
    print(f"podrun: wrote {out_path}: {stats['n']} variants, {stats['n_pass']} PASS from {stats['spans']} spans "
          f"({len(coord.transitions)} membership transitions)", flush=True)
    if not args.keep_logs:
        _remove(logs)
    return 0


def _print_worker_tails(logs: list[str]) -> None:
    for log in logs:
        try:
            with open(log, "rb") as fh:
                tail = fh.read()[-1500:]
        except OSError:
            continue
        if tail:
            print(f"podrun: --- {os.path.basename(log)} ---\n{tail.decode(errors='replace')}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
