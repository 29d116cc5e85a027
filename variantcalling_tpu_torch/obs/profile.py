"""Performance-attribution profiler: where wall-clock, bytes and the
card's work go.

Counterpart of ``variantcalling_tpu/obs/profile.py``. The event stream
records *what happened*; this module records *what it cost*:

- :class:`StageProfiler` / :class:`StageStats` — per-stage wall-clock
  attribution for the streaming executor: **work** (inside the stage
  callable) vs **wait-in** (blocked on the upstream queue) vs
  **wait-out** (backpressured on the downstream queue), plus
  items/records/bytes in/out. The executor (``parallel/pipeline.py``)
  and the filter writeback loop feed it; :meth:`StageProfiler.emit`
  lands one schema-versioned ``profile``/``stage`` event per stage plus
  a ``profile``/``pipeline`` wall event. ``obs bottleneck`` rolls them
  up and names the limiting stage.
- :class:`ResourceSampler` — a daemon thread sampling process RSS and
  host-CPU utilization every ``VCTPU_OBS_SAMPLE_S`` seconds into run
  gauges (``proc.rss_mb`` / ``proc.cpu_pct``, peaks kept by the gauge),
  with a final ``profile``/``resources`` watermark event.
- :func:`record_scoring_cost` — the scoring program's work: where the
  reference asks XLA for the compiled program's FLOPs, the port counts
  the forest kernel's own bytes and operations for the run's rows
  (:func:`variantcalling_tpu_torch.models.forest_cuda.scoring_work`, the
  count ``chip_smoke.py`` bounds each kernel with) and emits them as one
  ``profile``/``cost_analysis`` event per run and strategy, with the
  variants a second the H100 could reach at that bound
  (``roofline_vps_h100``).

Everything here is gated on ``enabled()`` — obs recording must be on
(``VCTPU_OBS=1``) AND profiling not opted out (``VCTPU_OBS_PROFILE``,
default on). Output bytes are identical with profiling on; the sampler's
gauges ride the periodic ``snapshot`` events, so an external ``obs
tail``/``prom`` reader sees fresh RSS/CPU watermarks mid-run.
"""

from __future__ import annotations

import os
import re
import threading
import time

from variantcalling_tpu_torch import knobs, obs

PROFILE_ENV = "VCTPU_OBS_PROFILE"
SAMPLE_ENV = "VCTPU_OBS_SAMPLE_S"

#: per-worker stage rows of the parallel host-IO pools (``<name>.w<idx>``)
#: and per-device rows of the mesh-sharded scoring path
#: (``<name>.d<idx>``) — the same family spellings obs/export.py's
#: bottleneck merge matches
_WORKER_STAGE_RE = re.compile(r"\.[wd]\d+$")

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def enabled() -> bool:
    """Profiling is on: an obs run is open and not opted out."""
    return obs.active() and knobs.get_bool(PROFILE_ENV)


class StageStats:
    """One stage's attribution accumulators.

    Each stage of the executor runs on exactly ONE thread, so plain
    float adds need no lock on the record path (the snapshot reader
    crosses threads only after the pipeline joined its workers). The
    parallel host-IO pools keep the same invariant by keying one stage
    PER WORKER (``parse.w0``, ``inflate.w1``, …): each pool worker feeds
    only its own stats object, and ``vctpu obs bottleneck`` re-merges
    the ``<name>.w<idx>`` family into one row normalized by worker count
    so the fractions still sum to ~100% of wall.
    """

    __slots__ = ("name", "work_s", "wait_in_s", "wait_out_s",
                 "items", "records", "bytes_in", "bytes_out")

    def __init__(self, name: str):
        self.name = name
        self.work_s = 0.0
        self.wait_in_s = 0.0
        self.wait_out_s = 0.0
        self.items = 0
        self.records = 0
        self.bytes_in = 0
        self.bytes_out = 0

    def add_work(self, dt: float, items: int = 1,
                 bytes_in: int = 0, bytes_out: int = 0,
                 records: int = 0) -> None:
        self.work_s += dt
        self.items += items
        self.bytes_in += bytes_in
        self.bytes_out += bytes_out
        self.records += records

    def add_wait_in(self, dt: float, items: int = 0) -> None:
        self.wait_in_s += dt
        self.items += items

    def add_wait_out(self, dt: float) -> None:
        self.wait_out_s += dt

    def snapshot(self) -> dict:
        out = {
            "stage": self.name,
            "work_s": round(self.work_s, 6),
            "wait_in_s": round(self.wait_in_s, 6),
            "wait_out_s": round(self.wait_out_s, 6),
            "items": self.items,
        }
        if self.records:
            out["records"] = self.records
            if self.work_s > 0:
                # the stage's standalone throughput: what it could sustain
                # if it never waited
                out["vps"] = round(self.records / self.work_s)
        if self.bytes_in:
            out["bytes_in"] = self.bytes_in
        if self.bytes_out:
            out["bytes_out"] = self.bytes_out
        return out


class StageProfiler:
    """Per-stage attribution for one pipeline run; stages are created on
    demand and keyed by name, so the executor and its caller (which owns
    e.g. the writeback loop) can feed the same profile."""

    def __init__(self):
        self._stages: dict[str, StageStats] = {}
        self._lock = threading.Lock()

    def stage(self, name: str) -> StageStats:
        s = self._stages.get(name)
        if s is None:
            with self._lock:
                s = self._stages.setdefault(name, StageStats(name))
        return s

    def set_records(self, n: int) -> None:
        """Every stage of a linear pipeline saw all N records. Worker
        stages (``<name>.w<idx>`` — the parallel host-IO pools) keep the
        per-worker counts they accumulated themselves — INCLUDING a
        byte-only zero (e.g. ``inflate.wN``): each worker saw only its
        share, and assigning the run total to k workers would inflate the
        merged family's records (and its reported standalone v/s) k-fold
        in ``vctpu obs bottleneck``."""
        for name, s in self._stages.items():
            if not s.records and not _WORKER_STAGE_RE.search(name):
                s.records = n

    def emit(self, wall_s: float, records: int | None = None) -> None:
        """Write the attribution into the open obs stream: one
        ``profile``/``stage`` event per stage (executor order is not
        meaningful here — ``vctpu obs bottleneck`` sorts by work share)
        plus the ``profile``/``pipeline`` wall event the roll-up divides
        by."""
        if records is not None:
            self.set_records(records)
        if not obs.active():
            return
        total_in = total_out = 0
        for name in self._stages:
            snap = self._stages[name].snapshot()
            total_in += snap.get("bytes_in", 0)
            total_out += snap.get("bytes_out", 0)
            obs.event("profile", "stage", **snap)
        obs.event("profile", "pipeline", wall_s=round(wall_s, 6),
                  stages=sorted(self._stages),
                  records=records if records is not None else 0,
                  bytes_in=total_in, bytes_out=total_out)


def _rss_bytes() -> int:
    """Current RSS from /proc (Linux); 0 when unreadable (the gauge then
    just never moves — telemetry must not throw)."""
    try:
        with open("/proc/self/statm", "rb") as fh:
            return int(fh.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        return 0


class ResourceSampler(threading.Thread):
    """Daemon thread: RSS + process-CPU utilization watermarks.

    ``proc.rss_mb`` and ``proc.cpu_pct`` gauges update every interval;
    the Gauge keeps the peak, so the metrics snapshot carries the run's
    high-water marks even though only the last sample's value survives.
    ``cpu_pct`` is process CPU time over wall time — >100 means multiple
    cores busy (the streaming executor's whole point), so the watermark
    doubles as a parallelism check against the ``scaling`` bench rows.
    ``proc.cpu_pct.<family>`` gauges break the same utilization down by
    THREAD FAMILY (io pool, pipeline stages, committer, prefetch, obs)
    from the per-task CPU clocks in ``/proc/self/task`` — the obs v3
    per-thread accounting, visible in snapshots and ``vctpu obs prom``.
    """

    def __init__(self, run, interval_s: float | None = None):
        super().__init__(name="obs-sampler", daemon=True)
        # NB: attribute names must dodge the Thread API (run/_stop are
        # Thread internals)
        self.obs_run = run
        self.interval_s = (knobs.get_float(SAMPLE_ENV)
                           if interval_s is None else interval_s)
        self._halt = threading.Event()
        self.samples = 0
        # run-start baseline: the final sample in stop() measures the
        # WHOLE run against it, so a run shorter than one interval still
        # gets a real CPU utilization (the gauge keeps the peak of both)
        self._t0 = time.perf_counter()
        self._cpu0 = time.process_time()
        # per-thread-FAMILY cpu baselines (obs v3 satellite): cumulative
        # /proc/self/task cpu seconds per family at the previous scan,
        # so a utilization gauge per family (proc.cpu_pct.<family>) can
        # ride next to the process-wide one. Scanned on its OWN slower
        # cadence (~1s): the scan enumerates threads + reads /proc per
        # thread, too heavy for the 0.05s watermark tick
        self._fam_prev: dict[str, float] = self._family_cpu()
        self._fam_t_prev = time.perf_counter()

    @staticmethod
    def _family_cpu() -> dict[str, float]:
        from variantcalling_tpu_torch.obs import sampler as sampler_mod

        try:
            return sampler_mod.family_cpu_seconds()
        except Exception:  # noqa: BLE001
            return {}

    def sample_once(self, t_prev: float, cpu_prev: float) -> tuple[float, float]:
        t_now = time.perf_counter()
        cpu_now = time.process_time()
        rss = _rss_bytes()
        if rss:
            self.obs_run.metrics.gauge("proc.rss_mb").set(
                round(rss / (1 << 20), 2))
        dt = t_now - t_prev
        if dt > 0:
            self.obs_run.metrics.gauge("proc.cpu_pct").set(
                round(100.0 * (cpu_now - cpu_prev) / dt, 1))
        # per-thread-family utilization from the per-task CPU clocks
        # (pool workers / pipeline stages / committer / prefetch /
        # obs): the same family spellings the continuous profiler
        # attributes samples to, exported as gauges so snapshots and
        # `vctpu obs prom` carry per-family series mid-run. Own ~1s
        # cadence — see __init__.
        fam_dt = t_now - self._fam_t_prev
        # the final stop() sample forces a scan even below the ~1s
        # cadence — a sub-second run still gets its per-family
        # watermark — but never over a window shorter than 0.25s: the
        # per-task clocks tick at 10ms, and dividing one quantum by a
        # tiny window would commit a 20-40% phantom peak to the
        # peak-keeping gauge
        if fam_dt >= 0.25 and (fam_dt >= 1.0 or self._halt.is_set()):
            fam_now = self._family_cpu()
            for family, cpu_s in fam_now.items():
                prev = self._fam_prev.get(family)
                if prev is not None and cpu_s >= prev:
                    self.obs_run.metrics.gauge(
                        f"proc.cpu_pct.{family}").set(
                        round(100.0 * (cpu_s - prev) / fam_dt, 1))
            self._fam_prev = fam_now
            self._fam_t_prev = t_now
        self.samples += 1
        return t_now, cpu_now

    def run(self) -> None:  # noqa: A003 — Thread API
        t_prev, cpu_prev = time.perf_counter(), time.process_time()
        while not self._halt.wait(self.interval_s):
            t_prev, cpu_prev = self.sample_once(t_prev, cpu_prev)

    def stop(self) -> None:
        """Stop sampling, take one final sample, and emit the watermark
        event (called by ``obs.end_run`` before the metrics snapshot so
        the peaks land in it)."""
        self._halt.set()
        self.join(timeout=2.0)
        # final sample: whole-run averages against the start baseline —
        # catches a run shorter than one interval, and the gauges keep
        # the max of this and every periodic sample
        self.sample_once(self._t0, self._cpu0)
        g_rss = self.obs_run.metrics.gauge("proc.rss_mb")
        g_cpu = self.obs_run.metrics.gauge("proc.cpu_pct")
        obs.event("profile", "resources", rss_peak_mb=g_rss.peak,
                  cpu_peak_pct=g_cpu.peak, samples=self.samples,
                  interval_s=self.interval_s)


# ---------------------------------------------------------------------------
# the scoring program's counted work (the forest kernel's bound)
# ---------------------------------------------------------------------------


def record_scoring_cost(strategy: str, kernel, n_variants: int) -> None:
    """Emit the run's ``profile``/``cost_analysis`` event: the bytes and
    operations that ``kernel`` (a ``WideForestKernel`` or
    ``TreeStepKernel`` of ``models/forest_cuda``) needs for ``n_variants``
    rows, counted by its ``work`` (:func:`forest_cuda.scoring_work`), with
    the least time the H100 could take for them and the variants a second
    that bound allows.

    Emitted ONCE per (run, strategy), after the first table that scored:
    the run's chunks share the forest, so one count stands for the run. No
    card work: the count reads the tables' sizes only."""
    if not enabled():
        return
    run = obs.current()
    if run is None or (strategy, "cost") in run.cost_recorded:
        return
    run.cost_recorded.add((strategy, "cost"))
    from variantcalling_tpu_torch.utils import degrade

    try:
        work = kernel.work(int(n_variants))
    except Exception as e:  # noqa: BLE001 — attribution is telemetry, never fatal
        degrade.record("obs.cost_analysis", e,
                       fallback="no scoring-cost attribution for this run")
        return
    fields = {"flops": float(work["ops"]), "bytes_accessed": float(work["bytes"]),
              "strategy": strategy, "n": int(n_variants),
              "bound_ms": round(work["bound_ms"], 6), "bound_by": work["bound_by"]}
    if n_variants > 0 and work["ops"] > 0:
        fields["flops_per_variant"] = round(work["ops"] / n_variants, 1)
        # the variants a second the card reaches at its bound (memory rate
        # or float32 peak, whichever takes longer)
        fields["roofline_vps_h100"] = round(n_variants / (work["bound_ms"] / 1e3))
    obs.event("profile", "cost_analysis", **fields)


# ---------------------------------------------------------------------------
# the device trace (VCTPU_OBS_JAXPROF): the card's kernels and busy time
# ---------------------------------------------------------------------------


def _without_arguments(name: str) -> str:
    """A demangled kernel name without its trailing argument list: the
    balanced parenthesized group at its end (the name itself may hold
    parentheses, as ``(anonymous namespace)::kernel(float const*)``)."""
    name = name.strip()
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i].strip() or name
    return name


def device_trace_summary(path: str) -> dict:
    """The card's work in a ``torch.profiler`` Chrome trace (the device
    trace ``obs`` writes into ``<run log>.jaxprof/``): the kernel events by
    kernel name (without its argument list), their summed time, and
    the card's busy seconds — the union of the kernel intervals, so two
    kernels that overlap count once. Times in seconds."""
    import json

    with open(path, encoding="utf-8") as fh:
        events = json.load(fh).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    by_name: dict[str, int] = {}
    for e in kernels:
        name = _without_arguments(str(e.get("name", "")))
        by_name[name] = by_name.get(name, 0) + 1
    busy = 0.0
    end = None
    for start, stop in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels):
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return {"kernel_events": len(kernels), "kernels": by_name,
            "kernel_s": sum(float(e["dur"]) for e in kernels) / 1e6, "busy_s": busy / 1e6}
