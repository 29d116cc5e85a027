"""Continuous in-process sampling profiler: whole-process CPU truth.

Counterpart of ``variantcalling_tpu/obs/sampler.py``, the same module. The
stage profiler attributes wall-clock to the stage bodies it was told
about, and the critical-path engine walks per-chunk wait edges; neither
can say what the cores were doing while a chunk waited. This module
samples the process:

- :class:`CpuSampler` — a daemon thread (``vctpu-sampler``) that every
  ``1/VCTPU_OBS_CPUPROF_HZ`` seconds snapshots ``sys._current_frames()``
  plus each thread's **CPU clock** (``/proc/self/task/<tid>/stat``,
  fds held open, read with a GIL-keeping ``pread``) and folds the
  result into collapsed form — each thread's LEAF frame every tick,
  whole stacks every :data:`STACK_EVERY`-th tick (the walk is the one
  body long enough to risk a mid-GIL-hold deschedule on a saturated
  host). Each sample is classified:

  * ``native`` — the thread is inside a registered **native span**
    (:class:`native_span` — every entry of the native host engine,
    ``native/__init__.py``), kernel state ``R`` at the instant *and* its CPU
    clock advanced: off-GIL native compute. The Python leaf is overlaid
    with ``[native:<name>]`` so flames show the native frame that owns
    the samples.
  * ``gil`` — no native span, state ``R`` with the CPU clock advanced:
    the thread is running Python bytecode (which holds the GIL) or
    GIL-releasing numpy inside a Python frame; either way the frame
    shown is the code that owns the core. (Both on-CPU categories
    require state ``R`` at the sample instant — clock-advance alone
    would attribute an earlier burst to whatever frame the thread is
    parked in now.)
  * ``runnable`` — state ``R`` but the CPU clock did NOT advance: the
    thread *wants* a core and is waiting for one (or for the GIL) —
    the CPU-pressure category.
  * ``wait`` — blocked (lock, queue, IO, condition): the frame shown is
    what it is blocked *in*.

- every thread family is attributed by an explicit registration
  (:func:`register_current` — pool workers, pipeline stages, the
  committer) with a name-based fallback (:func:`classify`), so samples
  always land somewhere meaningful;
- folded stacks emit as schema'd ``sample`` events in bounded windows
  (:data:`EMIT_EVERY_S`), each carrying ``win_t0`` so readers can join
  samples against trace-span wait intervals (:func:`explain_waits` —
  the "cores were running X during this wait edge" join the
  critical-path engine surfaces);
- exporters: :func:`to_speedscope` / :func:`collapsed_lines`
  (``vctpu obs flame``), :func:`diff_folds` (``obs flame --diff A B``,
  the before/after bench comparison), and :func:`cpuledger` — the
  **measured** cpu-seconds-per-1M-variants-per-stage ledger
  (``obs cpuledger``).

Knobs: ``VCTPU_OBS_CPUPROF=1`` (with ``VCTPU_OBS=1``) starts the
sampler for the run; ``VCTPU_OBS_CPUPROF_HZ`` sets the rate. The
default (7 Hz) is deliberately conservative: every tick must hold the
GIL briefly, and on a saturated host the tax grows about linearly with
the rate. Hosts with spare cores can raise the rate freely — the
sampler's own thread then rides an idle core. Off, the only cost anywhere is one
module-bool check at the native-span sites.

Lock discipline: the family registry is written under ``_REG_LOCK``;
the native-span table is per-thread-key dict item assignment (the
obs/metrics pattern — GIL-atomic, each thread writes only its own key,
the sampler thread only reads).
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time

from variantcalling_tpu_torch import knobs, obs

CPUPROF_ENV = "VCTPU_OBS_CPUPROF"
HZ_ENV = "VCTPU_OBS_CPUPROF_HZ"

#: seconds per fold window: the sampler flushes its fold table on this
#: cadence, so every emitted ``sample`` event covers a bounded window
#: (``win_t0`` .. envelope ``t``) — the join key for wait-edge
#: reconciliation — and the table never grows with run length
EMIT_EVERY_S = 2.0

#: distinct stacks kept per window; overflow folds into one
#: ``(truncated)`` bucket per (family, category) so a pathological
#: stack churn bounds event volume instead of exploding it
MAX_STACKS_PER_WINDOW = 400

#: frames kept per stack (root-most dropped first — the leaf is the
#: attribution signal)
MAX_DEPTH = 48

#: full-stack ticks are DECIMATED: every tick samples each thread's
#: LEAF frame (cheap — a few bytecodes per thread), and every Nth tick
#: walks whole stacks. A long GIL-held tick body is the profiler's real
#: hazard on a saturated host — the OS can deschedule the sampler
#: MID-BODY with the GIL held, stalling every Python-needing thread for
#: a scheduling period — so the expensive walk runs at ~1/N the rate
#: while the ledger/wait-attribution (leaf-driven) keep the full rate
STACK_EVERY = 8

#: sample categories that represent a core actually consumed —
#: the cpu-ledger numerator
CPU_CATEGORIES = ("gil", "native")

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100

# GIL-KEEPING pread for the per-tick clock reads: ``os.pread`` releases
# the GIL around its syscall, so N threads × hz reads/s means hundreds
# of forced GIL handoffs per second on a small host. ``ctypes.PyDLL`` calls do NOT release the GIL: a /proc stat read
# is ~2µs, so holding the GIL across it turns the whole tick into ONE
# short hold instead of a convoy of release/reacquire cycles.
try:
    import ctypes as _ctypes

    _libc = _ctypes.PyDLL(None)
    _libc.pread.restype = _ctypes.c_ssize_t
    _libc.pread.argtypes = [_ctypes.c_int, _ctypes.c_void_p,
                            _ctypes.c_size_t, _ctypes.c_long]
    _PREAD_BUF = _ctypes.create_string_buffer(1024)

    def _pread_stat(fd: int) -> bytes | None:
        n = _libc.pread(fd, _PREAD_BUF, 1024, 0)
        return _PREAD_BUF.raw[:n] if n > 0 else None
except Exception:  # noqa: BLE001
    def _pread_stat(fd: int) -> bytes | None:
        try:
            raw = os.pread(fd, 1024, 0)
        except OSError:
            return None
        return raw or None

#: fast flag native-span sites check before touching the table
_SAMPLING = False

#: kernel tid -> open native-span name. Each worker thread writes only
#: its own key; the sampler thread reads.
_NATIVE_SPANS: dict[int, str] = {}

#: kernel tid -> registered thread family (register_current); written
#: under _REG_LOCK (threads register once at start-of-life, never hot)
_FAMILIES: dict[int, str] = {}
_REG_LOCK = threading.Lock()


def register_current(family: str) -> None:
    """Attribute the calling thread's samples to ``family`` (pool
    workers, pipeline stage workers and the committer register
    themselves; unregistered threads fall back to :func:`classify`).
    Cheap and unconditional — one dict write per thread lifetime."""
    try:
        tid = threading.get_native_id()
    except (AttributeError, OSError):  # exotic platform: fallback naming
        return
    with _REG_LOCK:
        _FAMILIES[tid] = family


def classify(name: str) -> str:
    """Thread family from a thread NAME — the fallback for threads that
    never called :func:`register_current` (matches the executor/pool
    naming conventions, docs/observability.md)."""
    if name.startswith("vctpu-io"):
        return "io"
    if name.startswith("vctpu-mesh"):
        return "mesh"
    if name.startswith(("vctpu-sampler", "obs-sampler")):
        return "obs"
    if name == "pipe-src":
        return "pipe.src"
    if name.startswith("pipe-stage"):
        return "pipe.stage"
    if name == "genome-prefetch":
        return "prefetch"
    if name == "MainThread":
        return "main"
    return "other"


class native_span:
    """Marks the calling thread as inside a named native call for the
    sampler's overlay (``native/__init__.py`` wraps every entry point
    of the host engine).

    A native call releases the GIL, so the Python frame the sampler
    sees is frozen at the call site; the overlay names the native frame
    that actually owns the samples. One module-bool check when the
    sampler is off."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _SAMPLING:
            # per-thread key item assignment — GIL-atomic, sampler reads
            _NATIVE_SPANS[threading.get_native_id()] = self.name
        return self

    def __exit__(self, *exc):
        # unconditional pop (guarded by emptiness): a sampler stopping
        # mid-span must not leave a stale overlay for the next run
        if _NATIVE_SPANS:
            _NATIVE_SPANS.pop(threading.get_native_id(), None)
        return False


def _parse_stat(raw: bytes) -> tuple[float, str] | None:
    """(cpu seconds, kernel run state) from a ``/proc/.../stat`` read."""
    try:
        # comm may contain spaces/parens: split after the LAST ')'
        rest = raw.rsplit(b")", 1)[1].split()
        state = rest[0].decode("ascii", "replace")
        utime, stime = int(rest[11]), int(rest[12])
    except (IndexError, ValueError):
        return None
    return (utime + stime) / _CLK_TCK, state


def _task_stat(tid: int) -> tuple[float, str] | None:
    """(cpu seconds, kernel run state) of one kernel thread from
    ``/proc/self/task/<tid>/stat``; None when unreadable (thread died,
    or not Linux — callers then degrade to wall-only sampling)."""
    try:
        with open(f"/proc/self/task/{tid}/stat", "rb") as fh:
            raw = fh.read()
    except OSError:
        return None
    return _parse_stat(raw)


def thread_families() -> dict[int, str]:
    """kernel tid -> family for every live Python thread (registered
    name first, thread-name classification as the fallback). Registry
    entries of DEAD tids are pruned here — the kernel reuses tids, and
    a stale entry would book an unrelated new thread's samples under a
    long-gone worker's family."""
    out: dict[int, str] = {}
    live: set[int] = set()
    with _REG_LOCK:
        registered = dict(_FAMILIES)
    for t in threading.enumerate():
        tid = getattr(t, "native_id", None)
        if tid is None:
            continue
        live.add(tid)
        out[tid] = registered.get(tid) or classify(t.name)
    dead = set(registered) - live
    if dead:
        with _REG_LOCK:
            for tid in dead:
                _FAMILIES.pop(tid, None)
    return out


def family_cpu_seconds() -> dict[str, float]:
    """Cumulative CPU seconds per thread family right now — the
    substrate for the ResourceSampler's per-family ``proc.cpu_pct.*``
    gauges (obs/profile.py). Families of dead threads age out with the
    threads; callers diff successive snapshots."""
    out: dict[str, float] = {}
    for tid, family in thread_families().items():
        stat = _task_stat(tid)
        if stat is None:
            continue
        out[family] = out.get(family, 0.0) + stat[0]
    return out


def _frame_label(frame) -> str:
    """``module:function`` with the package prefix stripped — short
    enough for collapsed stacks, unambiguous enough to click through."""
    mod = frame.f_globals.get("__name__", "?")
    if mod.startswith("variantcalling_tpu_torch."):
        mod = mod[len("variantcalling_tpu_torch."):]
    return f"{mod}:{frame.f_code.co_name}"


class CpuSampler(threading.Thread):
    """The continuous profiler: one daemon thread sampling every live
    thread's stack + CPU clock at ``hz``, folding into ``sample``
    events on the open obs run (started by ``obs.start_run`` when
    ``VCTPU_OBS_CPUPROF=1``, stopped — with a final flush and a
    ``profile``/``cpuprof`` summary event — by ``obs.end_run``)."""

    #: seconds between thread-list refreshes: ``threading.enumerate`` +
    #: family resolution move OFF the per-tick path (vctpu threads are
    #: long-lived pools/stages; a thread born mid-window starts being
    #: sampled at the next refresh)
    REFRESH_S = 0.5

    def __init__(self, run, hz: float | None = None):
        super().__init__(name="vctpu-sampler", daemon=True)
        self.obs_run = run
        self.hz = knobs.get_float(HZ_ENV) if hz is None else float(hz)
        self.interval_s = 1.0 / max(self.hz, 0.001)
        self._halt = threading.Event()
        self.samples = 0
        self.cpu_samples = 0
        #: achieved ticks + wall span: GIL-held Python bursts DELAY the
        #: sampler past its nominal interval, so seconds-per-sample is
        #: ``elapsed/ticks`` (measured), never ``1/hz`` (aspirational) —
        #: the ledger and the summary both use the achieved rate
        self.ticks = 0
        self._t_started = time.perf_counter()
        #: whole-process CPU clock at start: the ledger calibrates its
        #: totals against the kernel's own accounting (sampling is
        #: biased AWAY from GIL-held bursts — the sampler cannot run
        #: during exactly the moments Python is busiest — so sampled
        #: totals undercount; the clock cannot)
        t = os.times()
        self._proc_cpu0 = t[0] + t[1]
        self._threads_seen: set[int] = set()
        #: kernel tid -> last-seen cumulative cpu seconds
        self._cpu_prev: dict[int, float] = {}
        #: (family, category, stack tuple) -> count, current window
        self._fold: dict[tuple, int] = {}
        self._win_t0 = self._now()
        self._last_emit = time.perf_counter()
        #: family -> cpu-category sample count (whole run, the summary)
        self._family_cpu: dict[str, int] = {}
        # -- per-tick cost containment: the tick body runs UNDER the
        # GIL, so every avoidable allocation/syscall directly stalls
        # GIL-needing workload threads
        #: code object -> "module:function" label (frames repeat the
        #: same code objects tick after tick — label building happens
        #: once per code object, not once per frame per tick)
        self._label_cache: dict = {}
        #: kernel tid -> open /proc/self/task/<tid>/stat fd: ONE pread
        #: per thread per tick instead of open+read+close
        self._stat_fds: dict[int, int] = {}
        #: cached (python ident, kernel tid, family) rows, refreshed on
        #: REFRESH_S — never enumerated per tick
        self._threads: list[tuple[int, int | None, str]] = []
        self._last_refresh = 0.0

    def _now(self) -> float:
        """Run-relative time on the stream's own clock (the join key
        wait-edge reconciliation uses must match the envelope ``t``)."""
        return time.perf_counter() - self.obs_run._t0_mono

    def _refresh_threads(self) -> None:
        """Rebuild the sampled-thread cache (every REFRESH_S, off the
        per-tick path): enumerate live threads, resolve families, open
        missing /proc stat fds, drop dead ones."""
        my_ident = threading.get_ident()
        with _REG_LOCK:
            registered = dict(_FAMILIES)
        rows: list[tuple[int, int | None, str]] = []
        live: set[int] = set()
        for t in threading.enumerate():
            ident = t.ident
            tid = getattr(t, "native_id", None)
            if ident is None or ident == my_ident:
                continue
            family = (registered.get(tid) if tid is not None else None) \
                or classify(t.name)
            rows.append((ident, tid, family))
            if tid is not None:
                live.add(tid)
                self._threads_seen.add(tid)
                if tid not in self._stat_fds:
                    try:
                        self._stat_fds[tid] = os.open(
                            f"/proc/self/task/{tid}/stat", os.O_RDONLY)
                    except OSError:
                        pass  # not Linux / thread died: wall-only below
        self._threads = rows
        # prune registry entries of dead tids (tid reuse would book a
        # new unrelated thread under a long-gone worker's family)
        dead = set(registered) - live
        if dead:
            with _REG_LOCK:
                for tid in dead:
                    _FAMILIES.pop(tid, None)
        for tid in list(self._stat_fds):
            if tid not in live:
                try:
                    os.close(self._stat_fds.pop(tid))
                except OSError:
                    pass
        for tid in list(self._cpu_prev):
            if tid not in live:
                del self._cpu_prev[tid]

    def _close_fds(self) -> None:
        for tid in list(self._stat_fds):
            try:
                os.close(self._stat_fds.pop(tid))
            except OSError:
                pass

    def _stack_of(self, frame, overlay: str | None) -> tuple:
        cache = self._label_cache
        rev: list[str] = []
        f = frame
        while f is not None and len(rev) < MAX_DEPTH:
            code = f.f_code
            label = cache.get(code)
            if label is None:
                cache[code] = label = _frame_label(f)
            rev.append(label)
            f = f.f_back
        rev.reverse()  # root first, leaf last — collapsed-stack order
        if overlay is not None:
            rev.append(f"[native:{overlay}]")
        return tuple(rev)

    def sample_once(self) -> None:
        """One tick: snapshot frames + per-thread CPU clocks (one pread
        each, fds held open), classify, fold. The body is deliberately
        allocation-light — it runs under the GIL, so every wasted
        microsecond here stalls a workload thread. Never raises — the
        profiler observes, it must not kill the run."""
        now = time.perf_counter()
        if now - self._last_refresh >= self.REFRESH_S:
            self._last_refresh = now
            self._refresh_threads()
        frames = sys._current_frames()
        self.ticks += 1
        full_stacks = self.ticks % STACK_EVERY == 1
        fold = self._fold
        cache = self._label_cache
        spans = _NATIVE_SPANS
        for ident, tid, family in self._threads:
            frame = frames.get(ident)
            if frame is None:
                continue
            ran = False
            state = ""
            fd = self._stat_fds.get(tid) if tid is not None else None
            if fd is not None:
                raw = _pread_stat(fd)  # GIL kept: no handoff per read
                stat = _parse_stat(raw) if raw else None
                if stat is not None:
                    cpu_now, state = stat
                    prev = self._cpu_prev.get(tid)
                    self._cpu_prev[tid] = cpu_now
                    ran = prev is not None and cpu_now > prev
                else:
                    ran = True  # wall-only degradation: book as on-CPU
            elif tid is not None:
                # /proc unavailable (not Linux): honest wall-only
                # degradation — everything books as on-CPU
                ran = True
            overlay = spans.get(tid) if tid is not None else None
            # on-CPU needs BOTH signals: kernel state R at the sample
            # instant AND the thread's CPU clock advanced over the
            # interval — clock-advance alone would attribute an earlier
            # burst to whatever frame the thread is parked in NOW (the
            # "threading:wait ran hot" artifact); state R alone is just
            # runnable (waiting for a core or the GIL)
            if ran and (state == "R" or not state):
                cat = "native" if overlay is not None else "gil"
                self.cpu_samples += 1
                self._family_cpu[family] = self._family_cpu.get(family, 0) + 1
            elif state == "R":
                cat = "runnable"
            else:
                cat = "wait"
            if full_stacks:
                stack = self._stack_of(frame, overlay)
            else:
                # leaf-only tick: minimum bytecodes under the GIL
                code = frame.f_code
                label = cache.get(code)
                if label is None:
                    cache[code] = label = _frame_label(frame)
                stack = (label,) if overlay is None \
                    else (label, f"[native:{overlay}]")
            key = (family, cat, stack)
            if key not in fold and len(fold) >= MAX_STACKS_PER_WINDOW:
                key = (family, cat, ("(truncated)",))
            fold[key] = fold.get(key, 0) + 1
            self.samples += 1

    def _flush(self) -> None:
        """Emit the window's fold as ``sample`` events and open the
        next window."""
        fold, self._fold = self._fold, {}
        win_t0 = self._win_t0
        self._win_t0 = self._now()
        for (family, cat, stack), n in sorted(fold.items(),
                                              key=lambda kv: -kv[1]):
            obs.event("sample", family, stack=";".join(stack), n=n,
                      cat=cat, family=family, win_t0=round(win_t0, 6))

    def run(self) -> None:  # noqa: A003 — Thread API
        global _SAMPLING
        _SAMPLING = True
        try:
            while not self._halt.wait(self.interval_s):
                try:
                    self.sample_once()
                except Exception:  # noqa: BLE001
                    pass
                if time.perf_counter() - self._last_emit >= EMIT_EVERY_S:
                    self._last_emit = time.perf_counter()
                    self._flush()
        finally:
            _SAMPLING = False
            self._close_fds()

    def stop(self) -> None:
        """Halt, final-flush, and emit the ``profile``/``cpuprof``
        summary (called by ``obs.end_run`` while the stream still
        accepts events)."""
        self._halt.set()
        self.join(timeout=2.0)
        self._flush()
        elapsed = max(time.perf_counter() - self._t_started, 1e-9)
        # MEASURED seconds each tick stands for: GIL-held bursts starve
        # the sampler below its nominal rate, and dividing by nominal hz
        # would then undercount CPU seconds by exactly the starvation
        spt = elapsed / self.ticks if self.ticks else 1.0 / self.hz
        cpu_s = {f: round(n * spt, 6)
                 for f, n in sorted(self._family_cpu.items())}
        t = os.times()
        obs.event("profile", "cpuprof", hz=self.hz,
                  interval_s=round(self.interval_s, 6),
                  samples=self.samples, cpu_samples=self.cpu_samples,
                  ticks=self.ticks, elapsed_s=round(elapsed, 6),
                  effective_hz=round(self.ticks / elapsed, 2),
                  threads=len(self._threads_seen),
                  cpu_s_total=round(self.cpu_samples * spt, 6),
                  proc_cpu_s=round(t[0] + t[1] - self._proc_cpu0, 6),
                  families=cpu_s)


# ---------------------------------------------------------------------------
# readers: fold / flame / diff / ledger (the `vctpu obs flame|cpuledger`
# substrate — pure functions over a parsed obs event list)
# ---------------------------------------------------------------------------


def fold_events(events: list[dict]) -> dict[tuple, int]:
    """Merge every ``sample`` event back into one
    ``(family, cat, stack string) -> samples`` fold table."""
    fold: dict[tuple, int] = {}
    for e in events:
        if e.get("kind") != "sample":
            continue
        key = (e.get("family", "?"), e.get("cat", "?"), e.get("stack", ""))
        fold[key] = fold.get(key, 0) + int(e.get("n", 0))
    return fold


def profiled_rate(events: list[dict]) -> tuple[float, float, float] | None:
    """``(nominal hz, measured seconds-per-sample, process cpu-s)``
    from the log's ``profile``/``cpuprof`` summaries, or None when the
    run never sampled. Seconds-per-sample is ``elapsed/ticks`` when the
    summary recorded the achieved rate (GIL starvation makes nominal
    1/hz undercount); ``1/hz`` is the legacy fallback. The process
    cpu-seconds (0 when absent) calibrate the ledger's totals.

    Multi-rank merged timelines (``export.read_run``): each rank wrote
    its own summary — the LAST summary per rank is aggregated (cpu
    seconds and ticks/elapsed SUM across ranks, matching the summed
    sample fold), so the ledger stays correct on a merged log."""
    last_by_rank: dict = {}
    for e in events:
        if e.get("kind") == "profile" and e.get("name") == "cpuprof" \
                and isinstance(e.get("hz"), (int, float)) and e["hz"] > 0:
            last_by_rank[e.get("rank", 0)] = e
    if not last_by_rank:
        return None
    hz = float(next(iter(last_by_rank.values()))["hz"])
    proc = ticks = elapsed = 0.0
    legacy_spt: float | None = None
    for e in last_by_rank.values():
        p = e.get("proc_cpu_s")
        if isinstance(p, (int, float)) and p > 0:
            proc += float(p)
        t, el = e.get("ticks"), e.get("elapsed_s")
        if isinstance(t, int) and t > 0 \
                and isinstance(el, (int, float)) and el > 0:
            ticks += t
            elapsed += el
        else:
            legacy_spt = 1.0 / float(e["hz"])
    spt = elapsed / ticks if ticks else (legacy_spt or 1.0 / hz)
    return hz, spt, proc


def collapsed_lines(events: list[dict]) -> list[str]:
    """Brendan-Gregg collapsed-stack text: ``family;cat;frame;...;leaf
    N`` per line, heaviest first — feed to any flamegraph tool."""
    fold = fold_events(events)
    return [f"{family};{cat};{stack} {n}"
            for (family, cat, stack), n in
            sorted(fold.items(), key=lambda kv: -kv[1])]


def to_speedscope(events: list[dict], name: str = "vctpu") -> dict | None:
    """The https://speedscope.app sampled-profile JSON of a log's
    ``sample`` events (one profile per category, shared frame table);
    None when the log holds no samples."""
    fold = fold_events(events)
    if not fold:
        return None
    frame_index: dict[str, int] = {}
    frames: list[dict] = []

    def fidx(label: str) -> int:
        i = frame_index.get(label)
        if i is None:
            i = frame_index[label] = len(frames)
            frames.append({"name": label})
        return i

    by_cat: dict[str, tuple[list, list]] = {}
    for (family, cat, stack), n in sorted(fold.items(),
                                          key=lambda kv: -kv[1]):
        samples, weights = by_cat.setdefault(cat, ([], []))
        labels = [family] + [s for s in stack.split(";") if s]
        samples.append([fidx(x) for x in labels])
        weights.append(n)
    profiles = []
    for cat in sorted(by_cat):
        samples, weights = by_cat[cat]
        profiles.append({
            "type": "sampled", "name": f"{name} [{cat}]",
            "unit": "none", "startValue": 0, "endValue": sum(weights),
            "samples": samples, "weights": weights,
        })
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "name": name,
        "shared": {"frames": frames},
        "profiles": profiles,
    }


def _frame_weights(events: list[dict],
                   cpu_only: bool = True) -> tuple[dict[str, int], int]:
    """Per-frame SELF sample weight (the leaf owns the sample) plus the
    total — the unit ``flame --diff`` ranks."""
    weights: dict[str, int] = {}
    total = 0
    for (family, cat, stack), n in fold_events(events).items():
        if cpu_only and cat not in CPU_CATEGORIES:
            continue
        leaf = stack.rsplit(";", 1)[-1] if stack else f"({family})"
        weights[leaf] = weights.get(leaf, 0) + n
        total += n
    return weights, total


def diff_folds(candidate: list[dict], baseline: list[dict],
               top: int = 20) -> dict:
    """The ``obs flame --diff A B`` report: per-frame CPU self-share in
    the candidate vs the baseline (shares, so runs of different length
    compare), ranked by absolute share delta. An attribution report,
    not a gate."""
    cw, ct = _frame_weights(candidate)
    bw, bt = _frame_weights(baseline)
    if not ct or not bt:
        return {"frames": [], "candidate_cpu_samples": ct,
                "baseline_cpu_samples": bt,
                "note": "one of the logs holds no CPU samples"}
    rows = []
    for frame in set(cw) | set(bw):
        c_share = 100.0 * cw.get(frame, 0) / ct
        b_share = 100.0 * bw.get(frame, 0) / bt
        rows.append({"frame": frame,
                     "candidate_pct": round(c_share, 2),
                     "baseline_pct": round(b_share, 2),
                     "delta_pct": round(c_share - b_share, 2)})
    rows.sort(key=lambda r: -abs(r["delta_pct"]))
    return {"candidate_cpu_samples": ct, "baseline_cpu_samples": bt,
            "frames": rows[:max(1, top)]}


def render_diff(report: dict) -> str:
    if not report["frames"]:
        return report.get("note", "no samples to diff")
    lines = [f"flame diff (CPU self-share per frame; candidate "
             f"{report['candidate_cpu_samples']} vs baseline "
             f"{report['baseline_cpu_samples']} cpu samples):"]
    width = max(len(r["frame"]) for r in report["frames"])
    lines.append(f"  {'frame':<{width}}  {'base%':>7} {'cand%':>7} "
                 f"{'delta':>7}")
    for r in report["frames"]:
        lines.append(f"  {r['frame']:<{width}}  {r['baseline_pct']:>7.2f} "
                     f"{r['candidate_pct']:>7.2f} {r['delta_pct']:>+7.2f}")
    return "\n".join(lines)


# -- the measured cpu-budget ledger ----------------------------------------

#: stage attribution markers, matched LEAF-FIRST against each stack's
#: frames: the first frame (from the leaf) matching a pattern names the
#: stage. Mirrors the docs/perf_notes.md budget-table rows; frames that
#: match nothing book under their thread family as ``other.<family>``.
STAGE_MARKERS: tuple[tuple[str, re.Pattern], ...] = tuple(
    (stage, re.compile(pat)) for stage, pat in (
        ("score", r"fused_chunk_score|score_table|score_stage|"
                  r"predict_margin|forest_predict|megabatch"),
        ("parse", r"parse_chunk|iter_raw|bgzf_inflate|_inflate|"
                  r"scan_block|read_chunk|VcfChunkReader|:_scan|"
                  r"_table_from_parsed|vcf_parse"),
        ("featurize", r"host_features|featurize|build_matrix|classify_vcf"),
        ("render", r"render_stage|render_table_bytes|assemble_table_bytes|"
                   r"format_float"),
        ("compress", r"bgzf_deflate|compress_stage|BgzfChunkCompressor|"
                     r"bgzf_compress"),
        ("commit", r"_sink_write|journal|writeback|filter_variants:attempt"),
        ("prefetch", r"encode_all|fasta_encode|_encode_contig"),
        ("obs", r"obs\.|obs/|:_emit|:snapshot"),
    ))


#: family -> ledger stage when no frame marker matches: a family whose
#: every CPU second belongs to one budget row by construction books
#: there even when the sampled frame is glue (heartbeats, journal
#: bookkeeping on the committer thread)
_FAMILY_STAGES = {"committer": "commit", "prefetch": "prefetch",
                  "obs": "obs"}


def _stage_of(stack: str, family: str) -> str:
    for frame in reversed(stack.split(";")):
        for stage, pat in STAGE_MARKERS:
            if pat.search(frame):
                return stage
    return _FAMILY_STAGES.get(family, f"other.{family}")


def _records_of(events: list[dict]) -> int:
    """Total records the log's run(s) processed: the final metrics
    snapshot's ``records`` counter (counters accumulate across every
    pipeline run recorded into one stream), heartbeat fallback. On a
    multi-rank merged timeline each rank reported its own counter —
    the last metrics event PER RANK sums (the read_run rule)."""
    last_by_rank: dict = {}
    for e in events:
        if e.get("kind") == "metrics":
            n = (e.get("counters") or {}).get("records")
            if isinstance(n, (int, float)) and n > 0:
                last_by_rank[e.get("rank", 0)] = int(n)
    if last_by_rank:
        return sum(last_by_rank.values())
    last_hb_by_rank: dict = {}
    for e in events:
        if e.get("kind") == "heartbeat":
            last_hb_by_rank[e.get("rank", 0)] = e.get("records", 0)
    return int(sum(last_hb_by_rank.values()))


def cpuledger(events: list[dict]) -> dict | None:
    """The measured cpu-budget ledger: CPU seconds per stage (samples in
    CPU categories / hz, attributed by :data:`STAGE_MARKERS`) and —
    when the log records how many variants the run processed —
    **cpu-s per 1M variants per stage**, the unit docs/perf_notes.md's
    budget table is written in. None when the log holds no samples."""
    rate = profiled_rate(events)
    fold = fold_events(events)
    if rate is None or not fold:
        return None
    hz, spt, proc_cpu_s = rate
    stage_samples: dict[str, int] = {}
    total = 0
    for (family, cat, stack), n in fold.items():
        if cat not in CPU_CATEGORIES:
            continue
        stage = _stage_of(stack, family)
        stage_samples[stage] = stage_samples.get(stage, 0) + n
        total += n
    records = _records_of(events)
    # CALIBRATION: sampled totals systematically undercount GIL-held
    # Python (the sampler cannot run during exactly those moments), so
    # when the summary carries the whole-process CPU clock the totals
    # anchor on it — the kernel's accounting is the truth, the sampled
    # fold provides the per-stage SPLIT
    sampled_s = total * spt
    total_s = proc_cpu_s if proc_cpu_s > 0 else sampled_s
    scale_s = total_s / sampled_s if sampled_s > 0 else 0.0
    out: dict = {
        "hz": hz,
        "effective_hz": round(1.0 / spt, 2),
        "cpu_samples": total,
        "records": records,
        "sampled_cpu_s": round(sampled_s, 4),
        "proc_cpu_s": round(proc_cpu_s, 4),
        "total_cpu_s": round(total_s, 4),
        "stages_cpu_s": {s: round(n * spt * scale_s, 4)
                         for s, n in sorted(stage_samples.items(),
                                            key=lambda kv: -kv[1])},
    }
    if records > 0:
        scale = 1e6 / records
        out["total_cpu_s_per_1m"] = round(total_s * scale, 4)
        out["stages"] = {s: round(n * spt * scale_s * scale, 4)
                         for s, n in sorted(stage_samples.items(),
                                            key=lambda kv: -kv[1])}
    return out


def render_cpuledger(ledger: dict) -> str:
    lines = [f"cpu-budget ledger ({ledger['cpu_samples']} CPU samples at "
             f"{ledger.get('effective_hz', ledger['hz']):g} Hz achieved "
             f"({ledger['hz']:g} nominal) over "
             f"{ledger['records']} records):"]
    if ledger.get("proc_cpu_s"):
        lines.append(f"  totals calibrated on the process CPU clock "
                     f"({ledger['proc_cpu_s']:.3f} cpu-s; sampling alone "
                     f"saw {ledger.get('sampled_cpu_s', 0):.3f} — the "
                     "sampler cannot run during GIL-held bursts)")
    per_1m = ledger.get("stages")
    stages = per_1m if per_1m is not None else ledger["stages_cpu_s"]
    width = max(len(s) for s in stages) if stages else 5
    if per_1m is not None:
        lines.append(f"  {'stage':<{width}}  {'cpu_s':>8}  {'cpu-s/1M':>9}")
        for s in stages:
            lines.append(f"  {s:<{width}}  "
                         f"{ledger['stages_cpu_s'][s]:>8.3f}  "
                         f"{per_1m[s]:>9.4f}")
        lines.append(f"  {'TOTAL':<{width}}  {ledger['total_cpu_s']:>8.3f}  "
                     f"{ledger['total_cpu_s_per_1m']:>9.4f}")
    else:
        lines.append(f"  {'stage':<{width}}  {'cpu_s':>8}")
        for s in stages:
            lines.append(f"  {s:<{width}}  {stages[s]:>8.3f}")
        lines.append("  (no record count in this log — per-1M column "
                     "unavailable)")
    return "\n".join(lines)


def compact_ledger(ledger: dict) -> dict:
    """The compact ledger: flat per-stage cpu-s/1M numbers plus the
    total."""
    out = {"hz": ledger["hz"], "cpu_samples": ledger["cpu_samples"],
           "records": ledger["records"]}
    if "stages" in ledger:
        out["total_cpu_s_per_1m"] = ledger["total_cpu_s_per_1m"]
        out["stages"] = dict(ledger["stages"])
    else:
        out["total_cpu_s"] = ledger["total_cpu_s"]
    return out


# -- wait-edge reconciliation ----------------------------------------------


def explain_waits(events: list[dict],
                  edge_intervals: dict[str, list[tuple[float, float]]],
                  top: int = 5) -> dict[str, dict]:
    """For each named wait edge: which frames were consuming CPU while
    chunks sat on that edge — the "cores were running X" answer the
    critical-path engine attaches to its dominant wait edges.

    ``edge_intervals`` maps edge name -> absolute (run-relative)
    ``(start, end)`` wait intervals (obs/critical.py collects them from
    the trace spans). Sample windows (``win_t0`` .. envelope ``t``)
    overlap-weight against the merged intervals: a sample batch whose
    window half-overlaps the edge's waits contributes half its count.
    Windowed, not exact — but measured, which the analytic budget never
    was."""
    batches = [(float(e.get("win_t0", 0.0)), float(e.get("t", 0.0)),
                e.get("cat"), e.get("stack", ""), int(e.get("n", 0)))
               for e in events if e.get("kind") == "sample"]
    if not batches:
        return {}
    out: dict[str, dict] = {}
    for edge, intervals in edge_intervals.items():
        merged: list[list[float]] = []
        for t0, t1 in sorted(intervals):
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        wait_s = sum(t1 - t0 for t0, t1 in merged)
        if wait_s <= 0:
            continue
        frames: dict[str, float] = {}
        total = 0.0
        for w0, w1, cat, stack, n in batches:
            if cat not in CPU_CATEGORIES or w1 <= w0:
                continue
            overlap = sum(max(0.0, min(w1, t1) - max(w0, t0))
                          for t0, t1 in merged)
            if overlap <= 0:
                continue
            weight = n * (overlap / (w1 - w0))
            leaf = stack.rsplit(";", 1)[-1] if stack else "?"
            frames[leaf] = frames.get(leaf, 0.0) + weight
            total += weight
        if total < 1.0:
            # less than one whole sample overlapped the edge's waits:
            # reporting frames off that would be noise, not measurement
            continue
        ranked = sorted(frames.items(), key=lambda kv: -kv[1])[:top]
        out[edge] = {
            "wait_s": round(wait_s, 6),
            "cpu_samples": round(total, 1),
            "frames": [{"frame": f,
                        "share_pct": round(100.0 * w / total, 1)}
                       for f, w in ranked],
        }
    return out
