"""Typed metrics registry: counters, gauges and bucketed histograms.

Counterpart of ``variantcalling_tpu/obs/metrics.py``, the same module. The
serving daemon records from its handler threads, and the streaming
executor's workers may record while a run is scoring, so the rule is **no
shared lock on the record path**:

- :class:`Counter` keeps one cell per recording thread (dict item
  assignment is atomic under the GIL) and sums the cells when read, so no
  increment is lost to a read-modify-write race between threads;
- :class:`Gauge` is one assignment, with a per-thread peak kept the same way;
- :class:`Histogram` keeps count, sum, min and max, a bounded ring of recent
  samples and a fixed array of :data:`N_BUCKETS` log-spaced buckets from
  1 us to about 10^9, so p50/p95/p99 come with a bounded relative error
  (at most about 4.4 %, half a bucket) and bounded memory; beside the
  cumulative buckets, a rolling window of bucket rings
  (:meth:`Histogram.rolling_quantile`) says what "recent" latency is, which
  the daemon's admission control reads for its early shed.

A registry belongs to one obs run or to one daemon; ``snapshot()`` merges
the per-thread cells.
"""

from __future__ import annotations

import math
import threading
import time

#: recent-sample ring size per histogram per thread (the merged snapshot
#: interleaves threads; 64 per thread bounds memory at any fan-out)
RECENT = 64

#: fixed log-spaced bucket geometry: bucket i's inclusive upper bound is
#: ``HIST_MIN * HIST_FACTOR**i``. FACTOR = 2**0.125 bounds the quantile
#: estimate's relative error at sqrt(FACTOR)-1 ≈ 4.4% (geometric-midpoint
#: reporting, half a bucket) at 400 int cells per recording thread —
#: HDR-histogram resolution without per-sample storage (range 1µs..~10⁹).
HIST_MIN = 1e-6
HIST_FACTOR = 2.0 ** 0.125
N_BUCKETS = 400
_LOG_FACTOR = math.log(HIST_FACTOR)

#: percentiles published in every histogram snapshot (serve-SLO substrate)
SNAPSHOT_QUANTILES = (0.5, 0.95, 0.99)

#: rolling-window geometry: the window is cut into ROLL_SLOTS bucket
#: rings rotated on the monotonic clock; the rolling quantile merges the
#: last ROLL_SLOTS+1 slots (current partial slot included), so "rolling
#: p95" covers between 1x and 1.25x of the configured window — recent by
#: construction, never all-of-run like the cumulative buckets next to it
ROLL_SLOTS = 4

#: default rolling window span in seconds (VCTPU_OBS_WINDOW_S overrides
#: per run via the MetricsRegistry constructor)
DEFAULT_WINDOW_S = 60.0


def bucket_index(v: float) -> int:
    """The fixed bucket a value lands in (0 = underflow, N-1 = overflow)."""
    if v <= HIST_MIN:
        return 0
    idx = int(math.log(v / HIST_MIN) / _LOG_FACTOR) + 1
    return idx if idx < N_BUCKETS else N_BUCKETS - 1


def bucket_bound(i: int) -> float:
    """Bucket ``i``'s inclusive upper bound."""
    return HIST_MIN * HIST_FACTOR ** i


def quantile_from_buckets(buckets: list[int], count: int, q: float) -> float | None:
    """Quantile estimate from a merged bucket-count array: find the
    bucket holding the q-th ranked sample and report its geometric
    midpoint (half-bucket worst-case error)."""
    if count <= 0:
        return None
    rank = q * count
    cum = 0
    for i, c in enumerate(buckets):
        cum += c
        if cum >= rank:
            hi = bucket_bound(i)
            if i == 0:
                return hi
            return math.sqrt(bucket_bound(i - 1) * hi)
    return bucket_bound(N_BUCKETS - 1)


class Counter:
    """Monotonic counter; ``add`` is lock-free (per-thread cells)."""

    __slots__ = ("name", "_cells")

    def __init__(self, name: str):
        self.name = name
        self._cells: dict[int, float] = {}

    def add(self, n: float = 1) -> None:
        tid = threading.get_ident()
        cells = self._cells
        cells[tid] = cells.get(tid, 0) + n

    @property
    def value(self) -> float:
        return sum(self._cells.values())

    def snapshot(self):
        v = self.value
        return int(v) if float(v).is_integer() else v


class Gauge:
    """Last-write-wins value plus the per-run peak."""

    __slots__ = ("name", "value", "_peaks")

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0
        self._peaks: dict[int, float] = {}

    def set(self, v: float) -> None:
        self.value = v
        tid = threading.get_ident()
        peaks = self._peaks
        prev = peaks.get(tid)
        if prev is None or v > prev:
            peaks[tid] = v

    @property
    def peak(self) -> float:
        return max(self._peaks.values(), default=0)

    def snapshot(self) -> dict:
        def num(v):
            return int(v) if float(v).is_integer() else v

        return {"value": num(self.value), "peak": num(self.peak)}


class _HistCell:
    __slots__ = ("count", "total", "vmin", "vmax", "recent", "buckets",
                 "windows")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin: float | None = None
        self.vmax: float | None = None
        self.recent: list[float] = []
        self.buckets = [0] * N_BUCKETS
        #: rolling bucket rings: {slot ordinal: bucket counts}, bounded
        #: to the last ROLL_SLOTS+2 slots (the windowed sibling of the
        #: cumulative ``buckets`` array next to it)
        self.windows: dict[int, list[int]] = {}


class Histogram:
    """count/sum/min/max + fixed log buckets (p50/p95/p99) + a bounded
    recent-sample ring, per thread — PLUS a rolling-window bucket ring
    (``window_s``) so quantiles can mean "recent", not all-of-run
    (the substrate of the daemon's admission control and ``/v1/metrics``)."""

    __slots__ = ("name", "window_s", "_slot_s", "_cells")

    def __init__(self, name: str, window_s: float = DEFAULT_WINDOW_S):
        self.name = name
        self.window_s = window_s
        self._slot_s = max(window_s, 1e-3) / ROLL_SLOTS
        self._cells: dict[int, _HistCell] = {}

    def _slot(self) -> int:
        # the monotonic clock never steps; one clock read per observation
        return int(time.monotonic() / self._slot_s)

    def observe(self, v: float) -> None:
        tid = threading.get_ident()
        cell = self._cells.get(tid)
        if cell is None:
            # dict item assignment is atomic; each thread only writes its
            # own key, so concurrent first-observations cannot clobber
            self._cells[tid] = cell = _HistCell()
        cell.count += 1
        cell.total += v
        if cell.vmin is None or v < cell.vmin:
            cell.vmin = v
        if cell.vmax is None or v > cell.vmax:
            cell.vmax = v
        idx = bucket_index(v)
        cell.buckets[idx] += 1
        slot = self._slot()
        ring = cell.windows.get(slot)
        if ring is None:
            cell.windows[slot] = ring = [0] * N_BUCKETS
            if len(cell.windows) > ROLL_SLOTS + 2:
                # prune rings that aged out of every possible window —
                # only this thread writes this cell, so the delete races
                # nothing (the snapshot reader tolerates either state)
                for old in sorted(cell.windows)[:-(ROLL_SLOTS + 2)]:
                    del cell.windows[old]
        ring[idx] += 1
        cell.recent.append(v)
        if len(cell.recent) > RECENT:
            del cell.recent[0]

    def rolling_buckets(self) -> tuple[list[int], int]:
        """(summed bucket counts, count) over the rolling window: the
        last ROLL_SLOTS complete slots plus the current partial one."""
        floor = self._slot() - ROLL_SLOTS
        merged = [0] * N_BUCKETS
        count = 0
        for c in list(self._cells.values()):
            for slot, ring in list(c.windows.items()):
                if slot < floor:
                    continue
                for i, n in enumerate(ring):
                    if n:
                        merged[i] += n
                        count += n
        return merged, count

    def rolling_quantile(self, q: float) -> float | None:
        """Windowed quantile — "recent" p50/p95/p99 next to the
        cumulative :meth:`quantile`."""
        merged, count = self.rolling_buckets()
        return quantile_from_buckets(merged, count, q)

    def merged_buckets(self) -> tuple[list[int], int]:
        """(summed bucket counts, total count) across recording threads."""
        cells = list(self._cells.values())
        merged = [0] * N_BUCKETS
        for c in cells:
            for i, n in enumerate(c.buckets):
                if n:
                    merged[i] += n
        return merged, sum(c.count for c in cells)

    def quantile(self, q: float) -> float | None:
        """Bucket-resolution quantile (≤ ~4.4% relative error)."""
        merged, count = self.merged_buckets()
        return quantile_from_buckets(merged, count, q)

    def snapshot(self) -> dict:
        cells = list(self._cells.values())
        count = sum(c.count for c in cells)
        total = sum(c.total for c in cells)
        mins = [c.vmin for c in cells if c.vmin is not None]
        maxs = [c.vmax for c in cells if c.vmax is not None]
        recent: list[float] = []
        for c in cells:
            recent.extend(c.recent)
        merged, _ = self.merged_buckets()
        out = {
            "count": count,
            "sum": round(total, 6),
            "mean": round(total / count, 6) if count else 0,
            "min": min(mins) if mins else None,
            "max": max(maxs) if maxs else None,
            "recent": [round(v, 6) for v in recent[-RECENT:]],
        }
        for q in SNAPSHOT_QUANTILES:
            est = quantile_from_buckets(merged, count, q)
            out[f"p{int(q * 100)}"] = round(est, 9) if est is not None else None
        # the windowed view rides next to the cumulative one: rolling
        # p95 means "the last ~window_s", the substrate for in-flight
        # SLO reads (admission, /v1/status, /v1/metrics) where all-of-run quantiles
        # would average away a current stall
        roll_merged, roll_count = self.rolling_buckets()
        rolling: dict = {"window_s": self.window_s, "count": roll_count}
        for q in SNAPSHOT_QUANTILES:
            est = quantile_from_buckets(roll_merged, roll_count, q)
            rolling[f"p{int(q * 100)}"] = round(est, 9) \
                if est is not None else None
        out["rolling"] = rolling
        return out


class _Noop:
    """Shared do-nothing metric for the obs-disabled fast path — callers
    can record unconditionally without branching on ``obs.active()``."""

    __slots__ = ()
    name = "noop"
    value = 0
    peak = 0

    def add(self, n: float = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


NOOP = _Noop()


class MetricsRegistry:
    """One run's named metrics. Creation takes a lock (rare); recording
    through the returned objects does not (hot). ``window_s`` sets every
    histogram's rolling-window span (``VCTPU_OBS_WINDOW_S``; the module
    stays knob-free so it imports standalone)."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S):
        self.window_s = window_s
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def _get(self, table: dict, name: str, cls):
        metric = table.get(name)
        if metric is None:
            with self._lock:
                metric = table.setdefault(name, cls(name))
        return metric

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        metric = self._hists.get(name)
        if metric is None:
            with self._lock:
                metric = self._hists.setdefault(
                    name, Histogram(name, window_s=self.window_s))
        return metric

    def snapshot(self) -> dict:
        """{counters, gauges, histograms} — the ``metrics`` event body."""
        return {
            "counters": {n: c.snapshot()
                         for n, c in sorted(self._counters.items())},
            "gauges": {n: g.snapshot()
                       for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.snapshot()
                           for n, h in sorted(self._hists.items())},
        }
