"""BED / Picard interval_list parsing and the interval algebra the filter needs.

Counterpart of ``variantcalling_tpu/io/bed.py`` (the parts that serve
``--annotate_intervals`` and ``--runs_file``, the ``BedWriter`` of
``evaluate_concordance --output_bed``, and the membership, intersection
and ``write_bed`` of the comparison and SEC tools). Intervals are
half-open 0-based [start, end) as in BED.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np


def _obj(x: list[str]) -> np.ndarray:
    a = np.empty(len(x), dtype=object)
    a[:] = x
    return a


@dataclass
class IntervalSet:
    """Columnar interval set: parallel arrays (chrom str, start, end)."""

    chrom: np.ndarray  # object (str)
    start: np.ndarray  # int64
    end: np.ndarray  # int64
    name: np.ndarray | None = None  # object (str): a BED's 4th column, "" where it has none

    def __len__(self) -> int:
        return len(self.start)

    def total_length(self) -> int:
        return int(np.sum(self.end - self.start))

    def by_chrom(self) -> dict[str, tuple[np.ndarray, np.ndarray]]:
        """chrom -> (starts, ends), each sorted by start."""
        out: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        for c in dict.fromkeys(self.chrom.tolist()):
            m = self.chrom == c
            s, e = self.start[m], self.end[m]
            order = np.argsort(s, kind="stable")
            out[c] = (s[order], e[order])
        return out

    def merged(self) -> "IntervalSet":
        """Union of overlapping/adjacent intervals (bedtools merge semantics)."""
        chroms: list[str] = []
        starts: list[int] = []
        ends: list[int] = []
        for c, (s, e) in self.by_chrom().items():
            cur_s = cur_e = None
            for lo, hi in zip(s.tolist(), e.tolist()):
                if cur_s is None:
                    cur_s, cur_e = lo, hi
                elif lo <= cur_e:
                    cur_e = max(cur_e, hi)
                else:
                    chroms.append(c)
                    starts.append(cur_s)
                    ends.append(cur_e)
                    cur_s, cur_e = lo, hi
            if cur_s is not None:
                chroms.append(c)
                starts.append(cur_s)
                ends.append(cur_e)
        return IntervalSet(_obj(chroms), np.asarray(starts, dtype=np.int64),
                           np.asarray(ends, dtype=np.int64))

    def intersect(self, other: "IntervalSet") -> "IntervalSet":
        """Pairwise intersection (bedtools intersect), by merged sweeps a chrom."""
        a = self.merged().by_chrom()
        b = other.merged().by_chrom()
        chroms: list[str] = []
        starts: list[int] = []
        ends: list[int] = []
        for c in a:
            if c not in b:
                continue
            sa, ea = a[c]
            sb, eb = b[c]
            i = j = 0
            while i < len(sa) and j < len(sb):
                lo = max(sa[i], sb[j])
                hi = min(ea[i], eb[j])
                if lo < hi:
                    chroms.append(c)
                    starts.append(int(lo))
                    ends.append(int(hi))
                if ea[i] < eb[j]:
                    i += 1
                else:
                    j += 1
        return IntervalSet(_obj(chroms), np.asarray(starts, dtype=np.int64), np.asarray(ends, dtype=np.int64))

    def subtract(self, other: "IntervalSet") -> "IntervalSet":
        """Set difference self \\ other (bedtools subtract), by merged sweeps a chrom."""
        a = self.merged().by_chrom()
        b = other.merged().by_chrom()
        none = np.empty(0, dtype=np.int64)
        chroms: list[str] = []
        starts: list[int] = []
        ends: list[int] = []
        for c in a:
            sa, ea = a[c]
            sb, eb = (x.tolist() for x in b.get(c, (none, none)))
            j = 0
            for cur, end in zip(sa.tolist(), ea.tolist()):
                while j < len(sb) and eb[j] <= cur:
                    j += 1
                k = j
                while k < len(sb) and sb[k] < end:
                    if cur < sb[k]:
                        chroms.append(c)
                        starts.append(cur)
                        ends.append(sb[k])
                    cur = max(cur, eb[k])
                    k += 1
                if cur < end:
                    chroms.append(c)
                    starts.append(cur)
                    ends.append(end)
        return IntervalSet(_obj(chroms), np.asarray(starts, dtype=np.int64), np.asarray(ends, dtype=np.int64))

    def contains(self, chrom: np.ndarray, pos0: np.ndarray) -> np.ndarray:
        """Membership of 0-based positions, a sorted search a chrom."""
        pos0 = np.asarray(pos0)
        out = np.zeros(len(pos0), dtype=bool)
        chrom = np.asarray(chrom)
        for c, (s, e) in self.merged().by_chrom().items():
            m = chrom == c
            if not m.any():
                continue
            idx = np.searchsorted(s, pos0[m], side="right") - 1
            ok = idx >= 0
            hit = np.zeros(m.sum(), dtype=bool)
            hit[ok] = pos0[m][ok] < e[idx[ok]]
            out[m] = hit
        return out


def _open_text(path: str):
    if str(path).endswith((".gz", ".bgz")):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, "rt", encoding="utf-8")


def read_bed(path: str) -> IntervalSet:
    """Read BED (3+ columns); tolerates track/browser/# headers."""
    chroms: list[str] = []
    starts: list[int] = []
    ends: list[int] = []
    names: list[str] = []
    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line or line.startswith(("#", "track", "browser")):
                continue
            p = line.split("\t")
            chroms.append(p[0])
            starts.append(int(p[1]))
            ends.append(int(p[2]))
            names.append(p[3] if len(p) > 3 else "")
    return IntervalSet(_obj(chroms), np.asarray(starts, dtype=np.int64),
                       np.asarray(ends, dtype=np.int64), name=_obj(names))


def read_interval_list(path: str) -> IntervalSet:
    """Picard .interval_list: SAM-style @ header + 1-based inclusive rows."""
    chroms: list[str] = []
    starts: list[int] = []
    ends: list[int] = []
    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line or line.startswith("@"):
                continue
            p = line.split("\t")
            chroms.append(p[0])
            starts.append(int(p[1]) - 1)  # 1-based inclusive -> 0-based half-open
            ends.append(int(p[2]))
    return IntervalSet(_obj(chroms), np.asarray(starts, dtype=np.int64),
                       np.asarray(ends, dtype=np.int64))


def read_intervals(path: str) -> IntervalSet:
    """Dispatch on extension: .interval_list, else BED (optionally gzipped)."""
    if str(path).endswith(".interval_list"):
        return read_interval_list(path)
    return read_bed(path)


def write_bed(path: str, intervals: IntervalSet) -> None:
    """One line an interval: chrom, start, end, and its name where it has one."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as out:
        for i in range(len(intervals)):
            cols = [str(intervals.chrom[i]), str(int(intervals.start[i])), str(int(intervals.end[i]))]
            if intervals.name is not None and intervals.name[i]:
                cols.append(str(intervals.name[i]))
            out.write("\t".join(cols) + "\n")


class BedWriter:
    """Streaming BED writer: one tab-separated line a ``write`` (gzip for a
    ``.gz`` path), as the reference's ``BedWriter`` writes it."""

    def __init__(self, path: str):
        self._fh = (gzip.open if str(path).endswith(".gz") else open)(path, "wt")

    def write(self, chrom: str, start: int, end: int, *extra) -> None:
        self._fh.write("\t".join([chrom, str(start), str(end), *map(str, extra)]) + "\n")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "BedWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
