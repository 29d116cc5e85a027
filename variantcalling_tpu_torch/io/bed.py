"""BED / Picard interval_list parsing and the interval algebra the filter needs.

Counterpart of ``variantcalling_tpu/io/bed.py`` (the parts that serve
``--annotate_intervals`` and ``--runs_file``). Intervals are half-open
0-based [start, end) as in BED.
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

    def __len__(self) -> int:
        return len(self.start)

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


def _open_text(path: str):
    if str(path).endswith((".gz", ".bgz")):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, "rt", encoding="utf-8")


def read_bed(path: str) -> IntervalSet:
    """Read BED (3+ columns); tolerates track/browser/# headers."""
    chroms: list[str] = []
    starts: list[int] = []
    ends: list[int] = []
    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line or line.startswith(("#", "track", "browser")):
                continue
            p = line.split("\t")
            chroms.append(p[0])
            starts.append(int(p[1]))
            ends.append(int(p[2]))
    return IntervalSet(_obj(chroms), np.asarray(starts, dtype=np.int64),
                       np.asarray(ends, dtype=np.int64))


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
