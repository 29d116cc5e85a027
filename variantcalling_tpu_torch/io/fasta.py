"""Indexed FASTA reader: ``.fa`` + ``.fai`` (the index is built when missing).

Counterpart of ``variantcalling_tpu/io/fasta.py``, without its native
encoder and its persistent encoded-genome cache: contigs are encoded with
one numpy table lookup and held in memory for the run.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np

log = logging.getLogger(__name__)


@dataclass
class FaiEntry:
    length: int
    offset: int
    line_bases: int
    line_width: int


_FAI_SCAN_CHUNK = 64 << 20


def build_fai(path: str) -> dict[str, FaiEntry]:
    """Scan a FASTA and build its ``.fai`` table (also written to ``<path>.fai``
    when the directory is writable). Newline offsets come from chunked numpy
    scans over a memory map."""
    entries: dict[str, FaiEntry] = {}
    size = os.path.getsize(path)
    if size == 0:
        return entries
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    nls = np.concatenate([
        np.flatnonzero(mm[lo: min(lo + _FAI_SCAN_CHUNK, size)] == 0x0A) + lo
        for lo in range(0, size, _FAI_SCAN_CHUNK)
    ])
    starts = np.concatenate([[0], nls + 1])
    ends = np.concatenate([nls, [size]])
    if starts[-1] >= size:  # file ends with a newline: no phantom last line
        starts, ends = starts[:-1], ends[:-1]
    has_cr = np.zeros(len(starts), dtype=bool)
    inner = ends > starts
    has_cr[inner] = mm[ends[inner] - 1] == 0x0D
    content_len = ends - starts - has_cr
    hdr_lines = np.flatnonzero((mm[starts] == ord(">")) & (ends > starts))
    cum = np.concatenate([[0], np.cumsum(content_len)])
    for k, li in enumerate(hdr_lines):
        name = bytes(mm[starts[li] + 1: ends[li] - has_cr[li]]).split()[0].decode()
        body_lo = li + 1
        body_hi = int(hdr_lines[k + 1]) if k + 1 < len(hdr_lines) else len(starts)
        line_bases = line_width = 0
        for bi in range(body_lo, body_hi):  # first non-empty body line
            if content_len[bi] > 0:
                line_bases = int(content_len[bi])
                line_width = int((starts[bi + 1] if bi + 1 < len(starts) else size) - starts[bi])
                break
        offset = int(starts[body_lo]) if body_lo < len(starts) else size
        entries[name] = FaiEntry(int(cum[body_hi] - cum[body_lo]), offset, line_bases, line_width)
    del mm
    try:
        with open(path + ".fai", "wt") as out:
            for n, e in entries.items():
                out.write(f"{n}\t{e.length}\t{e.offset}\t{e.line_bases}\t{e.line_width}\n")
    except OSError as e:
        log.debug("not caching .fai beside %s: %s", path, e)
    return entries


def read_fai(path: str) -> dict[str, FaiEntry]:
    entries: dict[str, FaiEntry] = {}
    with open(path, "rt") as fh:
        for line in fh:
            p = line.rstrip("\n").split("\t")
            entries[p[0]] = FaiEntry(int(p[1]), int(p[2]), int(p[3]), int(p[4]))
    return entries


_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
for _i, _b in enumerate(b"acgt"):
    _CODE[_b] = _i


def encode_seq(seq: str) -> np.ndarray:
    """str -> uint8 codes (A0 C1 G2 T3, N and anything else 4)."""
    return _CODE[np.frombuffer(seq.encode(), dtype=np.uint8)]


class FastaReader:
    """Indexed FASTA whose contigs are read whole as uint8 codes (:meth:`fetch_encoded`)."""

    def __init__(self, path: str):
        self.path = path
        fai = path + ".fai"
        self._index = read_fai(fai) if os.path.exists(fai) else build_fai(path)
        self._fh = open(path, "rb")
        self._encoded: dict[str, np.ndarray] = {}

    @property
    def references(self) -> list[str]:
        return list(self._index)

    def get_reference_length(self, chrom: str) -> int:
        return self._index[chrom].length

    def fetch_encoded(self, chrom: str) -> np.ndarray:
        """Whole-contig uint8 codes, encoded once per run and cached."""
        got = self._encoded.get(chrom)
        if got is None:
            got = self._encoded[chrom] = self.encode_contig(chrom)
        return got

    def encode_contig(self, chrom: str) -> np.ndarray:
        """Whole-contig uint8 codes, read and encoded anew (not cached)."""
        e = self._index[chrom]
        if e.length == 0:
            return np.empty(0, dtype=np.uint8)
        last_line = (e.length - 1) // e.line_bases
        byte_end = e.offset + last_line * e.line_width + (e.length - 1 - last_line * e.line_bases) + 1
        self._fh.seek(e.offset)
        raw = np.frombuffer(self._fh.read(byte_end - e.offset), dtype=np.uint8)
        if e.line_width == e.line_bases:  # no newlines inside the body
            return _CODE[raw[: e.length]]
        full = len(raw) // e.line_width
        body = _CODE[raw[: full * e.line_width].reshape(full, e.line_width)[:, : e.line_bases]]
        tail = _CODE[raw[full * e.line_width:][: e.line_bases]]
        return np.concatenate([body.reshape(-1), tail])[: e.length]

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
