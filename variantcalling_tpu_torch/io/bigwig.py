"""Dependency-free bigWig reader/writer (UCSC bbiFile format, little-endian).

Counterpart of ``variantcalling_tpu/io/bigwig.py``, a copy: numpy, struct
and zlib only, so the two packages write the same bytes. The upstream
tool exports with UCSC ``bedGraphToBigWig`` and reads back through
pyBigWig; neither is needed here:

- :func:`write_bigwig` — per-contig value arrays -> .bw with a chromosome
  B+ tree, bedGraph-typed data sections (run-length encoded) and a two-level
  R-tree index. Sections are zlib-compressed like the UCSC writer.
  :func:`write_bigwig_runs` writes the same file from the runs of equal
  value (``coverage_analysis`` computes them on the card). The sections
  deflate on a few threads (the same bytes as one after the other).
- :class:`BigWigReader` — header/chrom-tree/R-tree parser serving
  ``values(chrom, start, end)`` (NaN where uncovered) and ``chroms()``,
  the pyBigWig surface. Handles compressed and uncompressed sections, all
  three WIG section types.

Zoom levels are written as zero (valid per the spec; readers fall back to
full-resolution data for summaries).
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BIGWIG_MAGIC = 0x888FFC26
CHROM_TREE_MAGIC = 0x78CA8C91
RTREE_MAGIC = 0x2468ACE0

_SECTION_ITEMS = 1024  # bedGraph items per data section (fits u16 itemCount)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _runlength(values: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(starts, ends, vals) runs of equal value; zero runs are kept (bedGraph
    emits them, matching `samtools depth -a` semantics in the reference)."""
    v = np.asarray(values, dtype=np.float32)
    if len(v) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.float32)
    change = np.nonzero(v[1:] != v[:-1])[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(v)]])
    return starts, ends, v[starts]


def write_bigwig(path: str, chrom_values: dict[str, np.ndarray],
                 chrom_sizes: dict[str, int] | None = None, compress: bool = True) -> None:
    """Write per-base value arrays as a bigWig file.

    ``chrom_values``: contig -> float array (per-base, position 0-based).
    ``chrom_sizes`` defaults to the array lengths.
    """
    sizes = {c: int(chrom_sizes[c]) if chrom_sizes else len(v) for c, v in chrom_values.items()}
    write_bigwig_runs(path, {c: _runlength(v) for c, v in chrom_values.items()}, sizes, compress)


def write_bigwig_runs(path: str, chrom_runs: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]],
                      chrom_sizes: dict[str, int], compress: bool = True) -> None:
    """The file :func:`write_bigwig` writes, from each contig's runs of equal
    value: (starts, ends, values) as :func:`_runlength` gives them (int64,
    int64, float32; a run's value differs from the next run's)."""
    chroms = list(chrom_runs)
    sizes = {c: int(chrom_sizes[c]) for c in chroms}
    key_size = max([len(c) for c in chroms] or [1])

    sections = []  # (chrom_id, start, end, payload_bytes)
    valid = 0
    vmin, vmax, vsum, vsumsq = np.inf, -np.inf, 0.0, 0.0
    for cid, c in enumerate(chroms):
        starts, ends, vals = chrom_runs[c]
        if len(vals):
            # every emitted base — including zero runs — is "covered" data
            valid += int((ends - starts).sum())
            vmin = min(vmin, float(vals.min()))
            vmax = max(vmax, float(vals.max()))
            w = (ends - starts).astype(np.float64)
            vsum += float((vals * w).sum())
            vsumsq += float((vals.astype(np.float64) ** 2 * w).sum())
        for lo in range(0, len(starts), _SECTION_ITEMS):
            hi = min(lo + _SECTION_ITEMS, len(starts))
            s, e, v = starts[lo:hi], ends[lo:hi], vals[lo:hi]
            head = struct.pack("<IIIIIBBH", cid, int(s[0]), int(e[-1]), 0, 0, 1, 0, hi - lo)
            items = np.empty((hi - lo, 3), dtype=np.uint32)
            items[:, 0] = s
            items[:, 1] = e
            items[:, 2] = v.view(np.uint32) if v.dtype == np.float32 else \
                v.astype(np.float32).view(np.uint32)
            sections.append((cid, int(s[0]), int(e[-1]), head + items.tobytes()))
    if not np.isfinite(vmin):
        vmin = vmax = 0.0

    uncompress_buf = max((len(p) for _, _, _, p in sections), default=0)
    if compress:  # zlib releases the GIL: the sections deflate side by side, the same bytes
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            payloads = list(pool.map(zlib.compress, (p for _, _, _, p in sections)))
    else:
        payloads = [p for _, _, _, p in sections]

    # ---- layout ----
    n_chroms = len(chroms)
    header_size = 64
    chrom_tree_offset = header_size  # no zoom headers (zoomLevels=0)
    chrom_tree_size = 32 + 4 + (key_size + 8) * n_chroms
    total_summary_offset = chrom_tree_offset + chrom_tree_size
    full_data_offset = total_summary_offset + 40
    data_sizes = [len(p) for p in payloads]
    data_start = full_data_offset + 8
    offsets = np.concatenate([[0], np.cumsum(data_sizes)])[:-1] + data_start
    full_index_offset = data_start + sum(data_sizes)

    with open(path, "wb") as fh:
        fh.write(
            struct.pack(
                "<IHHQQQHHQQIQ",
                BIGWIG_MAGIC, 4, 0,
                chrom_tree_offset, full_data_offset, full_index_offset,
                0, 0, 0, total_summary_offset,
                uncompress_buf if compress else 0, 0,
            )
        )
        # chromosome B+ tree: one leaf node
        fh.write(struct.pack("<IIIIQQ", CHROM_TREE_MAGIC, max(n_chroms, 1), key_size, 8,
                             n_chroms, 0))
        fh.write(struct.pack("<BBH", 1, 0, n_chroms))
        for cid, c in enumerate(chroms):
            fh.write(c.encode().ljust(key_size, b"\x00"))
            fh.write(struct.pack("<II", cid, sizes[c]))
        fh.write(struct.pack("<Qdddd", valid, vmin, vmax, vsum, vsumsq))
        fh.write(struct.pack("<Q", len(sections)))
        for p in payloads:
            fh.write(p)
        _write_rtree(fh, sections, offsets, data_sizes, full_index_offset)


def _write_rtree(fh, sections, offsets, data_sizes, index_offset) -> None:
    """Two-level R-tree: one root over leaf nodes of <=256 items."""
    block = 256
    n = len(sections)
    if n:
        s_cid, s_start = sections[0][0], sections[0][1]
        e_cid, e_end = sections[-1][0], sections[-1][2]
    else:
        s_cid = s_start = e_cid = e_end = 0
    end_file = int(offsets[-1] + data_sizes[-1]) if n else index_offset
    fh.write(struct.pack("<IIQIIIIQII", RTREE_MAGIC, block, n,
                         s_cid, s_start, e_cid, e_end, end_file, _SECTION_ITEMS, 0))
    groups = [list(range(lo, min(lo + block, n))) for lo in range(0, n, block)] or [[]]
    if len(groups) == 1:
        _write_rtree_leaf(fh, groups[0], sections, offsets, data_sizes)
        return
    # root (internal) node, then leaves at computed offsets
    root_size = 4 + 24 * len(groups)
    leaf_sizes = [4 + 32 * len(g) for g in groups]
    leaf_offs = np.concatenate([[0], np.cumsum(leaf_sizes)])[:-1] + index_offset + 48 + root_size
    fh.write(struct.pack("<BBH", 0, 0, len(groups)))
    for g, off in zip(groups, leaf_offs):
        a, b = sections[g[0]], sections[g[-1]]
        fh.write(struct.pack("<IIIIQ", a[0], a[1], b[0], b[2], int(off)))
    for g in groups:
        _write_rtree_leaf(fh, g, sections, offsets, data_sizes)


def _write_rtree_leaf(fh, idxs, sections, offsets, data_sizes) -> None:
    fh.write(struct.pack("<BBH", 1, 0, len(idxs)))
    for i in idxs:
        cid, start, end, _ = sections[i]
        fh.write(struct.pack("<IIIIQQ", cid, start, cid, end, int(offsets[i]), data_sizes[i]))


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class BigWigReader:
    """Minimal pyBigWig-compatible reader: chroms() + values()."""

    def __init__(self, path: str):
        import mmap

        self.path = path
        self._fh = open(path, "rb")
        # mmap: block reads stay page-backed, so multi-GB WGS tracks never
        # fully materialize in RAM (only R-tree-hit pages fault in)
        self._data = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        magic, version, zooms, chrom_off, data_off, index_off, _fc, _dfc, _auto, \
            _summ, self._uncomp, _res = struct.unpack_from("<IHHQQQHHQQIQ", self._data, 0)
        if magic != BIGWIG_MAGIC:
            raise ValueError(f"not a little-endian bigWig file: {path}")
        self._index_off = index_off
        self._chrom_ids: dict[str, int] = {}
        self._chrom_sizes: dict[str, int] = {}
        self._read_chrom_tree(chrom_off)
        self._names = {v: k for k, v in self._chrom_ids.items()}

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False

    def close(self) -> None:
        try:
            self._data.close()
            self._fh.close()
        except (OSError, ValueError):
            pass

    def chroms(self, chrom: str | None = None):
        if chrom is not None:
            return self._chrom_sizes.get(chrom)
        return dict(self._chrom_sizes)

    def _read_chrom_tree(self, off: int) -> None:
        magic, _block, key_size, _val, _count, _res = struct.unpack_from("<IIIIQQ", self._data, off)
        if magic != CHROM_TREE_MAGIC:
            raise ValueError("bad chromosome tree")
        self._walk_chrom_node(off + 32, key_size)

    def _walk_chrom_node(self, off: int, key_size: int) -> None:
        is_leaf, _res, count = struct.unpack_from("<BBH", self._data, off)
        p = off + 4
        for _ in range(count):
            key = self._data[p : p + key_size].rstrip(b"\x00").decode()
            if is_leaf:
                cid, csize = struct.unpack_from("<II", self._data, p + key_size)
                self._chrom_ids[key] = cid
                self._chrom_sizes[key] = csize
                p += key_size + 8
            else:
                (child,) = struct.unpack_from("<Q", self._data, p + key_size)
                self._walk_chrom_node(child, key_size)
                p += key_size + 8

    def _overlapping_blocks(self, cid: int, start: int, end: int) -> list[tuple[int, int]]:
        out: list[tuple[int, int]] = []
        self._walk_rtree(self._index_off + 48, cid, start, end, out)
        return out

    def _walk_rtree(self, off: int, cid: int, start: int, end: int, out: list) -> None:
        is_leaf, _res, count = struct.unpack_from("<BBH", self._data, off)
        p = off + 4
        for _ in range(count):
            if is_leaf:
                scid, s, ecid, e, doff, dsize = struct.unpack_from("<IIIIQQ", self._data, p)
                p += 32
            else:
                scid, s, ecid, e, doff = struct.unpack_from("<IIIIQ", self._data, p)
                dsize = None
                p += 24
            if (scid, s) > (cid, end) or (ecid, e) < (cid, start):
                # no overlap with [cid:start, cid:end]
                if scid > cid or (scid == cid and s >= end):
                    break
                continue
            if is_leaf:
                out.append((doff, dsize))
            else:
                self._walk_rtree(doff, cid, start, end, out)

    def _section_items(self, payload: bytes):
        """Yield (start, end, value) from one WIG data section."""
        chrom_id, c_start, _c_end, step, span, typ, _res, n = struct.unpack_from(
            "<IIIIIBBH", payload, 0
        )
        body = payload[24:]
        if typ == 1:  # bedGraph
            arr = np.frombuffer(body, dtype="<u4", count=3 * n).reshape(n, 3)
            return chrom_id, arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64), \
                arr[:, 2].copy().view(np.float32)
        if typ == 2:  # varStep
            arr = np.frombuffer(body, dtype="<u4", count=2 * n).reshape(n, 2)
            s = arr[:, 0].astype(np.int64)
            return chrom_id, s, s + span, arr[:, 1].copy().view(np.float32)
        if typ == 3:  # fixedStep
            vals = np.frombuffer(body, dtype="<u4", count=n).copy().view(np.float32)
            s = c_start + step * np.arange(n, dtype=np.int64)
            return chrom_id, s, s + span, vals
        raise ValueError(f"unknown WIG section type {typ}")

    def values(self, chrom: str, start: int, end: int, numpy: bool = True) -> np.ndarray:
        """Per-base values over [start, end), NaN where uncovered (pyBigWig API)."""
        cid = self._chrom_ids.get(chrom)
        out = np.full(max(end - start, 0), np.nan, dtype=np.float64)
        if cid is None:
            return out if numpy else list(out)
        for doff, dsize in self._overlapping_blocks(cid, start, end):
            payload = self._data[doff : doff + dsize]
            if self._uncomp:
                payload = zlib.decompress(payload)
            scid, s, e, v = self._section_items(payload)
            if scid != cid:
                continue
            s2 = np.clip(s - start, 0, len(out))
            e2 = np.clip(e - start, 0, len(out))
            for a, b, val in zip(s2, e2, v):
                if b > a:
                    out[a:b] = val
        return out if numpy else list(out)

    def stats(self, chrom: str, start: int = 0, end: int | None = None,
              type: str = "mean") -> list:  # noqa: A002 — pyBigWig API name
        if end is None:
            end = self._chrom_sizes.get(chrom, 0)
        v = self.values(chrom, start, end)
        v = v[~np.isnan(v)]
        if len(v) == 0:
            return [None]
        fns = {"mean": np.mean, "min": np.min, "max": np.max, "sum": np.sum,
               "coverage": lambda x: len(x) / max(end - start, 1), "std": np.std}
        return [float(fns[type](v))]


def open_bigwig(path: str) -> BigWigReader:
    return BigWigReader(path)
