"""Indexed FASTA reader: ``.fa`` + ``.fai`` (the index is built when missing).

Counterpart of ``variantcalling_tpu/io/fasta.py``: contigs are encoded by
the native engine (``native.fasta_encode``, threaded), else with one numpy
table lookup, and held in memory for the run, up to
``VCTPU_FASTA_CACHE_BYTES``. The encoded genome persists beside the FASTA
as the reference's ``.venc`` sidecar, byte for byte its format (so either
package reads the other's): ``VCENC1\n``, one JSON line ``{"key":
{"path", "mtime_ns", "size"}, "contigs": [[name, offset, length], ...]}``,
then every contig's codes in index order. A sidecar whose key matches the FASTA's
(mtime and size) is memory-mapped when the reader opens, and serves
:meth:`FastaReader.fetch_encoded` with no encode. ``VCTPU_GENOME_CACHE=0``
reads and writes none; ``VCTPU_GENOME_CACHE_DIR`` keeps sidecars in one
directory instead of beside each FASTA.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from dataclasses import dataclass

import numpy as np

from variantcalling_tpu_torch import knobs, native

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


#: sidecar format version (``<fasta>.venc``), the reference's
_VENC_MAGIC = b"VCENC1\n"


def encode_seq(seq: str) -> np.ndarray:
    """str -> uint8 codes (A0 C1 G2 T3, N and anything else 4)."""
    return _CODE[np.frombuffer(seq.encode(), dtype=np.uint8)]


class FastaReader:
    """Indexed FASTA whose contigs are read whole as uint8 codes (:meth:`fetch_encoded`),
    or as text (:meth:`fetch`, for the comparison's haplotype matcher)."""

    def __init__(self, path: str):
        self.path = path
        fai = path + ".fai"
        self._index = read_fai(fai) if os.path.exists(fai) else build_fai(path)
        self._fh = open(path, "rb")
        #: one encode at a time, and the shared handle's seek + read together:
        #: the streaming executor's workers and its prefetch thread share a reader
        self._enc_lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._encoded: dict[str, np.ndarray] = {}
        self._venc: np.memmap | None = None
        self._venc_offsets: dict[str, tuple[int, int]] = {}
        self._load_persistent_cache()

    @property
    def references(self) -> list[str]:
        return list(self._index)

    def get_reference_length(self, chrom: str) -> int:
        return self._index[chrom].length

    # -- the .venc sidecar -------------------------------------------------

    @property
    def has_sidecar(self) -> bool:
        """Whether a valid sidecar serves this reader's codes."""
        return self._venc is not None

    def _cache_key(self) -> dict:
        st = os.stat(self.path)
        return {"path": os.path.abspath(self.path), "mtime_ns": st.st_mtime_ns, "size": st.st_size}

    def _venc_path(self) -> str:
        d = knobs.get_str("VCTPU_GENOME_CACHE_DIR")
        if d:
            tag = hashlib.sha256(os.path.abspath(self.path).encode()).hexdigest()[:16]
            return os.path.join(d, f"{os.path.basename(self.path)}.{tag}.venc")
        return self.path + ".venc"

    def _load_persistent_cache(self) -> None:
        """Memory-map the sidecar when its key matches this FASTA's (mtime and
        size) and it holds every contig at its length; a stale, truncated or
        unreadable one is ignored with a warning (and replaced by the next
        whole-genome encode)."""
        if not knobs.get_bool("VCTPU_GENOME_CACHE"):
            return
        p = self._venc_path()
        try:
            if not os.path.exists(p):
                return
            with open(p, "rb") as fh:
                if fh.read(len(_VENC_MAGIC)) != _VENC_MAGIC:
                    log.warning("ignoring genome cache %s: not a .venc file", p)
                    return
                header = json.loads(fh.readline().decode())
                data_off = fh.tell()
            key = self._cache_key()
            if header.get("key", {}).get("mtime_ns") != key["mtime_ns"] or \
                    header.get("key", {}).get("size") != key["size"]:
                log.warning("ignoring stale genome cache %s: the FASTA changed since it was written", p)
                return
            mm = np.memmap(p, dtype=np.uint8, mode="r", offset=data_off)
            offsets = {}
            for name, off, length in header.get("contigs", []):
                ent = self._index.get(name)
                if ent is None or ent.length != length or off + length > len(mm):
                    log.warning("ignoring genome cache %s: contig %s is missing, of another length or "
                                "cut short", p, name)
                    return
                offsets[name] = (int(off), int(length))
            if len(offsets) != len(self._index):
                log.warning("ignoring genome cache %s: it lacks contigs of the FASTA", p)
                return
            self._venc, self._venc_offsets = mm, offsets
        except (OSError, ValueError) as e:  # json.JSONDecodeError is a ValueError
            log.warning("ignoring unreadable genome cache %s: %s", p, e)

    def persist_encoded(self, arrays: dict[str, np.ndarray] | None = None) -> bool:
        """Write the sidecar from whole-contig codes (``arrays``, default the
        contigs this reader has encoded), when every contig is there and no
        valid sidecar serves the reader already. Atomic (tmp + replace); an
        ``OSError`` (a read-only directory, a full disk) skips it: the
        sidecar is a cache."""
        if not knobs.get_bool("VCTPU_GENOME_CACHE") or self._venc is not None:
            return False
        arrays = self._encoded if arrays is None else arrays
        if not all(c in arrays for c in self._index):
            return False
        contigs = []
        off = 0
        for name, e in self._index.items():
            contigs.append((name, off, int(e.length)))
            off += int(e.length)
        header = json.dumps({"key": self._cache_key(), "contigs": contigs}).encode()
        p = self._venc_path()
        tmp = f"{p}.{os.getpid()}-{threading.get_ident()}.tmp"
        try:
            os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
            with open(tmp, "wb") as fh:
                fh.write(_VENC_MAGIC + header + b"\n")
                for name in self._index:
                    fh.write(memoryview(np.ascontiguousarray(arrays[name])))
            os.replace(tmp, p)
            return True
        except OSError as e:
            log.warning("could not persist genome cache %s: %s", p, e)
            try:
                if os.path.exists(tmp):
                    os.remove(tmp)
            except OSError:
                pass
            return False

    def sidecar_codes(self, chrom: str) -> np.ndarray | None:
        """Whole-contig codes memory-mapped from the sidecar, or None without one."""
        if self._venc is None:
            return None
        off, length = self._venc_offsets[chrom]
        return self._venc[off: off + length]

    # -- encoded contigs -----------------------------------------------------

    def fetch_encoded(self, chrom: str) -> np.ndarray:
        """Whole-contig uint8 codes: from the sidecar, else encoded and kept in a
        cache of at most ``VCTPU_FASTA_CACHE_BYTES`` (the oldest contigs leave
        first; 0 keeps none); the encode that completes the genome in the
        cache writes the sidecar."""
        got = self.sidecar_codes(chrom)
        if got is None:
            got = self._encoded.get(chrom)
        if got is not None:
            return got
        with self._enc_lock:
            got = self._encoded.get(chrom)  # encoded by the caller this one waited for
            if got is None:
                got = self.encode_contig(chrom)
                budget = knobs.get_int("VCTPU_FASTA_CACHE_BYTES")
                if len(got) <= budget:
                    total = sum(len(v) for v in self._encoded.values()) + len(got)
                    while self._encoded and total > budget:
                        total -= len(self._encoded.pop(next(iter(self._encoded))))
                    self._encoded[chrom] = got
                    if len(self._encoded) == len(self._index):
                        self.persist_encoded()
        return got

    def encode_all(self, cancel: threading.Event | None = None) -> None:
        """Encode every contig (and so write the sidecar, so that later
        processes skip the encode); nothing to do where a sidecar serves.
        ``cancel`` stops it between contigs."""
        for chrom in self._index:
            if cancel is not None and cancel.is_set():
                return
            self.fetch_encoded(chrom)

    def genome_bytes(self) -> int:
        """The genome's length in bases: bytes of its codes."""
        return sum(e.length for e in self._index.values())

    def encode_contig(self, chrom: str) -> np.ndarray:
        """Whole-contig uint8 codes, read and encoded anew (not cached)."""
        e = self._index[chrom]
        if e.length == 0:
            return np.empty(0, dtype=np.uint8)
        last_line = (e.length - 1) // e.line_bases
        byte_end = e.offset + last_line * e.line_width + (e.length - 1 - last_line * e.line_bases) + 1
        with self._io_lock:
            self._fh.seek(e.offset)
            raw = np.frombuffer(self._fh.read(byte_end - e.offset), dtype=np.uint8)
        if e.line_width == e.line_bases:  # no newlines inside the body
            return _CODE[raw[: e.length]]
        enc = native.fasta_encode(raw, e.line_bases, e.line_width, e.length)
        if enc is not None:
            return enc
        full = len(raw) // e.line_width
        body = _CODE[raw[: full * e.line_width].reshape(full, e.line_width)[:, : e.line_bases]]
        tail = _CODE[raw[full * e.line_width:][: e.line_bases]]
        return np.concatenate([body.reshape(-1), tail])[: e.length]

    def fetch(self, chrom: str, start: int, end: int) -> str:
        """Uppercased sequence text of [start, end), clamped to the contig's bounds."""
        e = self._index[chrom]
        start = max(0, int(start))
        end = min(e.length, int(end))
        if end <= start:
            return ""
        first_line = start // e.line_bases
        byte_start = e.offset + first_line * e.line_width + (start - first_line * e.line_bases)
        last_line = (end - 1) // e.line_bases
        byte_end = e.offset + last_line * e.line_width + ((end - 1) - last_line * e.line_bases) + 1
        with self._io_lock:
            self._fh.seek(byte_start)
            data = self._fh.read(byte_end - byte_start)
        return data.replace(b"\n", b"").replace(b"\r", b"").decode().upper()

    def close(self) -> None:
        self._fh.close()
        self._venc = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
