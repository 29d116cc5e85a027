"""BAM reader and per-contig depth as int32 difference arrays.

Counterpart of ``variantcalling_tpu/io/bam.py``, a copy with the port's
imports. The upstream tool shells out to ``samtools depth -a -J -q -Q -l``
per contig; here the BAM binary layout (BGZF stream, SAM v1 section 4) is
parsed directly and each contig's depth accumulates as an int32
**difference array**: every aligned reference-consuming run adds +1 at
its start and -1 at its end, and the depth vector is one cumsum (on the
run's device in ``pipelines/coverage_analysis``).

The native host engine's ``bam_depth`` walks the inflated records
(:func:`_depth_diff_arrays_native`); :class:`BamReader`, pure Python, is
its plain version, which ``VCTPU_NO_NATIVE=1`` selects. ``.cram`` inputs go
to :mod:`io.cram`. One repair against the reference's walk: a CIGAR op that
starts past the contig's end covers nothing, and a base-quality run stops
at the contig's end, as the native walk has it (the reference's Python
walk raises ``IndexError`` there).
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass

import numpy as np

from variantcalling_tpu_torch import native

# samtools depth default exclusion: UNMAP | SECONDARY | QCFAIL | DUP
EXCLUDE_FLAGS = 0x4 | 0x100 | 0x200 | 0x400

_CIGAR_OPS = "MIDNSHP=X"
_REF_CONSUME = {0, 2, 3, 7, 8}  # M, D, N, =, X
_COV_OPS_J = {0, 2, 7, 8}  # with -J: deletions covered, N never
_COV_OPS = {0, 7, 8}


@dataclass
class BamHeader:
    text: str
    references: list[str]
    lengths: dict[str, int]


@dataclass
class Alignment:
    ref_id: int
    pos: int  # 0-based leftmost
    mapq: int
    flag: int
    cigar: list[tuple[int, int]]  # (op, length)
    read_len: int
    qual: np.ndarray | None  # per-base phred or None
    seq: np.ndarray | None = None  # per-base code 0..3 A/C/G/T, 4 other (when decoded)
    tags: dict | None = None  # optional aux tags (when decode_tags)


def _parse_aux_tags(rec: bytes, off: int) -> dict:
    """BAM auxiliary fields (SAM spec §4.2.4): tag(2) type(1) value."""
    tags: dict = {}
    n = len(rec)
    while off + 3 <= n:
        tag = rec[off : off + 2].decode(errors="replace")
        typ = chr(rec[off + 2])
        off += 3
        if typ == "A":
            tags[tag] = chr(rec[off]); off += 1
        elif typ in "cC":
            tags[tag] = rec[off] if typ == "C" else struct.unpack_from("<b", rec, off)[0]; off += 1
        elif typ in "sS":
            tags[tag] = struct.unpack_from("<h" if typ == "s" else "<H", rec, off)[0]; off += 2
        elif typ in "iI":
            tags[tag] = struct.unpack_from("<i" if typ == "i" else "<I", rec, off)[0]; off += 4
        elif typ == "f":
            tags[tag] = struct.unpack_from("<f", rec, off)[0]; off += 4
        elif typ in "ZH":
            end = rec.index(b"\x00", off)
            tags[tag] = rec[off:end].decode(errors="replace"); off = end + 1
        elif typ == "B":
            sub = chr(rec[off]); (cnt,) = struct.unpack_from("<I", rec, off + 1); off += 5
            size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I", "f": "<f"}[sub]
            tags[tag] = [struct.unpack_from(fmt, rec, off + j * size)[0] for j in range(cnt)]
            off += cnt * size
        else:  # unknown type code: cannot continue safely
            break
    return tags


# BAM 4-bit base nibble -> 0..3 ACGT, 4 anything else ('=ACMGRSVTWYHKDBN')
_NIBBLE_TO_CODE = np.full(16, 4, dtype=np.uint8)
for _nib, _code in ((1, 0), (2, 1), (4, 2), (8, 3)):
    _NIBBLE_TO_CODE[_nib] = _code


def _read_exact(fh, n: int) -> bytes:
    buf = fh.read(n)
    if len(buf) != n:
        raise EOFError("truncated BAM")
    return buf


class BamReader:
    def __init__(self, path: str, decode_seq: bool = False, decode_tags: bool = False):
        self._decode_seq = decode_seq
        self._decode_tags = decode_tags
        self._fh = gzip.open(path, "rb")  # BGZF is valid multi-member gzip
        magic = _read_exact(self._fh, 4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", _read_exact(self._fh, 4))
        text = _read_exact(self._fh, l_text).rstrip(b"\x00").decode(errors="replace")
        (n_ref,) = struct.unpack("<i", _read_exact(self._fh, 4))
        refs: list[str] = []
        lengths: dict[str, int] = {}
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", _read_exact(self._fh, 4))
            name = _read_exact(self._fh, l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", _read_exact(self._fh, 4))
            refs.append(name)
            lengths[name] = l_ref
        self.header = BamHeader(text, refs, lengths)

    def __iter__(self):
        while True:
            head = self._fh.read(4)
            if len(head) < 4:
                return
            (block_size,) = struct.unpack("<i", head)
            rec = _read_exact(self._fh, block_size)
            ref_id, pos, lrn_mq_bin, flag_nc, l_seq, _, _, _ = struct.unpack("<iiIIiiii", rec[:32])
            l_read_name = lrn_mq_bin & 0xFF
            mapq = (lrn_mq_bin >> 8) & 0xFF
            n_cigar = flag_nc & 0xFFFF
            flag = flag_nc >> 16
            off = 32 + l_read_name
            cigar_raw = np.frombuffer(rec, dtype="<u4", count=n_cigar, offset=off)
            off += 4 * n_cigar
            seq_bytes = (l_seq + 1) // 2
            seq = None
            if self._decode_seq and l_seq:
                packed = np.frombuffer(rec, dtype=np.uint8, count=seq_bytes, offset=off)
                nibbles = np.empty(seq_bytes * 2, dtype=np.uint8)
                nibbles[0::2] = packed >> 4
                nibbles[1::2] = packed & 0xF
                seq = _NIBBLE_TO_CODE[nibbles[:l_seq]]
            off += seq_bytes
            qual = np.frombuffer(rec, dtype=np.uint8, count=l_seq, offset=off) if l_seq else None
            off += l_seq
            tags = _parse_aux_tags(rec, off) if self._decode_tags else None
            cigar = [(int(c & 0xF), int(c >> 4)) for c in cigar_raw]
            yield Alignment(ref_id, pos, mapq, flag, cigar, l_seq, qual, seq, tags)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def depth_diff_arrays(
    path: str,
    min_bq: int = 0,
    min_mapq: int = 0,
    min_read_length: int = 0,
    include_deletions: bool = True,
    regions: list[str] | None = None,
) -> tuple[BamHeader, dict[str, np.ndarray]]:
    """Per-contig depth via difference arrays (samtools depth -a -J semantics).

    Returns (header, {contig: int32 depth vector}). ``regions`` restricts to
    named contigs (region strings "chr1" or "chr1:1000-2000"). CRAM inputs
    dispatch to the native CRAM 3.0 decoder (io/cram).
    """
    if str(path).endswith(".cram"):
        from variantcalling_tpu_torch.io import cram

        return cram.depth_diff_arrays(
            path, min_bq=min_bq, min_mapq=min_mapq, min_read_length=min_read_length,
            include_deletions=include_deletions, regions=regions,
        )
    cov_ops = _COV_OPS_J if include_deletions else _COV_OPS
    region_contigs = None
    if regions:
        region_contigs = {r.split(":")[0] for r in regions}
    native_out = _depth_diff_arrays_native(
        path, min_bq, min_mapq, min_read_length, include_deletions, region_contigs
    )
    if native_out is not None:
        return native_out
    with BamReader(path) as bam:
        refs = bam.header.references
        diffs: dict[str, np.ndarray] = {}
        for name in refs:
            if region_contigs is None or name in region_contigs:
                diffs[name] = np.zeros(bam.header.lengths[name] + 1, dtype=np.int32)
        for aln in bam:
            if aln.flag & EXCLUDE_FLAGS or aln.ref_id < 0:
                continue
            if aln.mapq < min_mapq or aln.read_len < min_read_length:
                continue
            name = refs[aln.ref_id]
            if name not in diffs:
                continue
            diff = diffs[name]
            if min_bq > 0 and aln.qual is not None:
                _add_bq_filtered(diff, aln, min_bq, cov_ops)
                continue
            ref_pos = aln.pos
            for op, length in aln.cigar:
                if op in cov_ops and ref_pos < len(diff) - 1:  # an op past the contig's end covers nothing
                    diff[ref_pos] += 1
                    diff[min(ref_pos + length, len(diff) - 1)] -= 1
                if op in _REF_CONSUME:
                    ref_pos += length
        return bam.header, diffs


def inflate_bam(path: str) -> tuple[BamHeader, np.ndarray, int] | None:
    """(header, the whole file inflated by ``native.bgzf_decompress_array``,
    the offset of its first record); None where the engine declines or the
    stream is not a BAM."""
    with open(path, "rb") as fh:
        raw = fh.read()
    arr = native.bgzf_decompress_array(raw)
    del raw
    if arr is None:
        return None
    buf = memoryview(arr)  # zero-copy view for header parsing
    if bytes(buf[:4]) != b"BAM\x01":
        return None
    (l_text,) = struct.unpack_from("<i", buf, 4)
    off = 8 + l_text
    text = bytes(buf[8 : 8 + l_text]).rstrip(b"\x00").decode(errors="replace")
    (n_ref,) = struct.unpack_from("<i", buf, off)
    off += 4
    refs: list[str] = []
    lengths: dict[str, int] = {}
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", buf, off)
        name = bytes(buf[off + 4 : off + 4 + l_name - 1]).decode()
        (l_ref,) = struct.unpack_from("<i", buf, off + 4 + l_name)
        off += 8 + l_name
        refs.append(name)
        lengths[name] = l_ref
    return BamHeader(text, refs, lengths), arr, off


def _depth_diff_arrays_native(
    path: str,
    min_bq: int,
    min_mapq: int,
    min_read_length: int,
    include_deletions: bool,
    region_contigs: set[str] | None,
) -> tuple[BamHeader, dict[str, np.ndarray]] | None:
    """The native engine's walk: the whole file inflated by
    ``bgzf_decompress_array``, its records walked by ``bam_depth``; None
    where the engine is off or declines (the plain reader serves)."""
    if not native.available():
        native.note_plain("bam_depth")
        return None
    inflated = inflate_bam(path)
    if inflated is None:
        return None
    header, arr, off = inflated
    refs, lengths = header.references, header.lengths
    n_ref = len(refs)
    starts = np.full(n_ref, -1, dtype=np.int64)
    lens = np.zeros(n_ref, dtype=np.int64)
    cursor = 0
    for i, name in enumerate(refs):
        lens[i] = lengths[name]
        if region_contigs is None or name in region_contigs:
            starts[i] = cursor
            cursor += lengths[name] + 1
    diff_flat = np.zeros(max(cursor, 1), dtype=np.int32)
    n = native.bam_depth(
        arr[off:],  # numpy slice: zero-copy view
        starts,
        lens,
        diff_flat,
        min_bq=min_bq,
        min_mapq=min_mapq,
        min_read_length=min_read_length,
        include_deletions=include_deletions,
        exclude_flags=EXCLUDE_FLAGS,
    )
    if n is None:
        return None
    diffs: dict[str, np.ndarray] = {}
    for i, name in enumerate(refs):
        if starts[i] >= 0:
            diffs[name] = diff_flat[starts[i] : starts[i] + lengths[name] + 1]
    return header, diffs


def _add_bq_filtered(diff: np.ndarray, aln: Alignment, min_bq: int, cov_ops: set) -> None:
    """Per-base quality filtering (-q): walk cigar over read and reference."""
    ref_pos = aln.pos
    read_pos = 0
    q = aln.qual
    clen = len(diff) - 1
    for op, length in aln.cigar:
        consumes_read = op in (0, 1, 4, 7, 8)  # M, I, S, =, X
        if op in cov_ops and ref_pos < clen:  # an op past the contig's end covers nothing
            if op == 2:  # deletion: no base quals; counts with -J
                diff[ref_pos] += 1
                diff[min(ref_pos + length, clen)] -= 1
            else:
                ok = q[read_pos : read_pos + min(length, clen - ref_pos)] >= min_bq
                # run-length the pass mask into diff updates
                edges = np.flatnonzero(np.diff(np.concatenate([[0], ok.view(np.int8), [0]])))
                for s, e in zip(edges[::2], edges[1::2]):
                    diff[ref_pos + s] += 1
                    diff[min(ref_pos + e, len(diff) - 1)] -= 1
        if op in _REF_CONSUME:
            ref_pos += length
        if consumes_read:
            read_pos += length


def depth_vectors(header: BamHeader, diffs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """cumsum of the diff arrays -> per-base depth (length = contig length)."""
    return {name: np.cumsum(d[:-1], dtype=np.int32) for name, d in diffs.items()}
