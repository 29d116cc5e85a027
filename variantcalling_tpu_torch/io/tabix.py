"""Tabix (``.tbi``) index of a BGZF-compressed VCF or BED, and region reads through it.

Counterpart of ``variantcalling_tpu/io/tabix.py``: the same index bytes
for the same ``.vcf.gz`` file, so that htslib tools (bcftools, IGV) read
the port's outputs as they read the reference's. Format per the tabix
spec: a BGZF-wrapped payload of UCSC-binned chunk lists and a 16 kb linear
index; a virtual file offset is ``(compressed block offset << 16) |
offset in the block``.

The index needs records sorted by position within each contig and each
contig in one run; :func:`build_tabix_index` raises ``ValueError`` on
anything else, and ``io/vcf.write_vcf`` then writes no index.
"""

from __future__ import annotations

import struct

import numpy as np

from variantcalling_tpu_torch.io.bgzf import BGZF_EOF, MAX_BLOCK_DATA, block_spans, compress_block, \
    inflate_block, iter_blocks

TBI_MAGIC = b"TBI\x01"
FMT_VCF = 2
FMT_BED = 0x10000  # generic, 0-based half-open
LINEAR_SHIFT = 14


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning: the smallest bin that holds all of [beg, end) (0-based)."""
    end -= 1
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return base + (beg >> shift)
    return 0


def _reg2bins(beg: int, end: int) -> list[int]:
    """Every bin that overlaps [beg, end)."""
    bins = [0]
    end -= 1
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


class _RefIndex:
    """One contig's bins (each a list of merged chunks) and linear index."""

    def __init__(self):
        self.bins: dict[int, list[tuple[int, int]]] = {}
        self.linear: dict[int, int] = {}
        self.last_beg = -1

    def add(self, beg: int, end: int, v_start: int, v_end: int) -> None:
        chunks = self.bins.setdefault(reg2bin(beg, end), [])
        if chunks and chunks[-1][1] >= v_start:  # adjacent chunks merge, as htslib's do
            chunks[-1] = (chunks[-1][0], v_end)
        else:
            chunks.append((v_start, v_end))
        for w in range(beg >> LINEAR_SHIFT, ((max(end, beg + 1) - 1) >> LINEAR_SHIFT) + 1):
            if w not in self.linear or v_start < self.linear[w]:
                self.linear[w] = v_start


def build_tabix_index(path: str, preset: int = FMT_VCF, col_seq: int = 1, col_beg: int = 2,
                      col_end: int = 0, meta_char: str = "#") -> str:
    """Write ``<path>.tbi`` for a sorted BGZF VCF (record span: POS to
    POS + len(REF)) or BED (columns ``col_beg``/``col_end``); returns its path.

    A record's chunk starts at the virtual offset of its first byte and ends
    after its newline; a newline that ends a block ends the chunk at that
    block's end.
    """
    names: list[str] = []
    refs: dict[str, _RefIndex] = {}
    starts: list[tuple[int, int]] = []  # (uncompressed start, compressed offset) of live blocks
    tail, tail_at, total = b"", 0, 0  # unconsumed bytes and their uncompressed offset

    def voffset(u: int) -> int:
        for ustart, coff in reversed(starts):
            if ustart <= u:
                return (coff << 16) | (u - ustart)
        raise AssertionError("offset before the first live block")

    for coff, data in iter_blocks(path):
        starts.append((total, coff))
        total += len(data)
        buf = tail + data
        pos = 0
        while (nl := buf.find(b"\n", pos)) >= 0:
            v_end = voffset(tail_at + nl + 1) if nl + 1 < len(buf) else (coff << 16) | len(data)
            _index_line(buf[pos:nl], names, refs, voffset(tail_at + pos), v_end, preset, col_seq,
                        col_beg, col_end, meta_char)
            pos = nl + 1
        tail, tail_at = buf[pos:], tail_at + pos
        while len(starts) > 1 and starts[1][0] <= tail_at:
            starts.pop(0)
    out = path + ".tbi"
    _write_tbi(out, names, refs, preset, col_seq, col_beg, col_end, meta_char)
    return out


def _index_line(line: bytes, names, refs, v_start, v_end, preset, col_seq, col_beg, col_end, meta_char):
    if not line or line.startswith(meta_char.encode()):
        return
    fields = line.split(b"\t")
    try:
        chrom = fields[col_seq - 1].decode()
        beg = int(fields[col_beg - 1])
    except (IndexError, ValueError):
        return
    if preset == FMT_VCF:
        beg -= 1  # VCF is 1-based
        end = beg + max(len(fields[3]) if len(fields) > 3 else 1, 1)
    else:
        end = int(fields[col_end - 1]) if col_end and len(fields) >= col_end else beg + 1
    ref = refs.get(chrom)
    if ref is None:
        names.append(chrom)
        ref = refs[chrom] = _RefIndex()
    elif chrom != names[-1] or beg < ref.last_beg:
        raise ValueError(f"records are not sorted: {chrom}:{beg + 1} after {names[-1]}:{refs[names[-1]].last_beg + 1}")
    ref.last_beg = beg
    ref.add(beg, end, v_start, v_end)


def _write_tbi(out: str, names, refs, preset, col_seq, col_beg, col_end, meta_char) -> None:
    payload = bytearray(TBI_MAGIC)
    payload += struct.pack("<i", len(names))
    payload += struct.pack("<6i", preset, col_seq, col_beg, col_end, ord(meta_char), 0)
    nm = b"".join(n.encode() + b"\x00" for n in names)
    payload += struct.pack("<i", len(nm)) + nm
    for name in names:
        ref = refs[name]
        payload += struct.pack("<i", len(ref.bins))
        for b, chunks in sorted(ref.bins.items()):
            payload += struct.pack("<Ii", b, len(chunks))
            for s, e in chunks:
                payload += struct.pack("<QQ", s, e)
        if ref.linear:
            ioff = np.zeros(max(ref.linear) + 1, dtype=np.uint64)
            prev = 0
            for w in range(len(ioff)):
                prev = ref.linear.get(w, prev)
                ioff[w] = prev
            payload += struct.pack("<i", len(ioff)) + ioff.tobytes()
        else:
            payload += struct.pack("<i", 0)
    data = bytes(payload)
    with open(out, "wb") as fh:
        for i in range(0, max(len(data), 1), MAX_BLOCK_DATA):
            fh.write(compress_block(data[i: i + MAX_BLOCK_DATA]))
        fh.write(BGZF_EOF)


class TabixIndex:
    """A parsed ``.tbi``: per contig its bins (chunk lists) and linear index."""

    def __init__(self, names, bins, linear, preset, col_seq, col_beg, col_end, meta_char):
        self.names = names
        self.bins = bins  # name -> {bin: [(v_start, v_end)]}
        self.linear = linear  # name -> np.uint64 array
        self.preset = preset
        self.col_seq, self.col_beg, self.col_end = col_seq, col_beg, col_end
        self.meta_char = meta_char

    @staticmethod
    def load(path: str) -> "TabixIndex":
        data = b"".join(chunk for _, chunk in iter_blocks(path))
        if data[:4] != TBI_MAGIC:
            raise ValueError(f"{path}: not a TBI index")
        n_ref, preset, col_seq, col_beg, col_end, meta, _skip, l_nm = struct.unpack_from("<8i", data, 4)
        off = 36
        names = [n.decode() for n in data[off: off + l_nm].rstrip(b"\x00").split(b"\x00")][:n_ref]
        off += l_nm
        bins: dict[str, dict[int, list[tuple[int, int]]]] = {}
        linear: dict[str, np.ndarray] = {}
        for name in names:
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            b: dict[int, list[tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                flat = struct.unpack_from(f"<{2 * n_chunk}Q", data, off)
                off += 16 * n_chunk
                b[bin_id] = list(zip(flat[::2], flat[1::2]))
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            linear[name] = np.frombuffer(data, dtype=np.uint64, count=n_intv, offset=off).copy()
            off += 8 * n_intv
            bins[name] = b
        return TabixIndex(names, bins, linear, preset, col_seq, col_beg, col_end, chr(meta))

    def query_chunks(self, chrom: str, beg: int, end: int) -> list[tuple[int, int]]:
        """Merged candidate (v_start, v_end) chunks for 0-based [beg, end)."""
        if chrom not in self.bins:
            return []
        lin = self.linear.get(chrom)
        min_off = int(lin[beg >> LINEAR_SHIFT]) if lin is not None and (beg >> LINEAR_SHIFT) < len(lin) else 0
        found = sorted((max(s, min_off), e) for b in _reg2bins(beg, end)
                       for s, e in self.bins[chrom].get(b, []) if e > min_off)
        merged: list[tuple[int, int]] = []
        for s, e in found:  # overlapping ranges merge, so no line is read twice
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged


def read_region_lines(vcf_path: str, chrom: str, beg: int, end: int, index: TabixIndex | None = None):
    """Yield the record lines that overlap 0-based [beg, end), reading only
    the BGZF blocks the index points at."""
    index = index or TabixIndex.load(vcf_path + ".tbi")
    chunks = index.query_chunks(chrom, beg, end)
    if not chunks:
        return
    with open(vcf_path, "rb") as fh:
        data = fh.read()
    spans = dict(block_spans(data))
    cache: dict[int, bytes] = {}
    for v_start, v_end in chunks:
        coff, uoff = v_start >> 16, v_start & 0xFFFF
        end_coff, end_uoff = v_end >> 16, v_end & 0xFFFF
        text = bytearray()
        while True:
            if coff not in cache:
                cache[coff] = inflate_block(data, coff, spans[coff])
            block = cache[coff]
            text += block[uoff: end_uoff if coff == end_coff else len(block)]
            nxt = coff + spans[coff]
            if coff == end_coff or nxt >= len(data):
                break
            coff, uoff = nxt, 0
        for line in bytes(text).split(b"\n"):
            if not line or line.startswith(index.meta_char.encode()):
                continue
            fields = line.split(b"\t")
            try:
                c = fields[index.col_seq - 1].decode()
                p = int(fields[index.col_beg - 1])
            except (IndexError, ValueError):
                continue
            if index.preset == FMT_VCF:
                rb = p - 1
                re_ = rb + max(len(fields[3]) if len(fields) > 3 else 1, 1)
            else:
                rb = p
                re_ = int(fields[index.col_end - 1]) if index.col_end else rb + 1
            if c == chrom and rb < end and re_ > beg:
                yield line.decode()
