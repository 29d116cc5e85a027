"""BGZF (blocked gzip, the htslib container framing) for ``.vcf.gz`` input and output.

Counterpart of ``variantcalling_tpu/io/bgzf.py``: independent <=64 KiB gzip
members carrying the BC extra field, closed by the 28-byte EOF sentinel
(:data:`BGZF_EOF`), written by :class:`BgzfWriter` or, chunk by chunk in
the streaming executor, by :class:`BgzfChunkCompressor` (the same bytes);
:func:`block_spans` and :func:`iter_blocks` read a file back block by block
for the ``.tbi`` index (``io/tabix.py``). Full blocks are deflated by the
native engine where it serves (``native.bgzf_compress``), else by ``zlib``
here; both give the same bytes where they use the same ``libz``.

Members are independent deflate streams, so the streaming ingest splits a
compressed input at member boundaries (:func:`scan_block_spans`,
:func:`group_spans`) and inflates the shards on a worker pool
(:func:`inflate_spans`).
"""

from __future__ import annotations

import struct
import zlib

MAX_BLOCK_DATA = 65280  # uncompressed payload per block (htslib convention)
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")


def compress_block(data, level: int = 6) -> bytes:
    """One complete BGZF block for <=64 KiB of payload."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    deflated = co.compress(data) + co.flush()
    bsize = len(deflated) + 26  # header(18) + deflated + crc/isize(8)
    if bsize - 1 > 0xFFFF:
        raise ValueError("BGZF block overflow (incompressible 64K payload)")
    header = (
        b"\x1f\x8b\x08\x04"  # magic, CM=deflate, FLG=FEXTRA
        + b"\x00\x00\x00\x00"  # MTIME
        + b"\x00\xff"  # XFL, OS=unknown
        + struct.pack("<H", 6)  # XLEN
        + b"BC"
        + struct.pack("<H", 2)
        + struct.pack("<H", bsize - 1)  # BSIZE = total block size - 1
    )
    trailer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data) & 0xFFFFFFFF)
    return header + deflated + trailer


def block_spans(data) -> list[tuple[int, int]]:
    """(compressed offset, block size) of every BGZF block of ``data``; raises
    ``ValueError`` where the bytes are not BGZF."""
    spans = []
    off, n = 0, len(data)
    while off < n:
        if data[off: off + 2] != b"\x1f\x8b" or off + 12 > n:
            raise ValueError(f"not BGZF at offset {off}")
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        xoff, bsize = off + 12, None
        while xoff + 4 <= off + 12 + xlen:
            slen = struct.unpack_from("<H", data, xoff + 2)[0]
            if data[xoff: xoff + 2] == b"BC" and slen == 2:
                bsize = struct.unpack_from("<H", data, xoff + 4)[0] + 1
            xoff += 4 + slen
        if bsize is None or off + bsize > n:
            raise ValueError(f"no BC subfield, or a truncated block, at offset {off}")
        spans.append((off, bsize))
        off += bsize
    return spans


def inflate_block(data, off: int, bsize: int) -> bytes:
    """The uncompressed payload of the block at ``off``."""
    xlen = struct.unpack_from("<H", data, off + 10)[0]
    return zlib.decompress(data[off + 12 + xlen: off + bsize - 8], wbits=-15)


def iter_blocks(path: str):
    """Yield (compressed offset, uncompressed payload) of each block of a BGZF file."""
    with open(path, "rb") as fh:
        data = fh.read()
    for off, bsize in block_spans(data):
        yield off, inflate_block(data, off, bsize)


def scan_block_spans(buf) -> list[tuple[int, int, int]] | None:
    """(compressed offset, compressed size, uncompressed size) of every
    member of ``buf`` (bytes-like, random access), or None when the stream
    is not BGZF-framed end to end (plain single-member gzip, a missing BC
    subfield, a truncated chain): callers then inflate it serially."""
    mv = memoryview(buf)
    n = len(mv)
    spans: list[tuple[int, int, int]] = []
    off = 0
    try:
        while off < n:
            if n - off < 18 or bytes(mv[off:off + 4]) != b"\x1f\x8b\x08\x04":
                return None  # not BGZF-framed (magic/FEXTRA missing)
            (xlen,) = struct.unpack("<H", mv[off + 10:off + 12])
            xoff = off + 12
            xend = xoff + xlen
            if xend > n:
                return None
            bsize = None
            while xoff + 4 <= xend:
                (slen,) = struct.unpack("<H", mv[xoff + 2:xoff + 4])
                if mv[xoff] == 0x42 and mv[xoff + 1] == 0x43 and slen == 2:
                    if xoff + 6 > n:
                        return None  # truncated inside the BC payload
                    (b,) = struct.unpack("<H", mv[xoff + 4:xoff + 6])
                    bsize = b + 1
                xoff += 4 + slen
            if bsize is None or off + bsize > n or bsize < 12 + xlen + 8:
                return None
            (isize,) = struct.unpack("<I", mv[off + bsize - 4:off + bsize])
            spans.append((off, bsize, isize))
            off += bsize
    except struct.error:
        return None  # truncated mid-field
    return spans


def group_spans(spans, shard_bytes: int) -> list[list[tuple[int, int, int]]]:
    """Consecutive member spans grouped into inflate shards of about
    ``shard_bytes`` uncompressed bytes each."""
    groups: list[list[tuple[int, int, int]]] = []
    cur: list[tuple[int, int, int]] = []
    acc = 0
    for span in spans:
        cur.append(span)
        acc += span[2]
        if acc >= shard_bytes:
            groups.append(cur)
            cur, acc = [], 0
    if cur:
        groups.append(cur)
    return groups


def inflate_spans(buf, spans) -> bytes:
    """The uncompressed bytes of a run of members of ``buf`` (one shard; zlib
    releases the interpreter lock, so shards inflate concurrently)."""
    mv = memoryview(buf)
    out = []
    for off, bsize, _isize in spans:
        (xlen,) = struct.unpack("<H", mv[off + 10:off + 12])
        out.append(zlib.decompress(mv[off + 12 + xlen:off + bsize - 8], wbits=-15))
    return b"".join(out)


def _compress_full_blocks(chunk, level: int, pool=None) -> bytes:
    """BGZF blocks (no EOF block) of a payload whose length is a multiple of
    :data:`MAX_BLOCK_DATA`: from the native engine, which deflates straight
    from the caller's buffer, else one :func:`compress_block` each, on
    ``pool`` where given."""
    from variantcalling_tpu_torch import native

    out = native.bgzf_compress(chunk, level)
    if out is not None:
        return out[:-len(BGZF_EOF)]  # close() writes the EOF block once
    view = memoryview(chunk)
    blocks = [view[i:i + MAX_BLOCK_DATA] for i in range(0, len(view), MAX_BLOCK_DATA)]
    if pool is not None and len(blocks) > 1:
        from variantcalling_tpu_torch.parallel.pipeline import imap_ordered

        return b"".join(imap_ordered(pool, lambda b: compress_block(b, level), blocks, window=2 * pool.threads))
    return b"".join(compress_block(b, level) for b in blocks)


class BgzfWriter:
    """Binary file-like writer emitting BGZF blocks: every full block through
    :func:`_compress_full_blocks`, the last one through :func:`compress_block`."""

    def __init__(self, path: str, level: int = 6):
        self._fh = open(path, "wb")
        self._buf = bytearray()
        self._level = level

    def write(self, data) -> int:
        n_in = len(data)
        view = memoryview(data)
        if self._buf and len(self._buf) + n_in >= 2 * MAX_BLOCK_DATA:
            # the carry topped up to one block alone, so that the rest goes to deflate uncopied
            fill = MAX_BLOCK_DATA - len(self._buf)
            self._buf += view[:fill]
            self._fh.write(_compress_full_blocks(bytes(self._buf), self._level))
            self._buf.clear()
            view = view[fill:]
        if not self._buf and len(view) >= MAX_BLOCK_DATA:  # large write: no copy on the way to deflate
            n_full = (len(view) // MAX_BLOCK_DATA) * MAX_BLOCK_DATA
            self._fh.write(_compress_full_blocks(view[:n_full], self._level))
            self._buf += view[n_full:]
            return n_in
        self._buf += view
        if len(self._buf) >= MAX_BLOCK_DATA:
            n_full = (len(self._buf) // MAX_BLOCK_DATA) * MAX_BLOCK_DATA
            chunk = bytes(self._buf[:n_full])
            del self._buf[:n_full]
            self._fh.write(_compress_full_blocks(chunk, self._level))
        return n_in

    def close(self) -> None:
        if self._fh.closed:
            return
        if self._buf:
            self._fh.write(compress_block(bytes(self._buf), self._level))
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BgzfChunkCompressor:
    """BGZF framing of the streaming writeback's compress stage.

    The byte stream is cut into consecutive :data:`MAX_BLOCK_DATA` payloads
    exactly as a serial :class:`BgzfWriter` cuts it (the carry is always the
    stream length mod :data:`MAX_BLOCK_DATA`, whatever the write sizes), so
    the output is the serial writer's bytes at any chunk size or worker
    count. :meth:`add` runs on one stage thread in chunk order; the deflate
    itself fans out (the native engine's shards, or ``pool``).
    """

    def __init__(self, level: int = 6, pool=None):
        self._carry = bytearray()
        self._level = level
        self._pool = pool

    def add(self, body) -> bytes:
        """Compressed blocks of every full payload of carry + ``body``; the
        rest becomes the next carry. ``body`` is not copied where it alone
        covers the full blocks."""
        from variantcalling_tpu_torch.utils import faults

        # injection point "io.shard_compress": a compress-worker death is a
        # stage exception; the atomic commit discards the torn partial
        faults.check("io.shard_compress")
        view = body if isinstance(body, memoryview) else memoryview(body)
        if not self._carry:
            n_full = (len(view) // MAX_BLOCK_DATA) * MAX_BLOCK_DATA
            out = _compress_full_blocks(view[:n_full], self._level, self._pool) if n_full else b""
            if n_full < len(view):
                self._carry += view[n_full:]
            return out
        need = MAX_BLOCK_DATA - len(self._carry)
        if len(view) < need:
            self._carry += view
            return b""
        self._carry += view[:need]
        head = bytes(self._carry)
        self._carry.clear()
        rest = view[need:]
        n_full = (len(rest) // MAX_BLOCK_DATA) * MAX_BLOCK_DATA
        out = _compress_full_blocks(head, self._level, self._pool)
        if n_full:
            out += _compress_full_blocks(rest[:n_full], self._level, self._pool)
        if n_full < len(rest):
            self._carry += rest[n_full:]
        return out

    def finish(self) -> bytes:
        """The last partial block (if any) and the EOF block: the tail
        :meth:`BgzfWriter.close` writes."""
        out = b""
        if self._carry:
            out = compress_block(bytes(self._carry), self._level)
            self._carry.clear()
        return out + BGZF_EOF
