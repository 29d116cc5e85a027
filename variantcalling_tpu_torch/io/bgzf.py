"""BGZF (blocked gzip, the htslib container framing) for ``.vcf.gz`` output.

Counterpart of ``variantcalling_tpu/io/bgzf.py``'s writer and block
reader: independent <=64 KiB gzip members carrying the BC extra field,
closed by the 28-byte EOF sentinel (:data:`BGZF_EOF`), written by
:class:`BgzfWriter`; :func:`block_spans` and :func:`iter_blocks` read a
file back block by block for the ``.tbi`` index (``io/tabix.py``). Full
blocks are deflated by the native engine where it serves
(``native.bgzf_compress``), else by ``zlib`` here; both give the same
bytes where they use the same ``libz``.
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


def _compress_full_blocks(chunk, level: int) -> bytes:
    """BGZF blocks (no EOF block) of a payload whose length is a multiple of
    :data:`MAX_BLOCK_DATA`: from the native engine, which deflates straight
    from the caller's buffer, else one :func:`compress_block` each."""
    from variantcalling_tpu_torch import native

    out = native.bgzf_compress(chunk, level)
    if out is not None:
        return out[:-len(BGZF_EOF)]  # close() writes the EOF block once
    view = memoryview(chunk)
    return b"".join(compress_block(view[i:i + MAX_BLOCK_DATA], level) for i in range(0, len(view), MAX_BLOCK_DATA))


class BgzfWriter:
    """Binary file-like writer emitting BGZF blocks: every full block through
    :func:`_compress_full_blocks`, the last one through :func:`compress_block`."""

    def __init__(self, path: str, level: int = 6):
        self._fh = open(path, "wb")
        self._buf = bytearray()
        self._level = level

    def write(self, data) -> int:
        n_in = len(data)
        if not self._buf and n_in >= MAX_BLOCK_DATA:  # large write: no copy on the way to deflate
            view = memoryview(data)
            n_full = (n_in // MAX_BLOCK_DATA) * MAX_BLOCK_DATA
            self._fh.write(_compress_full_blocks(view[:n_full], self._level))
            self._buf += view[n_full:]
            return n_in
        self._buf += data
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
