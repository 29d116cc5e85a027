"""A numpy-only parquet writer for flat frames of strings, booleans, int64, float32 and float64.

The JAX package writes ``coverage_analysis``'s binned coverage with
pandas' ``to_parquet`` (pyarrow). The card's machine has neither, so the
port writes the file itself, in the simplest layout every reader takes:

- the ``PAR1`` magic;
- one row group; a column chunk a column, cut into data pages (v1) of at
  most :data:`PAGE_ROWS` values, each PLAIN-encoded and uncompressed. The
  columns are declared ``optional``, as pyarrow declares a pandas
  column, so each page starts with its definition levels (all 1: no
  nulls), RLE-encoded with a 4-byte length;
- the Thrift-compact ``FileMetaData``, its 4-byte length and ``PAR1``.

Strings are BYTE_ARRAY with the String logical type (and the legacy UTF8
converted type); bool is BOOLEAN (PLAIN: one bit a value, the first value
in the lowest bit, the last byte padded with 0), int64 INT64, float32
FLOAT, float64 DOUBLE. No
``pandas`` key-value metadata is written: ``pd.read_parquet`` then gives
the default RangeIndex, the frame's index here.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"PAR1"
#: values a data page holds at most
PAGE_ROWS = 1 << 20
CREATED_BY = "variantcalling_tpu_torch parquet writer"

# parquet.thrift enums
_BOOLEAN, _BYTE_ARRAY, _INT64, _FLOAT, _DOUBLE = 0, 6, 2, 4, 5
_PLAIN, _RLE = 0, 3
_DATA_PAGE = 0
_OPTIONAL = 1
_UTF8 = 0
# Thrift compact protocol type ids
_T_I32, _T_I64, _T_BINARY, _T_LIST, _T_STRUCT = 5, 6, 8, 9, 12


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


class _Struct:
    """A Thrift-compact struct written field by field in ascending id order."""

    def __init__(self):
        self.buf = bytearray()
        self._last = 0

    def _head(self, fid: int, ttype: int) -> None:
        delta = fid - self._last
        if 0 < delta <= 15:
            self.buf.append((delta << 4) | ttype)
        else:
            self.buf.append(ttype)
            self.buf += _varint(_zigzag(fid))
        self._last = fid

    def i32(self, fid: int, v: int) -> "_Struct":
        self._head(fid, _T_I32)
        self.buf += _varint(_zigzag(int(v)))
        return self

    def i64(self, fid: int, v: int) -> "_Struct":
        self._head(fid, _T_I64)
        self.buf += _varint(_zigzag(int(v)))
        return self

    def binary(self, fid: int, v: bytes) -> "_Struct":
        self._head(fid, _T_BINARY)
        self.buf += _varint(len(v)) + v
        return self

    def struct(self, fid: int, v: "_Struct") -> "_Struct":
        self._head(fid, _T_STRUCT)
        self.buf += v.end()
        return self

    def list(self, fid: int, etype: int, items: list) -> "_Struct":
        """A list of i32 (``etype`` I32), binaries (BINARY) or structs (STRUCT)."""
        self._head(fid, _T_LIST)
        n = len(items)
        self.buf += bytes([(n << 4) | etype]) if n < 15 else bytes([0xF0 | etype]) + _varint(n)
        for it in items:
            if etype == _T_I32:
                self.buf += _varint(_zigzag(int(it)))
            elif etype == _T_BINARY:
                self.buf += _varint(len(it)) + it
            else:
                self.buf += it.end()
        return self

    def end(self) -> bytes:
        return bytes(self.buf) + b"\x00"


def _physical(values: np.ndarray) -> int:
    if values.dtype.kind in "OUS":
        return _BYTE_ARRAY
    kinds = {np.dtype(bool): _BOOLEAN, np.dtype(np.int64): _INT64, np.dtype(np.float32): _FLOAT,
             np.dtype(np.float64): _DOUBLE}
    if values.dtype not in kinds:
        raise ValueError(f"parquet writer: no type for {values.dtype} (strings, bool, int64, float32, float64)")
    return kinds[values.dtype]


def _plain(values: np.ndarray, ptype: int) -> bytes:
    """PLAIN encoding: booleans bit-packed, the first in the lowest bit;
    little-endian fixed-width numbers; a BYTE_ARRAY value as its 4-byte
    length and its UTF-8 bytes (built as one byte matrix and compacted, no
    loop over the values)."""
    if ptype == _BOOLEAN:
        return np.packbits(values, bitorder="little").tobytes()
    if ptype != _BYTE_ARRAY:
        return np.ascontiguousarray(values, dtype=values.dtype.newbyteorder("<")).tobytes()
    raw = values if values.dtype.kind == "S" else np.char.encode(values.astype(str), "utf-8")
    n, width = len(raw), raw.dtype.itemsize
    lens = np.char.str_len(raw).astype("<u4")
    mat = np.empty((n, 4 + width), dtype=np.uint8)
    mat[:, :4] = lens.view(np.uint8).reshape(n, 4)
    mat[:, 4:] = np.ascontiguousarray(raw).view(np.uint8).reshape(n, width)
    keep = np.ones(mat.shape, dtype=bool)
    keep[:, 4:] = np.arange(width) < lens[:, None]
    return mat[keep].tobytes()


def _def_levels(n: int) -> bytes:
    """``n`` definition levels of 1 (bit width 1) as one RLE run, with the
    4-byte length a v1 data page puts before them."""
    body = _varint(n << 1) + b"\x01" if n else b""
    return struct.pack("<I", len(body)) + body


def _pages(values: np.ndarray, ptype: int) -> bytes:
    """The column's data pages, one a :data:`PAGE_ROWS` values (one, empty,
    for an empty column)."""
    out = bytearray()
    for lo in range(0, max(len(values), 1), PAGE_ROWS):
        part = values[lo: lo + PAGE_ROWS]
        data = _def_levels(len(part)) + _plain(part, ptype)
        dph = _Struct().i32(1, len(part)).i32(2, _PLAIN).i32(3, _RLE).i32(4, _RLE)
        header = _Struct().i32(1, _DATA_PAGE).i32(2, len(data)).i32(3, len(data)).struct(5, dph)
        out += header.end() + data
    return bytes(out)


def write_parquet(path: str, columns: dict[str, np.ndarray]) -> None:
    """Write the columns (equal lengths, in order) as one row group."""
    names = list(columns)
    arrays = [np.asarray(columns[n]) for n in names]
    n_rows = len(arrays[0]) if arrays else 0
    if any(len(a) != n_rows for a in arrays):
        raise ValueError(f"parquet writer: columns of unequal lengths {[len(a) for a in arrays]}")
    body = bytearray(MAGIC)
    chunks, schema = [], [_Struct().binary(4, b"schema").i32(5, len(names))]
    for name, values in zip(names, arrays):
        ptype = _physical(values)
        offset = len(body)
        body += _pages(values, ptype)
        size = len(body) - offset
        meta = (_Struct().i32(1, ptype).list(2, _T_I32, [_PLAIN, _RLE]).list(3, _T_BINARY, [name.encode()])
                .i32(4, 0).i64(5, n_rows).i64(6, size).i64(7, size).i64(9, offset))
        chunks.append(_Struct().i64(2, offset).struct(3, meta))
        element = _Struct().i32(1, ptype).i32(3, _OPTIONAL).binary(4, name.encode())
        if ptype == _BYTE_ARRAY:
            element.i32(6, _UTF8).struct(10, _Struct().struct(1, _Struct()))  # LogicalType.STRING
        schema.append(element)
    total = len(body) - len(MAGIC)
    group = _Struct().list(1, _T_STRUCT, chunks).i64(2, total).i64(3, n_rows).i64(5, len(MAGIC)).i64(6, total)
    footer = (_Struct().i32(1, 1).list(2, _T_STRUCT, schema).i64(3, n_rows).list(4, _T_STRUCT, [group])
              .binary(6, CREATED_BY.encode()).end())
    body += footer + struct.pack("<I", len(footer)) + MAGIC
    with open(path, "wb") as fh:
        fh.write(body)
