"""An HDF5 parser and writer in numpy, for the frames the pipelines read and write.

The reference reads and writes HDF5 through h5py; the port may not depend on
h5py (nor on pandas), so this module reads the file format itself, as far
as the frames of ``utils/h5_utils`` need and no further:

- superblock versions 0 and 1;
- version 1 object headers, with continuation messages;
- symbol-table groups: version 1 B-trees of type 0, ``SNOD`` nodes and the
  local heap that holds the link names;
- dataspaces: scalar and simple;
- datatypes: fixed-point, floating-point, fixed-length strings,
  variable-length strings and sequences (from global heap collections,
  ``GCOL``), and enumerations over an integer (the ``FALSE``/``TRUE`` enum
  that h5py and pytables write for booleans reads as numpy bool), in
  either byte order;
- data layout version 3: compact, contiguous, and chunked through a
  version 1 B-tree of type 1, with the deflate (``zlib``) and shuffle
  filters; the fill value where no data was written (the undefined
  address: an empty dataset, or a chunk never written);
- attribute messages of versions 1 to 3.

Anything else raises :class:`H5Unsupported`, naming the feature (superblock
version 2 or 3 as written by ``libver="latest"``, version 2 object headers,
new-style and dense link storage, dense attribute storage, another filter,
a compound type, ...): the reader never returns values it did not decode.

The write half (:func:`write_file`) emits only what the reader parses, in
the layout h5py writes by default: superblock 0, version 1 object headers,
symbol-table groups (a version 1 B-tree of ``SNOD`` nodes over a local
heap of names, more levels past 256 members), contiguous datasets of
fixed-point, IEEE float, fixed-length and variable-length UTF-8 string
types, and version 1 attributes (scalars and arrays of those types), the
variable-length strings in global heap collections. A file is written
whole (a temporary name and ``os.replace``); :func:`read_tree` reads one
back as the writer's nodes, so that a key can be added to it.
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL, _LINK = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5, 0x6
_EXTERNAL, _LAYOUT, _BOGUS, _GROUP_INFO, _FILTERS, _ATTRIBUTE = 0x7, 0x8, 0x9, 0xA, 0xB, 0xC
_COMMENT, _MTIME_OLD, _SHARED_TABLE, _CONTINUATION, _SYMBOL_TABLE = 0xD, 0xE, 0xF, 0x10, 0x11
_MTIME, _BTREE_K, _DRIVER_INFO, _ATTR_INFO, _REFCOUNT = 0x12, 0x13, 0x14, 0x15, 0x16
# messages that carry nothing the values depend on
_IGNORED = {_NIL, _FILL_OLD, _GROUP_INFO, _COMMENT, _MTIME_OLD, _MTIME, _BTREE_K, _DRIVER_INFO, _REFCOUNT}

_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference", 10: "array"}
_IEEE = {2: (5, 10), 4: (8, 23), 8: (11, 52)}  # bytes -> (exponent bits, mantissa bits)


class H5Unsupported(ValueError):
    """The file uses an HDF5 feature this reader does not implement; the
    message names it."""


class _Type:
    """A decoded datatype: ``kind`` is "num" (a numpy dtype), "vstr" (a
    variable-length string) or "vseq" (a variable-length sequence of
    ``base``); ``size`` is the bytes of one stored element."""

    __slots__ = ("kind", "dtype", "size", "base")

    def __init__(self, kind: str, size: int, dtype: np.dtype | None = None, base: "_Type | None" = None):
        self.kind, self.size, self.dtype, self.base = kind, size, dtype, base


class H5File:
    """An open HDF5 file: ``root`` is its root :class:`Group`."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            self._mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        self._heaps: dict[int, dict[int, bytes]] = {}
        try:
            self.root = Group(self, self._superblock(), "/")
        except BaseException:
            self.close()
            raise

    # -- low-level reads -------------------------------------------------------

    def _bytes(self, addr: int, n: int) -> bytes:
        if addr < 0 or addr + n > len(self._mm):
            raise H5Unsupported(f"{self.path}: a structure at {addr} runs past the end of the file (truncated?)")
        return self._mm[addr: addr + n]

    def _u(self, buf, off: int, n: int) -> int:
        return int.from_bytes(buf[off: off + n], "little")

    def _addr(self, buf, off: int) -> int | None:
        """An address field (relative to the base address) as an absolute
        offset, or None for the undefined address."""
        v = self._u(buf, off, self.so)
        return None if v == (1 << (8 * self.so)) - 1 else self.base + v

    def _superblock(self) -> int:
        """Parse the superblock; returns the root group's object header address."""
        at = 0
        while at + 8 <= len(self._mm) and self._mm[at: at + 8] != _SIGNATURE:
            at = 512 if at == 0 else 2 * at
        if at + 8 > len(self._mm):
            raise H5Unsupported(f"{self.path}: not an HDF5 file (no superblock signature)")
        version = self._mm[at + 8]
        if version not in (0, 1):
            raise H5Unsupported(f"{self.path}: superblock version {version} (files written with "
                                "libver='latest' or 'v108' and later); this reader reads versions 0 and 1")
        self.so, self.sl = self._mm[at + 13], self._mm[at + 14]
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise H5Unsupported(f"{self.path}: offsets of {self.so} bytes, lengths of {self.sl} bytes")
        p = at + 24 + (4 if version == 1 else 0)
        buf = self._bytes(p, 4 * self.so + 2 * self.so)
        self.base = 0
        self.base = self._addr(buf, 0) or 0
        # the root group's symbol table entry: link name offset, object header address
        return self._addr(buf, 4 * self.so + self.so)

    def _messages(self, addr: int) -> list[tuple[int, bytes]]:
        """(type, data) of every message of the version 1 object header at ``addr``."""
        head = self._bytes(addr, 16)
        if head[:4] == b"OHDR":
            raise H5Unsupported(f"{self.path}: version 2 object headers (written with libver='latest' "
                                "or with tracked creation order)")
        if head[0] != 1:
            raise H5Unsupported(f"{self.path}: object header version {head[0]}")
        blocks = [(addr + 16, self._u(head, 8, 4))]
        out = []
        while blocks:
            start, size = blocks.pop(0)
            buf = self._bytes(start, size)
            p = 0
            while p + 8 <= size:
                mtype, msize, flags = self._u(buf, p, 2), self._u(buf, p + 2, 2), buf[p + 4]
                data = buf[p + 8: p + 8 + msize]
                p += 8 + msize
                if flags & 0x2:
                    raise H5Unsupported(f"{self.path}: shared object header messages (type {mtype})")
                if mtype == _CONTINUATION:
                    blocks.append((self._addr(data, 0), self._u(data, self.so, self.sl)))
                elif mtype not in _IGNORED:
                    out.append((mtype, data))
        return out

    # -- datatypes, dataspaces ------------------------------------------------

    def _datatype(self, buf, off: int = 0) -> tuple[_Type, int]:
        """(type, encoded length) of the datatype message at ``buf[off:]``."""
        cls, version = buf[off] & 0x0F, buf[off] >> 4
        bits = self._u(buf, off + 1, 3)
        size = self._u(buf, off + 4, 4)
        if cls == 0:  # fixed-point
            bit_off, prec = self._u(buf, off + 8, 2), self._u(buf, off + 10, 2)
            if size not in (1, 2, 4, 8) or bit_off != 0 or prec != 8 * size:
                raise H5Unsupported(f"{self.path}: a {prec}-bit integer at bit {bit_off} of {size} bytes")
            order = ">" if bits & 1 else "<"
            return _Type("num", size, np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}")), 12
        if cls == 1:  # floating-point
            bit_off, prec = self._u(buf, off + 8, 2), self._u(buf, off + 10, 2)
            exp_size, mant_size = buf[off + 13], buf[off + 15]
            order_bits = (bits & 1) | ((bits >> 5) & 2)
            if order_bits not in (0, 1):
                raise H5Unsupported(f"{self.path}: VAX-ordered floating point")
            if _IEEE.get(size) != (exp_size, mant_size) or bit_off != 0 or prec != 8 * size:
                raise H5Unsupported(f"{self.path}: a non-IEEE {size}-byte floating-point type")
            return _Type("num", size, np.dtype(f"{'>' if order_bits else '<'}f{size}")), 20
        if cls == 3:  # fixed-length string
            if bits & 0xF == 2:
                raise H5Unsupported(f"{self.path}: space-padded fixed-length strings")
            return _Type("num", size, np.dtype(f"S{size}")), 8
        if cls == 8:  # enumeration over an integer
            base, blen = self._datatype(buf, off + 8)
            if base.kind != "num" or base.dtype.kind not in "iu":
                raise H5Unsupported(f"{self.path}: an enumeration over a non-integer type")
            n = bits & 0xFFFF
            p = off + 8 + blen
            names = []
            for _ in range(n):
                end = bytes(buf[p:]).index(b"\0")
                names.append(bytes(buf[p: end + p]).decode())
                p += end + 1 if version >= 3 else (end + 8) // 8 * 8
            values = np.frombuffer(bytes(buf[p: p + n * base.size]), dtype=base.dtype).tolist()
            p += n * base.size
            if dict(zip(names, values)) == {"FALSE": 0, "TRUE": 1} and base.size == 1:
                return _Type("num", 1, np.dtype(np.bool_)), p - off
            return base, p - off
        if cls == 9:  # variable-length
            base, blen = self._datatype(buf, off + 8)
            return _Type("vstr" if bits & 0xF == 1 else "vseq", size, base=base), 8 + blen
        raise H5Unsupported(f"{self.path}: {_CLASS_NAMES.get(cls, f'class {cls}')} datatypes")

    def _dataspace(self, buf) -> tuple[int, ...]:
        version, rank, flags = buf[0], buf[1], buf[2]
        if version == 1:
            if flags & 0x2:
                raise H5Unsupported(f"{self.path}: dataspace permutation indices")
            p = 8
        elif version == 2:
            if buf[3] == 2:
                raise H5Unsupported(f"{self.path}: null dataspaces")
            p = 4
        else:
            raise H5Unsupported(f"{self.path}: dataspace message version {version}")
        return tuple(self._u(buf, p + i * self.sl, self.sl) for i in range(rank))

    # -- variable-length data -----------------------------------------------

    def _heap_object(self, addr: int, index: int) -> bytes:
        heap = self._heaps.get(addr)
        if heap is None:
            head = self._bytes(addr, 8 + self.sl)
            if head[:4] != b"GCOL":
                raise H5Unsupported(f"{self.path}: no global heap collection at {addr}")
            size = self._u(head, 8, self.sl)
            buf = self._bytes(addr, size)
            heap, p = {}, 8 + self.sl
            while p + 8 + self.sl <= size:
                idx = self._u(buf, p, 2)
                n = self._u(buf, p + 8, self.sl)
                if idx == 0:  # free space: the rest of the collection
                    break
                heap[idx] = bytes(buf[p + 8 + self.sl: p + 8 + self.sl + n])
                p += 8 + self.sl + (n + 7) // 8 * 8
            self._heaps[addr] = heap
        return heap[index]

    def _decode(self, raw: bytes, dtype: _Type, shape: tuple[int, ...]) -> np.ndarray:
        """Stored elements -> numpy: fixed types by a view; variable-length
        ones as an object array of bytes (strings) or arrays (sequences)."""
        n = int(np.prod(shape, dtype=np.int64))
        if dtype.kind == "num":
            return np.frombuffer(raw, dtype=dtype.dtype, count=n).reshape(shape)
        out = np.empty(n, dtype=object)
        for i in range(n):
            e = i * dtype.size
            length = self._u(raw, e, 4)
            addr = self._addr(raw, e + 4)
            data = b"" if addr is None or length == 0 else \
                self._heap_object(addr, self._u(raw, e + 4 + self.so, 4))
            if dtype.kind == "vstr":
                out[i] = data[:length]
            else:
                base = dtype.base
                if base.kind != "num":
                    raise H5Unsupported(f"{self.path}: nested variable-length types")
                out[i] = np.frombuffer(data, dtype=base.dtype, count=length).copy()
        return out.reshape(shape)

    def _attributes(self, msgs: list[tuple[int, bytes]]) -> dict:
        attrs = {}
        for mtype, buf in msgs:
            if mtype == _ATTR_INFO:
                heap_addr = self._addr(buf, 2 + (2 if buf[1] & 1 else 0))
                if heap_addr is not None:
                    raise H5Unsupported(f"{self.path}: dense attribute storage")
            if mtype != _ATTRIBUTE:
                continue
            version = buf[0]
            if version not in (1, 2, 3):
                raise H5Unsupported(f"{self.path}: attribute message version {version}")
            if version > 1 and buf[1] & 0x3:
                raise H5Unsupported(f"{self.path}: attributes of shared datatypes or dataspaces")
            nlen, tlen, slen = self._u(buf, 2, 2), self._u(buf, 4, 2), self._u(buf, 6, 2)

            def pad(n: int) -> int:
                return (n + 7) // 8 * 8 if version == 1 else n

            p = 8 + (1 if version == 3 else 0)
            name = bytes(buf[p: p + nlen]).split(b"\0", 1)[0].decode()
            p += pad(nlen)
            dtype, _ = self._datatype(buf, p)
            p += pad(tlen)
            shape = self._dataspace(buf[p: p + slen])
            p += pad(slen)
            n = int(np.prod(shape, dtype=np.int64))
            value = self._decode(bytes(buf[p: p + n * dtype.size]), dtype, shape)
            attrs[name] = _attr_value(value, dtype)
        return attrs

    def close(self) -> None:
        self._mm.close()

    def __enter__(self) -> "H5File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _attr_value(value: np.ndarray, dtype: _Type):
    """An attribute as h5py gives it: a scalar as a numpy scalar (a
    variable-length string as ``str``), anything else as an array."""
    if dtype.kind == "vstr":
        value = np.vectorize(lambda b: b.decode("utf-8"), otypes=[object])(value) if value.size else value
    return value[()] if value.shape == () else value


class Group:
    """A symbol-table group: a mapping of link names to groups and datasets."""

    def __init__(self, file: H5File, addr: int, name: str):
        self.file, self.name = file, name
        msgs = file._messages(addr)
        self.attrs = file._attributes(msgs)
        self._links: dict[str, int] = {}
        types = {t for t, _ in msgs}
        if _LINK_INFO in types or _LINK in types:
            for t, buf in msgs:
                if t == _LINK_INFO and file._addr(buf, 2 + (8 if buf[1] & 1 else 0)) is not None:
                    raise H5Unsupported(f"{file.path}: dense link storage (group {name})")
            raise H5Unsupported(f"{file.path}: new-style (link message) groups (group {name})")
        table = [buf for t, buf in msgs if t == _SYMBOL_TABLE]
        if not table:
            raise H5Unsupported(f"{file.path}: object {name} is neither a group nor a dataset")
        btree, heap = file._addr(table[0], 0), file._addr(table[0], file.so)
        hhead = file._bytes(heap, 8 + 2 * file.sl + file.so)
        if hhead[:4] != b"HEAP":
            raise H5Unsupported(f"{file.path}: no local heap at {heap}")
        seg = file._bytes(file._addr(hhead, 8 + 2 * file.sl), file._u(hhead, 8, file.sl))
        for entry_name_off, obj in self._walk(btree):
            link = bytes(seg[entry_name_off:]).split(b"\0", 1)[0].decode()
            self._links[link] = obj

    def _walk(self, addr: int):
        """(name offset, object header address) of every link under the group
        B-tree node at ``addr``."""
        f = self.file
        head = f._bytes(addr, 8 + 2 * f.so)
        if head[:4] != b"TREE" or head[4] != 0:
            raise H5Unsupported(f"{f.path}: no group B-tree node at {addr}")
        level, n = head[5], f._u(head, 6, 2)
        body = f._bytes(addr + 8 + 2 * f.so, n * (f.sl + f.so) + f.sl)
        for i in range(n):
            child = f._addr(body, i * (f.sl + f.so) + f.sl)
            if level > 0:
                yield from self._walk(child)
                continue
            snod = f._bytes(child, 8)
            if snod[:4] != b"SNOD":
                raise H5Unsupported(f"{f.path}: no symbol table node at {child}")
            entry = 2 * f.so + 24
            ents = f._bytes(child + 8, f._u(snod, 6, 2) * entry)
            for k in range(f._u(snod, 6, 2)):
                yield f._u(ents, k * entry, f.so), f._addr(ents, k * entry + f.so)

    def keys(self) -> list[str]:
        return list(self._links)

    def __contains__(self, name: str) -> bool:
        return name in self._links

    def __getitem__(self, name: str) -> "Group | Dataset":
        addr = self._links[name]
        types = {t for t, _ in self.file._messages(addr)}
        path = f"{self.name.rstrip('/')}/{name}"
        return Dataset(self.file, addr, path) if _LAYOUT in types else Group(self.file, addr, path)


class Dataset:
    """A dataset: ``shape``, ``attrs``, and its values through :meth:`read`
    (also ``ds[()]`` and ``ds[:]``)."""

    def __init__(self, file: H5File, addr: int, name: str):
        self.file, self.name = file, name
        msgs = file._messages(addr)
        self.attrs = file._attributes(msgs)
        self._type = self._shape = self._layout = None
        self._filters: list[tuple[int, int, list[int]]] = []
        self._fill: bytes | None = None
        for t, buf in msgs:
            if t == _DATASPACE:
                self._shape = file._dataspace(buf)
            elif t == _DATATYPE:
                self._type, _ = file._datatype(buf)
            elif t == _LAYOUT:
                self._layout = buf
            elif t == _FILTERS:
                self._filters = self._parse_filters(buf)
            elif t == _FILL:
                self._fill = self._parse_fill(buf)
            elif t == _EXTERNAL:
                raise H5Unsupported(f"{file.path}: external data files (dataset {name})")
            elif t not in (_ATTRIBUTE, _ATTR_INFO):
                raise H5Unsupported(f"{file.path}: object header message type {t} (dataset {name})")
        if self._type is None or self._shape is None:
            raise H5Unsupported(f"{file.path}: dataset {name} lacks a datatype or a dataspace")

    @property
    def shape(self) -> tuple[int, ...]:
        return self._shape

    def _parse_filters(self, buf) -> list[tuple[int, int, list[int]]]:
        """(id, flags, client data) of each filter of a pipeline message."""
        version, n = buf[0], buf[1]
        p = 8 if version == 1 else 2
        out = []
        for _ in range(n):
            fid = self.file._u(buf, p, 2)
            if version == 1 or fid >= 256:
                name_len = self.file._u(buf, p + 2, 2)
                flags, nvals = self.file._u(buf, p + 4, 2), self.file._u(buf, p + 6, 2)
                p += 8 + ((name_len + 7) // 8 * 8 if version == 1 else name_len)
            else:
                flags, nvals = self.file._u(buf, p + 2, 2), self.file._u(buf, p + 4, 2)
                p += 6
            vals = [self.file._u(buf, p + 4 * i, 4) for i in range(nvals)]
            p += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in (1, 2):
                raise H5Unsupported(f"{self.file.path}: filter {fid} on dataset {self.name}; this reader "
                                    "applies deflate (1) and shuffle (2) only")
            out.append((fid, flags, vals))
        return out

    def _parse_fill(self, buf) -> bytes | None:
        version = buf[0]
        if version in (1, 2):
            defined = buf[3]
            size = self.file._u(buf, 4, 4) if (version == 1 or defined) else 0
            return bytes(buf[8: 8 + size]) if defined and size else None
        if version == 3 and buf[1] & 0x20:
            size = self.file._u(buf, 2, 4)
            return bytes(buf[6: 6 + size]) if size else None
        return None

    def _filled(self, n: int) -> bytearray:
        esize = self._type.size
        if self._fill is not None and len(self._fill) == esize and any(self._fill):
            return bytearray(self._fill * n)
        return bytearray(n * esize)

    def _unfilter(self, data: bytes, mask: int) -> bytes:
        for i in range(len(self._filters) - 1, -1, -1):
            if mask & (1 << i):
                continue
            fid, _, vals = self._filters[i]
            if fid == 1:
                data = zlib.decompress(data)
            else:
                size = vals[0] if vals else self._type.size
                n = len(data) // size
                head = np.frombuffer(data, dtype=np.uint8, count=n * size).reshape(size, n).T
                data = head.tobytes() + data[n * size:]
        return data

    def read(self) -> np.ndarray:
        f, shape, esize = self.file, self._shape, self._type.size
        n = int(np.prod(shape, dtype=np.int64))
        buf = self._layout
        if buf[0] != 3:
            raise H5Unsupported(f"{f.path}: data layout message version {buf[0]} (dataset {self.name})")
        cls = buf[1]
        if cls == 0:  # compact
            raw = bytes(buf[4: 4 + f._u(buf, 2, 2)])
        elif cls == 1:  # contiguous
            addr = f._addr(buf, 2)
            raw = bytes(self._filled(n)) if addr is None else f._bytes(addr, n * esize)
        elif cls == 2:  # chunked
            raw = self._read_chunked(buf, n)
        else:
            raise H5Unsupported(f"{f.path}: data layout class {cls} (dataset {self.name})")
        if len(raw) < n * esize:
            raise H5Unsupported(f"{f.path}: dataset {self.name} holds {len(raw)} bytes, not {n * esize}")
        return f._decode(raw, self._type, shape)

    def _read_chunked(self, buf, n: int) -> bytes:
        f, shape, esize = self.file, self._shape, self._type.size
        ndims = buf[2]
        btree = f._addr(buf, 3)
        cdims = [f._u(buf, 3 + f.so + 4 * i, 4) for i in range(ndims)][:-1]
        if len(cdims) != len(shape):
            raise H5Unsupported(f"{f.path}: chunks of rank {len(cdims)} in a dataset of rank {len(shape)}")
        out = np.frombuffer(self._filled(n), dtype=np.uint8).reshape(*shape, esize).copy()
        if btree is None or n == 0:
            return out.tobytes()
        for size, mask, offs, addr in self._chunks(btree, ndims):
            chunk = self._unfilter(f._bytes(addr, size), mask)
            block = np.frombuffer(chunk, dtype=np.uint8, count=int(np.prod(cdims)) * esize).reshape(*cdims, esize)
            dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offs, cdims, shape))
            src = tuple(slice(0, d.stop - d.start) for d in dst)
            out[dst] = block[src]
        return out.tobytes()

    def _chunks(self, addr: int, ndims: int):
        """(stored size, filter mask, element offsets, address) of every chunk
        under the chunk B-tree node at ``addr``."""
        f = self.file
        head = f._bytes(addr, 8 + 2 * f.so)
        if head[:4] != b"TREE" or head[4] != 1:
            raise H5Unsupported(f"{f.path}: no chunk B-tree node at {addr}")
        level, n = head[5], f._u(head, 6, 2)
        key = 8 + 8 * ndims
        body = f._bytes(addr + 8 + 2 * f.so, n * (key + f.so) + key)
        for i in range(n):
            k = i * (key + f.so)
            child = f._addr(body, k + key)
            if level > 0:
                yield from self._chunks(child, ndims)
                continue
            offs = [f._u(body, k + 8 + 8 * d, 8) for d in range(ndims - 1)]
            yield f._u(body, k, 4), f._u(body, k + 4, 4), offs, child

    def __getitem__(self, key) -> np.ndarray:
        if key == () or key == slice(None):
            return self.read()
        return self.read()[key]



# -- the write half -------------------------------------------------------

_UNDEF = (1 << 64) - 1  # the undefined address
_LEAF_K, _NODE_K = 4, 16  # the superblock's group leaf and internal node K (h5py's defaults)
_GCOL_MIN = 4096  # the smallest global heap collection the library allocates
_GCOL_MAX_OBJECTS = 65_535  # object indices are 16 bits; 0 is the free space


class WDataset:
    """A dataset to write: ``data`` a numpy array of fixed-point, IEEE
    float or fixed-length bytes (``S``) elements, or an object array of
    ``str``/``bytes`` (variable-length UTF-8 strings); ``attrs`` as for
    :class:`WGroup`."""

    def __init__(self, data: np.ndarray, attrs: dict | None = None):
        self.data = data
        self.attrs = dict(attrs or {})


class WGroup:
    """A group to write: ``members`` maps link names to :class:`WGroup` and
    :class:`WDataset`; ``attrs`` maps names to ``int``, ``float``, ``str``,
    ``bytes``, numpy scalars or arrays."""

    def __init__(self, attrs: dict | None = None, members: dict | None = None):
        self.attrs = dict(attrs or {})
        self.members = dict(members or {})


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _dtype_message(dt: np.dtype | None) -> bytes:
    """The datatype message of a numpy dtype; None: a variable-length UTF-8
    string (of unsigned bytes)."""
    if dt is None:
        return bytes([0x19, 0x01, 0x01, 0x00]) + struct.pack("<I", 16) + _dtype_message(np.dtype(np.uint8))
    if dt.kind in "iu":
        return bytes([0x10, 0x08 if dt.kind == "i" else 0, 0, 0]) + struct.pack("<IHH", dt.itemsize, 0,
                                                                                 8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in _IEEE:
        exp, mant = _IEEE[dt.itemsize]
        bits = 8 * dt.itemsize
        return bytes([0x11, 0x20, bits - 1, 0]) + struct.pack("<IHHBBBBI", dt.itemsize, 0, bits, mant, exp, 0, mant,
                                                              (1 << (exp - 1)) - 1)
    if dt.kind == "S":
        return bytes([0x13, 0x01, 0, 0]) + struct.pack("<I", dt.itemsize)  # null-padded ASCII, as h5py
    raise H5Unsupported(f"writing {dt} data (the writer takes integers, IEEE floats and strings)")


def _dataspace_message(shape: tuple[int, ...]) -> bytes:
    return bytes([1, len(shape), 0, 0, 0, 0, 0, 0]) + b"".join(struct.pack("<Q", d) for d in shape)


class _Writer:
    """Lays a file out front to back: every block is appended once, after
    the blocks it points at, and the superblock is patched last."""

    def __init__(self):
        self.buf = bytearray(96)

    def put(self, block: bytes) -> int:
        self.buf += b"\0" * (-len(self.buf) % 8)
        addr = len(self.buf)
        self.buf += block
        return addr

    # -- variable-length strings ------------------------------------------

    def vlen_elements(self, values) -> bytes:
        """The (length, collection, index) heap IDs of ``values``' strings,
        their bytes stored in global heap collections."""
        raw = [v if isinstance(v, bytes) else str(v).encode("utf-8") for v in values]
        ids = bytearray()
        for lo in range(0, len(raw), _GCOL_MAX_OBJECTS):
            part = raw[lo: lo + _GCOL_MAX_OBJECTS]
            objs = bytearray()
            for i, data in enumerate(part, start=1):
                objs += struct.pack("<HHIQ", i, 0, 0, len(data)) + _pad8(data)
            used = 16 + len(objs)
            size = max(_GCOL_MIN, used + 16)
            free = struct.pack("<HHIQ", 0, 0, 0, size - used)
            addr = self.put(b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size) + objs + free
                            + b"\0" * (size - used - 16))
            for i, data in enumerate(part, start=1):
                ids += struct.pack("<IQI", len(data), addr, i)
        return bytes(ids)

    def encode(self, value) -> tuple[bytes, bytes, tuple[int, ...]]:
        """(datatype message, element bytes, shape) of an attribute or dataset value."""
        if isinstance(value, (str, bytes)) and not isinstance(value, np.bytes_):
            value = np.asarray([value], dtype=object).reshape(())
        elif isinstance(value, bool):
            raise H5Unsupported("writing a bool attribute")
        elif not isinstance(value, np.ndarray):
            value = np.asarray(value)
        if value.dtype == object:
            return _dtype_message(None), self.vlen_elements(value.reshape(-1)), value.shape
        if value.dtype.kind == "b":
            raise H5Unsupported("writing bool data (the frames store booleans as uint8)")
        dt = value.dtype.newbyteorder("<") if value.dtype.kind in "iuf" else value.dtype
        return _dtype_message(dt), np.ascontiguousarray(value, dtype=dt).tobytes(), value.shape

    # -- object headers ---------------------------------------------------

    def header(self, messages: list[tuple[int, int, bytes]], attrs: dict) -> int:
        """A version 1 object header of ``messages`` (type, flags, data) and
        one attribute message per attribute."""
        msgs = list(messages)
        for name, value in attrs.items():
            dtm, data, shape = self.encode(value)
            nm = name.encode("utf-8") + b"\0"
            dsm = _dataspace_message(shape)
            body = struct.pack("<BBHHH", 1, 0, len(nm), len(dtm), len(dsm)) + _pad8(nm) + _pad8(dtm) + _pad8(dsm) \
                + data
            msgs.append((_ATTRIBUTE, 0, body))
        out = bytearray()
        for mtype, flags, data in msgs:
            data = _pad8(data)
            out += struct.pack("<HHB3x", mtype, len(data), flags) + data
        return self.put(struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(out)) + out)

    def dataset(self, ds: WDataset) -> int:
        dtm, data, shape = self.encode(ds.data)
        addr = self.put(data) if data else _UNDEF
        fill = bytes([2, 2, 0 if ds.data.dtype == object else 2, 1, 0, 0, 0, 0])
        layout = bytes([3, 1]) + struct.pack("<QQ", addr, len(data))
        return self.header([(_DATASPACE, 0, _dataspace_message(shape)), (_DATATYPE, 1, dtm), (_FILL, 1, fill),
                            (_LAYOUT, 0, layout)], ds.attrs)

    # -- groups -----------------------------------------------------------

    def group(self, g: WGroup) -> tuple[int, int, int]:
        """(object header, B-tree, local heap) addresses of a symbol-table group."""
        names = sorted(g.members, key=lambda k: k.encode("utf-8"))
        for name in names:
            if not name or "/" in name or name == ".":
                raise H5Unsupported(f"writing a member named {name!r}")
        children = {}
        for name in names:
            m = g.members[name]
            children[name] = self.group(m)[0] if isinstance(m, WGroup) else self.dataset(m)
        seg, offset = bytearray(8), {}  # offset 0: the empty name
        for name in names:
            offset[name] = len(seg)
            seg += _pad8(name.encode("utf-8") + b"\0")
        heap = self.put(b"HEAP" + bytes(4) + struct.pack("<QQQ", len(seg), 1, 0))  # free list: none (1)
        seg_addr = self.put(bytes(seg))
        self.buf[heap + 24: heap + 32] = struct.pack("<Q", seg_addr)
        # level 0: SNODs of up to 2*leaf-K entries; each B-tree level groups up
        # to 2*node-K children (an empty group: a B-tree node with no child)
        nodes = []  # (address, offsets of the names it holds)
        for lo in range(0, len(names), 2 * _LEAF_K):
            part = names[lo: lo + 2 * _LEAF_K]
            ents = b"".join(struct.pack("<QQII16x", offset[n], children[n], 0, 0) for n in part)
            snod = b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(part)) + ents
            nodes.append((self.put(snod + bytes(8 + 2 * _LEAF_K * 40 - len(snod))), [offset[n] for n in part]))
        level = 0
        while True:
            parents = []
            for lo in range(0, max(len(nodes), 1), 2 * _NODE_K):
                part = nodes[lo: lo + 2 * _NODE_K]
                body = bytearray(struct.pack("<Q", 0))
                for addr, offs in part:
                    body += struct.pack("<QQ", addr, offs[-1] if offs else 0)
                node = b"TREE" + bytes([0, level]) + struct.pack("<HQQ", len(part), _UNDEF, _UNDEF) + body
                size = 24 + (2 * _NODE_K + 1) * 8 + 2 * _NODE_K * 8
                parents.append((self.put(bytes(node) + bytes(size - len(node))), [o for _, offs in part for o in offs]))
            if len(parents) == 1:
                btree = parents[0][0]
                break
            nodes, level = parents, level + 1
        obj = self.header([(_SYMBOL_TABLE, 0, struct.pack("<QQ", btree, heap))], g.attrs)
        return obj, btree, heap

    def finish(self, root: WGroup) -> bytes:
        obj, btree, heap = self.group(root)
        eof = len(self.buf)
        self.buf[0:96] = (_SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + struct.pack("<HHI", _LEAF_K, _NODE_K, 0)
                          + struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
                          + struct.pack("<QQII", 0, obj, 1, 0) + struct.pack("<QQ", btree, heap))
        return bytes(self.buf)


def write_file(path: str, root: WGroup) -> None:
    """Write the tree under ``root`` as a new HDF5 file at ``path`` (a
    temporary name, then ``os.replace``: a failed write leaves ``path`` as
    it was)."""
    data = _Writer().finish(root)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _as_written(value, what: str):
    """An attribute or dataset value as read, in the form the writer takes;
    raises H5Unsupported for what the writer does not emit."""
    if isinstance(value, np.ndarray) and value.dtype.kind == "b" or isinstance(value, np.bool_):
        raise H5Unsupported(f"{what}: a boolean enumeration, which the writer does not emit")
    if isinstance(value, np.ndarray) and value.dtype == object and any(isinstance(v, np.ndarray) for v in value.flat):
        raise H5Unsupported(f"{what}: variable-length sequences, which the writer does not emit")
    return value


def read_tree(path: str) -> WGroup:
    """The whole file at ``path`` as writer nodes (every dataset read), to
    write it again with changes; raises :class:`H5Unsupported`, naming the
    feature, where the reader refuses the file or the writer could not emit
    what it holds."""

    def walk(g: Group) -> WGroup:
        members = {}
        for name in g.keys():
            node = g[name]
            if isinstance(node, Group):
                members[name] = walk(node)
                continue
            if node._type.kind == "vseq":
                raise H5Unsupported(f"{path}: dataset {node.name} holds variable-length sequences, which the "
                                    "writer does not emit")
            members[name] = WDataset(_as_written(node.read(), f"{path}: dataset {node.name}"),
                                     {k: _as_written(v, f"{path}: attribute {k} of {node.name}")
                                      for k, v in node.attrs.items()})
        return WGroup({k: _as_written(v, f"{path}: attribute {k} of {g.name}") for k, v in g.attrs.items()}, members)

    with H5File(path) as f:
        return walk(f.root)
