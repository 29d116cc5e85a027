"""Columnar VCF reader and writer (host-side ingest and writeback).

Counterpart of ``variantcalling_tpu/io/vcf.py`` on its default path, the
native engine's. The whole file is scanned by the port's native host
engine (``native.vcf_parse``; a ``.gz`` inflated by
``native.bgzf_decompress_array`` first): numbers, sample 0's FORMAT
values, the hot INFO keys and the allele classes come out as arrays
(:class:`NativeAux`), and the string columns stay byte spans into the text
until they are read.
The filter pipeline's writeback (``write_vcf(verbatim_core=True)``) then
splices each record from that text: CHROM..QUAL and FORMAT..end verbatim,
a new FILTER, INFO with ``;TREE_SCORE=`` appended (``native.vcf_assemble``,
``native.format_float_info``).

The plain versions, which serve with ``VCTPU_NO_NATIVE=1``, without a
compiler, or where the scan declines the input (a malformed record), give
the same columns and bytes: the file is read as bytes and split on ``\n``
alone, so a CRLF file's ``##`` lines keep their ``\r`` (written back as
``\r\n``) while the ``#CHROM`` line and the records drop it, as the
reference's ``parse_header_bytes`` and record scanner do; each record's
FORMAT and sample columns are kept as one verbatim tail string, and so is
its QUAL text, written back for every record whose QUAL was not edited;
the other core columns are rendered from the column arrays, with the
reference's ``_format_extra_info_bytes`` rendering of new INFO keys.

The streaming filter executor reads through :class:`VcfChunkReader`: the
same scan over line-aligned chunks (a memory map of a ``.vcf``, or a
``.vcf.gz`` inflated shard-parallel), each chunk a row slice of
:func:`read_vcf`'s table, and renders each chunk's records with
:func:`assemble_table_bytes` (:func:`render_table_bytes_python` without the
engine).
"""

from __future__ import annotations

import gzip
import io as _io
import logging
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np

log = logging.getLogger(__name__)

MISSING = "."


def _open_bytes(path: str):
    if str(path).endswith((".gz", ".bgz")):
        return gzip.open(path, "rb")
    return open(path, "rb")


@dataclass
class VcfHeader:
    """Parsed VCF header: meta lines (verbatim), contigs, field definitions, samples."""

    lines: list[str] = field(default_factory=list)  # '##...' lines, no newline
    samples: list[str] = field(default_factory=list)
    contigs: list[str] = field(default_factory=list)
    contig_lengths: dict[str, int] = field(default_factory=dict)
    infos: dict[str, dict] = field(default_factory=dict)
    formats: dict[str, dict] = field(default_factory=dict)
    filters: dict[str, str] = field(default_factory=dict)

    @staticmethod
    def _parse_structured(line: str) -> dict:
        # ##INFO=<ID=DP,Number=1,Type=Integer,Description="...">
        inner = line[line.index("<") + 1: line.rindex(">")]
        out: dict[str, str] = {}
        key = val = ""
        in_quotes = False
        target = "key"
        for ch in inner:
            if target == "key":
                if ch == "=":
                    target = "val"
                else:
                    key += ch
            elif ch == '"':
                in_quotes = not in_quotes
                val += ch
            elif ch == "," and not in_quotes:
                out[key] = val.strip('"')
                key, val, target = "", "", "key"
            else:
                val += ch
        if key:
            out[key] = val.strip('"')
        return out

    def add_meta_line(self, line: str) -> None:
        line = line.rstrip("\n")
        self.lines.append(line)
        if line.startswith("##contig="):
            d = self._parse_structured(line)
            name = d.get("ID", "")
            self.contigs.append(name)
            if "length" in d:
                try:
                    self.contig_lengths[name] = int(d["length"])
                except ValueError:
                    pass
        elif line.startswith("##INFO="):
            d = self._parse_structured(line)
            self.infos[d.get("ID", "")] = d
        elif line.startswith("##FORMAT="):
            d = self._parse_structured(line)
            self.formats[d.get("ID", "")] = d
        elif line.startswith("##FILTER="):
            d = self._parse_structured(line)
            self.filters[d.get("ID", "")] = d.get("Description", "")

    def ensure_info(self, info_id: str, number: str, info_type: str, description: str) -> None:
        if info_id not in self.infos:
            self.add_meta_line(
                f'##INFO=<ID={info_id},Number={number},Type={info_type},Description="{description}">')

    def ensure_format(self, fmt_id: str, number: str, fmt_type: str, description: str) -> None:
        if fmt_id not in self.formats:
            self.add_meta_line(
                f'##FORMAT=<ID={fmt_id},Number={number},Type={fmt_type},Description="{description}">')

    def ensure_filter(self, filter_id: str, description: str) -> None:
        if filter_id not in self.filters:
            self.add_meta_line(f'##FILTER=<ID={filter_id},Description="{description}">')

    def column_header(self) -> str:
        cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
        if self.samples:
            cols += ["FORMAT", *self.samples]
        return "\t".join(cols)


@dataclass
class NativeAux:
    """What the native scan (``native.vcf_parse``) gives beside the columns,
    row-aligned with the owning :class:`VariantTable`: the text buffer and
    each record's byte spans in it (for the verbatim writeback), sample 0's
    GT, GQ, DP and AD, the hot INFO keys (``native.VCF_INFO_KEYS``) and the
    allele classes, so that featurization parses no string."""

    buf: np.ndarray  # uint8 text of the whole file
    line_spans: np.ndarray  # (n, 2) [start, end) byte offsets
    tail_spans: np.ndarray  # (n, 2): FORMAT..line end (empty without samples)
    info_spans: np.ndarray
    filter_spans: np.ndarray
    gt: np.ndarray  # (n, 2) int8
    gq: np.ndarray  # (n,) float32, NaN missing
    dp_fmt: np.ndarray  # (n,) float32
    ad: np.ndarray  # (n, 3) float32: ref, first alt, total of the positive counts
    info_vals: np.ndarray  # (n, len(info_keys)) float64
    info_keys: tuple
    alle: dict  # aclass, indel_length, indel_nuc, ref_code, alt_code, n_alts, ref_len

    def take(self, keep) -> "NativeAux":
        return NativeAux(self.buf, *(getattr(self, f)[keep] for f in (
            "line_spans", "tail_spans", "info_spans", "filter_spans", "gt", "gq", "dp_fmt", "ad", "info_vals")),
            self.info_keys, {k: v[keep] for k, v in self.alle.items()})


class FactorizedColumn:
    """Low-cardinality string column held as (int32 codes, uniques)."""

    __slots__ = ("codes", "uniques")

    def __init__(self, codes: np.ndarray, uniques: list[str]):
        self.codes = np.ascontiguousarray(codes, dtype=np.int32)
        self.uniques = list(uniques)

    def __eq__(self, other):  # vectorized `filters == "PASS"`
        if isinstance(other, str):
            if other not in self.uniques:
                return np.zeros(len(self.codes), dtype=bool)
            return self.codes == self.uniques.index(other)
        return NotImplemented

    def to_object(self) -> np.ndarray:
        return np.asarray(self.uniques, dtype=object)[self.codes]


class _LazyCols:
    """String columns held as (n, 2) byte spans into one text buffer, decoded
    on first use; a row subset takes the spans only."""

    __slots__ = ("buf", "spans")

    def __init__(self, buf, spans: dict[str, np.ndarray]):
        self.buf = buf
        self.spans = spans

    def take(self, keep) -> "_LazyCols":
        return _LazyCols(self.buf, {k: v[keep] for k, v in self.spans.items()})

    def materialize(self, name: str) -> np.ndarray:
        buf = memoryview(self.buf)  # bytes, or a chunk's uint8 array (a memory map's slice)
        return _obj([str(buf[a:b], "utf-8") for a, b in self.spans[name].tolist()])

    def byte_matrix(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        """(n, W) uint8 of each record's bytes of column ``name``, 0-padded,
        and the (n,) lengths: a short column compared or factorized in numpy."""
        spans = self.spans[name]
        lens = spans[:, 1] - spans[:, 0]
        width = max(int(lens.max(initial=0)), 1)
        buf = np.frombuffer(self.buf, dtype=np.uint8) if isinstance(self.buf, bytes) else np.asarray(self.buf)
        cols = np.arange(width)
        idx = np.minimum(spans[:, :1] + cols, max(len(buf) - 1, 0))
        return np.where(cols < lens[:, None], buf[idx], 0).astype(np.uint8), lens


#: the string columns a scanned table decodes only when they are read
LAZY_COLUMNS = ("vid", "ref", "alt", "filters", "info", "tail", "qual_text")


def _lazy_column(name: str) -> property:
    slot = "_" + name

    def get(self):
        v = getattr(self, slot)
        if v is None and self._lazy is not None and name in self._lazy.spans:
            v = self._lazy.materialize(name)
            setattr(self, slot, v)
        return v

    return property(get, lambda self, v: setattr(self, slot, v))


class VariantTable:
    """Columnar view of a VCF: one numpy array per column over all records.

    ``tail`` holds each record's FORMAT and sample columns verbatim (one
    tab-joined string, "" when the record has none). ``qual_text`` holds each
    record's QUAL as read, beside the float ``qual`` the features use, and
    ``qual_read`` a copy of ``qual`` as read: a record whose ``qual`` still
    equals it writes its text back (both None: a table with no text).

    A table from the native scan also has ``aux`` (:class:`NativeAux`), and
    its string columns (:data:`LAZY_COLUMNS`) are spans into the text until
    they are read; ``chrom_codes`` and ``chrom_names`` hold its CHROM
    dictionary. Row subsets (:meth:`subset`) carry all of it along.
    """

    vid, ref, alt, filters, info, tail, qual_text = (_lazy_column(c) for c in LAZY_COLUMNS)

    def __init__(self, header: VcfHeader, chrom, pos, vid, ref, alt, qual, filters, info, tail,
                 qual_text=None, qual_read=None, *, aux: NativeAux | None = None, lazy: _LazyCols | None = None,
                 chrom_codes: np.ndarray | None = None, chrom_names: np.ndarray | None = None):
        self.header = header
        self.chrom = chrom
        self.pos = pos
        self.qual = qual
        self._lazy = lazy
        for name, v in zip(LAZY_COLUMNS, (vid, ref, alt, filters, info, tail, qual_text)):
            setattr(self, "_" + name, v)
        self.aux = aux
        self.chrom_codes = chrom_codes
        self.chrom_names = chrom_names
        has_text = qual_text is not None or (lazy is not None and "qual_text" in lazy.spans)
        self.qual_read = None if not has_text else \
            (np.array(qual, dtype=np.float64) if qual_read is None else qual_read)

    def __len__(self) -> int:
        return len(self.pos)

    @property
    def n_samples(self) -> int:
        return len(self.header.samples)

    def subset(self, keep: np.ndarray) -> "VariantTable":
        """Row-subset every column (and the scan's arrays) by a boolean/index array."""
        held = {c: getattr(self, "_" + c) for c in LAZY_COLUMNS}
        pending = self._lazy is not None and any(v is None for v in held.values())

        def sub(a):
            return None if a is None else a[keep]

        return VariantTable(self.header, self.chrom[keep], self.pos[keep], sub(held["vid"]), sub(held["ref"]),
                            sub(held["alt"]), self.qual[keep], sub(held["filters"]), sub(held["info"]),
                            sub(held["tail"]), sub(held["qual_text"]), sub(self.qual_read),
                            aux=None if self.aux is None else self.aux.take(keep),
                            lazy=self._lazy.take(keep) if pending else None,
                            chrom_codes=sub(self.chrom_codes), chrom_names=self.chrom_names)

    def factorize(self, name: str) -> tuple[np.ndarray, list[str]]:
        """(int64 codes, distinct values) of a short string column (FILTER):
        from the scan's bytes while the column is still unread, so that its
        strings are never made one by one."""
        if getattr(self, "_" + name) is None and self._lazy is not None and name in self._lazy.spans:
            mat, _ = self._lazy.byte_matrix(name)
            uniq, codes = np.unique(mat.view(f"S{mat.shape[1]}").ravel(), return_inverse=True)
            return codes.astype(np.int64), [u.decode() for u in uniq.tolist()]
        index: dict[str, int] = {}
        codes = np.fromiter((index.setdefault(v, len(index)) for v in getattr(self, name)), dtype=np.int64,
                            count=len(self))
        return codes, list(index)

    def alt_lists(self) -> list[list[str]]:
        return [[] if a in (MISSING, "") else a.split(",") for a in self.alt]

    def format_columns(self) -> tuple[np.ndarray, np.ndarray]:
        """(FORMAT (n,), sample columns (n, n_samples)) as strings, split
        from ``tail``; ``.`` where a record lacks one. :func:`join_tails`
        puts them back together."""
        rows = [t.split("\t") if t else [MISSING] for t in self.tail.tolist()]
        fmt = _obj([r[0] for r in rows])
        samples = np.empty((len(rows), self.n_samples), dtype=object)
        for j in range(self.n_samples):
            samples[:, j] = [r[1 + j] if len(r) > 1 + j else MISSING for r in rows]
        return fmt, samples

    def n_alts(self) -> np.ndarray:
        if self.aux is not None:
            return self.aux.alle["n_alts"].copy()
        return np.fromiter(
            (0 if a in (MISSING, "") else a.count(",") + 1 for a in self.alt),
            dtype=np.int32, count=len(self))

    def info_flag(self, name: str) -> np.ndarray:
        """True where INFO holds ``name`` as a flag or a key."""
        out = np.zeros(len(self), dtype=bool)
        for i, s in enumerate(self.info):
            if s is None or s == MISSING:
                continue
            for part in s.split(";"):
                if part == name or part.startswith(name + "="):
                    out[i] = True
                    break
        return out

    def info_field(self, name: str, dtype=np.float64, missing=np.nan, index: int = 0) -> np.ndarray:
        """One INFO key per record (scalar, or the ``index``-th list element);
        a hot key of a scanned table comes from the scan (a bare flag: 1)."""
        if self.aux is not None and index == 0 and name in self.aux.info_keys:
            vals = self.aux.info_vals[:, self.aux.info_keys.index(name)]
            out = np.full(len(self), missing, dtype=dtype)
            ok = ~np.isnan(vals)
            out[ok] = vals[ok].astype(dtype)
            return out
        out = np.full(len(self), missing, dtype=dtype)
        key_eq = name + "="
        conv = np.dtype(dtype).type
        for i, s in enumerate(self.info):
            if s is None or s == MISSING:
                continue
            for part in s.split(";"):
                if part.startswith(key_eq):
                    v = part[len(key_eq):]
                    if "," in v:
                        v = v.split(",")[index]
                    if v != MISSING and v != "":
                        try:
                            out[i] = conv(v)
                        except (ValueError, TypeError):
                            pass
                    break
        return out

    def format_field(self, name: str, sample: int = 0) -> list[str | None]:
        """Raw string of one FORMAT key for one sample, per record (None if absent)."""
        if self.n_samples == 0:
            return [None] * len(self)
        out: list[str | None] = []
        for t in self.tail:
            parts = t.split("\t") if t else [MISSING]
            keys = parts[0]
            if not keys or keys == MISSING:
                out.append(None)
                continue
            try:
                idx = keys.split(":").index(name)
            except ValueError:
                out.append(None)
                continue
            col = parts[1 + sample] if 1 + sample < len(parts) else MISSING
            vals = col.split(":")
            out.append(vals[idx] if idx < len(vals) else None)
        return out

    def genotypes(self, sample: int = 0) -> np.ndarray:
        """(n, 2) int8 diploid genotype; -1 for missing/haploid-second slot; phasing dropped."""
        if sample == 0 and self.aux is not None:
            return self.aux.gt.copy()
        out = np.full((len(self), 2), -1, dtype=np.int8)
        for i, g in enumerate(self.format_field("GT", sample)):
            if not g:
                continue
            for j, p in enumerate(g.replace("|", "/").split("/")[:2]):
                if p not in (MISSING, ""):
                    out[i, j] = int(p)
        return out

    def format_numeric(self, name: str, sample: int = 0, max_len: int | None = None,
                       missing=-1) -> np.ndarray:
        """Padded (n, max_len) float64 tensor of a comma-listed FORMAT field (e.g. AD);
        sample 0's GQ and DP of a scanned table come from the scan."""
        if sample == 0 and self.aux is not None and name in ("GQ", "DP") and max_len in (None, 1):
            vals = (self.aux.gq if name == "GQ" else self.aux.dp_fmt).astype(np.float64)[:, None]
            return np.where(np.isnan(vals), missing, vals)
        split = [r.split(",") if r not in (None, MISSING, "") else []
                 for r in self.format_field(name, sample)]
        if max_len is None:
            max_len = max((len(s) for s in split), default=0)
        out = np.full((len(self), max_len), missing, dtype=np.float64)
        for i, vals in enumerate(split):
            for j, v in enumerate(vals[:max_len]):
                if v not in (MISSING, ""):
                    try:
                        out[i, j] = float(v)
                    except ValueError:
                        pass
        return out


def _obj(x: list) -> np.ndarray:
    a = np.empty(len(x), dtype=object)
    a[:] = x
    return a


def sample_fields(fmt, sample, names: tuple[str, ...]) -> dict[str, list]:
    """For each FORMAT key of ``names``, its raw value in one sample column
    per record (``fmt``, ``sample``: the records' FORMAT and that sample's
    text), None where the record lacks it: what ``format_field`` reads, one
    pass for all the keys."""
    out: dict[str, list] = {name: [] for name in names}
    cols = [out[name] for name in names]
    key_index: dict[str, list] = {}
    for keys, text in zip(fmt, sample):
        if not keys or keys == MISSING:
            for col in cols:
                col.append(None)
            continue
        idx = key_index.get(keys)
        if idx is None:
            ks = keys.split(":")
            idx = key_index[keys] = [ks.index(name) if name in ks else None for name in names]
        vals = text.split(":")
        for col, i in zip(cols, idx):
            col.append(vals[i] if i is not None and i < len(vals) else None)
    return out


def number_lists(raw: list, width: int | None, missing: float) -> np.ndarray:
    """(n, width) float64 of comma-listed FORMAT values (PL, DS) as
    ``format_numeric`` parses them (``width`` None: the longest list),
    ``missing`` in the slots a record lacks: all values joined and parsed at
    once where every one is a number, else value by value."""
    n = len(raw)
    present = [r not in (None, MISSING, "") for r in raw]
    texts = [r for r, p in zip(raw, present) if p]
    lens = np.zeros(n, dtype=np.int64)
    lens[np.asarray(present, dtype=bool)] = [t.count(",") + 1 for t in texts]
    if width is None:
        width = int(lens.max(initial=0))
    out = np.full((n, width), missing, dtype=np.float64)
    try:
        values = np.asarray(",".join(texts).split(","), dtype=np.float64) if texts else np.zeros(0)
    except ValueError:
        for i, r in enumerate(raw):
            if not present[i]:
                continue
            for j, v in enumerate(r.split(",")[:width]):
                if v not in (MISSING, ""):
                    try:
                        out[i, j] = float(v)
                    except ValueError:
                        pass
        return out
    rows = np.repeat(np.arange(n), lens)
    cols = np.arange(len(values)) - np.repeat(np.cumsum(lens) - lens, lens)
    keep = cols < width
    out[rows[keep], cols[keep]] = values[keep]
    return out


def join_tails(fmt: np.ndarray, samples: np.ndarray) -> np.ndarray:
    """Each record's FORMAT and sample columns as one tab-joined ``tail``
    (the inverse of :meth:`VariantTable.format_columns`)."""
    return _obj(["\t".join((f, *row)) for f, row in zip(fmt.tolist(), samples.tolist())])


_READ_BYTES = 16 << 20


def _text_lines(path: str):
    """The file's lines as str, split on ``\n`` alone and without it, read in
    blocks and each block decoded at once. Header (``#``) lines that are not
    valid UTF-8 decode with replacement characters, as the reference's
    header parse does; such a record raises."""
    with _open_bytes(path) as fh:
        yield from _stream_lines(fh)


def _stream_lines(fh):
    """:func:`_text_lines` over an open binary stream."""
    rest = b""
    while True:
        block = fh.read(_READ_BYTES)
        data = rest + block
        cut = len(data) if not block else data.rfind(b"\n") + 1
        data, rest = data[:cut], data[cut:]
        if data:
            try:
                lines = data.decode("utf-8").split("\n")
            except UnicodeDecodeError:
                lines = [ln.decode("utf-8", "replace" if ln.startswith(b"#") else "strict")
                         for ln in data.split(b"\n")]
            if data.endswith(b"\n"):
                lines.pop()
            yield from lines
        if not block:
            return


# a .gz above this size is read by the plain reader, in blocks, rather than
# inflated whole by the native engine
NATIVE_INFLATE_MAX_BYTES = 512 << 20


def read_vcf(path: str, region: tuple[str, int, int] | None = None, drop_format: bool = False,
             numeric_info: bool = False) -> VariantTable:
    """Parse a VCF (``.vcf`` or ``.vcf.gz``) into a :class:`VariantTable`.

    Lines split on ``\n`` alone. ``##`` lines before the first record are
    the header, kept with any ``\r``; the ``#CHROM`` line and the records
    lose one trailing ``\r``; empty lines and ``#`` lines among the records
    are skipped, as the reference's scanner skips them. The native scan
    (:func:`_read_vcf_native`) serves where it can, else the plain reader:
    both give the same columns.

    ``drop_format``: keep no FORMAT or sample data (every ``tail`` empty,
    genotypes missing) and no reference to the file's text, for a caller
    that reads only the core columns of a large file.

    ``numeric_info``: the native scan also reads every INFO key the header
    types ``Integer`` or ``Float`` as a number (:meth:`VariantTable.info_field`
    then serves it from the scan), for a caller that reads them all.

    ``region``: ``(chrom, start_1based, end_inclusive)``, the reference's
    semantics: only the records of ``chrom`` with ``start <= POS <= end``.
    A ``.gz`` with a ``.tbi`` beside it is read through the index, as the
    reference reads it (:func:`_read_vcf_indexed`): the header from the
    file's head, the records from the BGZF blocks that cover the region."""
    table = None
    if region is not None and str(path).endswith(".gz") and os.path.exists(str(path) + ".tbi"):
        table = _read_vcf_indexed(path, region)
    if table is None:
        table = _read_vcf_native(path, numeric_info)
        table = table if table is not None else _read_vcf_plain(path)
    if region is not None:
        chrom, lo, hi = region
        table = table.subset(np.flatnonzero((table.chrom == chrom) & (table.pos >= lo) & (table.pos <= hi)))
    if not drop_format:
        return table
    return VariantTable(table.header, table.chrom, table.pos, table.vid, table.ref, table.alt, table.qual,
                        table.filters, table.info, _obj([""] * len(table)), table.qual_text, table.qual_read)


def parse_header_bytes(bufb: bytes) -> tuple[VcfHeader, int]:
    """The header of a VCF text buffer, and the offset of its first record line."""
    header = VcfHeader()
    off, n = 0, len(bufb)
    while off < n:
        nl = bufb.find(b"\n", off)
        end = nl if nl >= 0 else n
        if end > off and bufb[off: off + 1] != b"#":
            break
        line = bufb[off:end].decode("utf-8", "replace")
        if line.startswith("##"):
            header.add_meta_line(line)
        elif line.startswith("#"):
            names = line.rstrip("\r").split("\t")
            if len(names) > 9:
                header.samples = names[9:]
        off = end + 1
    return header, min(off, n)


def _scan_info_keys(header: VcfHeader, numeric_info: bool) -> tuple[str, ...]:
    """The INFO keys the native scan reads as numbers: the hot keys, and with
    ``numeric_info`` every key the header types ``Integer`` or ``Float``."""
    from variantcalling_tpu_torch import native

    if not numeric_info:
        return native.VCF_INFO_KEYS
    extra = [k for k, meta in header.infos.items()
             if meta.get("Type") in ("Integer", "Float") and k not in native.VCF_INFO_KEYS]
    return (*native.VCF_INFO_KEYS, *extra)


def _read_vcf_native(path: str, numeric_info: bool = False) -> VariantTable | None:
    """The whole file through the native scan (a ``.gz`` inflated by the
    engine first); None where the engine is off, the ``.gz`` is larger than
    :data:`NATIVE_INFLATE_MAX_BYTES`, or the scan declines the input."""
    from variantcalling_tpu_torch import native

    gz = str(path).endswith((".gz", ".bgz"))
    if not native.available() or (gz and os.path.getsize(path) > NATIVE_INFLATE_MAX_BYTES):
        if gz:
            native.note_plain("bgzf_decompress_array")
        native.note_plain("vcf_parse")
        return None
    with open(path, "rb") as fh:
        bufb = fh.read()
    if gz:
        arr = native.bgzf_decompress_array(bufb)
        if arr is None:
            native.note_plain("vcf_parse")
            return None
        bufb = arr.tobytes()
    return _scan_text(bufb, numeric_info)


def _scan_text(bufb: bytes, numeric_info: bool = False) -> VariantTable | None:
    """The table of a VCF's whole text by the native scan; None where it declines."""
    from variantcalling_tpu_torch import native

    buf = np.frombuffer(bufb, dtype=np.uint8)
    header, _ = parse_header_bytes(bufb)
    keys = _scan_info_keys(header, numeric_info)
    parsed = native.vcf_parse(buf, len(header.samples), keys)
    return None if parsed is None else _table_from_parsed(parsed, header, bufb, buf, keys)


def _table_from_parsed(parsed: dict, header: VcfHeader, bufb: bytes, buf: np.ndarray,
                       info_keys: tuple[str, ...] | None = None) -> VariantTable:
    """A table over one scan of ``buf`` (``bufb``: the same bytes): numbers
    from the scan (``info_keys``: the INFO keys it read, the hot keys by
    default), string columns lazy, QUAL's text the span between ALT and
    FILTER."""
    from variantcalling_tpu_torch import native

    alt, filt = parsed["alt_spans"], parsed["filter_spans"]
    lazy = _LazyCols(bufb, {"vid": parsed["id_spans"], "ref": parsed["ref_spans"], "alt": alt,
                            "filters": filt, "info": parsed["info_spans"], "tail": parsed["tail_spans"],
                            "qual_text": np.stack([alt[:, 1] + 1, filt[:, 0] - 1], axis=1)})
    aux = NativeAux(buf, parsed["line_spans"], parsed["tail_spans"], parsed["info_spans"], filt, parsed["gt"],
                    parsed["gq"], parsed["dp_fmt"], parsed["ad"], parsed["info_vals"],
                    native.VCF_INFO_KEYS if info_keys is None else info_keys,
                    {k: parsed[k] for k in ("aclass", "indel_length", "indel_nuc", "ref_code", "alt_code",
                                            "n_alts", "ref_len")})
    names = _obj(parsed["chroms"])
    codes = parsed["chrom_codes"]
    return VariantTable(header, names[codes], parsed["pos"], None, None, None, parsed["qual"], None, None, None,
                        aux=aux, lazy=lazy, chrom_codes=codes, chrom_names=names)


def _read_vcf_indexed(path: str, region: tuple[str, int, int]) -> VariantTable:
    """The header (the file's head, inflated block by block up to its first
    record) and the record lines the ``.tbi`` finds for ``region``
    (:func:`tabix.read_region_lines` over 0-based ``[start - 1, end)``),
    parsed as one text by the scan that parses a whole file (the native
    scan where it serves, else the plain reader), so the columns are the
    ones the whole-file path gives; :func:`read_vcf` then keeps
    ``start <= POS <= end`` as it does there."""
    from variantcalling_tpu_torch import native
    from variantcalling_tpu_torch.io import tabix

    chrom, lo, hi = region
    text = tabix.read_header_bytes(path) + b"".join(
        line.encode() + b"\n" for line in tabix.read_region_lines(str(path), chrom, lo - 1, hi))
    table = None
    if native.available():
        table = _scan_text(text)
    else:
        native.note_plain("vcf_parse")
    return table if table is not None else _parse_plain(_stream_lines(_io.BytesIO(text)))


def _read_vcf_plain(path: str) -> VariantTable:
    """:func:`read_vcf` in Python: lines decoded in blocks."""
    return _parse_plain(_text_lines(path))


def _parse_plain(lines) -> VariantTable:
    """The table of a VCF's text lines (without their ``\n``)."""
    header = VcfHeader()
    cols: list[list] = [[] for _ in range(10)]
    chrom, pos, vid, ref, alt, qual, qual_text, filt, info, tail = cols
    for line in lines:
        if line.startswith("#"):
            if chrom:  # among the records
                continue
            if line.startswith("##"):
                header.add_meta_line(line)
            else:
                names = line.rstrip("\r").split("\t")
                if len(names) > 9:
                    header.samples = names[9:]
            continue
        if line.endswith("\r"):
            line = line[:-1]
        if not line:
            continue
        parts = line.split("\t", 8)
        chrom.append(parts[0])
        pos.append(int(parts[1]))
        vid.append(parts[2])
        ref.append(parts[3])
        alt.append(parts[4])
        qual_text.append(parts[5])
        qual.append(float(parts[5]) if parts[5] != MISSING else np.nan)
        filt.append(parts[6])
        info.append(parts[7] if len(parts) > 7 else MISSING)
        tail.append(parts[8] if len(parts) > 8 else "")
    return VariantTable(header, _obj(chrom), np.asarray(pos, dtype=np.int64), _obj(vid),
                        _obj(ref), _obj(alt), np.asarray(qual, dtype=np.float64),
                        _obj(filt), _obj(info), _obj(tail), qual_text=_obj(qual_text))


def format_qual(q: float) -> str:
    if q is None or (isinstance(q, float) and np.isnan(q)):
        return MISSING
    if float(q) == int(q):
        return str(int(q))
    return f"{q:g}"


def _format_qual_column(qual: np.ndarray) -> np.ndarray:
    """Vectorized :func:`format_qual` over the whole column."""
    q = np.asarray(qual, dtype=np.float64)
    out = np.full(len(q), MISSING, dtype=object)
    ok = ~np.isnan(q)
    is_int = ok & (q == np.floor(q))
    out[is_int] = np.char.mod("%d", q[is_int].astype(np.int64))
    frac = ok & ~is_int
    out[frac] = np.char.mod("%g", q[frac])
    return out


def _qual_text_is_formatted(table: VariantTable) -> bool:
    """Whether every record's QUAL text as read is :func:`format_qual` of its
    value (``0``, ``50``, ``45.3``: not GATK's ``34.30``), compared in numpy
    on the scan's bytes: then the text and the rendering write the same bytes."""
    lazy = table._lazy
    if table.qual_read is None or lazy is None or "qual_text" not in lazy.spans or table._qual_text is not None:
        return False
    q, was = np.asarray(table.qual, dtype=np.float64), table.qual_read
    if not ((q == was) | (np.isnan(q) & np.isnan(was))).all():
        return False
    uniq, inv = np.unique(q, return_inverse=True)
    want = [t.encode() for t in _format_qual_column(uniq).tolist()]
    mat, lens = lazy.byte_matrix("qual_text")
    want_lens = np.fromiter(map(len, want), dtype=np.int64, count=len(want))
    if not np.array_equal(lens, want_lens[inv.ravel()]) or mat.shape[1] < want_lens.max(initial=0):
        return False
    table_u = np.zeros((len(want), mat.shape[1]), dtype=np.uint8)
    for i, w in enumerate(want):
        table_u[i, :len(w)] = np.frombuffer(w, dtype=np.uint8)
    return bool(np.array_equal(mat, table_u[inv.ravel()]))


def _qual_column(table: VariantTable) -> np.ndarray:
    """QUAL strings to write: the text as read wherever ``qual`` was not
    edited, :func:`format_qual` of the value elsewhere."""
    if table.qual_text is None:
        return _format_qual_column(table.qual)
    q, was = np.asarray(table.qual, dtype=np.float64), table.qual_read
    edited = ~((q == was) | (np.isnan(q) & np.isnan(was)))
    if not edited.any():
        return table.qual_text
    out = table.qual_text.copy()
    out[edited] = _format_qual_column(q[edited])
    return out


def _format_extra_info(n: int, extra_info: dict) -> list[str]:
    """Per-record ";K=V" suffixes in dict key order; float columns render as
    ``%g`` of their float64 value, NaN skips the record; in an object column
    None (or a float NaN) skips the record, ``True`` writes the bare flag
    ``;K``, anything else ``;K=`` and its ``str``."""
    acc = np.full(n, "", dtype=object)
    for k, vals in (extra_info or {}).items():
        arr = np.asarray(vals)
        if arr.dtype.kind == "f":
            f64 = arr.astype(np.float64)
            ok = ~np.isnan(f64)
            acc[ok] = acc[ok] + np.char.mod(f";{k}=%g", f64[ok]).astype(object)
            continue
        for i, v in enumerate(arr.tolist()):
            if v is None or (isinstance(v, float) and np.isnan(v)):
                continue
            acc[i] += f";{k}" if v is True else f";{k}={v}"
    return acc.tolist()


def write_vcf(path: str, table: VariantTable, new_filters=None,
              extra_info: dict[str, np.ndarray] | None = None, index: bool = True,
              verbatim_core: bool = False, qual_as_read: bool = True, tails: np.ndarray | None = None) -> None:
    """Write a VariantTable back to VCF (``.gz`` -> BGZF), rewriting FILTER and
    appending ``extra_info`` keys to INFO; FORMAT/sample tails are verbatim,
    and so is the QUAL text of every record whose QUAL was not edited.

    ``tails``: each record's FORMAT and sample columns to write instead of
    its own (a rewritten FORMAT or sample, built with :func:`join_tails`);
    the records are then rendered by the plain writer.

    ``verbatim_core``: the caller has edited none of CHROM..QUAL since the
    read, so a scanned table's records are assembled by the native engine
    from its text (:func:`_write_assembled_native`); elsewhere, and when the
    engine declines, the plain writer renders them, with the same bytes.

    ``index``: a ``.gz`` output also gets its ``.tbi`` (``io/tabix``), as the
    reference's does; unsorted records leave the VCF valid and write no
    index (a stale one beside it is removed).

    ``qual_as_read=False``: every QUAL is written as :func:`format_qual` of
    its value (``34.30`` as ``34.3``), as the reference's ``write_vcf``
    writes it outside its native splice (its SEC correction's output);
    the records are then rendered by the plain writer, unless
    ``verbatim_core`` holds and every QUAL text already is that rendering
    (a gVCF's ``0``): then the native assembly writes the same bytes."""
    if verbatim_core and not qual_as_read and tails is None and _qual_text_is_formatted(table):
        qual_as_read = True  # the same bytes: the native assembly may serve
    if str(path).endswith(".gz"):
        from variantcalling_tpu_torch.io.bgzf import BgzfWriter

        out = BgzfWriter(path)
    else:
        out = open(path, "wb")
    with out:
        head = [*table.header.lines, table.header.column_header()]
        out.write(("\n".join(head) + "\n").encode())
        if not (verbatim_core and qual_as_read and tails is None
                and _write_assembled_native(out, table, new_filters, extra_info)):
            _write_records(out, table, new_filters, extra_info, qual_as_read, tails)
    if index and str(path).endswith(".gz"):
        write_tabix(str(path))


def write_tabix(path: str) -> None:
    """The ``.tbi`` beside a ``.vcf.gz`` (``io/tabix``); unsorted records
    leave the VCF valid and write none (a stale one beside it is removed)."""
    from variantcalling_tpu_torch.io.tabix import build_tabix_index

    try:
        build_tabix_index(path)
    except ValueError as e:
        log.warning("no .tbi for %s: %s", path, e)
        if os.path.exists(f"{path}.tbi"):
            os.remove(f"{path}.tbi")


def _write_records(out, table: VariantTable, new_filters, extra_info, qual_as_read: bool = True,
                   tails: np.ndarray | None = None) -> None:
    """The plain writer: each record rendered from the columns."""
    n = len(table)
    suffix = _format_extra_info(n, extra_info) if extra_info else None
    filters = new_filters if new_filters is not None else table.filters
    if isinstance(filters, FactorizedColumn):
        filters = filters.to_object()
    pos_s = np.char.mod("%d", table.pos).tolist()
    qual_s = (_qual_column(table) if qual_as_read else _format_qual_column(table.qual)).tolist()
    info = table.info.tolist()
    if suffix is not None:
        info = [i if not x else (x[1:] if i == MISSING else i + x) for i, x in zip(info, suffix)]
    tails = (table.tail if tails is None else tails).tolist()
    cols = (table.chrom.tolist(), pos_s, table.vid.tolist(), table.ref.tolist(), table.alt.tolist(), qual_s,
            list(filters), info)
    for lo in range(0, n, 16384):
        lines = ["\t".join(core) + "\t" + t if t else "\t".join(core)
                 for *core, t in zip(*(c[lo: lo + 16384] for c in cols), tails[lo: lo + 16384])]
        out.write(("\n".join(lines) + "\n").encode())


def _single_float_info(extra_info) -> tuple[str, np.ndarray] | None:
    """The one floating INFO column of ``extra_info`` (the pipeline's
    TREE_SCORE), which the native engine renders; None otherwise."""
    if extra_info and len(extra_info) == 1:
        (k, vals), = extra_info.items()
        arr = np.asarray(vals)
        if arr.dtype.kind == "f":
            return k, arr
    return None


def _encode_column_factorized(values, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(byte buffer, (n + 1,) offsets) of a low-cardinality string column
    (FILTER): one fill a distinct value; missing values write ``.``."""
    if isinstance(values, FactorizedColumn):
        codes, uniques = values.codes, values.uniques
    else:
        index: dict = {}
        codes = np.fromiter((index.setdefault(v, len(index)) for v in values), dtype=np.int64, count=n)
        uniques = list(index)
    enc = [(MISSING if u is None or u == "" else str(u)).encode() for u in uniques]
    lens = np.fromiter((len(e) for e in enc), dtype=np.int64, count=len(enc))
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens[codes], out=offs[1:])
    buf = np.empty(int(offs[-1]), dtype=np.uint8)
    starts = offs[:-1]
    for ui, e in enumerate(enc):
        s = starts[codes == ui]
        for j, byte in enumerate(e):
            buf[s + j] = byte
    return buf, offs


def _filter_info_blobs(table: VariantTable, new_filters, extra_info):
    """(FILTER bytes, offsets, INFO suffix bytes, offsets) for
    ``native.vcf_assemble``: one float INFO column rendered by the engine,
    anything else by :func:`_format_extra_info`."""
    from variantcalling_tpu_torch import native

    n = len(table)
    filters = new_filters if new_filters is not None else FactorizedColumn(*table.factorize("filters"))
    filt_buf, filt_offs = _encode_column_factorized(filters, n)
    one = _single_float_info(extra_info)
    sfx = native.format_float_info(one[1], f";{one[0]}=".encode()) if one is not None else None
    if sfx is None:
        suffix = [s.encode() for s in _format_extra_info(n, extra_info)] if extra_info else [b""] * n
        sfx_offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.fromiter(map(len, suffix), dtype=np.int64, count=n), out=sfx_offs[1:])
        sfx = np.frombuffer(b"".join(suffix), dtype=np.uint8), sfx_offs
    return filt_buf, filt_offs, *sfx


#: records a native assembly call renders into its one reused buffer
ASSEMBLE_CHUNK = 1 << 20


def _write_assembled_native(out, table: VariantTable, new_filters, extra_info) -> bool:
    """Records spliced by the native engine (CHROM..QUAL and FORMAT..end from
    the scanned text, a new FILTER, INFO with the suffix), written in chunks
    of :data:`ASSEMBLE_CHUNK` records through one reused buffer. False, with
    nothing written, where the table has no scan or the engine is off; a
    failure after the first chunk finishes with the plain writer."""
    from variantcalling_tpu_torch import native

    aux = table.aux
    if aux is None or not native.available():
        if _single_float_info(extra_info) is not None:
            native.note_plain("format_float_info")
        native.note_plain("vcf_assemble")
        return False
    n = len(table)
    filt_buf, filt_offs, sfx_buf, sfx_offs = _filter_info_blobs(table, new_filters, extra_info)
    scratch = None
    for lo in range(0, n, ASSEMBLE_CHUNK):
        hi = min(lo + ASSEMBLE_CHUNK, n)
        body = native.vcf_assemble(aux.buf, aux.line_spans[lo:hi], aux.filter_spans[lo:hi], aux.info_spans[lo:hi],
                                   aux.tail_spans[lo:hi], filt_buf, filt_offs[lo: hi + 1], sfx_buf,
                                   sfx_offs[lo: hi + 1], out=scratch)
        if body is None:
            if lo == 0:
                return False
            rest = np.arange(lo, n)
            _write_records(out, table.subset(rest),
                           None if new_filters is None else _take(new_filters, rest),
                           {k: np.asarray(v)[rest] for k, v in extra_info.items()} if extra_info else None)
            return True
        out.write(memoryview(body))
        scratch = body.base if isinstance(body.base, np.ndarray) else body
    return True


def _take(column, rows: np.ndarray):
    if isinstance(column, FactorizedColumn):
        return FactorizedColumn(column.codes[rows], column.uniques)
    return np.asarray(column, dtype=object)[rows]


def assemble_table_bytes(table: VariantTable, new_filters=None, extra_info=None) -> np.ndarray | None:
    """One table's records rendered by the native engine as a uint8 array (the
    streaming executor's per-chunk writeback); None where the table has no
    scan or the engine is off: :func:`render_table_bytes_python` serves."""
    from variantcalling_tpu_torch import native

    aux = table.aux
    if aux is None or not native.available():
        if _single_float_info(extra_info) is not None:
            native.note_plain("format_float_info")
        native.note_plain("vcf_assemble")
        return None
    filt_buf, filt_offs, sfx_buf, sfx_offs = _filter_info_blobs(table, new_filters, extra_info)
    return native.vcf_assemble(aux.buf, aux.line_spans, aux.filter_spans, aux.info_spans, aux.tail_spans,
                               filt_buf, filt_offs, sfx_buf, sfx_offs)


def render_table_bytes_python(table: VariantTable, new_filters=None, extra_info=None) -> bytes:
    """The plain version of :func:`assemble_table_bytes`: the same bytes from
    the plain writer."""
    sink = _io.BytesIO()
    _write_records(sink, table, new_filters, extra_info)
    return sink.getvalue()


#: default streaming chunk size (bytes of VCF text a pipeline item), the
#: default of ``VCTPU_STREAM_CHUNK_BYTES``
STREAM_CHUNK_BYTES = 8 << 20


class _ParallelBgzfStream:
    """File-like ``read(n)`` over a BGZF file, inflated shard-parallel.

    The compressed file splits at member boundaries
    (:func:`bgzf.scan_block_spans`) into shards of about
    ``VCTPU_IO_SHARD_BYTES`` uncompressed bytes, inflated on the IO pool and
    reassembled in file order: the byte stream of a serial ``gzip`` read, so
    chunk boundaries do not depend on the worker count. Raises ``ValueError``
    on a file that is not BGZF-framed (plain gzip): the caller reads it
    serially. ``spans``: inflate only these members (a rank's window of the
    chain) instead of the whole file. ``profiler`` (``obs/profile.StageProfiler``): each worker's
    inflate work goes to its ``inflate.w<idx>`` row.
    """

    def __init__(self, path: str, pool, profiler=None, spans=None):
        from variantcalling_tpu_torch import knobs
        from variantcalling_tpu_torch.io import bgzf as bgzf_mod
        from variantcalling_tpu_torch.parallel.pipeline import imap_ordered

        size = os.path.getsize(path)
        self.path = str(path)
        self._mm = np.memmap(path, dtype=np.uint8, mode="r") if size else np.empty(0, dtype=np.uint8)
        if spans is None:
            spans = bgzf_mod.scan_block_spans(self._mm) if size else []
            if spans is None:
                raise ValueError(f"{path}: not BGZF-framed")
        # ``spans`` given: a run of the member chain (a rank's window), so a
        # rank inflates only about its share of the file
        groups = bgzf_mod.group_spans(spans, knobs.get_int("VCTPU_IO_SHARD_BYTES"))
        self._profiler = profiler
        self._shards = imap_ordered(pool, self._inflate, groups, window=pool.threads + 2)
        self._buf = bytearray()
        self._eof = False

    def _inflate(self, spans) -> bytes:
        from variantcalling_tpu_torch.io import bgzf as bgzf_mod
        from variantcalling_tpu_torch.parallel.pipeline import retry_transient
        from variantcalling_tpu_torch.utils import faults

        def attempt() -> bytes:
            # injection point "io.shard_decompress": inflate is a function of
            # the mapped bytes, so a transient error is safely retried
            faults.check("io.shard_decompress")
            return bgzf_mod.inflate_spans(self._mm, spans)

        if self._profiler is None:
            return retry_transient(attempt, f"bgzf shard inflate ({self.path})")
        t0 = time.perf_counter()
        out = retry_transient(attempt, f"bgzf shard inflate ({self.path})")
        worker = threading.current_thread().name.rsplit("-", 1)[-1]
        self._profiler.stage(f"inflate.{worker}").add_work(time.perf_counter() - t0,
                                                           bytes_in=sum(s[1] for s in spans), bytes_out=len(out))
        return out

    def read(self, n: int) -> bytes:
        while len(self._buf) < n and not self._eof:
            nxt = next(self._shards, None)
            if nxt is None:
                self._eof = True
                break
            self._buf += nxt
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def close(self) -> None:
        self._shards.close()
        self._buf.clear()
        self._mm = None


class _MemberStream:
    """Serial ``read(n)`` over a run of BGZF members (a rank's suffix of the
    member chain): the ``VCTPU_IO_THREADS=1`` sibling of
    :class:`_ParallelBgzfStream` for a span window."""

    def __init__(self, mm, spans):
        self._mm = mm
        self._spans = spans
        self._i = 0
        self._buf = bytearray()

    def read(self, n: int) -> bytes:
        from variantcalling_tpu_torch.io import bgzf as bgzf_mod

        while len(self._buf) < n and self._i < len(self._spans):
            j = min(self._i + 16, len(self._spans))
            self._buf += bgzf_mod.inflate_spans(self._mm, self._spans[self._i:j])
            self._i = j
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def close(self) -> None:
        self._buf.clear()
        self._i = len(self._spans)


class _SpanGzWindow:
    """File-like ``read(n)`` serving one line-aligned window of a BGZF file's
    decompressed stream (the rank and span partition rule).

    The window is ``[cut(t_lo), cut(t_hi))``, where ``cut(u)`` is the
    smallest line start at or after ``u``: the position after the first
    newline at offset ``u - 1`` or later, clamped to the record region
    ``[h, total]``. Neighbouring windows compute the same cut for their
    shared target, so the windows tile the record region exactly, whatever
    the block layout. ``inner`` starts at the member that holds the first
    byte the window needs (``base`` is that member's decompressed offset),
    so a rank inflates about its share (and the members its boundary lines
    straddle).
    """

    def __init__(self, inner, base: int, t_lo: int, t_hi: int, h: int, total: int):
        self._inner = inner
        self._buf = bytearray()
        self._buf_abs = base  # absolute offset of _buf[0]
        self._inner_eof = False
        self._t_lo, self._t_hi = t_lo, t_hi
        self._h, self._total = h, total
        self._start: int | None = None  # cut(t_lo), resolved on first use
        self._end: int | None = None  # cut(t_hi)

    def start(self) -> int:
        """The absolute decompressed offset of the window's first byte,
        ``cut(t_lo)``: the base of the chunks' end offsets."""
        self._resolve_start()
        return self._start

    def _resolve_start(self) -> None:
        if self._start is not None:
            return
        self._start = self._cut(self._t_lo)
        if self._t_hi >= self._total:
            self._end = self._total
        while self._buf_abs < self._start:
            if not self._buf:
                if not self._more():
                    break
                continue
            self._drop(min(len(self._buf), self._start - self._buf_abs))

    def _more(self) -> bool:
        if self._inner_eof:
            return False
        block = self._inner.read(4 << 20)
        if not block:
            self._inner_eof = True
            return False
        self._buf += block
        return True

    def _drop(self, n: int) -> None:
        del self._buf[:n]
        self._buf_abs += n

    def _cut(self, t: int) -> int:
        """``cut(t)``, buffering inner bytes as needed; the end of the stream
        clamps."""
        if t <= self._h:
            return self._h
        if t >= self._total:
            return self._total
        probe = t - 1
        if probe < self._buf_abs:
            # the probe byte is consumed already: only when this cut is the
            # start cut (no newline lies between the two targets)
            return self._start if self._start is not None else self._buf_abs
        while True:
            start_idx = probe - self._buf_abs
            if start_idx < len(self._buf):
                nl = self._buf.find(b"\n", start_idx)
                if nl >= 0:
                    return self._buf_abs + nl + 1
                probe = self._buf_abs + len(self._buf)
            if not self._more():
                return self._buf_abs + len(self._buf)  # the stream ends mid-line

    def read(self, n: int) -> bytes:
        self._resolve_start()
        out = bytearray()
        while len(out) < n:
            if self._end is not None and self._buf_abs >= self._end:
                break
            if not self._buf and not self._more():
                break
            avail = len(self._buf)
            if self._end is None:
                # the end is unknown: every byte before t_hi - 1 is inside;
                # once the buffer reaches the probe byte, resolve the end cut
                # (the last line may straddle members)
                if self._buf_abs + avail > self._t_hi - 1:
                    self._end = self._cut(self._t_hi)
                    continue
                take = avail
            else:
                take = min(avail, self._end - self._buf_abs)
            take = min(take, n - len(out))
            if take <= 0:
                break
            out += self._buf[:take]
            self._drop(take)
        return bytes(out)

    def close(self) -> None:
        self._inner.close()


class VcfChunkReader:
    """Line-aligned chunked VCF ingest for the streaming executor.

    Counterpart of the reference's ``VcfChunkReader``. Iterating yields :class:`VariantTable` chunks in file order, each
    scanned by ``native.vcf_parse`` and built by the table assembly
    :func:`read_vcf` uses, so a chunk's table is a row slice of the
    whole-file table. Sources:

    - ``.vcf``: a memory map, cut at line ends, so the file never
      materializes in anonymous memory;
    - ``.vcf.gz``/``.bgz``: streamed decompression, one bytes buffer a chunk
      with the partial line carried over (shard-parallel inflate of a BGZF
      file with ``VCTPU_IO_THREADS`` > 1).

    Chunk boundaries follow the reference's rule for the same
    ``chunk_bytes`` (argument, else ``VCTPU_STREAM_CHUNK_BYTES``), at any
    IO thread count, as a function of (input bytes, ``chunk_bytes``, the
    span's start).

    ``rank_span=(rank, ranks)``: only that rank's line-aligned span of the
    record region (targets at ``rank / ranks`` of the record bytes, each
    advanced to the next line start), so the ranks' spans tile the file;
    ``span_targets=(lo, hi)``: an elastic worker's absolute decompressed
    targets, cut by the same rule (the rank fractions are a special case).
    A BGZF input is read from the member holding the span's first byte; a
    plain single-member gzip under either raises :class:`EngineError`
    (exit 2), never inflated from its start by every rank. With ``VCTPU_IO_THREADS`` > 1 iteration parses the
    chunks on the IO pool, reassembled in order. One-shot; needs the native
    engine; a mid-stream scan failure raises. ``profiler``
    (``obs/profile.StageProfiler``): the pool workers' inflate and parse
    work goes to their ``inflate.w<idx>`` and ``parse.w<idx>`` rows.
    """

    def __init__(self, path: str, chunk_bytes: int = 0, io_threads: int | None = None, profiler=None,
                 rank_span: tuple[int, int] | None = None, span_targets: tuple[int, int] | None = None):
        from variantcalling_tpu_torch import knobs, native
        from variantcalling_tpu_torch.parallel.pipeline import resolve_io_threads

        if not native.available():
            raise RuntimeError("VcfChunkReader requires the native engine")
        self.path = str(path)
        self._rank_span: tuple[int, int] | None = None
        if rank_span is not None and int(rank_span[1]) > 1:
            r, nr = int(rank_span[0]), int(rank_span[1])
            if not 0 <= r < nr:
                raise ValueError(f"rank_span {rank_span!r} out of range")
            self._rank_span = (r, nr)
        self._span_targets: tuple[int, int] | None = None
        if span_targets is not None:
            lo, hi = int(span_targets[0]), int(span_targets[1])
            if hi < lo:
                raise ValueError(f"span_targets {span_targets!r} inverted")
            self._span_targets = (lo, hi)
            if self._rank_span is not None:
                raise ValueError("rank_span and span_targets are exclusive")
        #: decompressed bytes of this reader's span (None: the whole file)
        self.span_bytes: int | None = None
        #: the absolute (decompressed) end offset of every chunk boundary
        #: computed so far, skipped chunks included, by sequence number
        self.chunk_ends: list[int] = []
        env_chunk = knobs.get_int("VCTPU_STREAM_CHUNK_BYTES") \
            if knobs.raw("VCTPU_STREAM_CHUNK_BYTES") is not None else None
        self.chunk_bytes = int(chunk_bytes) or env_chunk or STREAM_CHUNK_BYTES
        self.io_threads = resolve_io_threads() if io_threads is None else max(1, int(io_threads))
        self.profiler = profiler
        self._pool = None
        self._pool_shared = False
        #: chunks to advance without parsing (resume: their bytes are committed)
        self._skip = 0
        self._gz = self.path.endswith((".gz", ".bgz"))
        self._mm: np.ndarray | None = None
        self._fh = None
        self._pending = b""
        if self._gz and (self._rank_span is not None or self._span_targets is not None):
            try:
                self._init_gz_span()
            except BaseException:
                self.close()
                raise
        elif self._gz:
            try:  # a failing header read must release the started pool
                self._fh = self._open_gz_stream()
                self.header, first_off, head = self._scan_gz_header(self._fh)
                self._pending = head[first_off:]
                self._gz_base = first_off
            except BaseException:
                self.close()
                raise
        else:
            size = os.path.getsize(self.path)
            self._mm = np.memmap(self.path, dtype=np.uint8, mode="r") if size else np.empty(0, dtype=np.uint8)
            cap = 1 << 20
            while True:
                head = bytes(memoryview(self._mm[: min(cap, size)]))
                header, first_off = parse_header_bytes(head)
                if (first_off < len(head) and head[first_off: first_off + 1] != b"#") or cap >= size:
                    break
                cap *= 8
            self.header = header
            self._first_off = first_off
            self._span_lo, self._span_hi = first_off, size
            if self._rank_span is not None:
                self._span_lo, self._span_hi = self._mm_span_bounds(size)
                self.span_bytes = self._span_hi - self._span_lo
            elif self._span_targets is not None:
                lo, hi = self._span_targets
                self._span_lo = self._mm_newline_cut(lo, size)
                self._span_hi = max(self._span_lo, self._mm_newline_cut(hi, size))
                self.span_bytes = self._span_hi - self._span_lo

    def _scan_gz_header(self, fh) -> tuple:
        """The header off a decompressed stream: ``chunk_bytes`` windows until
        a record line begins or the stream ends. Returns ``(header,
        first_off, head)``; ``head[first_off:]`` is the records already read."""
        head = b""
        while True:
            block = fh.read(self.chunk_bytes)
            head += block
            header, first_off = parse_header_bytes(head)
            if not block or (first_off < len(head) and head[first_off:first_off + 1] != b"#"):
                break
        return header, first_off, head

    def _mm_newline_cut(self, u: int, size: int) -> int:
        """The smallest line start at or after ``u``: the position after the
        first newline at ``u - 1`` or later, clamped to the record region.
        Every rank applies it, so neighbouring spans meet exactly."""
        if u <= self._first_off:
            return self._first_off
        if u >= size:
            return size
        pos = u - 1
        probe = 1 << 16
        while pos < size:
            w = self._mm[pos: min(pos + probe, size)]
            hits = np.flatnonzero(w == 0x0A)
            if len(hits):
                return min(pos + int(hits[0]) + 1, size)
            pos += len(w)
            probe *= 8
        return size

    def _mm_span_bounds(self, size: int) -> tuple[int, int]:
        r, n_ranks = self._rank_span
        body = size - self._first_off
        lo = self._mm_newline_cut(self._first_off + body * r // n_ranks, size)
        hi = self._mm_newline_cut(self._first_off + body * (r + 1) // n_ranks, size)
        return lo, max(lo, hi)

    def _init_gz_span(self) -> None:
        """A span of a BGZF input: the member chain mapped, the header read
        by a short serial inflate from the start, then the span's window of
        the decompressed stream (:class:`_SpanGzWindow`) from the member that
        holds its first needed byte."""
        from variantcalling_tpu_torch.engine import EngineError
        from variantcalling_tpu_torch.io import bgzf as bgzf_mod

        size = os.path.getsize(self.path)
        mm = np.memmap(self.path, dtype=np.uint8, mode="r") if size else np.empty(0, dtype=np.uint8)
        spans = bgzf_mod.scan_block_spans(mm) if size else []
        if spans is None:
            raise EngineError(
                f"{self.path}: rank-partitioned ingest needs BGZF-framed input (plain gzip is one "
                "indivisible deflate stream) — re-compress with bgzip/the BGZF writer, or run single-rank")
        with gzip.open(self.path, "rb") as fh:
            self.header, first_off, _ = self._scan_gz_header(fh)
        h = first_off
        total = int(sum(s[2] for s in spans))
        if self._span_targets is not None:
            t_lo = max(h, min(self._span_targets[0], total))
            t_hi = max(t_lo, min(self._span_targets[1], total))
        else:
            r, n_ranks = self._rank_span
            body = max(0, total - h)
            t_lo = h + body * r // n_ranks
            t_hi = h + body * (r + 1) // n_ranks
        self.span_bytes = max(0, t_hi - t_lo)
        # the first decompressed byte the window needs: the line-start probe
        # at t_lo - 1 (or the header's end, for the first span)
        probe = t_lo - 1 if t_lo > h else h
        probe = max(0, min(probe, max(total - 1, 0)))
        cum = 0
        m_lo = len(spans)
        for i, sp in enumerate(spans):
            if cum + sp[2] > probe:
                m_lo = i
                break
            cum += sp[2]
        tail = spans[m_lo:]
        if self.io_threads > 1 and tail:
            inner = _ParallelBgzfStream(self.path, self._ensure_pool(), profiler=self.profiler, spans=tail)
        else:
            inner = _MemberStream(mm, tail)
        self._fh = _SpanGzWindow(inner, cum, t_lo, t_hi, h, total)
        self._pending = b""

    def _open_gz_stream(self):
        """Shard-parallel BGZF inflate where the IO pool is on and the file
        is BGZF-framed, else the serial gzip stream: the same bytes."""
        if self.io_threads > 1:
            try:
                return _ParallelBgzfStream(self.path, self._ensure_pool(), profiler=self.profiler)
            except ValueError:
                pass  # not BGZF-framed: one deflate stream, inflated serially
        return gzip.open(self.path, "rb")

    def _ensure_pool(self):
        if self._pool is None:
            from variantcalling_tpu_torch.parallel.pipeline import IoPool

            self._pool = IoPool(self.io_threads)
        return self._pool

    def shared_pool(self):
        """The run's IO pool, marked shared: the executor hands it to work
        that outlives ingest (the chunk fan-out, the compress stage), so the
        end of iteration no longer shuts it down; the owner's :meth:`close`
        does."""
        self._pool_shared = True
        return self._ensure_pool()

    def _close_stream(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    def close(self) -> None:
        """Release the IO pool and the input stream (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        self._close_stream()

    def skip(self, n_chunks: int) -> None:
        """Advance past the first ``n_chunks`` chunks without parsing them
        (resume). Call before iterating."""
        self._skip = max(0, int(n_chunks))

    def chunk_end(self, seq: int) -> int | None:
        """The absolute decompressed end offset of chunk ``seq`` (None before
        its boundary is computed)."""
        return self.chunk_ends[seq] if 0 <= seq < len(self.chunk_ends) else None

    def parse_chunk(self, buf_np: np.ndarray, lazy_buf) -> VariantTable:
        """One raw chunk buffer (:meth:`iter_raw`) scanned into a table."""
        from variantcalling_tpu_torch import native
        from variantcalling_tpu_torch.parallel.pipeline import retry_transient
        from variantcalling_tpu_torch.utils import faults

        def attempt() -> VariantTable:
            # injection point "io.chunk_read": parse is a function of the
            # buffer already read, so a retry is always safe
            faults.check("io.chunk_read")
            parsed = native.vcf_parse(buf_np, len(self.header.samples))
            if parsed is None:
                raise RuntimeError(f"native VCF scan failed mid-stream in {self.path}")
            return _table_from_parsed(parsed, self.header, lazy_buf, buf_np)

        return retry_transient(attempt, f"chunk read ({self.path})")

    def iter_raw(self):
        """Raw ``(buf_np, lazy_buf)`` chunk buffers in order, not parsed: the
        pooled layout runs each chunk's whole body (parse, score, render) as
        one task over them. The same boundaries as iteration."""
        raw = self._raw_gz() if self._gz else self._raw_mm()
        try:
            yield from raw
        finally:
            if self._pool_shared:
                self._close_stream()
            else:
                self.close()

    def __iter__(self):
        raw = self._raw_gz() if self._gz else self._raw_mm()
        if self.io_threads <= 1:
            for buf_np, lazy_buf in raw:
                yield self.parse_chunk(buf_np, lazy_buf)
            return
        from variantcalling_tpu_torch.parallel.pipeline import imap_ordered

        try:
            yield from imap_ordered(self._ensure_pool(), self._parse_worker, raw, window=self.io_threads + 1)
        finally:
            if self._pool_shared:
                self._close_stream()
            else:
                self.close()

    def _parse_worker(self, raw: tuple) -> VariantTable:
        """One pooled chunk parse, its work attributed to the worker's row."""
        buf_np, lazy_buf = raw
        if self.profiler is None:
            return self.parse_chunk(buf_np, lazy_buf)
        t0 = time.perf_counter()
        table = self.parse_chunk(buf_np, lazy_buf)
        worker = threading.current_thread().name.rsplit("-", 1)[-1]
        self.profiler.stage(f"parse.{worker}").add_work(time.perf_counter() - t0, bytes_in=len(buf_np),
                                                        records=len(table))
        return table

    def _raw_mm(self):
        """Chunk buffers of a plain-text file (or of its span): ``chunk_bytes``
        from the last cut, extended to the next line end."""
        mm = self._mm
        n = self._span_hi
        off = self._span_lo
        while off < n:
            end = min(off + self.chunk_bytes, n)
            if end < n:
                probe = 1 << 16  # grows for the all-one-line case
                while True:
                    w = mm[end: min(end + probe, n)]
                    hits = np.flatnonzero(w == 0x0A)
                    if len(hits):
                        end = end + int(hits[0]) + 1
                        break
                    if end + probe >= n:
                        end = n
                        break
                    probe *= 8
            self.chunk_ends.append(end)
            if self._skip > 0:
                self._skip -= 1
            else:
                view = mm[off:end]
                yield view, view
            off = end

    def _raw_gz(self):
        """Chunk buffers of the decompressed stream: ``chunk_bytes`` windows
        cut at their last line end, the rest carried to the next. Chunk ends
        count from the header's end, or from a span window's start."""
        pos = self._fh.start() if isinstance(self._fh, _SpanGzWindow) else self._gz_base
        carry = self._pending
        self._pending = b""
        while True:
            block = self._fh.read(self.chunk_bytes)
            if not block:
                break
            block = carry + block
            cut = block.rfind(b"\n")
            if cut < 0:
                carry = block
                continue
            carry = block[cut + 1:]
            chunk = block[: cut + 1]
            pos += len(chunk)
            self.chunk_ends.append(pos)
            if self._skip > 0:
                self._skip -= 1
                continue
            yield np.frombuffer(chunk, dtype=np.uint8), chunk
        if carry:
            pos += len(carry)
            self.chunk_ends.append(pos)
            if self._skip > 0:
                self._skip -= 1
            else:
                yield np.frombuffer(carry, dtype=np.uint8), carry
        self._fh.close()


def scan_record_region(path: str) -> tuple[int, int]:
    """``(header_end, total_size)`` of a VCF in decompressed bytes: the target
    domain an elastic pod cuts its spans over (``parallel/elastic``). The
    header's end follows the chunk reader's rule, so the coordinator's
    targets and every worker's cuts agree byte for byte. A BGZF file's total
    comes from its member index without inflating it; plain single-member
    gzip raises :class:`EngineError`, as a span reader does."""
    path = str(path)
    if path.endswith((".gz", ".bgz")):
        from variantcalling_tpu_torch.engine import EngineError
        from variantcalling_tpu_torch.io import bgzf as bgzf_mod

        size = os.path.getsize(path)
        mm = np.memmap(path, dtype=np.uint8, mode="r") if size else np.empty(0, dtype=np.uint8)
        spans = bgzf_mod.scan_block_spans(mm) if size else []
        if spans is None:
            raise EngineError(
                f"{path}: span-partitioned ingest needs BGZF-framed input (plain gzip is one indivisible "
                "deflate stream) — re-compress with bgzip/the BGZF writer, or run single-rank")
        total = int(sum(s[2] for s in spans))
        head = b""
        with gzip.open(path, "rb") as fh:
            while True:
                block = fh.read(STREAM_CHUNK_BYTES)
                head += block
                _header, first_off = parse_header_bytes(head)
                if not block or (first_off < len(head) and head[first_off:first_off + 1] != b"#"):
                    break
        return first_off, total
    size = os.path.getsize(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r") if size else np.empty(0, dtype=np.uint8)
    cap = 1 << 20
    while True:
        head = bytes(memoryview(mm[: min(cap, size)]))
        _header, first_off = parse_header_bytes(head)
        if (first_off < len(head) and head[first_off:first_off + 1] != b"#") or cap >= size:
            break
        cap *= 8
    return first_off, size
