"""Columnar VCF reader and writer (host-side ingest and writeback).

Counterpart of ``variantcalling_tpu/io/vcf.py`` on its default path, the
native engine's: the file is read as bytes and split on ``\n`` alone, so a
CRLF file's ``##`` lines keep their ``\r`` (written back as ``\r\n``) while
the ``#CHROM`` line and the records drop it, as the reference's
``parse_header_bytes`` and record scanner do. The FORMAT and sample columns
of each record are kept as one verbatim tail string and written back
unchanged; so is the QUAL text of every record whose QUAL was not edited
(the reference splices CHROM..QUAL verbatim, ``write_vcf(verbatim_core=
True)``). The other core columns are rendered from the column arrays, with
the reference's ``_format_extra_info_bytes`` rendering of new INFO keys.
"""

from __future__ import annotations

import gzip
import logging
import os
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

    def ensure_filter(self, filter_id: str, description: str) -> None:
        if filter_id not in self.filters:
            self.add_meta_line(f'##FILTER=<ID={filter_id},Description="{description}">')

    def column_header(self) -> str:
        cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
        if self.samples:
            cols += ["FORMAT", *self.samples]
        return "\t".join(cols)


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


class VariantTable:
    """Columnar view of a VCF: one numpy array per column over all records.

    ``tail`` holds each record's FORMAT and sample columns verbatim (one
    tab-joined string, "" when the record has none). ``qual_text`` holds each
    record's QUAL as read, beside the float ``qual`` the features use, and
    ``qual_read`` a copy of ``qual`` as read: a record whose ``qual`` still
    equals it writes its text back (both None: a table with no text).
    """

    def __init__(self, header: VcfHeader, chrom, pos, vid, ref, alt, qual,
                 filters, info, tail, qual_text=None, qual_read=None):
        self.header = header
        self.chrom = chrom
        self.pos = pos
        self.vid = vid
        self.ref = ref
        self.alt = alt
        self.qual = qual
        self.filters = filters
        self.info = info
        self.tail = tail
        self.qual_text = qual_text
        self.qual_read = None if qual_text is None else \
            (np.array(qual, dtype=np.float64) if qual_read is None else qual_read)

    def __len__(self) -> int:
        return len(self.pos)

    @property
    def n_samples(self) -> int:
        return len(self.header.samples)

    def subset(self, keep: np.ndarray) -> "VariantTable":
        """Row-subset every column by a boolean/index array."""
        return VariantTable(self.header, self.chrom[keep], self.pos[keep], self.vid[keep],
                            self.ref[keep], self.alt[keep], self.qual[keep],
                            self.filters[keep], self.info[keep], self.tail[keep],
                            *(() if self.qual_text is None else (self.qual_text[keep], self.qual_read[keep])))

    def n_alts(self) -> np.ndarray:
        return np.fromiter(
            (0 if a in (MISSING, "") else a.count(",") + 1 for a in self.alt),
            dtype=np.int32, count=len(self))

    def info_field(self, name: str, dtype=np.float64, missing=np.nan, index: int = 0) -> np.ndarray:
        """One INFO key per record (scalar, or the ``index``-th list element)."""
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
        """Padded (n, max_len) float64 tensor of a comma-listed FORMAT field (e.g. AD)."""
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


_READ_BYTES = 16 << 20


def _text_lines(path: str):
    """The file's lines as str, split on ``\n`` alone and without it, read in
    blocks and each block decoded at once. Header (``#``) lines that are not
    valid UTF-8 decode with replacement characters, as the reference's
    header parse does; such a record raises."""
    with _open_bytes(path) as fh:
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


def read_vcf(path: str) -> VariantTable:
    """Parse a VCF (``.vcf`` or ``.vcf.gz``) into a :class:`VariantTable`.

    Lines split on ``\n`` alone. ``##`` lines before the first record are
    the header, kept with any ``\r``; the ``#CHROM`` line and the records
    lose one trailing ``\r``; empty lines and ``#`` lines among the records
    are skipped, as the reference's scanner skips them."""
    header = VcfHeader()
    cols: list[list] = [[] for _ in range(10)]
    chrom, pos, vid, ref, alt, qual, qual_text, filt, info, tail = cols
    for line in _text_lines(path):
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
    ``%g`` of their float64 value, NaN skips the record."""
    acc = np.full(n, "", dtype=object)
    for k, vals in (extra_info or {}).items():
        arr = np.asarray(vals)
        if arr.dtype.kind != "f":
            raise TypeError(f"extra INFO column {k!r} must be floating point")
        f64 = arr.astype(np.float64)
        ok = ~np.isnan(f64)
        acc[ok] = acc[ok] + np.char.mod(f";{k}=%g", f64[ok]).astype(object)
    return acc.tolist()


def write_vcf(path: str, table: VariantTable, new_filters=None,
              extra_info: dict[str, np.ndarray] | None = None, index: bool = True) -> None:
    """Write a VariantTable back to VCF (``.gz`` -> BGZF), rewriting FILTER and
    appending ``extra_info`` keys to INFO; FORMAT/sample tails are verbatim,
    and so is the QUAL text of every record whose QUAL was not edited.

    ``index``: a ``.gz`` output also gets its ``.tbi`` (``io/tabix``), as the
    reference's does; unsorted records leave the VCF valid and write no
    index (a stale one beside it is removed)."""
    n = len(table)
    suffix = _format_extra_info(n, extra_info) if extra_info else None
    filters = new_filters if new_filters is not None else table.filters
    if isinstance(filters, FactorizedColumn):
        filters = filters.to_object()
    pos_s = np.char.mod("%d", table.pos)
    qual_s = _qual_column(table)
    if str(path).endswith(".gz"):
        from variantcalling_tpu_torch.io.bgzf import BgzfWriter

        out = BgzfWriter(path)
    else:
        out = open(path, "wb")
    with out:
        head = [*table.header.lines, table.header.column_header()]
        out.write(("\n".join(head) + "\n").encode())
        chunk: list[str] = []
        for i in range(n):
            info = table.info[i]
            if suffix is not None and suffix[i]:
                info = suffix[i][1:] if info == MISSING else info + suffix[i]
            line = "\t".join((table.chrom[i], pos_s[i], table.vid[i], table.ref[i],
                              table.alt[i], qual_s[i], filters[i], info))
            t = table.tail[i]
            chunk.append(line + "\t" + t if t else line)
            if len(chunk) >= 16384:
                out.write(("\n".join(chunk) + "\n").encode())
                chunk.clear()
        if chunk:
            out.write(("\n".join(chunk) + "\n").encode())
    if index and str(path).endswith(".gz"):
        from variantcalling_tpu_torch.io.tabix import build_tabix_index

        try:
            build_tabix_index(str(path))
        except ValueError as e:
            log.warning("no .tbi for %s: %s", path, e)
            if os.path.exists(f"{path}.tbi"):
                os.remove(f"{path}.tbi")
