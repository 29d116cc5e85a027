"""CRAM ingest: native CRAM 3.0 decode -> per-contig depth difference arrays.

Counterpart of ``variantcalling_tpu/io/cram.py``, a copy with the port's
imports. The upstream tools read CRAM through samtools subprocesses
(BASELINE config 4 is "30x WGS CRAM"); here the native engine's decoder
(``native/src/vctpu_cram.cc``) serves the same inputs in process:
``cram_depth`` walks each record's features with its quality array, so
the ``-q`` filter, deletions under ``-J`` and N skips follow the BAM walk
(:mod:`io.bam`), and CRAM and BAM depth agree.

Native only, as in the reference: with the engine off or unbuilt, or on a
CRAM 3.1 codec (rANS-Nx16, arithmetic, fqzcomp, name tokenizer) or a
bzip2/lzma block, decoding raises ``ValueError`` with a clear message.
"""

from __future__ import annotations

import numpy as np

from variantcalling_tpu_torch import native
from variantcalling_tpu_torch.io.bam import EXCLUDE_FLAGS, BamHeader


def read_cram_header(path: str) -> BamHeader:
    with open(path, "rb") as fh:
        buf = fh.read()
    return header_from_buffer(buf, path)


def header_from_buffer(buf, path: str = "<buffer>") -> BamHeader:
    text = native.cram_header(buf)
    if text is None:
        raise ValueError(
            f"cannot decode CRAM header of {path}: native engine unavailable or "
            "unsupported CRAM version/codec (supported: CRAM 3.0, raw/gzip/rANS-4x8)"
        )
    refs: list[str] = []
    lengths: dict[str, int] = {}
    for line in text.splitlines():
        if line.startswith("@SQ"):
            name, ln = None, None
            for field in line.split("\t")[1:]:
                if field.startswith("SN:"):
                    name = field[3:]
                elif field.startswith("LN:"):
                    ln = int(field[3:])
            if name is not None and ln is not None:
                refs.append(name)
                lengths[name] = ln
    return BamHeader(text=text, references=refs, lengths=lengths)


def cram_records(path: str) -> tuple[BamHeader, dict]:
    """(header, record arrays) for a whole CRAM file (single read, exact alloc)."""
    with open(path, "rb") as fh:
        buf = fh.read()
    header = header_from_buffer(buf, path)
    n = native.cram_count(buf)
    if n is None:
        raise ValueError(f"cannot walk CRAM containers of {path} (malformed stream?)")
    recs = native.cram_scan(buf, max(n, 1))
    if recs is None or recs == "grow":
        raise ValueError(
            f"cannot decode CRAM records of {path}: unsupported codec or "
            "malformed stream (supported: CRAM 3.0, raw/gzip/rANS-4x8 blocks)"
        )
    return header, recs


def depth_diff_arrays(
    path: str,
    min_bq: int = 0,
    min_mapq: int = 0,
    min_read_length: int = 0,
    include_deletions: bool = True,
    regions: list[str] | None = None,
) -> tuple[BamHeader, dict[str, np.ndarray]]:
    """CRAM counterpart of io.bam.depth_diff_arrays (same contract,
    including the per-base ``-q`` filter — the decoder walks alignment
    features with the record's quality array, so CRAM and BAM depth agree
    on mixed-quality data)."""
    with open(path, "rb") as fh:
        buf = fh.read()
    header = header_from_buffer(buf, path)
    region_contigs = {r.split(":")[0] for r in regions} if regions else None

    starts = np.full(len(header.references), -1, dtype=np.int64)
    lens = np.zeros(len(header.references), dtype=np.int64)
    off = 0
    for rid, name in enumerate(header.references):
        if region_contigs is not None and name not in region_contigs:
            continue
        starts[rid] = off
        lens[rid] = header.lengths[name]
        off += header.lengths[name] + 1
    diff_flat = np.zeros(max(off, 1), dtype=np.int32)
    n = native.cram_depth(
        buf, starts, lens, diff_flat,
        min_bq=min_bq, min_mapq=min_mapq, min_read_length=min_read_length,
        include_deletions=include_deletions, exclude_flags=EXCLUDE_FLAGS,
    )
    if n is None or n < 0:
        raise ValueError(
            f"cannot decode CRAM records of {path}: unsupported codec or "
            "malformed stream (supported: CRAM 3.0, raw/gzip/rANS blocks)"
        )
    diffs: dict[str, np.ndarray] = {}
    for rid, name in enumerate(header.references):
        if starts[rid] < 0:
            continue
        diffs[name] = diff_flat[starts[rid] : starts[rid] + header.lengths[name] + 1]
    return header, diffs
