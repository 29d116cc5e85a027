"""find_adapter_coords — locate adapters/UMIs in uBAM reads, write XF/XT/RX tags.

Counterpart of ``variantcalling_tpu/pipelines/find_adapter_coords.py``, with
the same arguments (a host tool: no ``--backend``) and the same tags:

- XF:i = 1-based first coordinate after the 5' adapter (+ left UMI), 1 if
  no 5' adapter found, 0 if the whole read is adapter;
- XT:i = 1-based start of the 3' adapter (- right UMI), read_len+1 if no
  3' adapter found, 0 if the whole read is adapter;
- RX:Z = left UMI, revcomp(right UMI), or "left-right" (N-filled when the
  flanking adapter was not found).

Matching is substitution-only with an error budget of ``int(error_rate *
overlap)``; partial matches at the read start (5') / end (3') honour
``min_overlap``, and the first offset within budget wins. The reference
tries the offsets of one read one numpy call at a time
(:func:`find_left_plain`, :func:`find_right_plain`, kept here as the plain
spec); the port compares every offset of a block of reads of one length at
once (:func:`match_left`, :func:`match_right`): for each adapter position,
one add of the reads' shifted equality mask, so a block's matches at every
offset are ``len(adapter)`` vector adds. The BAM is inflated whole, the
records keep every byte and get their tags appended, and the stream is
written once.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from variantcalling_tpu_torch.io import bam
from variantcalling_tpu_torch.io.bgzf import BgzfWriter

log = logging.getLogger(__name__)

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
#: ASCII letter -> its complement (A C G T N), every other byte N
_COMP_BYTES = np.full(256, ord("N"), dtype=np.uint8)
for _b, _c in _COMP.items():
    _COMP_BYTES[ord(_b)] = ord(_c)
#: reads a block of the batched matcher
BLOCK_READS = 8192


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="find_adapter_coords", description=run.__doc__)
    ap.add_argument("--input_bam", required=True)
    ap.add_argument("--output_bam", required=True)
    ap.add_argument("--left_adapter", default="")
    ap.add_argument("--right_adapter", default="")
    ap.add_argument("--left_umi_length", type=int, default=0)
    ap.add_argument("--right_umi_length", type=int, default=0)
    ap.add_argument("--error_rate_5p", type=float, default=0.15)
    ap.add_argument("--error_rate_3p", type=float, default=0.2)
    ap.add_argument("--min_overlap_5p", type=int, default=5)
    ap.add_argument("--min_overlap_3p", type=int, default=5)
    return ap.parse_args(argv)


# -- the plain per-read spec ---------------------------------------------------------------------------------------


def _encode(seq: str) -> np.ndarray:
    return np.frombuffer(seq.encode(), dtype=np.uint8)


def find_left_plain(read: np.ndarray, adapter: np.ndarray, error_rate: float, min_overlap: int) -> int:
    """Index AFTER the 5' adapter match (0 = none). Partial at read start OK."""
    la, lr = len(adapter), len(read)
    # offset o: adapter start relative to read start (negative = truncated)
    for o in range(-(la - min_overlap), lr - min_overlap + 1):
        a_lo = max(0, -o)
        overlap = min(la - a_lo, lr - max(o, 0))
        if overlap < min_overlap:
            continue
        r_lo = max(o, 0)
        errs = int(np.count_nonzero(adapter[a_lo: a_lo + overlap] != read[r_lo: r_lo + overlap]))
        if errs <= int(error_rate * overlap):
            return r_lo + overlap  # first occurrence wins (cutadapt -g)
    return 0


def find_right_plain(read: np.ndarray, adapter: np.ndarray, error_rate: float, min_overlap: int) -> int:
    """0-based start of the 3' adapter match (-1 = none). Partial at read end OK."""
    la, lr = len(adapter), len(read)
    for o in range(0, lr - min_overlap + 1):
        overlap = min(la, lr - o)
        if overlap < min_overlap:
            continue
        errs = int(np.count_nonzero(adapter[:overlap] != read[o: o + overlap]))
        if errs <= int(error_rate * overlap):
            return o
    return -1


def analyze_read(seq: str, args) -> tuple[int, int, str | None]:
    """(XF, XT, RX) of one read, the reference's rule."""
    read = _encode(seq)
    lr = len(read)
    end5 = find_left_plain(read, _encode(args.left_adapter), args.error_rate_5p,
                           args.min_overlap_5p) if args.left_adapter else 0
    start3 = find_right_plain(read, _encode(args.right_adapter), args.error_rate_3p,
                              args.min_overlap_3p) if args.right_adapter else -1
    coord1 = end5 + 1  # 1-based first non-adapter base (1 when no 5' adapter)
    coord2 = (start3 + 1) if start3 >= 0 else lr + 1
    if coord2 <= coord1:  # entire read masked
        coord1 = coord2 = 0
    umi1 = umi2 = None
    if args.left_umi_length > 0:
        if coord1 > 1:
            umi1 = seq[coord1 - 1: coord1 - 1 + args.left_umi_length]
            coord1 += args.left_umi_length
        else:
            umi1 = "N" * args.left_umi_length
    if args.right_umi_length > 0:
        if start3 >= 0 and coord2 > 0:
            coord2 -= args.right_umi_length
            raw = seq[max(coord2 - 1, 0): max(coord2 - 1, 0) + args.right_umi_length]
            umi2 = "".join(_COMP.get(b, "N") for b in reversed(raw))
        else:
            umi2 = "N" * args.right_umi_length
    if umi1 is not None and umi2 is not None:
        rx = f"{umi1}-{umi2}"
    else:
        rx = umi1 if umi1 is not None else umi2
    return coord1, coord2, rx


# -- the batched matcher -------------------------------------------------------------------------------------------


def _first_within_budget(reads: np.ndarray, adapter: bytes, offsets: np.ndarray, overlap: np.ndarray,
                         error_rate: float, min_overlap: int) -> np.ndarray:
    """For each read (a row of ``reads``), the position in ``offsets`` of the
    first offset whose overlap has at most ``int(error_rate * overlap)``
    mismatches, -1 where none has. ``offsets[i]`` is where the adapter's
    first base falls on the read (negative: before its start); bases
    outside the read match nothing."""
    n, lr = reads.shape
    la = len(adapter)
    a = np.frombuffer(adapter, dtype=np.uint8)
    pad = max(la, int(-offsets.min(initial=0)))
    width = lr + 2 * pad + la
    padded = np.zeros((n, width), dtype=np.uint8)  # 0 matches no adapter byte (the caller checks)
    padded[:, pad:pad + lr] = reads
    eq = {int(c): (padded == c).view(np.uint8) for c in np.unique(a)}
    t = offsets + pad  # the column of each offset's first adapter base
    acc = np.zeros((n, len(offsets)), dtype=np.uint8 if la < 256 else np.uint16)
    span = np.arange(len(offsets))
    contiguous = len(offsets) == 0 or bool((np.diff(t) == 1).all())
    for k in range(la):
        hit = eq[int(a[k])]
        acc += hit[:, t[0] + k: t[0] + k + len(offsets)] if contiguous else hit[:, t[span] + k]
    budget = (error_rate * overlap.astype(np.float64)).astype(np.int64)
    ok = (overlap >= min_overlap) & ((overlap - acc.astype(np.int64)) <= budget)
    first = ok.argmax(axis=1)
    return np.where(ok[np.arange(n), first], first, -1)


def _plain_needed(adapter: bytes, min_overlap: int) -> bool:
    """An adapter the batched matcher leaves to the plain spec: empty, with a NUL, or ``min_overlap < 1``."""
    return not adapter or b"\x00" in adapter or min_overlap < 1


def match_left(reads: np.ndarray, adapter: str, error_rate: float, min_overlap: int) -> np.ndarray:
    """:func:`find_left_plain` of every row of ``reads`` ((reads, length) uint8 letters), int64."""
    a = adapter.encode()
    n, lr = reads.shape
    if _plain_needed(a, min_overlap) or lr == 0:
        return np.array([find_left_plain(r, np.frombuffer(a, np.uint8), error_rate, min_overlap) for r in reads],
                        dtype=np.int64)
    la = len(a)
    offsets = np.arange(-(la - min_overlap), lr - min_overlap + 1, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    if not len(offsets):
        return out
    a_lo = np.maximum(0, -offsets)
    overlap = np.minimum(la - a_lo, lr - np.maximum(offsets, 0))
    for lo in range(0, n, BLOCK_READS):
        first = _first_within_budget(reads[lo:lo + BLOCK_READS], a, offsets, overlap, error_rate, min_overlap)
        f = np.maximum(first, 0)
        out[lo:lo + BLOCK_READS] = np.where(first >= 0, np.maximum(offsets[f], 0) + overlap[f], 0)
    return out


def match_right(reads: np.ndarray, adapter: str, error_rate: float, min_overlap: int) -> np.ndarray:
    """:func:`find_right_plain` of every row of ``reads``, int64."""
    a = adapter.encode()
    n, lr = reads.shape
    if _plain_needed(a, min_overlap) or lr == 0:
        return np.array([find_right_plain(r, np.frombuffer(a, np.uint8), error_rate, min_overlap) for r in reads],
                        dtype=np.int64)
    offsets = np.arange(0, lr - min_overlap + 1, dtype=np.int64)
    out = np.full(n, -1, dtype=np.int64)
    if not len(offsets):
        return out
    overlap = np.minimum(len(a), lr - offsets)
    for lo in range(0, n, BLOCK_READS):
        first = _first_within_budget(reads[lo:lo + BLOCK_READS], a, offsets, overlap, error_rate, min_overlap)
        out[lo:lo + BLOCK_READS] = np.where(first >= 0, offsets[np.maximum(first, 0)], -1)
    return out


def _umi_bytes(reads: np.ndarray, start: np.ndarray, length: int) -> tuple[np.ndarray, np.ndarray]:
    """(reads, length) letters of ``reads[i, start[i]:start[i] + length]`` (Python's clamped slice) and their counts."""
    lr = reads.shape[1]
    cols = start[:, None] + np.arange(length)
    inside = cols < lr
    got = np.zeros((len(start), length), dtype=np.uint8)
    if lr:
        got = np.where(inside, reads[np.arange(len(start))[:, None], np.minimum(cols, lr - 1)], 0).astype(np.uint8)
    return got, inside.sum(axis=1)


def analyze_reads(reads: np.ndarray, args) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """:func:`analyze_read` of every row of ``reads`` (one length): (XF, XT,
    the RX letters padded with 0 (reads, RX width), each RX's length; -1: no
    RX tag)."""
    n, lr = reads.shape
    lu, ru = args.left_umi_length, args.right_umi_length
    end5 = match_left(reads, args.left_adapter, args.error_rate_5p, args.min_overlap_5p) if args.left_adapter \
        else np.zeros(n, dtype=np.int64)
    start3 = match_right(reads, args.right_adapter, args.error_rate_3p, args.min_overlap_3p) \
        if args.right_adapter else np.full(n, -1, dtype=np.int64)
    coord1 = end5 + 1
    coord2 = np.where(start3 >= 0, start3 + 1, lr + 1)
    masked = coord2 <= coord1
    coord1[masked] = 0
    coord2[masked] = 0
    parts = []
    if lu > 0:
        found = coord1 > 1
        umi, count = _umi_bytes(reads, np.maximum(coord1 - 1, 0), lu)
        umi[~found] = ord("N")
        count[~found] = lu
        coord1 = np.where(found, coord1 + lu, coord1)
        parts.append((umi, count))
    if ru > 0:
        found = (start3 >= 0) & (coord2 > 0)
        coord2 = np.where(found, coord2 - ru, coord2)
        raw, count = _umi_bytes(reads, np.maximum(coord2 - 1, 0), ru)
        rev = np.zeros_like(raw)
        # revcomp of the first count letters: letter j of the result is the complement of letter count-1-j
        src = count[:, None] - 1 - np.arange(ru)
        valid = src >= 0
        rev[valid] = _COMP_BYTES[raw[np.nonzero(valid)[0], src[valid]]]
        rev[~found] = ord("N")
        count = np.where(found, count, ru)
        parts.append((rev, count))
    if not parts:
        return coord1, coord2, np.zeros((n, 0), dtype=np.uint8), np.full(n, -1, dtype=np.int64)
    if len(parts) == 2:  # "left-right": the letters of both and the dash, packed to the left
        (u1, c1), (u2, c2) = parts
        cand = np.concatenate([u1, np.full((n, 1), ord("-"), np.uint8), u2], axis=1)
        valid = np.concatenate([np.arange(lu)[None, :] < c1[:, None], np.ones((n, 1), bool),
                                np.arange(ru)[None, :] < c2[:, None]], axis=1)
        packed = np.take_along_axis(cand, np.argsort(~valid, axis=1, kind="stable"), axis=1)
        count = c1 + 1 + c2
    else:
        packed, count = parts[0]
    rx = np.where(np.arange(packed.shape[1])[None, :] < count[:, None], packed, 0).astype(np.uint8)
    return coord1, coord2, rx, count


def tag_bytes(xf: np.ndarray, xt: np.ndarray, rx: np.ndarray, rx_len: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(every record's appended fields, concatenated; each record's byte
    count): ``XF:i``, ``XT:i`` and, where ``rx_len >= 0``, ``RX:Z``."""
    n = len(xf)
    width = 14 + 3 + rx.shape[1] + 1
    mat = np.zeros((n, width), dtype=np.uint8)
    mat[:, 0:3] = np.frombuffer(b"XFi", np.uint8)
    mat[:, 3:7] = xf.astype("<i4").view(np.uint8).reshape(n, 4)
    mat[:, 7:10] = np.frombuffer(b"XTi", np.uint8)
    mat[:, 10:14] = xt.astype("<i4").view(np.uint8).reshape(n, 4)
    has = rx_len >= 0
    mat[:, 14:17] = np.frombuffer(b"RXZ", np.uint8)
    mat[:, 17:17 + rx.shape[1]] = rx  # 0 after each RX: its NUL
    lens = np.where(has, 14 + 3 + np.maximum(rx_len, 0) + 1, 14)
    keep = np.arange(width)[None, :] < lens[:, None]
    return mat[keep], lens


def run(argv) -> int:
    """Tag every read with adapter coordinates (+UMIs)."""
    args = parse_args(argv)
    buf = bam.read_stream(args.input_bam)
    try:
        first = bam.header_end(buf)
    except ValueError:
        raise SystemExit(f"{args.input_bam}: not a BAM") from None
    starts, sizes = bam.record_offsets(buf, first)
    lay = bam.record_layout(buf, starts, sizes)
    n = len(starts)
    xf = np.zeros(n, dtype=np.int64)
    xt = np.zeros(n, dtype=np.int64)
    rx_width = (args.left_umi_length > 0) * args.left_umi_length + (args.right_umi_length > 0) * \
        args.right_umi_length + (args.left_umi_length > 0 and args.right_umi_length > 0)
    rx = np.zeros((n, rx_width), dtype=np.uint8)
    rx_len = np.full(n, -1, dtype=np.int64)
    for length in np.unique(lay["l_seq"]).tolist():
        rows = np.flatnonzero(lay["l_seq"] == length)
        for lo in range(0, len(rows), 8 * BLOCK_READS):
            part = rows[lo:lo + 8 * BLOCK_READS]
            reads = bam.sequence_letters(buf, lay["seq"][part], max(length, 0))
            xf[part], xt[part], got, rx_len[part] = analyze_reads(reads, args)
            rx[part, :got.shape[1]] = got
    extra, lens = tag_bytes(xf, xt, rx, rx_len)
    with BgzfWriter(args.output_bam) as out:
        out.write(bam.append_to_records(buf, first, starts, sizes, extra, lens))
    log.info("tagged %d reads -> %s", n, args.output_bam)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
