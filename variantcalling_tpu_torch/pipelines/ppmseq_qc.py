"""ppmseq_qc — ppmSeq strand-tag QC categorization.

Counterpart of ``variantcalling_tpu/pipelines/ppmseq_qc.py`` without pandas,
with the same arguments (a host tool: no ``--backend``). ppmSeq reads carry
loop-adapter strand tags at both ends (default ``as``/``ae``: MIXED, MINUS,
PLUS, UNDETERMINED, END_UNREACHED). The BAM is inflated whole and every
record's two tags are found at once (``io/bam.find_aux_tags``, the fields
walked as ``BamReader(decode_tags=True)`` walks them, the last of a tag
kept); each value is categorized as the reference's ``_norm`` does (a
missing tag MISSING, a text upper-cased and kept where it is a category,
else UNDETERMINED, an empty text MISSING; a non-text value UNDETERMINED).
The start x end crosstab and the summary rates (``round(x, 5)``) go to the
h5 keys ``strand_tag_crosstab`` and ``summary`` in the reference's kinds.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from variantcalling_tpu_torch.io import bam
from variantcalling_tpu_torch.utils.h5_utils import Frame, write_hdf

log = logging.getLogger(__name__)

CATEGORIES = ["MIXED", "MINUS", "PLUS", "UNDETERMINED", "END_UNREACHED", "MISSING"]
_MISSING, _UNDETERMINED = CATEGORIES.index("MISSING"), CATEGORIES.index("UNDETERMINED")
_WIDTH = max(map(len, CATEGORIES))


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="ppmseq_qc", description=run.__doc__)
    ap.add_argument("--input_bam", required=True)
    ap.add_argument("--output_h5", required=True)
    ap.add_argument("--start_tag", default="as")
    ap.add_argument("--end_tag", default="ae")
    ap.add_argument("--max_reads", type=int, default=0, help="0 = all")
    ap.add_argument("--verbosity", default="INFO")
    return ap.parse_args(argv)


def _norm(v) -> int:
    """The reference's ``_norm`` of one decoded tag value, as a category number."""
    if v is None:
        return _MISSING
    s = str(v).upper()
    return CATEGORIES.index(s) if s in CATEGORIES else (_UNDETERMINED if s else _MISSING)


def _categories(buf: np.ndarray, typ: np.ndarray, at: np.ndarray, size: np.ndarray) -> np.ndarray:
    """Each record's category number of one tag (:func:`_norm` of its value)."""
    cat = np.full(len(typ), _UNDETERMINED, dtype=np.int64)
    cat[typ == 0] = _MISSING
    text = np.flatnonzero(np.isin(typ, np.frombuffer(b"ZH", np.uint8)))
    length = size[text] - 1  # without the NUL
    cols = np.arange(_WIDTH)
    raw = buf[np.minimum(at[text][:, None] + cols, len(buf) - 1)]
    inside = cols < length[:, None]
    plain = ~((raw >= 128) & inside).any(axis=1) & (length <= _WIDTH)
    upper = np.where((raw >= ord("a")) & (raw <= ord("z")), raw - 32, raw)
    upper[~inside] = 0
    got = np.where(length == 0, _MISSING, _UNDETERMINED)
    for k, name in enumerate(CATEGORIES):
        want = np.zeros(_WIDTH, np.uint8)
        want[:len(name)] = np.frombuffer(name.encode(), np.uint8)
        got[(length == len(name)) & (upper == want).all(axis=1)] = k
    cat[text] = got
    for i in text[~plain]:  # a non-ASCII or long text: decoded and upper-cased as the reference does
        cat[i] = _norm(bytes(buf[at[i]:at[i] + size[i] - 1]).decode(errors="replace"))
    return cat


def categorize(bam_path: str, start_tag: str, end_tag: str, max_reads: int = 0) -> np.ndarray:
    """The 6 x 6 start x end category counts (int64, :data:`CATEGORIES` order)."""
    buf = bam.read_stream(bam_path)
    starts, sizes = bam.record_offsets(buf, bam.header_end(buf))
    if max_reads:
        starts, sizes = starts[:max_reads], sizes[:max_reads]
    lay = bam.record_layout(buf, starts, sizes)
    tags = bam.find_aux_tags(buf, lay["aux"], lay["end"], (start_tag, end_tag))
    s = _categories(buf, *tags[start_tag])
    e = _categories(buf, *tags[end_tag])
    n = len(CATEGORIES)
    return np.bincount(s * n + e, minlength=n * n).reshape(n, n).astype(np.int64)


def qc_tables(cross: np.ndarray) -> tuple[Frame, Frame]:
    """(the crosstab with its ``start_tag`` column, the one-row summary)."""
    total = int(cross.sum())
    u = _UNDETERMINED
    mixed_mixed = int(cross[0, 0])
    undet = int(cross[u].sum() + cross[:, u].sum() - cross[u, u])
    labels = np.empty(len(CATEGORIES), dtype=object)
    labels[:] = CATEGORIES
    table = Frame({"start_tag": labels, **{c: cross[:, j].copy() for j, c in enumerate(CATEGORIES)}})
    summary = Frame({
        "total_reads": np.array([total], dtype=np.int64),
        "mixed_mixed": np.array([mixed_mixed], dtype=np.int64),
        "pct_mixed_mixed": np.array([round(mixed_mixed / total, 5) if total else 0.0]),
        "pct_undetermined": np.array([round(undet / total, 5) if total else 0.0]),
    })
    return table, summary


def run(argv) -> int:
    """Cross-tabulate ppmSeq strand tags and write QC rates."""
    args = parse_args(argv)
    cross = categorize(args.input_bam, args.start_tag, args.end_tag, args.max_reads)
    table, summary = qc_tables(cross)
    write_hdf(table, args.output_h5, key="strand_tag_crosstab", mode="w")
    write_hdf(summary, args.output_h5, key="summary", mode="a")
    log.info("%d reads, %.1f%% mixed-mixed -> %s", int(summary["total_reads"][0]),
             100 * summary["pct_mixed_mixed"][0], args.output_h5)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
