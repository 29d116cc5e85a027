"""Featuremap VCF -> columnar per-read frame, without pandas.

Counterpart of ``variantcalling_tpu/io/featuremap.py``. A featuremap is a
VCF with one record per supporting read of each candidate SNV, its per-read
evidence in INFO (``X_SCORE``, ``X_EDIST``, ``X_LENGTH``, ``X_MAPQ``,
``X_INDEX``, ``X_READ_COUNT``, ``X_FILTERED_COUNT``, ``rq``, ...). The
reference returns a pandas frame; the port returns a
:class:`~variantcalling_tpu_torch.utils.h5_utils.Frame` with the same
columns in the same order, the same dtypes and the same NaN positions:
``chrom``, ``pos``, ``ref``, ``alt`` (the first allele), ``qual`` (NaN as
0), ``filter`` (``.`` and empty as ``PASS``), one lower-cased column an
INFO key (``Integer`` and ``Float`` as float64 with NaN where absent,
``Flag`` as bool, anything else the value's text, ``""`` where absent),
and with a reference the ``left_motif``, ``right_motif`` and ``ref_motif``
columns. A million records is an ordinary featuremap, so the numeric keys
come from the native scan (:func:`read_vcf` with ``numeric_info``) and the
motifs are built by array operations, the same text the reference's
per-record joins give.
"""

from __future__ import annotations

import numpy as np

from variantcalling_tpu_torch.io.vcf import MISSING, VariantTable, read_vcf
from variantcalling_tpu_torch.utils.h5_utils import Frame, object_column

_BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)


def _text_column(table: VariantTable, name: str, rename=None) -> np.ndarray:
    """A short string column as an object column, each distinct value made
    once (:meth:`VariantTable.factorize`, from the scan's bytes), ``rename``
    applied to each distinct value."""
    codes, uniques = table.factorize(name)
    return object_column([rename(u) if rename else u for u in uniques])[codes] if len(codes) else \
        np.zeros(0, dtype=object)


def _string_keys(info: np.ndarray, keys: list[str]) -> dict[str, np.ndarray]:
    """Each key's value text a record (the first ``key=`` part), ``""`` where absent."""
    out = {k: np.full(len(info), "", dtype=object) for k in keys}
    if not keys:
        return out
    prefixes = {k + "=": out[k] for k in keys}
    for i, s in enumerate(info.tolist()):
        if s in (None, MISSING, ""):
            continue
        seen = set()
        for part in s.split(";"):
            key, eq, value = part.partition("=")
            if eq and key + "=" in prefixes and key not in seen:
                prefixes[key + "="][i] = value
                seen.add(key)
    return out


def _letters(codes: np.ndarray) -> np.ndarray:
    """(N, W) base codes -> (N,) str of W letters (``ACGTN``)."""
    n, w = codes.shape
    if w == 0:
        return np.full(n, "", dtype=object)
    return np.ascontiguousarray(_BASES[codes]).view(f"S{w}").ravel().astype(f"U{w}").astype(object)


def motif_columns(windows: np.ndarray, ref: np.ndarray, radius: int) -> dict[str, np.ndarray]:
    """``left_motif`` and ``right_motif`` (the ``radius`` reference bases on
    each side) and ``ref_motif`` (the last left base, REF, the first right
    base) of each record's window."""
    left = _letters(windows[:, :radius])
    right = _letters(windows[:, radius + 1:])
    ref_motif = (_letters(windows[:, radius - 1: radius]).astype(str) + np.asarray(ref, dtype=str)
                 + _letters(windows[:, radius + 1: radius + 2]).astype(str))
    return {"left_motif": left, "right_motif": right, "ref_motif": ref_motif.astype(object)}


def featuremap_to_dataframe(
    featuremap_vcf: str,
    ref_fasta: str | None = None,
    flow_order: str = "TGCA",
    info_fields: list[str] | None = None,
    motif_length: int = 3,
) -> Frame:
    """Columnar frame from a featuremap VCF; one row per record (= per read)."""
    table = read_vcf(featuremap_vcf, numeric_info=True)
    return frame_from_table(table, ref_fasta, info_fields, motif_length)


def frame_from_table(table: VariantTable, ref_fasta: str | None = None, info_fields: list[str] | None = None,
                     motif_length: int = 3) -> Frame:
    """:func:`featuremap_to_dataframe` of a table already read (with
    ``numeric_info``, so that the numeric keys come from the scan)."""
    cols: dict[str, np.ndarray] = {
        "chrom": np.asarray(table.chrom),
        "pos": table.pos,
        "ref": _text_column(table, "ref"),
        "alt": _text_column(table, "alt", lambda a: a.split(",", 1)[0]),
        "qual": np.nan_to_num(table.qual, nan=0.0),
        "filter": _text_column(table, "filters", lambda f: "PASS" if f in (MISSING, "") else f),
    }
    keys = info_fields if info_fields is not None else list(table.header.infos)
    types = {k: table.header.infos.get(k, {}).get("Type", "String") for k in keys}
    text_keys = [k for k in keys if types[k] not in ("Integer", "Float", "Flag")]
    strings = _string_keys(table.info, text_keys) if text_keys else {}
    for key in keys:
        if types[key] in ("Integer", "Float"):
            cols[key.lower()] = table.info_field(key, dtype=np.float64, missing=np.nan)
        elif types[key] == "Flag":
            cols[key.lower()] = table.info_flag(key)
        else:
            cols[key.lower()] = strings[key]

    if ref_fasta is not None:
        from variantcalling_tpu_torch.featurize import gather_windows
        from variantcalling_tpu_torch.io.fasta import FastaReader

        with FastaReader(ref_fasta) as fa:
            windows = gather_windows(table, fa, radius=motif_length)
        cols.update(motif_columns(windows, cols["ref"], motif_length))
    return Frame(cols)


NUMERIC_FEATURE_CANDIDATES = [
    "x_score",
    "x_edist",
    "x_length",
    "x_mapq",
    "x_index",
    "x_fc1",
    "x_fc2",
    "rq",
    "max_softclip_length",
]


def numeric_feature_columns(df: Frame) -> list[str]:
    """The numeric per-read evidence columns present in a featuremap frame."""
    return [c for c in NUMERIC_FEATURE_CANDIDATES
            if c in df.columns and np.issubdtype(np.asarray(df[c]).dtype, np.number)]


def feature_matrix(df: Frame, names: list[str]) -> np.ndarray:
    """``df[names].to_numpy(np.float32)``: (rows, len(names)) float32."""
    out = np.empty((len(df), len(names)), dtype=np.float32)
    for j, name in enumerate(names):
        out[:, j] = df[name]
    return out
