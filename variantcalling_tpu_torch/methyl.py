"""Methylation postprocessing core (MethylDackel output -> metrics), without pandas.

Counterpart of ``variantcalling_tpu/methyl.py``. MethylDackel's public
output formats:

- ``extract`` bedGraph rows: chrom, start, end, meth_pct, n_meth, n_unmeth
- ``mbias --txt`` rows: strand (OT/OB/CTOT/CTOB), read (1/2), position,
  n_meth, n_unmeth
- ``perRead`` rows: read, chrom, pos, meth_fraction, n_sites

Frames are :class:`~variantcalling_tpu_torch.utils.h5_utils.Frame`\\ s whose
columns, dtypes and row order are the reference's pandas frames', its
``read_csv``, ``groupby``, ``sort_values`` and ``np.round`` replayed by
:mod:`utils.frame_ops`. Note :func:`read_extract_bedgraph`'s quirk, kept:
the reference reads with ``comment="t"``, so every line is cut at its first
``t``; that drops the ``track`` line, and also every row of a contig whose
name holds a ``t`` (a GRCh38 ``..._alt`` contig), whose columns then come
back float64.

The device reductions (:func:`methylation_histogram`,
:func:`coverage_methylation_stats`) run on the caller's device in float32
as the reference's XLA programs: the fraction ``nm / max(nm + nu, 1)``, the
bin ``int32(frac * (n_bins - 1) + 0.5)``, int32 counts. The per-coverage
float32 sums depend on the order of addition (``np.round(mean, 5)`` can
show the last bit), so they are added on the host in row order, as XLA's
CPU scatter-add adds them, and equal the reference's on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch.utils.frame_ops import concat_rows, group_sum, lexsort_rows, read_tsv, run_codes, \
    take_rows, to_numeric
from variantcalling_tpu_torch.utils.h5_utils import Frame, object_column

BEDGRAPH_COLS = ["chrom", "start", "end", "meth_pct", "n_meth", "n_unmeth"]
MBIAS_COLS = ["strand", "read", "position", "n_meth", "n_unmeth"]


def read_extract_bedgraph(path: str) -> Frame:
    """MethylDackel extract output (with or without the track header line)."""
    df = Frame(read_tsv(path, BEDGRAPH_COLS, comment=b"t"))
    df = take_rows(df, ~np.isnan(to_numeric(df["start"], coerce=True).astype(np.float64)))
    for c in BEDGRAPH_COLS[1:]:
        df[c] = to_numeric(df[c])
    return df


def read_mbias_txt(path: str) -> Frame:
    raw = read_tsv(path)
    rename = {"nmethylated": "n_meth", "nunmethylated": "n_unmeth", "pos": "position"}
    cols = {}
    for name, col in raw.items():
        name = name.strip().lower().replace("#", "").replace(" ", "_")
        cols[rename.get(name, name)] = col
    for col in ("strand", "read", "position", "n_meth", "n_unmeth"):
        if col not in cols:
            raise ValueError(f"{path}: mbias table missing column {col!r}")
    return Frame(cols)


def _fractions(n_meth, n_unmeth, device: torch.device):
    """float32 ``nm``, ``nm + nu`` and ``where(cov > 0, nm / max(cov, 1), 0)`` on ``device``."""
    nm = torch.as_tensor(np.asarray(n_meth, dtype=np.float32), device=device)
    nu = torch.as_tensor(np.asarray(n_unmeth, dtype=np.float32), device=device)
    cov = nm + nu
    frac = torch.where(cov > 0, nm / torch.clamp(cov, min=1.0), torch.zeros_like(cov))
    return nm, cov, frac


def methylation_histogram(n_meth: np.ndarray, n_unmeth: np.ndarray, n_bins: int = 101,
                          device: torch.device | str = "cpu") -> np.ndarray:
    """Histogram (int32) of per-site methylation fraction (0..1 in n_bins bins)."""
    dev = device_mod.as_device(device)
    _, cov, frac = _fractions(n_meth, n_unmeth, dev)
    bins = torch.clamp((frac * float(n_bins - 1) + 0.5).to(torch.int32), 0, n_bins - 1)
    hist = torch.bincount(bins[cov > 0].to(torch.int64), minlength=n_bins)
    return hist.to(torch.int32).cpu().numpy()


def ordered_bin_sums(values: np.ndarray, bins: np.ndarray, n_bins: int) -> np.ndarray:
    """float32 sum of ``values`` a bin, each bin's values added one after the
    other in row order (a stable sort by bin, then a float32 cumulative sum a bin)."""
    order = np.argsort(bins, kind="stable")
    sv, sb = np.asarray(values, dtype=np.float32)[order], bins[order]
    bounds = np.searchsorted(sb, np.arange(n_bins + 1))
    out = np.zeros(n_bins, dtype=np.float32)
    for b in range(n_bins):
        lo, hi = bounds[b], bounds[b + 1]
        if hi > lo:
            out[b] = np.cumsum(sv[lo:hi], dtype=np.float32)[-1]
    return out


def coverage_methylation_stats(n_meth: np.ndarray, n_unmeth: np.ndarray, max_cov: int = 100,
                               device: torch.device | str = "cpu") -> Frame:
    """Per-coverage-level mean methylation + site counts (joint reduction).

    The reference divides with ``np.divide(..., where=counts > 0)`` and no
    ``out``, which leaves the levels without sites uninitialised; they are
    0.0 here."""
    dev = device_mod.as_device(device)
    _, cov, frac = _fractions(n_meth, n_unmeth, dev)
    level = torch.clamp(cov.to(torch.int32), 0, max_cov)
    counts = torch.bincount(level.to(torch.int64), minlength=max_cov + 1).to(torch.int32).cpu().numpy()
    sums = ordered_bin_sums(frac.cpu().numpy(), level.cpu().numpy(), max_cov + 1)
    mean = np.divide(sums, np.maximum(counts, 1), out=np.zeros(max_cov + 1), where=counts > 0)
    return Frame({"coverage": np.arange(max_cov + 1), "n_sites": counts, "mean_methylation": np.round(mean, 5)})


def global_methylation_summary(df: Frame) -> Frame:
    nm = float(np.nansum(df["n_meth"]))  # Series.sum: NaN skipped
    nu = float(np.nansum(df["n_unmeth"]))
    cov = np.asarray(df["n_meth"]) + np.asarray(df["n_unmeth"])
    row = {"n_sites": len(df), "n_covered_sites": int((cov > 0).sum()), "total_calls": nm + nu,
           "global_methylation": round(nm / max(nm + nu, 1.0), 5),
           "mean_coverage": round(float(cov.mean()) if len(cov) else 0.0, 3)}
    return Frame({k: np.array([v]) for k, v in row.items()})


def mbias_curves(df: Frame) -> Frame:
    """Per (strand, read, position) methylation fraction: the M-bias curve."""
    keys = ("strand", "read", "position")
    order = lexsort_rows(*(df[k] for k in keys))
    codes, n = run_codes(*(np.asarray(df[k])[order] for k in keys))
    _, first = np.unique(codes, return_index=True)
    out = {k: np.asarray(df[k])[order][first] for k in keys}
    for c in ("n_meth", "n_unmeth"):
        out[c] = group_sum(np.asarray(df[c])[order], codes, n)
    tot = out["n_meth"] + out["n_unmeth"]
    with np.errstate(invalid="ignore", divide="ignore"):
        out["methylation"] = np.round(np.where(tot > 0, out["n_meth"] / np.maximum(tot, 1), np.nan), 5)
    return Frame(out)


def mbias_inclusion_bounds(curves: Frame, tolerance: float = 0.05) -> Frame:
    """Suggested 5'/3' trim bounds per (strand, read): positions whose
    methylation deviates > tolerance from the plateau median are excluded
    (the standard MethylDackel --OT/--OB trimming recommendation)."""
    order = lexsort_rows(curves["strand"], curves["read"])
    codes, n = run_codes(*(np.asarray(curves[k])[order] for k in ("strand", "read")))
    rows = []
    for g in range(n):
        idx = order[codes == g]
        grp_pos = np.asarray(curves["position"])[idx]
        sel = idx[np.argsort(grp_pos, kind="quicksort")]
        m = np.asarray(curves["methylation"], dtype=np.float64)[sel]
        pos = np.asarray(curves["position"])[sel]
        if len(m) == 0 or np.all(np.isnan(m)):
            continue
        med = np.nanmedian(m)
        ok = np.abs(m - med) <= tolerance
        first = pos[np.argmax(ok)] if ok.any() else pos[0]
        last = pos[len(ok) - 1 - np.argmax(ok[::-1])] if ok.any() else pos[-1]
        rows.append({"strand": curves["strand"][sel[0]], "read": curves["read"][sel[0]],
                     "inclusion_start": int(first), "inclusion_end": int(last)})
    if not rows:
        return Frame({})
    return Frame({"strand": object_column([r["strand"] for r in rows]),
                  **{k: np.array([r[k] for r in rows]) for k in ("read", "inclusion_start", "inclusion_end")}})


def merge_cpg_strands(df: Frame) -> Frame:
    """Combine +/- strand CpG records into per-CpG-dinucleotide rows.

    MethylDackel emits one row per cytosine; the C on the reverse strand of
    a CpG sits at start+1. Rows whose start differs by 1 on the same chrom
    are merged by summing counts (the ``--mergeContext`` semantics)."""
    df = take_rows(df, lexsort_rows(df["chrom"], df["start"]))
    chrom = np.asarray(df["chrom"])
    start = np.asarray(df["start"])
    prev_same = np.zeros(len(df), dtype=bool)
    if len(df) > 1:
        prev_same[1:] = (chrom[1:] == chrom[:-1]) & (start[1:] == start[:-1] + 1)
    gid = np.cumsum(~prev_same) - 1
    n = int(gid[-1]) + 1 if len(gid) else 0
    first = np.flatnonzero(~prev_same)
    end = np.asarray(df["end"])
    end_max = np.full(n, -np.inf) if end.dtype.kind == "f" else np.full(n, np.iinfo(np.int64).min)
    np.maximum.at(end_max, gid, end)
    out = {"chrom": chrom[first], "start": start[first], "end": end_max.astype(end.dtype),
           "n_meth": group_sum(df["n_meth"], gid, n), "n_unmeth": group_sum(df["n_unmeth"], gid, n)}
    tot = out["n_meth"] + out["n_unmeth"]
    meth_pct = np.round(100.0 * out["n_meth"] / np.maximum(tot, 1), 2)
    return Frame({"chrom": out["chrom"], "start": out["start"], "end": out["end"], "meth_pct": meth_pct,
                  "n_meth": out["n_meth"], "n_unmeth": out["n_unmeth"]})


def concat_extracts(frames: list[Frame]) -> Frame:
    """``pd.concat(frames).groupby(["chrom", "start", "end"], as_index=False)[["n_meth",
    "n_unmeth"]].sum().sort_values(["chrom", "start"])`` with ``meth_pct`` from the sums,
    in the bedGraph column order."""
    df = concat_rows(frames)
    keys = ("chrom", "start", "end")
    order = lexsort_rows(*(df[k] for k in keys))
    codes, n = run_codes(*(np.asarray(df[k])[order] for k in keys))
    _, first = np.unique(codes, return_index=True)
    out = {k: np.asarray(df[k])[order][first] for k in keys}
    for c in ("n_meth", "n_unmeth"):
        out[c] = group_sum(np.asarray(df[c])[order], codes, n)
    tot = np.maximum(out["n_meth"] + out["n_unmeth"], 1)
    meth_pct = np.round(100.0 * out["n_meth"] / tot, 2)
    return Frame({"chrom": out["chrom"], "start": out["start"], "end": out["end"], "meth_pct": meth_pct,
                  "n_meth": out["n_meth"], "n_unmeth": out["n_unmeth"]})

