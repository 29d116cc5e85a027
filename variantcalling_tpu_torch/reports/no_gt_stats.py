"""No-ground-truth callset statistics: indel hmer tables, AF histograms, SNP motifs.

Counterpart of ``variantcalling_tpu/reports/no_gt_stats.py``. The counts
run on the run's device: the hmer features of the reference windows
(``ops/features.hmer_indel_features``), the (class x length) and 96-motif
counts as ``torch.bincount`` with ``minlength``, and the AF histogram as
the reference's ``jnp.histogram`` computes it over float32 edges
(:func:`allele_freq_hist`). The reference's pandas frames are
:class:`~variantcalling_tpu_torch.utils.h5_utils.Frame` here, with the same
columns and dtypes.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from variantcalling_tpu_torch.featurize import AlleleColumns, classify_alleles, gather_windows
from variantcalling_tpu_torch.io.fasta import FastaReader
from variantcalling_tpu_torch.io.vcf import VariantTable
from variantcalling_tpu_torch.ops.features import hmer_indel_features
from variantcalling_tpu_torch.utils.h5_utils import Frame, object_column

_BASES = "ACGT"
_COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N", "a": "t", "c": "g", "g": "c", "t": "a"}
#: row labels of the hmer tables: (ins/del) x (A/T, G/C)
HMER_CLASSES = ["ins A", "ins G", "del A", "del G"]
HMER_MAX = 12


def revcomp(seq: str) -> str:
    """Reverse complement (the reference's ``io/fasta.revcomp``)."""
    return "".join(_COMP.get(c, "N") for c in reversed(seq))


def _annotate(table: VariantTable, ref_fasta: str, device: torch.device | str = "cpu"):
    """(allele columns, (N, 25) reference windows, hmer length, hmer nucleotide):
    the windows gathered on the host, the hmer features on ``device``."""
    cols = classify_alleles(table)
    with FastaReader(ref_fasta) as fa:
        windows = gather_windows(table, fa, radius=12)
    hmer_len, hmer_nuc = (x.cpu().numpy() for x in hmer_indel_features(
        torch.from_numpy(windows).to(device), 12, torch.from_numpy(cols.is_indel).to(device),
        torch.from_numpy(cols.indel_nuc).to(device)))
    return cols, windows, hmer_len, hmer_nuc


def _bincount(codes: np.ndarray, length: int, device: torch.device) -> np.ndarray:
    return torch.bincount(torch.from_numpy(codes.astype(np.int64)).to(device), minlength=length).cpu().numpy()


def insertion_deletion_statistics(table: VariantTable, cols: AlleleColumns, hmer_len: np.ndarray,
                                  hmer_nuc: np.ndarray, sample: int = 0,
                                  device: torch.device | str = "cpu") -> dict[str, np.ndarray]:
    """{'homo', 'hete'} -> (4, 12) int32 hmer counts, rows :data:`HMER_CLASSES`,
    columns hmer lengths 1..12."""
    device = torch.device(device)
    gts = table.genotypes(sample)
    hom = (gts[:, 0] == 1) & (gts[:, 1] == 1)
    is_at = (hmer_nuc == 0) | (hmer_nuc == 3)
    is_gc = (hmer_nuc == 1) | (hmer_nuc == 2)
    cls = np.where(cols.is_ins & is_at, 0,
                   np.where(cols.is_ins & is_gc, 1, np.where(is_at, 2, np.where(is_gc, 3, -1))))
    valid = cols.is_indel & (hmer_len >= 1) & (hmer_len <= HMER_MAX) & (cls >= 0)

    def tally(zygosity: np.ndarray) -> np.ndarray:
        m = valid & zygosity
        code = cls[m].astype(np.int64) * HMER_MAX + (hmer_len[m].astype(np.int64) - 1)
        return _bincount(code, 4 * HMER_MAX, device).astype(np.int32).reshape(4, HMER_MAX)

    return {"homo": tally(hom), "hete": tally(~hom)}


def hmer_frame(counts: np.ndarray) -> Frame:
    """A (4, 12) hmer table as the reference writes it: ``.T.reset_index(names="hmer_len")``."""
    cols = {"hmer_len": np.arange(1, HMER_MAX + 1, dtype=np.int64)}
    cols.update({name: np.ascontiguousarray(counts[i]) for i, name in enumerate(HMER_CLASSES)})
    return Frame(cols)


def variant_type_labels(cols: AlleleColumns, hmer_len: np.ndarray) -> np.ndarray:
    """snp / h-indel / non-h-indel labels (annotate_concordance convention)."""
    return np.where(cols.is_snp, "snp", np.where(cols.is_indel & (hmer_len > 0), "h-indel", "non-h-indel"))


def unique_in_order(values: np.ndarray) -> list:
    """Distinct values in order of first appearance (``pd.unique``)."""
    return list(dict.fromkeys(values.tolist()))


def f32_histogram(vals: np.ndarray, edges: np.ndarray, device: torch.device) -> np.ndarray:
    """``jnp.histogram(vals, bins=edges)[0]`` as jax computes it without x64:
    values and edges in float32, ``idx = searchsorted(edges, x, side="right")``,
    ``idx = len(edges) - 1`` where ``x == edges[-1]``, counts
    ``zeros(len(edges)).at[idx].add(1)[1:]`` in float32 (a value past the last
    edge is dropped, one below the first lands in the slot that is cut)."""
    e = torch.from_numpy(edges.astype(np.float32)).to(device)
    x = torch.from_numpy(vals.astype(np.float32)).to(device)
    idx = torch.searchsorted(e, x, right=True)
    idx = torch.where(x == e[-1], torch.full_like(idx, len(edges) - 1), idx)
    counts = torch.bincount(idx, minlength=len(edges) + 1)[: len(edges)]  # idx == len(edges): dropped
    return counts[1:].to(torch.float32).cpu().numpy()


def allele_freq_hist(table: VariantTable, vtype: np.ndarray, nbins: int = 100, sample: int = 0,
                     af: np.ndarray | None = None, device: torch.device | str = "cpu") -> Frame:
    """Per-variant-type AF histogram (VAF from FORMAT/VAF|AF, else AD/DP):
    one float32 column a type in order of first appearance, int64 zeros for a
    type with no AF."""
    device = torch.device(device)
    if af is None:
        af = _compute_af(table, sample)
    edges = np.linspace(0, 1, nbins + 1)
    result = {}
    for group in unique_in_order(vtype):
        vals = af[(vtype == group) & ~np.isnan(af)]
        result[group] = f32_histogram(vals, edges, device) if len(vals) else np.zeros(nbins, dtype=np.int64)
    return Frame(result) if result else Frame({}, index=range(0, 0))


def _compute_af(table: VariantTable, sample: int = 0) -> np.ndarray:
    n = len(table)
    for key in ("VAF", "AF"):
        raw = table.format_field(key, sample)
        if any(r not in (None, ".", "") for r in raw):
            out = np.full(n, np.nan)
            for i, r in enumerate(raw):
                if r not in (None, ".", ""):
                    try:
                        out[i] = float(r.split(",")[0])
                    except ValueError:
                        pass
            return out
    ad = table.format_numeric("AD", sample=sample, missing=np.nan)
    dp = table.format_numeric("DP", sample=sample, max_len=1, missing=np.nan)
    if ad.shape[1] >= 2:
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(dp[:, 0] > 0, ad[:, 1] / dp[:, 0], np.nan)
    return np.full(n, np.nan)


def motif_index_96() -> list[tuple[str, str]]:
    """The 96 canonical (trinucleotide with center A/C, alt != center) classes."""
    return [
        x
        for x in itertools.product(["".join(m) for m in itertools.product(_BASES, repeat=3)], list(_BASES))
        if x[0][1] != x[1] and x[0][1] in ("A", "C")
    ]


def _fold_table() -> np.ndarray:
    """(64, 4) -> canonical class id 0..95 (or -1): center G/T motifs fold by
    reverse complement of (motif, alt)."""
    canon = {t: i for i, t in enumerate(motif_index_96())}
    out = np.full((64, 4), -1, dtype=np.int32)
    for m in range(64):
        motif = _BASES[m // 16] + _BASES[(m // 4) % 4] + _BASES[m % 4]
        for a in range(4):
            alt = _BASES[a]
            if motif[1] == alt:
                continue
            key = (motif, alt) if motif[1] in ("A", "C") else (revcomp(motif), revcomp(alt))
            out[m, a] = canon[key]
    return out


def snp_statistics(table: VariantTable, cols: AlleleColumns, windows: np.ndarray, center: int = 12,
                   exclude: np.ndarray | None = None, device: torch.device | str = "cpu") -> np.ndarray:
    """(96,) int64 folded SNP motif counts, in :func:`motif_index_96` order.

    ``exclude`` masks records already consumed elsewhere (adjacent-SNV
    pairs reclassified as DBS78 doublets must not also count as SBS96)."""
    m = cols.is_snp & (cols.ref_code < 4) & (cols.alt_code < 4)
    if exclude is not None:
        m = m & ~exclude
    left = windows[m, center - 1].astype(np.int64)
    mid = cols.ref_code[m].astype(np.int64)
    right = windows[m, center + 1].astype(np.int64)
    ok = (left < 4) & (right < 4)
    motif_code = left[ok] * 16 + mid[ok] * 4 + right[ok]
    alt_code = cols.alt_code[m][ok].astype(np.int64)
    cls = _fold_table()[motif_code, alt_code]
    cls = cls[cls >= 0]
    return _bincount(cls, 96, torch.device(device)).astype(np.int64)


def motif_frame(counts: np.ndarray) -> Frame:
    """SNP motif counts as the reference writes them: ``ref_motif``, ``alt_1``, ``size``."""
    index = motif_index_96()
    return Frame({"ref_motif": object_column([m for m, _ in index]), "alt_1": object_column([a for _, a in index]),
                  "size": counts})
