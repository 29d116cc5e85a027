"""Concordance-frame loader for the variant reports.

Counterpart of ``variantcalling_tpu/reports/report_data_loader.py``, without
pandas: the ``run_comparison`` h5 (key ``all``) read into a
:class:`~variantcalling_tpu_torch.utils.h5_utils.Frame`, with the fp/fn/tp
masks, ``max_vaf``, the ``qual`` fallback and the per-variant
:class:`ErrorType` from the (ground-truth, called) genotype pairs. Genotypes
are ``j/k`` strings; a frame without the genotype or call columns raises
``KeyError``, as the reference's does.
"""

from __future__ import annotations

from enum import Enum

import numpy as np

from variantcalling_tpu_torch.utils.h5_utils import Frame, read_hdf

COMMON_COLUMNS = [
    "indel",
    "hmer_indel_length",
    "tree_score",
    "filter",
    "blacklst",
    "classify",
    "classify_gt",
    "indel_length",
    "hmer_indel_nuc",
    "well_mapped_coverage",
    "base",
    "call",
    "gt_ground_truth",
    "gt_ultima",
    "ad",
    "dp",
    "vaf",
    "ref",
    "alleles",
    "gc_content",
    "indel_classify",
    "qual",
    "gq",
]


class ErrorType(Enum):
    """The reference's error classes (``reports/report_utils.ErrorType``)."""

    NOISE = 1
    NO_VARIANT = 2
    HOM_TO_HET = 3
    HET_TO_HOM = 4
    WRONG_ALLELE = 5
    NO_ERROR = 6


def _gt_set(g) -> frozenset:
    """'0/1' | '1|1' | './.' | tuple -> set of allele ints (None for '.')."""
    if isinstance(g, tuple):
        return frozenset(g)
    if g is None or (isinstance(g, float) and np.isnan(g)):
        return frozenset({None})
    parts = str(g).replace("|", "/").split("/")
    return frozenset(None if p in (".", "") else int(p) for p in parts)


def get_error_type(gtr, call) -> ErrorType:
    """The reference's decision tree over the two genotypes' allele sets."""
    gtr_gt = _gt_set(gtr)
    call_gt = _gt_set(call)
    if gtr_gt == call_gt:
        return ErrorType.NO_ERROR
    if gtr_gt in (frozenset({0}), frozenset({None})):
        return ErrorType.NOISE
    if call_gt in (frozenset({0}), frozenset({None})):
        return ErrorType.NO_VARIANT
    if gtr_gt & call_gt == gtr_gt:
        return ErrorType.HOM_TO_HET
    if gtr_gt & call_gt == call_gt:
        return ErrorType.HET_TO_HOM
    return ErrorType.WRONG_ALLELE


def _is_missing(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and np.isnan(v))


def _ad_alt(v) -> float:
    """The second AD count of an ``a,b`` text, else 0.0."""
    return float(str(v).split(",")[1]) if isinstance(v, str) and "," in v else 0.0


def _max_vaf(v):
    if isinstance(v, float) and np.isnan(v):
        return 0
    return max(v) if isinstance(v, (tuple, list)) else v


class ReportDataLoader:
    def __init__(self, concordance_file: str, reference_version: str = "hg38", exome_column_name: str = "exome.twist"):
        self.concordance_file = concordance_file
        self.reference_version = reference_version
        self.columns = self._columns_subset(exome_column_name)
        self.rename_dict = self._rename_dict()

    def load_concordance_df(self) -> Frame:
        df = read_hdf(self.concordance_file, key="all", skip_keys=["concordance", "input_args"],
                      columns_subset=self.columns)
        df = _renamed(df, self.rename_dict)
        call = np.asarray(df["call"], dtype=object)
        base = np.asarray(df["base"], dtype=object)
        df["fp"] = (call == "FP") | (call == "FP_CA")
        df["fn"] = (base == "FN") | (base == "FN_CA")
        df["tp"] = call == "TP"
        if "vaf" not in df:
            dp = np.asarray(df["dp"], dtype=np.float64)
            ad1 = np.array([_ad_alt(v) for v in df["ad"]], dtype=np.float64)
            with np.errstate(invalid="ignore", divide="ignore"):
                df["vaf"] = ad1 / np.where(dp == 0, np.nan, dp)
        # element by element, as pandas' apply hands numpy scalars over: a
        # float32 NaN is no Python float and stays NaN
        df["max_vaf"] = np.array([_max_vaf(v) for v in np.asarray(df["vaf"])])
        if "qual" not in df or not (~np.array([_is_missing(v) for v in df["qual"]], dtype=bool)).any():
            df["qual"] = df["tree_score"]
        types = np.empty(len(df), dtype=object)
        for i, (g, u) in enumerate(zip(df["gt_ground_truth"], df["gt_ultima"])):
            types[i] = get_error_type(g, u)
        df["error_type"] = types
        return _renamed(df, {"hmer_indel_length": "hmer_length"})

    def _rename_dict(self):
        if self.reference_version == "hg38":
            return {"LCR-hs38": "LCR"}
        if self.reference_version == "hg19":
            return {
                "LCR-hg19_tab_no_chr": "LCR",
                "mappability.hg19.0_tab_no_chr": "mappability.0",
                "ug_hcr_hg19_no_chr": "ug_hcr",
            }
        return {}

    def _columns_subset(self, exome_column_name):
        cols = COMMON_COLUMNS + [exome_column_name]
        if self.reference_version == "hg38":
            return cols + ["LCR-hs38", "mappability.0", "ug_hcr", "callable"]
        if self.reference_version == "hg19":
            return cols + ["LCR-hg19_tab_no_chr", "mappability.hg19.0_tab_no_chr", "ug_hcr_hg19_no_chr", "callable"]
        return cols


def _renamed(df: Frame, names: dict[str, str]) -> Frame:
    """``df`` with the columns of ``names`` renamed, in place in the order."""
    return Frame({names.get(c, c): df[c] for c in df.columns}, df.index)
