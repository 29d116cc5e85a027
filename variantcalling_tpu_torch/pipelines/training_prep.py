"""training_prep_pipeline: a labeled training set for model fitting.

Counterpart of ``variantcalling_tpu/pipelines/training_prep.py``, with
the same arguments and output. Two labeling modes:

- exact ground truth: a concordance frame (an h5 of ``run_comparison``)
  already carries ``classify``/``classify_gt``: tp -> label 1, fp -> 0, fn
  dropped (there is no call to train on);
- approximate ground truth: a dbSNP-annotated callset VCF: a dbSNP member
  (an ID, or the INFO flag DB) -> 1, a blacklisted locus -> 0, every other
  record dropped.

Output: ``<prefix>.labels.h5`` with one key a contig, in order of first
appearance, each a frame of the kept rows (their columns and ``label``,
``label_gt``), its index as pandas would hold it (:mod:`utils.h5_utils`).
The tool reads and writes on the host and needs no device.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from variantcalling_tpu_torch.io import hdf5
from variantcalling_tpu_torch.io.vcf import read_vcf
from variantcalling_tpu_torch.pipelines.filter_variants import BlacklistError, read_blacklist
from variantcalling_tpu_torch.utils.h5_utils import CONCORDANCE_SKIP_KEYS, Frame, read_hdf, write_frames

log = logging.getLogger(__name__)


def _is(values, label: str) -> np.ndarray:
    return np.asarray([v == label for v in values], dtype=bool)


def labels_from_concordance(df: Frame) -> Frame:
    """Exact-GT labels: tp=1, fp=0 (per classify and classify_gt); fn dropped."""
    cls = df["classify"]
    keep = _is(cls, "tp") | _is(cls, "fp")
    out = df.select([c for c in df.columns if c not in ("classify", "classify_gt")]).take(keep)
    out.data["label"] = _is(cls[keep], "tp").astype(np.int8)
    cls_gt = df["classify_gt"] if "classify_gt" in df else cls
    out.data["label_gt"] = _is(cls_gt[keep], "tp").astype(np.int8)
    return out


def labels_from_approximate_gt(
    chrom: np.ndarray,
    pos: np.ndarray,
    in_dbsnp: np.ndarray,
    in_blacklist: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """(keep mask, labels): dbSNP hit -> 1, blacklist hit -> 0, rest dropped.

    A locus in both sets is treated as blacklisted (cohort evidence of a
    systematic artifact beats database membership).
    """
    keep = in_dbsnp | in_blacklist
    labels = np.where(in_blacklist, 0, 1).astype(np.int8)
    return keep, labels


def blacklist_membership(chrom: np.ndarray, pos: np.ndarray, bl_chrom: np.ndarray, bl_pos: np.ndarray) -> np.ndarray:
    """Vectorized (chrom, pos) membership via packed int64 keys."""
    if len(bl_chrom) == 0:
        return np.zeros(len(chrom), dtype=bool)
    cmap = {c: i for i, c in enumerate(dict.fromkeys(np.concatenate([bl_chrom, chrom]).tolist()))}
    cidx_bl = np.fromiter((cmap[c] for c in bl_chrom), dtype=np.int64, count=len(bl_chrom))
    cidx = np.fromiter((cmap[c] for c in chrom), dtype=np.int64, count=len(chrom))
    key_bl = np.sort((cidx_bl << 40) | np.asarray(bl_pos, dtype=np.int64))
    key = (cidx << 40) | np.asarray(pos, dtype=np.int64)
    loc = np.minimum(np.searchsorted(key_bl, key), len(key_bl) - 1)
    return key_bl[loc] == key


def read_blacklist_loci(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Blacklist loci from bed / h5 / pkl, as the filter pipeline reads them."""
    return read_blacklist(path)


def parse_args(argv: list[str]):
    ap = argparse.ArgumentParser(prog="training_prep_pipeline", description=run.__doc__)
    ap.add_argument("--input_file", required=True, help="concordance h5 or dbSNP-annotated VCF")
    ap.add_argument("--blacklist", help="blacklist loci (bed/h5/pkl) for approximate-GT labeling")
    ap.add_argument("--output_prefix", required=True)
    ap.add_argument("--dataset_key", default="all")
    ap.add_argument("--verbosity", default="INFO")
    return ap.parse_args(argv)


def run(argv: list[str]) -> int:
    """Build labeled training data from exact or approximate ground truth."""
    args = parse_args(argv)
    out_path = f"{args.output_prefix}.labels.h5"
    try:
        if args.input_file.endswith((".h5", ".hdf", ".hdf5")):
            df = read_hdf(args.input_file, key=args.dataset_key,
                          skip_keys=CONCORDANCE_SKIP_KEYS)
            labeled = labels_from_concordance(df)
        else:
            table = read_vcf(args.input_file)
            chrom = np.asarray(table.chrom, dtype=object)
            in_dbsnp = (np.asarray(table.vid) != ".") | table.info_flag("DB")
            if args.blacklist:
                bl_chrom, bl_pos = read_blacklist_loci(args.blacklist)
                in_bl = blacklist_membership(chrom, table.pos, bl_chrom, bl_pos)
            else:
                in_bl = np.zeros(len(table), dtype=bool)
            keep, labels = labels_from_approximate_gt(chrom, table.pos, in_dbsnp, in_bl)
            labeled = Frame({"chrom": chrom[keep], "pos": table.pos[keep], "label": labels[keep],
                             "label_gt": labels[keep]})
        chroms = labeled["chrom"]
        if len(labeled):  # one key a contig, as written one after the other
            write_frames(out_path, {str(c): labeled.take(chroms == c) for c in dict.fromkeys(chroms.tolist())})
    except (hdf5.H5Unsupported, BlacklistError, NotImplementedError) as e:
        log.error("%s", e)
        return 2
    log.info("wrote %d labeled variants to %s", len(labeled), out_path)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
