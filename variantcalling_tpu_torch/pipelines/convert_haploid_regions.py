"""convert_haploid_regions: rewrite diploid PL/GQ/GT as haploid inside given regions.

Counterpart of ``variantcalling_tpu/pipelines/convert_haploid_regions.py``,
with the same arguments (``--input_vcf --output_vcf --haploid_regions <bed
| hg38_non_par>``) plus ``--backend gpu|cpu`` (default ``gpu``: the card;
asking for it without one exits 2). Records inside the regions whose PL has
the diploid length of their alt count are converted by
``ops/genotypes.diploid_pl_to_haploid``, one batch an alt count on the run's
device; GT stays a no-call where it was one, GQ is rewritten where FORMAT
has it. Every other record, and every other byte of a converted one, is
written as the reference writes it (QUAL as ``%g`` of its value).
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np
import torch

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.io.bed import read_bed
from variantcalling_tpu_torch.io.vcf import MISSING, join_tails, number_lists, read_vcf, sample_fields, write_vcf
from variantcalling_tpu_torch.ops.genotypes import diploid_pl_to_haploid, n_genotypes
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)

#: hg38's non-pseudoautosomal X and Y spans, the reference's, 1-based inclusive (chrom, start, end)
HG38_NON_PAR = [
    ("chrX", 1, 10001),
    ("chrX", 2781479, 155701383),
    ("chrX", 156030895, 156040895),
    ("chrY", 1, 10001),
    ("chrY", 2781479, 56887903),
]


def parse_args(argv: list[str]):
    ap = argparse.ArgumentParser(prog="convert_haploid_regions", description=__doc__)
    ap.add_argument("--input_vcf", required=True)
    ap.add_argument("--output_vcf", required=True)
    ap.add_argument("--haploid_regions", required=True,
                    help="BED of haploid regions, or 'hg38_non_par' for the hardcoded hg38 non-PAR X/Y spans")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def in_regions_mask(chrom: np.ndarray, pos: np.ndarray, regions: list[tuple[str, int, int]]) -> np.ndarray:
    """Records with ``start < pos <= end`` in any region of their chromosome."""
    mask = np.zeros(len(pos), dtype=bool)
    for rc, rs, re in regions:
        mask |= (chrom == rc) & (pos > rs) & (pos <= re)
    return mask


def convert_haploid(table, regions: list[tuple[str, int, int]], device: torch.device) -> tuple[np.ndarray, int]:
    """(each record's rewritten ``tail``, records in the regions)."""
    fmt, samples = table.format_columns()
    in_region = in_regions_mask(table.chrom, table.pos, regions)
    n_in = int(in_region.sum())
    n_alts = table.n_alts()
    raw = sample_fields(fmt.tolist(), samples[:, 0].tolist(), ("GT", "PL"))
    gt_raw, pl_raw = raw["GT"], raw["PL"]
    for a in np.unique(n_alts[in_region]).tolist():
        g = n_genotypes(a)
        rows = [i for i in np.nonzero(in_region & (n_alts == a))[0].tolist()
                if pl_raw[i] not in (None, MISSING, "") and pl_raw[i].count(",") + 1 == g]
        if not rows:
            continue
        pl = number_lists([pl_raw[i] for i in rows], g, np.nan)
        hpl, gq, gt = (x.cpu().tolist() for x in diploid_pl_to_haploid(torch.from_numpy(pl).to(device), a))
        for i, h, q, t in zip(rows, hpl, gq, gt):
            keys = fmt[i].split(":")
            vals = samples[i, 0].split(":")
            vals += [MISSING] * (len(keys) - len(vals))
            d = dict(zip(keys, vals))
            no_call = gt_raw[i] in (None, MISSING, "") or gt_raw[i].split("/")[0].split("|")[0] == MISSING
            d["GT"] = MISSING if no_call else str(t)
            if "GQ" in d:
                d["GQ"] = str(q)
            d["PL"] = ",".join(map(str, h))
            samples[i, 0] = ":".join(d.get(k, MISSING) for k in keys)
    return join_tails(fmt, samples), n_in


def run(argv: list[str]) -> int:
    """Convert genotypes of specified regions to haploid calls, maintaining GT,GQ,PL."""
    args = parse_args(argv)
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    if args.haploid_regions == "hg38_non_par":
        regions = HG38_NON_PAR
    else:
        bed = read_bed(args.haploid_regions)
        regions = [(str(c), int(s), int(e)) for c, s, e in zip(bed.chrom, bed.start, bed.end)]
    with stage("ingest", device):
        table = read_vcf(args.input_vcf)
    with stage("convert", device):
        tails, n_conv = convert_haploid(table, regions, device)
    with stage("writeback", device):
        write_vcf(args.output_vcf, table, qual_as_read=False, tails=tails)
    sys.stderr.write(f"convert_haploid_regions: {n_conv} records in haploid regions\n")
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
