"""calibrate_bridging_snvs: un-filter somatic SNVs that bridge long homopolymers.

Counterpart of ``variantcalling_tpu/pipelines/calibrate_bridging_snvs.py``
with its arguments plus ``--backend gpu|cpu`` (default ``gpu``: the card;
asking for it without one exits 2). A filtered SNV whose alt allele joins
the flanking reference homopolymers into a run of at least
``--min_query_hmer_size`` (and is not a symmetric tandem repeat), with a
high tumor VAF and a low normal VAF (FORMAT ``AD``/``DP`` against
``BG_AD``/``BG_DP``), gets PASS and ``--set_qual``. The bridging test runs
over the records' reference windows (:func:`featurize.gather_windows` at
radius ``--min_query_hmer_size``) as torch ops on the run's device
(:func:`bridging_hmer_lengths`); the per-record SNV and PASS tests are
host code, and the VCF is written back by the plain writer, a rescued
record's QUAL rendered as the reference renders a changed QUAL.
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
from variantcalling_tpu_torch.featurize import gather_windows
from variantcalling_tpu_torch.io.fasta import FastaReader
from variantcalling_tpu_torch.io.vcf import read_vcf, write_vcf
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)

_BASES = "ACGT"


def bridging_hmer_lengths(windows: np.ndarray, alt_code: np.ndarray, radius: int,
                          device: torch.device | str = "cpu") -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(upstream_len, downstream_len, tandem) for each variant window, on ``device``.

    upstream/downstream = consecutive reference bases equal to the alt base
    on each side of the variant position (the first 0 of the match mask by
    ``argmin``, the arm's length where it matches throughout); tandem = the
    bases bounding the joined run (code 4 where the run reaches the window's
    edge) are equal to each other and to the reference base at the variant,
    with arms of equal length.
    """
    dev = device_mod.as_device(device)
    w = torch.from_numpy(np.ascontiguousarray(windows)).to(dev, torch.int32)
    alt = torch.from_numpy(np.asarray(alt_code, dtype=np.int32)).to(dev)[:, None]
    right = w[:, radius + 1:]
    left = torch.flip(w[:, :radius], dims=(1,))

    def run_len(arm: torch.Tensor) -> torch.Tensor:
        same = arm == alt
        if arm.shape[1] == 0:
            return torch.zeros(arm.shape[0], dtype=torch.int64, device=dev)
        first = torch.argmin(same.to(torch.int32), dim=1)  # the first 0 (torch.argmin returns the first minimum)
        return torch.where(same.all(dim=1), torch.full_like(first, arm.shape[1]), first)

    up, down = run_len(left), run_len(right)

    def bounding(arm: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
        if arm.shape[1] == 0:
            return torch.full_like(length, 4)
        picked = torch.gather(arm, 1, torch.clamp(length, max=arm.shape[1] - 1)[:, None])[:, 0].to(torch.int64)
        return torch.where(length < arm.shape[1], picked, torch.full_like(picked, 4))

    before, after = bounding(left, up), bounding(right, down)
    tandem = (before == after) & (before == w[:, radius].to(torch.int64)) & (up == down)
    return up.cpu().numpy(), down.cpu().numpy(), tandem.cpu().numpy()


def run(argv: list[str]):
    """Un-filter SNVs which generate a long homopolymer, have borderline quality
    and have a high VAF in the tumor and low VAF in the normal."""
    ap = argparse.ArgumentParser(prog="calibrate_bridging_snvs", description=run.__doc__)
    ap.add_argument("--vcf", required=True, help="Path to the VCF file")
    ap.add_argument("--reference", required=True, help="Path to the reference genome")
    ap.add_argument("--output", required=True, help="name of output vcf file")
    ap.add_argument("--min_query_hmer_size", default=5, type=int)
    ap.add_argument("--min_initial_qual", default=5, type=int)
    ap.add_argument("--min_tumor_vaf", default=0.2, type=float)
    ap.add_argument("--max_normal_vaf", default=0.1, type=float)
    ap.add_argument("--min_normal_depth", default=10, type=int)
    ap.add_argument("--min_distance_from_edge", default=0, type=int)
    ap.add_argument("--set_qual", default=20, type=int)
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    args = ap.parse_args(argv)
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2

    with stage("ingest"):
        table = read_vcf(args.vcf)
    n = len(table)
    code = {b: i for i, b in enumerate(_BASES)}
    with stage("candidates"):
        is_snv = np.zeros(n, dtype=bool)
        alt_code = np.full(n, 4, dtype=np.int32)
        for i, (ref, alt) in enumerate(zip(table.ref.tolist(), table.alt.tolist())):
            if len(ref) == 1 and len(alt) == 1 and alt in code:
                is_snv[i] = True
                alt_code[i] = code[alt]
        not_pass = np.array([f != "PASS" and "PASS" not in str(f).split(";") for f in table.filters.tolist()],
                            dtype=bool)
        candidate = is_snv & not_pass & (np.nan_to_num(table.qual, nan=-1) >= args.min_initial_qual)

    radius = args.min_query_hmer_size
    with stage("windows"):
        with FastaReader(args.reference) as fa:
            windows = gather_windows(table, fa, radius=radius)
    with stage("bridging", device):
        up, down, tandem = bridging_hmer_lengths(windows, alt_code, radius, device)
    hmer_size = 1 + up + down
    bridging = (candidate & (hmer_size >= args.min_query_hmer_size) & ~tandem
                & (np.minimum(up, down) >= args.min_distance_from_edge))

    with stage("vaf"):
        ad = table.format_numeric("AD", missing=0)
        dp = table.format_numeric("DP", max_len=1, missing=0)[:, 0]
        bg_ad = table.format_numeric("BG_AD", missing=0)
        bg_dp = table.format_numeric("BG_DP", max_len=1, missing=0)[:, 0]
        with np.errstate(invalid="ignore", divide="ignore"):
            tumor_vaf = np.where(dp > 0, ad[:, 1:].sum(axis=1) / np.maximum(dp, 1), 0.0)
            normal_vaf = bg_ad[:, 1:].sum(axis=1) / np.maximum(bg_dp, 0.01)
    rescued = (bridging & (tumor_vaf >= args.min_tumor_vaf) & (normal_vaf <= args.max_normal_vaf)
               & (bg_dp > args.min_normal_depth))

    new_filters = np.array(table.filters, dtype=object, copy=True)
    new_filters[rescued] = "PASS"
    table.qual = np.where(rescued, float(args.set_qual), table.qual)
    with stage("writeback"):
        write_vcf(args.output, table, new_filters=new_filters, qual_as_read=False)
    log.info("calibrate_bridging_snvs: rescued %d of %d candidate SNVs", int(rescued.sum()), int(candidate.sum()))
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
