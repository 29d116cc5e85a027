"""run_somatic_comparison_and_graphs — somatic (Mutect-style) eval driver.

Counterpart of ``variantcalling_tpu/pipelines/run_somatic_comparison_and_graphs.py``:
the same arguments plus ``--backend gpu|cpu`` (default ``gpu``: the card,
exit 2 without one), handed to both stages. It chains the port's
``run_comparison_pipeline`` (a somatic callset against the tumor-minus-normal
truth, ``somatic_comparison.h5`` and ``.intervals.bed``) and
``evaluate_concordance`` (``somatic_eval.*``) in process.

``--make_plots``: the reference draws its recall/precision figure through
``reports/nexusplt``, which the port has not taken over; the figure is
skipped, recorded through ``utils/degrade`` (point
``reports/html.FIGURE_POINT``) and counted (``figures_skipped`` in the
log), as ``reports/html.add_figure_safe`` does where matplotlib is absent.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch.pipelines import evaluate_concordance, run_comparison
from variantcalling_tpu_torch.reports.html import FIGURE_POINT
from variantcalling_tpu_torch.utils import degrade

log = logging.getLogger(__name__)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="run_somatic_comparison_and_graphs", description=run.__doc__)
    ap.add_argument("--somatic_vcf", required=True, help="Mutect-style somatic callset")
    ap.add_argument("--gt_vcf", required=True, help="tumor-minus-normal GT (create_somatic_gt_file)")
    ap.add_argument("--highconf_bed", required=True, help="cleaned cmp intervals (create_somatic_gt_file)")
    ap.add_argument("--reference", required=True)
    ap.add_argument("--output_folder", required=True)
    ap.add_argument("--call_sample_name", default="tumor")
    ap.add_argument("--truth_sample_name", default="somatic_gt")
    ap.add_argument("--score_key", default="tree_score")
    ap.add_argument("--make_plots", action="store_true")
    ap.add_argument("--backend", choices=["gpu", "cpu"], default="gpu",
                    help="device of both stages (gpu: the card, exit 2 without one)")
    return ap.parse_args(argv)


def run(argv) -> int:
    """Chain comparison + concordance evaluation (+ graphs) for somatic calls."""
    args = parse_args(argv)
    try:
        device_mod.resolve(args.backend)
    except device_mod.DeviceUnavailable as e:
        log.error("%s", e)
        return 2
    os.makedirs(args.output_folder, exist_ok=True)
    h5 = os.path.join(args.output_folder, "somatic_comparison.h5")
    bed = os.path.join(args.output_folder, "somatic_comparison.intervals.bed")
    rc = run_comparison.run([
        "--input_prefix", args.somatic_vcf,
        "--output_file", h5,
        "--output_interval", bed,
        "--gtr_vcf", args.gt_vcf,
        "--highconf_intervals", args.highconf_bed,
        "--reference", args.reference,
        "--call_sample_name", args.call_sample_name,
        "--truth_sample_name", args.truth_sample_name,
        "--ignore_filter_status",
        "--backend", args.backend,
    ])
    if rc not in (0, None):
        return int(rc)
    prefix = os.path.join(args.output_folder, "somatic_eval")
    rc = evaluate_concordance.run(["--input_file", h5, "--output_prefix", prefix, "--score_key", args.score_key,
                                   "--backend", args.backend])
    if rc not in (0, None):
        return int(rc)
    figures_skipped = 0
    if args.make_plots:
        figures_skipped += 1
        degrade.record(FIGURE_POINT, None, fallback="somatic recall/precision figure skipped: the port does not "
                       "draw reports/nexusplt figures")
    log.info("somatic comparison + evaluation -> %s (figures_skipped %d)", args.output_folder, figures_skipped)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
