"""process_mbias: M-bias curves + trim-bound suggestion from MethylDackel mbias.

Counterpart of ``variantcalling_tpu/pipelines/methylation/process_mbias.py``
with its arguments (host code only, so no ``--backend``). Outputs h5 keys
``mbias`` (per strand/read/position curves) and ``inclusion_bounds``
(suggested trimming), through the port's ``write_hdf``.
"""

from __future__ import annotations

import argparse
import logging
import sys

from variantcalling_tpu_torch.methyl import mbias_curves, mbias_inclusion_bounds, read_mbias_txt
from variantcalling_tpu_torch.utils.h5_utils import write_frames

log = logging.getLogger(__name__)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="process_mbias", description=run.__doc__)
    ap.add_argument("--input", required=True, help="MethylDackel mbias --txt output")
    ap.add_argument("--output", required=True, help="metrics h5")
    ap.add_argument("--tolerance", type=float, default=0.05)
    ap.add_argument("--verbosity", default="INFO")
    return ap.parse_args(argv)


def run(argv) -> int:
    """Process an M-bias table into curves and inclusion bounds."""
    args = parse_args(argv)
    curves = mbias_curves(read_mbias_txt(args.input))
    bounds = mbias_inclusion_bounds(curves, args.tolerance)
    write_frames(args.output, {"mbias": curves, "inclusion_bounds": bounds})
    log.info("mbias curves (%d rows) + bounds (%d) -> %s", len(curves), len(bounds), args.output)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
