"""sec_validation: validate a SEC noise DB against a truth-labeled sample.

Counterpart of ``variantcalling_tpu/pipelines/sec/sec_validation.py``, with
the same arguments plus ``--backend gpu|cpu`` (default ``gpu``: the card;
asking for it without one exits 2). The likelihood ratio of every sample
call at a DB locus is computed once on the run's device; each threshold of
the sweep then splits those loci into noise and variant, against the
truth VCF's loci:

- a locus called noise where truth has a variant: a lost true variant;
- a locus called noise with no truth variant: correctly suppressed;
- a locus kept with no truth variant: a missed systematic error.

The sweep is written as the reference's ``to_csv(index=False)`` writes it
(``utils.h5_utils.Frame.to_csv``): NaN as an empty field, the precision
rounded to 5 places; with no call at a DB locus, the header alone.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.io import hdf5
from variantcalling_tpu_torch.io.vcf import read_vcf
from variantcalling_tpu_torch.utils.stages import stage
from variantcalling_tpu_torch.sec.caller import hit_ratios
from variantcalling_tpu_torch.sec.db import SecDb, pack_keys
from variantcalling_tpu_torch.utils.h5_utils import Frame

log = logging.getLogger(__name__)

# noise_likelihood_ratio is noise-vs-best-fit in (0, 1]; 1 = counts look
# exactly like the cohort noise (sec.caller.DEFAULT_NOISE_RATIO = 0.1)
DEFAULT_SWEEP = (0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 0.8, 0.95)
COLUMNS = ("threshold", "suppressed", "lost_true", "kept_true", "missed_noise", "suppression_precision")


def parse_args(argv: list[str]):
    ap = argparse.ArgumentParser(prog="sec_validation", description=run.__doc__)
    ap.add_argument("--model", required=True, help="SEC DB h5 (from sec_training)")
    ap.add_argument("--sample_vcf", required=True, help="sample callset with FORMAT/AD")
    ap.add_argument("--truth_vcf", required=True, help="ground-truth VCF for the same sample")
    ap.add_argument("--output_file", required=True, help="sweep csv")
    ap.add_argument("--thresholds", type=float, nargs="*", default=list(DEFAULT_SWEEP))
    ap.add_argument("--verbosity", default="INFO")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def _at_truth(chrom: np.ndarray, pos: np.ndarray, truth) -> np.ndarray:
    """True where (chrom, pos) is a locus of ``truth``."""
    contigs = list(dict.fromkeys([*truth.chrom.tolist(), *chrom.tolist()]))
    truth_keys = np.unique(pack_keys(contigs, np.asarray(truth.chrom), truth.pos))
    keys = pack_keys(contigs, chrom, pos)
    if len(truth_keys) == 0:
        return np.zeros(len(keys), dtype=bool)
    at = np.minimum(np.searchsorted(truth_keys, keys), len(truth_keys) - 1)
    return truth_keys[at] == keys


def validate(db: SecDb, sample_vcf: str, truth_vcf: str, thresholds: list[float], device) -> Frame:
    table = read_vcf(sample_vcf)
    hit, rows = db.lookup(table.chrom, table.pos)
    if not hit.any():
        return Frame({c: np.zeros(0, dtype=object) for c in COLUMNS})
    ratios = hit_ratios(table, db, hit, rows, device)
    is_true = _at_truth(np.asarray(table.chrom)[hit], np.asarray(table.pos)[hit], read_vcf(truth_vcf))

    out = {c: [] for c in COLUMNS}
    for thr in thresholds:
        is_noise = ratios >= thr
        suppressed = int(is_noise.sum())
        lost_true = int((is_noise & is_true).sum())
        out["threshold"].append(thr)
        out["suppressed"].append(suppressed)
        out["lost_true"].append(lost_true)
        out["kept_true"].append(int((~is_noise & is_true).sum()))
        out["missed_noise"].append(int((~is_noise & ~is_true).sum()))
        out["suppression_precision"].append(round((suppressed - lost_true) / suppressed, 5) if suppressed
                                            else np.nan)
    return Frame({c: np.asarray(v, dtype=np.float64 if c in ("threshold", "suppression_precision") else np.int64)
                  for c, v in out.items()})


def run(argv: list[str]) -> int:
    """Validate a SEC DB: threshold sweep against a truth-labeled sample."""
    args = parse_args(argv)
    logging.getLogger("variantcalling_tpu_torch").setLevel(getattr(logging, args.verbosity))
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
        db = SecDb.load(args.model)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable, hdf5.H5Unsupported) as e:
        log.error("%s", e)
        return 2
    with stage("sweep", device):
        sweep = validate(db, args.sample_vcf, args.truth_vcf, args.thresholds, device)
    sweep.to_csv(args.output_file)
    log.info("SEC validation sweep (%d thresholds) -> %s on %s", len(sweep), args.output_file, device)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
