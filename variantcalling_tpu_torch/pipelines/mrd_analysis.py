"""mrd_analysis: tumor-informed minimal-residual-disease estimation.

Counterpart of ``variantcalling_tpu/pipelines/mrd_analysis.py`` with its
arguments plus ``--backend gpu|cpu`` (default ``gpu``: the card; asking
for it without one exits 2). Given the patient's somatic signature loci
(a tumor mutations VCF) and a cfDNA featuremap scored by the single-read
model (``srsnv_inference``'s ``ML_QUAL``), the tumor fraction is the
maximum of a binomial likelihood over the signature loci's supporting
reads with an error-rate background, with an exact Clopper-Pearson
interval and a Poisson detection test.

- The support count is one vectorised pass: a sorted-key membership of
  ``(chrom, pos)`` and ``isnan(q) | (q >= threshold)``.
- The likelihood profile runs on the run's device in float32 as the
  reference's does on XLA's CPU backend: ``jnp.linspace``'s grid (the
  iota times the float32 reciprocal of the step count), ``log`` and
  ``log1p`` replayed bit for bit (:mod:`ops.math`), the first maximum. So
  the card, the CPU and the JAX package pick the same grid point.
- ``scipy.stats.beta.ppf`` and ``poisson.sf`` are not imported: for the
  integer shapes of a Clopper-Pearson interval, ``beta.ppf(q, k, n-k+1)``
  is the ``x`` where ``P(Binomial(n, x) >= k) = q``, found by bisection
  over the binomial tail summed in float64 from a log-pmf computed by
  Loader's saddle-point formula (:func:`binomial_tail`); ``poisson.sf(k-1,
  mu)`` is the regularised lower incomplete gamma ``P(k, mu)``
  (``torch.special.gammainc`` in float64).
"""

from __future__ import annotations

import argparse
import logging
import math
import sys

import numpy as np
import torch

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.io.vcf import VariantTable, read_vcf
from variantcalling_tpu_torch.ops.math import log1p_f32, log_f32
from variantcalling_tpu_torch.utils.h5_utils import Frame, write_hdf
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="mrd_analysis", description=run.__doc__)
    ap.add_argument("--signature_vcf", required=True, help="patient somatic mutations (tumor-informed)")
    ap.add_argument("--featuremap", required=True, help="cfDNA featuremap (srsnv_inference output)")
    ap.add_argument("--coverage_per_locus", type=float, required=True,
                    help="mean effective coverage per signature locus")
    ap.add_argument("--ml_qual_threshold", type=float, default=40.0)
    ap.add_argument("--background_error_rate", type=float, default=1e-6,
                    help="residual per-base error rate after filtering")
    ap.add_argument("--output_h5", required=True)
    ap.add_argument("--verbosity", default="INFO")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def _chrom_ids(table: VariantTable, ids: dict[str, int]) -> np.ndarray:
    """Each record's contig as its number in ``ids`` (-1 where absent), from
    the scan's contig codes where the table has them."""
    if table.chrom_codes is not None:
        lut = np.array([ids.get(str(c), -1) for c in table.chrom_names], dtype=np.int64)
        return lut[table.chrom_codes] if len(lut) else np.zeros(0, dtype=np.int64)
    return np.array([ids.get(str(c), -1) for c in np.asarray(table.chrom).tolist()], dtype=np.int64)


def count_supporting_reads(signature_vcf: str, featuremap: str, ml_qual_threshold: float) -> tuple[int, int]:
    """(n signature loci, reads supporting them above the quality bar)."""
    sig = read_vcf(signature_vcf, drop_format=True)
    ids = {c: i for i, c in enumerate(dict.fromkeys(np.asarray(sig.chrom).tolist()))}
    sig_keys = np.unique((_chrom_ids(sig, ids) << 32) | sig.pos.astype(np.int64))
    fm = read_vcf(featuremap, numeric_info=True)
    qual = fm.info_field("ML_QUAL")
    fm_ids = _chrom_ids(fm, ids)
    at_locus = (fm_ids >= 0) & np.isin((fm_ids << 32) | fm.pos.astype(np.int64), sig_keys)
    return len(sig_keys), int((at_locus & (np.isnan(qual) | (qual >= ml_qual_threshold))).sum())


def likelihood_argmax(k: int, n_trials: int, background_rate: float, grid_size: int,
                      device: torch.device) -> float:
    """The grid's tumor fraction of the first maximum of the binomial
    log-likelihood, in float32 on ``device`` as XLA's CPU backend computes the
    reference's eager program."""
    div = grid_size - 1
    f32 = torch.float32
    if div > 0:
        iota = torch.arange(div, dtype=f32, device=device)
        grid = torch.cat([iota * float(np.float32(1.0) / np.float32(div)), torch.ones(1, dtype=f32, device=device)])
    else:
        grid = torch.zeros(grid_size, dtype=f32, device=device)
    p = grid / 2.0 + float(np.float32(background_rate))
    lo = torch.tensor(float(np.float32(1e-12)), dtype=f32, device=device)
    hi = torch.tensor(float(np.float32(1 - 1e-12)), dtype=f32, device=device)
    p = torch.minimum(torch.maximum(p, lo), hi)
    log_l = float(np.float32(k)) * log_f32(p) + float(np.float32(n_trials - k)) * log1p_f32(-p)
    return float(grid[int(torch.argmax(log_l))])


# -- the interval and the test without scipy ----------------------------------------------------------------------

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _stirlerr(n: float) -> float:
    """``log(n!) - log(sqrt(2 pi n) (n / e)^n)``: the series for n > 15 (Loader)."""
    if n <= 15.0:
        return math.lgamma(n + 1.0) - (n + 0.5) * math.log(n) + n - _HALF_LOG_2PI
    nn = n * n
    s0, s1, s2, s3, s4 = 1 / 12, 1 / 360, 1 / 1260, 1 / 1680, 1 / 1188
    if n > 500:
        return (s0 - s1 / nn) / n
    if n > 80:
        return (s0 - (s1 - s2 / nn) / nn) / n
    if n > 35:
        return (s0 - (s1 - (s2 - s3 / nn) / nn) / nn) / n
    return (s0 - (s1 - (s2 - (s3 - s4 / nn) / nn) / nn) / nn) / n


def _bd0(x: float, m: float) -> float:
    """``x log(x / m) + m - x`` without cancellation (Loader)."""
    if abs(x - m) < 0.1 * (x + m):
        v = (x - m) / (x + m)
        s = (x - m) * v
        ej = 2.0 * x * v
        v *= v
        for j in range(1, 1000):
            ej *= v
            s1 = s + ej / (2 * j + 1)
            if s1 == s:
                return s1
            s = s1
        return s
    return x * math.log(x / m) + m - x


def binomial_log_pmf(j: int, n: int, p: float) -> float:
    """``log P(Binomial(n, p) = j)`` to a few ulps (Loader's saddle-point form)."""
    q = 1.0 - p
    if p == 0.0:
        return 0.0 if j == 0 else -math.inf
    if q == 0.0:
        return 0.0 if j == n else -math.inf
    if j == 0:
        return n * math.log1p(-p) if p < 0.1 else -_bd0(n, n * q) - n * p
    if j == n:
        return n * math.log(p) if q >= 0.1 else -_bd0(n, n * p) - n * q
    lc = _stirlerr(n) - _stirlerr(j) - _stirlerr(n - j) - _bd0(j, n * p) - _bd0(n - j, n * q)
    return lc - 0.5 * (math.log(2.0 * math.pi) + math.log(j) + math.log1p(-j / n))


def binomial_tail(k: int, n: int, x: float) -> float:
    """``P(Binomial(n, x) >= k)`` in float64: the tail away from the mode
    summed term by term from its accurate first term (the other tail,
    subtracted from 1, where the mode lies in this one)."""
    if k <= 0:
        return 1.0
    if k > n:
        return 0.0
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    odds = x / (1.0 - x)
    mode = (n + 1) * x
    if k > mode:  # the upper tail decreases from its first term
        start, step, stop = k, 1, n
    else:  # the lower tail j <= k - 1 decreases from its last term
        start, step, stop = k - 1, -1, 0
    term = math.exp(binomial_log_pmf(start, n, x))
    total, j = term, start
    while j != stop and term > total * 1e-17:
        term *= (n - j) / (j + 1) * odds if step > 0 else j / (n - j + 1) / odds
        total += term
        j += step
    return total if step > 0 else 1.0 - total


def clopper_pearson_quantile(q: float, k: int, n: int) -> float:
    """``scipy.stats.beta.ppf(q, k, n - k + 1)`` for integers ``1 <= k <= n``:
    the ``x`` where ``P(Binomial(n, x) >= k) = q``, by bisection in float64
    until the bracket cannot narrow."""
    lo, hi = 0.0, 1.0
    for _ in range(2000):
        mid = 0.5 * (lo + hi)
        if mid <= lo or mid >= hi:
            break
        if binomial_tail(k, n, mid) < q:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def poisson_sf(k: int, mu: float) -> float:
    """``scipy.stats.poisson.sf(k, mu)`` = ``P(X > k)``: the regularised lower
    incomplete gamma ``P(k + 1, mu)`` in float64."""
    if k < 0:
        return 1.0
    if mu <= 0.0:
        return 0.0
    return float(torch.special.gammainc(torch.tensor(k + 1.0, dtype=torch.float64),
                                        torch.tensor(mu, dtype=torch.float64)))


def estimate_tumor_fraction(
    n_loci: int,
    n_support: int,
    coverage: float,
    background_rate: float,
    grid_size: int = 4001,
    device: torch.device | str = "gpu",
) -> dict:
    """Binomial ML estimate + 95% Clopper-Pearson over the support counts.

    Model: supporting reads ~ Binomial(n_trials, tf/2 + e) with
    n_trials = n_loci * coverage (tf/2: heterozygous somatic allele).
    """
    dev = device_mod.as_device(device)
    n_trials = max(int(round(n_loci * coverage)), 1)
    k = min(n_support, n_trials)
    tf_hat = likelihood_argmax(k, n_trials, background_rate, grid_size, dev)
    # exact binomial CI on p, then back out tf = 2*(p - e)
    lo_p = clopper_pearson_quantile(0.025, k, n_trials) if k > 0 else 0.0
    hi_p = clopper_pearson_quantile(0.975, k + 1, n_trials) if k < n_trials else 1.0
    tf_lo = max(0.0, 2.0 * (lo_p - background_rate))
    tf_hi = min(1.0, 2.0 * (hi_p - background_rate))
    expected_bg = n_trials * background_rate
    # one-sided Poisson tail: P(X >= k | background only)
    detected = bool(k > 0 and poisson_sf(k - 1, expected_bg) < 0.05)
    return {
        "n_signature_loci": n_loci,
        "n_supporting_reads": n_support,
        "n_trials": n_trials,
        "tumor_fraction": tf_hat,
        "tf_ci_low": tf_lo,
        "tf_ci_high": tf_hi,
        "expected_background_reads": expected_bg,
        "mrd_detected": detected,
    }


def summary_frame(result: dict) -> Frame:
    """``pd.DataFrame([result])``: one row, each value's numpy dtype as pandas infers it."""
    return Frame({k: np.array([v]) for k, v in result.items()})


def run(argv) -> int:
    """Estimate tumor fraction from signature-locus supporting reads."""
    args = parse_args(argv)
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    with stage("count"):
        n_loci, n_support = count_supporting_reads(args.signature_vcf, args.featuremap, args.ml_qual_threshold)
    with stage("estimate", device):
        result = estimate_tumor_fraction(n_loci, n_support, args.coverage_per_locus, args.background_error_rate,
                                         device=device)
    with stage("writes"):
        write_hdf(summary_frame(result), args.output_h5, key="mrd_summary", mode="w")
    log.info("MRD: %d/%d supporting reads, tf=%.2e [%.2e, %.2e], detected=%s -> %s", result["n_supporting_reads"],
             result["n_trials"], result["tumor_fraction"], result["tf_ci_low"], result["tf_ci_high"],
             result["mrd_detected"], args.output_h5)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
