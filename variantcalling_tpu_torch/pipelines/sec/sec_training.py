"""sec_training: build the SEC noise DB from a cohort of callsets.

Counterpart of ``variantcalling_tpu/pipelines/sec/sec_training.py``, with
the same arguments plus ``--backend gpu|cpu`` (default ``gpu``: the card;
asking for it without one exits 2). Per sample, the allele counts at each
locus (``--relevant_coords``: the loci of a BED; else every locus called)
are read on the host; the cohort is their sum: the host merge
(``sec.db.merge_sample_counts``), or with ``--use_mesh`` the dense
(S, L, A) tensor over the union of loci summed on the run's device
(``sec.aggregate.aggregate_on_device``). Loci seen fewer than
``--min_samples`` times (every occurrence counts, duplicates within one
sample too) are dropped. The DB is written in the reference's h5 layout.

One process builds the whole cohort. A launch of more than one rank
(``VCTPU_RANK``, ``VCTPU_NUM_PROCESSES``, ``VCTPU_SPAN``) exits 2: the
reference's multi-host branch, one all-reduce over every host's samples,
waits for multi-GPU support (``ROADMAP.md`` A7c).
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.io import bed as bedio
from variantcalling_tpu_torch.io.vcf import read_vcf
from variantcalling_tpu_torch.utils.stages import stage
from variantcalling_tpu_torch.sec.aggregate import aggregate_on_device
from variantcalling_tpu_torch.sec.caller import observed_allele_counts
from variantcalling_tpu_torch.sec.db import SecDb, merge_sample_counts, pack_keys

log = logging.getLogger(__name__)


def parse_args(argv: list[str]):
    ap = argparse.ArgumentParser(prog="sec_training", description=run.__doc__)
    ap.add_argument("--inputs", nargs="+", required=True, help="per-sample VCFs (the cohort)")
    ap.add_argument("--relevant_coords", help="BED of loci to model (default: union of cohort calls)")
    ap.add_argument("--output_file", required=True, help="SEC DB h5")
    ap.add_argument("--min_samples", type=int, default=2,
                    help="keep loci observed in at least this many samples")
    ap.add_argument("--use_mesh", action="store_true",
                    help="sum the dense per-sample tensor on the device")
    ap.add_argument("--verbosity", default="INFO")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def sample_counts(path: str, contigs: list[str], region) -> tuple[np.ndarray, np.ndarray]:
    """One sample's (sorted keys, (l, A) counts), its header's contigs (or
    its records' chroms) appended to ``contigs`` first."""
    table = read_vcf(path)
    for c in table.header.contigs or dict.fromkeys(table.chrom.tolist()):
        if c not in contigs:
            contigs.append(c)
    mask = np.ones(len(table), dtype=bool)
    if region is not None and len(region):
        mask = np.asarray(region.contains(np.asarray(table.chrom), table.pos - 1))
    keys = pack_keys(contigs, np.asarray(table.chrom)[mask], table.pos[mask])
    counts = observed_allele_counts(table)[mask]
    order = np.argsort(keys)
    return keys[order], counts[order]


def run(argv: list[str]) -> int:
    """Build a cohort systematic-error (noise) database."""
    args = parse_args(argv)
    logging.getLogger("variantcalling_tpu_torch").setLevel(getattr(logging, args.verbosity))
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    ranks = device_mod.multi_rank()
    if ranks:
        log.error("sec_training: %s asks for more than one rank; the port builds the cohort in one process "
                  "(the multi-host all-reduce is ROADMAP A7c) and never builds one rank's share as the whole "
                  "cohort: unset them", ranks)
        return 2
    region = bedio.read_intervals(args.relevant_coords) if args.relevant_coords else None

    contigs: list[str] = []
    per_sample = []
    with stage("ingest", device):
        for path in args.inputs:
            per_sample.append(sample_counts(path, contigs, region))
            log.info("%s: %d loci", path, len(per_sample[-1][0]))

    with stage("aggregate", device):
        if args.use_mesh and per_sample:
            all_keys = np.unique(np.concatenate([k for k, _ in per_sample]))
            dense = np.zeros((len(per_sample), len(all_keys), per_sample[0][1].shape[1]), dtype=np.float32)
            for s, (keys, counts) in enumerate(per_sample):
                dense[s, np.searchsorted(all_keys, keys)] = counts
            total = aggregate_on_device(dense, device)
            del dense
            db = SecDb(contigs=contigs, keys=all_keys, counts=total, n_samples=len(per_sample))
        else:
            db = merge_sample_counts(contigs, per_sample)
        # every occurrence of a key counts, as the reference's per-key tally does
        occurrences = np.concatenate([k for k, _ in per_sample]) if per_sample else np.zeros(0, np.int64)
        union, seen = np.unique(occurrences, return_counts=True)
        keep = seen[np.searchsorted(union, db.keys)] >= args.min_samples if len(db.keys) else \
            np.zeros(0, dtype=bool)
        db = SecDb(contigs=db.contigs, keys=db.keys[keep], counts=db.counts[keep], n_samples=db.n_samples)

    with stage("writes", device):
        db.save(args.output_file)
    log.info("SEC DB: %d loci from %d samples -> %s on %s", len(db), db.n_samples, args.output_file, device)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
