"""find_runs_bed: a BED of the homopolymer runs of a reference FASTA, on the device.

Counterpart of ``variantcalling_tpu/pipelines/misc/find_runs_bed.py``, with
the same arguments plus ``--backend gpu|cpu`` (default ``gpu``: the card;
asking for it without one exits 2). Each contig is encoded by
``FastaReader.encode_contig``, uploaded once and scanned by
:func:`variantcalling_tpu_torch.ops.runs.find_runs` on the run's one
device, however many cards are visible. ``--halo`` is accepted as the
reference accepts it: it sizes the reference's position-sharded scan over
several devices, which the port does not have yet (``ROADMAP.md`` A7), so
it changes nothing here, as it changes nothing in the reference on one
device. The BED lines are ``contig, start, start + length`` of every run of
at least ``--min_length`` real bases, the reference's bytes.
"""

from __future__ import annotations

import argparse
import logging
import sys

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.io.fasta import FastaReader
from variantcalling_tpu_torch.ops import runs as rops
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="find_runs_bed", description=run.__doc__)
    ap.add_argument("--reference", required=True, help="indexed reference FASTA")
    ap.add_argument("--output_bed", required=True)
    ap.add_argument("--min_length", type=int, default=10, help="minimum homopolymer run length to emit")
    ap.add_argument("--contigs", nargs="*", default=None, help="restrict to these contigs (default: all)")
    ap.add_argument("--halo", type=int, default=256,
                    help="shard halo for the multi-device scan (must be >= min_length; "
                         "longer runs are stitched exactly on the host)")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def run(argv) -> int:
    """Write a BED of homopolymer runs >= min_length."""
    args = parse_args(argv)
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    n_total = 0
    with FastaReader(args.reference) as fasta, open(args.output_bed, "w") as out:
        for contig in args.contigs or fasta.references:
            with stage("encode", device):
                codes = fasta.encode_contig(contig)
            with stage("scan", device):
                starts, lengths = rops.find_runs(codes, args.min_length, device)
            with stage("write", device):
                out.write("".join(f"{contig}\t{s}\t{s + ln}\n" for s, ln in zip(starts.tolist(), lengths.tolist())))
            n_total += len(starts)
    log.info("%d runs >= %dbp -> %s on %s", n_total, args.min_length, args.output_bed, device)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
