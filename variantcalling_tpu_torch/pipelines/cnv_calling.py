"""cnv_calling: CNV segments from a BAM's depth through a copy-number HMM.

Counterpart of ``variantcalling_tpu/pipelines/cnv_calling.py``, with the
same arguments plus ``--backend gpu|cpu`` (default ``gpu``: the card;
asking for it without one exits 2). BAM or CRAM -> per-contig depth
difference arrays (the native engine's walk, ``io/bam``) -> each contig
uploaded once, its depth integrated and its bins' means taken on the
run's device -> GC-corrected log2 ratios (host numpy, as the reference) ->
the Viterbi of all contigs in one call on the device (on the card the
kernel ``csrc/cnv_viterbi.cu``) -> a BED of segments (chrom, start, end,
CN, bins, mean log2) and, with ``--output_vcf``, a VCF of symbolic
``<DEL>``/``<DUP>`` alleles (BGZF where the name ends in ``.gz``).
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
from variantcalling_tpu_torch.cnv.caller import call_cnvs
from variantcalling_tpu_torch.io.bam import depth_diff_arrays
from variantcalling_tpu_torch.io.bgzf import BgzfWriter
from variantcalling_tpu_torch.io.fasta import FastaReader
from variantcalling_tpu_torch.ops.coverage import depth_from_diff
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)

#: FastaReader codes of G and C (either case)
_GC_CODES = (1, 2)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="cnv_calling", description=run.__doc__)
    ap.add_argument("--input_bam", required=True)
    ap.add_argument("--output_bed", required=True)
    ap.add_argument("--output_vcf", default=None)
    ap.add_argument("--bin_size", type=int, default=1000)
    ap.add_argument("--reference", default=None, help="FASTA for GC correction")
    ap.add_argument("--min_contig_length", type=int, default=1_000_000)
    ap.add_argument("--min_bins", type=int, default=3)
    ap.add_argument("--sigma", type=float, default=0.35)
    ap.add_argument("--mapq", type=int, default=1)
    ap.add_argument("--verbosity", default="INFO")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def binned_depth(depth: torch.Tensor, bin_size: int) -> np.ndarray:
    """float32 mean depth of each whole bin (the tail bin is dropped): an
    int64 sum on the depth's device, then float64 / bin_size, then float32:
    numpy's float64 mean of the integers."""
    n_bins = depth.shape[0] // bin_size
    if n_bins == 0:
        return np.zeros(0, dtype=np.float32)
    sums = depth[: n_bins * bin_size].view(n_bins, bin_size).sum(1, dtype=torch.int64)
    return (sums.to(torch.float64) / bin_size).to(torch.float32).cpu().numpy()


def gc_per_bin(fasta: FastaReader, contig: str, n_bins: int, bin_size: int) -> np.ndarray:
    """float32 share of G and C (either case) in each bin, from the contig's
    codes; past the contig's end the bases count as N."""
    codes = fasta.fetch_encoded(contig)[: n_bins * bin_size]
    is_gc = np.zeros(n_bins * bin_size, dtype=bool)
    is_gc[: len(codes)] = (codes == _GC_CODES[0]) | (codes == _GC_CODES[1])
    return is_gc.reshape(n_bins, bin_size).mean(axis=1).astype(np.float32)


def run(argv) -> int:
    """Call CNVs from coverage depth via the device HMM."""
    args = parse_args(argv)
    logging.getLogger("variantcalling_tpu_torch").setLevel(getattr(logging, args.verbosity))
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    with stage("ingest", device):
        header, diffs = depth_diff_arrays(args.input_bam, min_mapq=args.mapq)
    per_contig: dict[str, np.ndarray] = {}
    gc: dict[str, np.ndarray] | None = {} if args.reference else None
    fasta = FastaReader(args.reference) if args.reference else None
    with stage("bins", device):
        for name, diff in diffs.items():
            if header.lengths[name] < args.min_contig_length:
                continue
            b = binned_depth(depth_from_diff(torch.from_numpy(diff).to(device)), args.bin_size)
            if not len(b):
                continue
            per_contig[name] = b
            if fasta is not None:
                gc[name] = gc_per_bin(fasta, name, len(b), args.bin_size)
    with stage("segment", device):
        segs = call_cnvs(per_contig, args.bin_size, gc, sigma=args.sigma, min_bins=args.min_bins, device=device)
    with stage("writes", device):
        with open(args.output_bed, "w") as fh:
            for s in segs:
                fh.write(f"{s.chrom}\t{s.start}\t{s.end}\tCN{s.copy_number}\t{s.n_bins}\t{s.mean_log2:.3f}\n")
        if args.output_vcf:
            _write_vcf(args.output_vcf, segs, header)
    log.info("%d CNV segments -> %s on %s", len(segs), args.output_bed, device)
    return 0


def _write_vcf(path: str, segs, header) -> None:
    lines = ["##fileformat=VCFv4.2\n",
             '##ALT=<ID=DEL,Description="Deletion">\n##ALT=<ID=DUP,Description="Duplication">\n',
             '##INFO=<ID=END,Number=1,Type=Integer,Description="Segment end">\n',
             '##INFO=<ID=CN,Number=1,Type=Integer,Description="Copy number">\n',
             '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="SV type">\n']
    lines += [f"##contig=<ID={name},length={length}>\n" for name, length in header.lengths.items()]
    lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    for s in segs:
        svtype = "DEL" if s.copy_number < 2 else "DUP"
        lines.append(f"{s.chrom}\t{s.start + 1}\t.\tN\t<{svtype}>\t.\tPASS\tEND={s.end};CN={s.copy_number};"
                     f"SVTYPE={svtype}\n")
    text = "".join(lines)
    if path.endswith(".gz"):
        with BgzfWriter(path) as fh:
            fh.write(text.encode())
    else:
        with open(path, "w") as fh:
            fh.write(text)


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
