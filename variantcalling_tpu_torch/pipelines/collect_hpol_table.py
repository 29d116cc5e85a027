"""collect_hpol_table — sample homopolymer loci (length x nucleotide) from a reference.

Counterpart of ``variantcalling_tpu/pipelines/collect_hpol_table.py``, with
the same arguments (a host tool: no ``--backend``): ``--reference
--collection_regions --output --max_hpol_length --max_number_to_collect``.
Each interval's flow-space key (``utils/flow``) gives its homopolymers; each
(length, nucleotide) class of an interval keeps ``ceil(share *
max_number_to_collect)`` of them, the interval's share being its part of
the regions' total length. The draws are the reference's: one
``default_rng(seed)``, one ``permutation`` a non-empty class, in the
reference's loop order (interval, length, nucleotide), so the table is
byte-equal. The classes of an interval are grouped by one stable sort
rather than found by a scan each.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from variantcalling_tpu_torch.io.bed import read_bed
from variantcalling_tpu_torch.io.fasta import FastaReader
from variantcalling_tpu_torch.utils.flow import DEFAULT_FLOW_ORDER, generate_key_from_sequence, key_to_base_index


def plan_sampling(collection_regions: str) -> list[float]:
    """Per-interval fraction of the total collection length."""
    ivals = read_bed(collection_regions)
    lengths = (ivals.end - ivals.start).astype(float)
    total = lengths.sum()
    return (lengths / total).tolist() if total else []


def collect_homopolymers(
    reference: str,
    collection_regions: str,
    max_hpol_length: int,
    max_number_to_collect: int,
    sampling_fractions: list[float],
    seed: int = 0,
) -> tuple[list[str], np.ndarray]:
    """The sampled homopolymers sorted by (chrom, position) as Python sorts
    those pairs (stably): (the contig names, an (rows, 4) int64 array of
    contig number, 0-based position, hmer length, nucleotide number in the
    flow order)."""
    rng = np.random.default_rng(seed)
    ivals = read_bed(collection_regions)
    cycle = len(DEFAULT_FLOW_ORDER)
    names: list[str] = []
    parts: list[np.ndarray] = []
    with FastaReader(reference) as fa:
        refs = set(fa.references)
        for i in range(len(ivals)):
            chrom = str(ivals.chrom[i])
            start, end = int(ivals.start[i]), int(ivals.end[i])
            if chrom not in refs:
                continue
            seq = fa.fetch(chrom, start, min(end, fa.get_reference_length(chrom)))
            key = generate_key_from_sequence(seq, DEFAULT_FLOW_ORDER, non_standard_as_a=True)
            if len(key) == 0:
                continue
            if chrom not in names:
                names.append(chrom)
            k2base = key_to_base_index(key)
            take = int(np.ceil(sampling_fractions[i] * max_number_to_collect))
            flows = np.flatnonzero((key >= 1) & (key <= max_hpol_length))
            cls = (key[flows] - 1) * cycle + flows % cycle  # (length, nucleotide) class, in loop order
            order = np.argsort(cls, kind="stable")  # each class's flows stay ascending
            bounds = np.searchsorted(cls[order], np.arange(max_hpol_length * cycle + 1))
            for c in range(max_hpol_length * cycle):
                lo, hi = bounds[c], bounds[c + 1]
                if lo == hi:
                    continue
                locs = rng.permutation(flows[order[lo:hi]])[:take]
                rows = np.empty((len(locs), 4), dtype=np.int64)
                rows[:, 0] = names.index(chrom)
                rows[:, 1] = k2base[locs] + start
                rows[:, 2] = c // cycle + 1
                rows[:, 3] = c % cycle
                parts.append(rows)
    table = np.concatenate(parts) if parts else np.zeros((0, 4), dtype=np.int64)
    rank = np.argsort(np.argsort(np.array(names, dtype=object)))  # each contig's place in string order
    sort_key = rank[table[:, 0]] * (int(table[:, 1].max(initial=0)) + 1) + table[:, 1] if len(table) else table[:, 1]
    return names, table[np.argsort(sort_key, kind="stable")]


def write_hpol_table(hpol: tuple[list[str], np.ndarray], output: str) -> None:
    names, table = hpol
    with open(output, "w", encoding="utf-8") as fh:
        fh.write("".join(f"{names[c]}\t{p}\t{h}\t{DEFAULT_FLOW_ORDER[n]}\n"
                         for c, p, h, n in table.tolist()))


def run(argv: list[str]):
    ap = argparse.ArgumentParser(prog="collect_hpol_table", description="Collect homopolymer locations")
    ap.add_argument("--reference", required=True, help="Reference genome")
    ap.add_argument("--collection_regions", required=True, help="bed file with regions to collect from")
    ap.add_argument("--output", required=True, help="Homopolymer table")
    ap.add_argument("--max_hpol_length", default=20, type=int)
    ap.add_argument("--max_number_to_collect", default=100000, type=int)
    args = ap.parse_args(argv)
    fractions = plan_sampling(args.collection_regions)
    table = collect_homopolymers(
        args.reference, args.collection_regions, args.max_hpol_length, args.max_number_to_collect, fractions
    )
    write_hpol_table(table, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
