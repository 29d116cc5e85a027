"""run_comparison_pipeline: compare a callset to ground truth.

Counterpart of ``variantcalling_tpu/pipelines/run_comparison.py``, with
the same arguments plus ``--backend gpu|cpu`` (default ``gpu``: the card;
asking for it without one exits 2). It writes the per-contig concordance
h5 (one key a contig, through ``utils/h5_utils``, no pandas) and the BED
of the intersected intervals. The matching is host code: the haplotype
matcher (``comparison.matcher``; the native engine's, else its Python
specification) or, with ``--concordance_tool GC``, exact-position joins.
The annotation is the port's ``featurize.featurize`` on the run's device.
The concordance frame (``utils.h5_utils.Frame``) is sorted by (chrom,
pos), stably, as the reference's ``sort_values`` sorts it.

Genotype columns are stored as "a/b" strings. ``--n_jobs`` is accepted
and not used.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np
import torch

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.comparison.matcher import make_side, match_contig
from variantcalling_tpu_torch.featurize import featurize
from variantcalling_tpu_torch.io import bed as bedio
from variantcalling_tpu_torch.io.fasta import FastaReader
from variantcalling_tpu_torch.io.vcf import VariantTable, read_vcf
from variantcalling_tpu_torch.ops import intervals as iops
from variantcalling_tpu_torch.utils.stages import stage
from variantcalling_tpu_torch.utils.h5_utils import Frame, concat_frames, write_frames, write_hdf

log = logging.getLogger(__name__)


def parse_args(argv: list[str]):
    ap = argparse.ArgumentParser(prog="run_comparison_pipeline", description=run.__doc__)
    ap.add_argument("--n_parts", type=int, default=0, help="Number of parts the VCF is split into")
    ap.add_argument("--input_prefix", required=True, help="Prefix of the input file (or full path)")
    ap.add_argument("--output_file", required=True, help="Output h5 file")
    ap.add_argument("--output_interval", required=True, help="Output bed of intersected intervals")
    ap.add_argument("--gtr_vcf", required=True, help="Ground truth VCF")
    ap.add_argument("--cmp_intervals", help="Ranges on which to perform comparison (bed/interval_list)")
    ap.add_argument("--highconf_intervals", required=True, help="High confidence intervals")
    ap.add_argument("--runs_intervals", help="Runs intervals (bed/interval_list)")
    ap.add_argument("--annotate_intervals", action="append", default=[])
    ap.add_argument("--reference", required=True, help="Reference FASTA")
    ap.add_argument("--reference_dict", help="(accepted for drop-in compatibility; unused)")
    ap.add_argument("--coverage_bw_high_quality", action="append", default=None,
                    help="BigWig file with coverage only on high mapq reads")
    ap.add_argument("--coverage_bw_all_quality", action="append", default=None,
                    help="BigWig file with coverage on all mapq reads")
    ap.add_argument("--call_sample_name", default="sm1")
    ap.add_argument("--truth_sample_name", default="HG001")
    ap.add_argument("--header_file", help="(accepted; unused)")
    ap.add_argument("--filter_runs", action="store_true")
    ap.add_argument("--hpol_filter_length_dist", nargs=2, type=int, default=[10, 10])
    ap.add_argument("--ignore_filter_status", action="store_true")
    ap.add_argument("--flow_order", default="TGCA")
    ap.add_argument("--output_suffix", default="")
    ap.add_argument("--concordance_tool", default="native",
                    choices=["native", "VCFEVAL", "vcfeval", "GC"],
                    help="native/vcfeval: haplotype matcher (VCFEVAL-equivalent); "
                         "GC: exact-position GenotypeConcordance joins")
    ap.add_argument("--disable_reinterpretation", action="store_true",
                    help="skip the haplotype-rescue (representation repair) matching stage")
    ap.add_argument("--is_mutect", action="store_true")
    ap.add_argument("--n_jobs", type=int, default=-1, help="(accepted; the device owns parallelism)")
    ap.add_argument("--verbosity", default="INFO")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def _input_path(prefix: str, n_parts: int) -> list[str]:
    if os.path.exists(prefix):
        return [prefix]
    if n_parts and n_parts > 1:
        parts = []
        for i in range(1, n_parts + 1):
            for ext in (f"{prefix}.{i}.vcf.gz", f"{prefix}.{i}.vcf"):
                if os.path.exists(ext):
                    parts.append(ext)
                    break
        if parts:
            return parts
    for ext in (prefix + ".vcf.gz", prefix + ".vcf"):
        if os.path.exists(ext):
            return [ext]
    raise FileNotFoundError(f"no VCF found for prefix {prefix!r}")


def _concat_tables(tables: list[VariantTable]) -> VariantTable:
    """Tables one after the other, the first one's header; the scan's
    arrays (spans into each part's own text) are dropped, so FORMAT values
    are read from the text."""
    if len(tables) == 1:
        return tables[0]
    cols = {f: np.concatenate([getattr(t, f) for t in tables])
            for f in ("chrom", "pos", "vid", "ref", "alt", "qual", "filters", "info", "tail", "qual_text")}
    return VariantTable(tables[0].header, cols["chrom"], cols["pos"], cols["vid"], cols["ref"], cols["alt"],
                        cols["qual"], cols["filters"], cols["info"], cols["tail"], qual_text=cols["qual_text"])


def _gt_strings(table: VariantTable) -> np.ndarray:
    """Each record's genotype as "a/b" text ("." for a missing allele), an object array."""
    gts = table.genotypes().astype(np.int64)
    half = [np.where(gts[:, j] >= 0, gts[:, j].astype(str), ".") for j in range(2)]
    return np.char.add(np.char.add(half[0], "/"), half[1]).astype(object)


def _restrict(table: VariantTable, intervals: bedio.IntervalSet) -> VariantTable:
    if intervals is None or len(intervals) == 0:
        return table
    return table.subset(np.asarray(intervals.contains(np.asarray(table.chrom), table.pos - 1)))


class _GCResult:
    """match_contig-shaped result from the genotype-concordance join."""

    __slots__ = ("call_tp", "call_tp_gt", "truth_tp", "truth_tp_gt", "call_truth_idx")

    def __init__(self, call_tp, call_tp_gt, truth_tp, truth_tp_gt, call_truth_idx):
        self.call_tp = call_tp
        self.call_tp_gt = call_tp_gt
        self.truth_tp = truth_tp
        self.truth_tp_gt = truth_tp_gt
        self.call_truth_idx = call_truth_idx


def genotype_concordance_match(calls: VariantTable, truth: VariantTable) -> _GCResult:
    """The "GC" comparison flavor (``--concordance_tool GC``): exact position
    joins, no haplotype search. A call is tp when a truth record at the same
    pos carries an overlapping called ALT allele; tp_gt also needs the same
    called-allele multiset."""
    def called_alleles(table):
        gts = table.genotypes()
        out = []
        for i in range(len(table)):
            alleles = [table.ref[i]] + ([] if table.alt[i] in (".", "") else table.alt[i].split(","))
            called = [alleles[a] for a in gts[i] if 0 <= a < len(alleles)]
            alt_called = {alleles[a] for a in gts[i] if 0 < a < len(alleles)}
            out.append((tuple(sorted(called)), alt_called))
        return out

    c_all = called_alleles(calls)
    t_all = called_alleles(truth)
    # every truth record a position: a call matches against any of them
    t_by_pos: dict[int, list[int]] = {}
    for j in range(len(truth)):
        t_by_pos.setdefault(int(truth.pos[j]), []).append(j)

    n_c, n_t = len(calls), len(truth)
    call_tp = np.zeros(n_c, dtype=bool)
    call_tp_gt = np.zeros(n_c, dtype=bool)
    truth_tp = np.zeros(n_t, dtype=bool)
    truth_tp_gt = np.zeros(n_t, dtype=bool)
    call_truth_idx = np.full(n_c, -1, dtype=np.int64)
    for i in range(n_c):
        cands = t_by_pos.get(int(calls.pos[i]), [])
        if not cands:
            continue
        best, exact = -1, False
        for j in cands:
            if c_all[i][1] & t_all[j][1]:
                if c_all[i][0] == t_all[j][0]:
                    best, exact = j, True
                    break
                if best < 0:
                    best = j
        call_truth_idx[i] = best  # unmatched calls keep -1, as the haplotype matcher's do
        if best >= 0:
            call_tp[i] = truth_tp[best] = True
            if exact:
                call_tp_gt[i] = truth_tp_gt[best] = True
    return _GCResult(call_tp, call_tp_gt, truth_tp, truth_tp_gt, call_truth_idx)


def _alts(table: VariantTable) -> list[list[str]]:
    return [a.split(",") if a not in (".", "") else [] for a in table.alt]


def match_calls(calls: VariantTable, truth: VariantTable, fasta: FastaReader, reinterpret: bool = True,
                tool: str = "native"):
    """(call_tp, call_tp_gt, truth_tp, call_truth_gt) over contigs the
    reference has, contig by contig (the truth's tp flag, call_tp_gt's
    counterpart, is not kept: the frame does not carry it)."""
    contigs = list(dict.fromkeys(list(calls.chrom) + list(truth.chrom)))
    call_tp = np.zeros(len(calls), dtype=bool)
    call_tp_gt = np.zeros(len(calls), dtype=bool)
    truth_tp = np.zeros(len(truth), dtype=bool)
    call_truth_gt = np.full(len(calls), "./.", dtype=object)
    c_chrom, t_chrom = np.asarray(calls.chrom), np.asarray(truth.chrom)
    for contig in contigs:
        cm = c_chrom == contig
        tm = t_chrom == contig
        if contig not in fasta.references:
            continue
        c_sub, t_sub = calls.subset(cm), truth.subset(tm)
        if tool == "GC":
            res = genotype_concordance_match(c_sub, t_sub)
        else:
            # only the haplotype matcher needs the contig sequence
            seq = fasta.fetch(contig, 0, fasta.get_reference_length(contig))
            cs = make_side(c_sub.pos, list(c_sub.ref), _alts(c_sub), c_sub.genotypes())
            ts = make_side(t_sub.pos, list(t_sub.ref), _alts(t_sub), t_sub.genotypes())
            res = match_contig(cs, ts, seq, haplotype_rescue=reinterpret)
        call_tp[cm] = res.call_tp
        call_tp_gt[cm] = res.call_tp_gt
        truth_tp[tm] = res.truth_tp
        t_gt = _gt_strings(t_sub) if tm.any() else np.array([], object)
        matched = res.call_truth_idx >= 0
        sub = call_truth_gt[cm]
        sub[matched] = t_gt[res.call_truth_idx[matched]]
        call_truth_gt[cm] = sub
    return call_tp, call_tp_gt, truth_tp, call_truth_gt


def build_concordance_frame(
    calls: VariantTable,
    truth: VariantTable,
    fasta: FastaReader,
    annotate_intervals: dict[str, bedio.IntervalSet] | None = None,
    runs_intervals: bedio.IntervalSet | None = None,
    hpol_length: int = 10,
    hpol_dist: int = 10,
    flow_order: str = "TGCA",
    is_mutect: bool = False,
    reinterpret: bool = True,
    tool: str = "native",
    device: torch.device | str = "gpu",
) -> Frame:
    """Match + annotate -> one concordance frame over calls and the truth's fns.

    ``reinterpret=False`` (``--disable_reinterpretation``) turns off the
    matcher's haplotype-rescue stage, leaving exact-representation joins.
    The annotation (``featurize``) runs on ``device``."""
    with stage("match", device_mod.as_device(device)):
        call_tp, call_tp_gt, truth_tp, call_truth_gt = match_calls(calls, truth, fasta, reinterpret, tool)
    fn_truth = truth.subset(~truth_tp)

    frames = []
    with stage("annotate", device_mod.as_device(device)):
        for table, is_call in ((calls, True), (fn_truth, False)):
            if len(table) == 0:
                continue
            frames.append(_annotated_frame(table, fasta, annotate_intervals, flow_order, is_mutect, device,
                                           (call_tp, call_tp_gt, call_truth_gt) if is_call else None))

    df = concat_frames(frames) if frames else Frame({})
    if len(df):
        _, chrom_code = np.unique(np.asarray(df["chrom"], dtype=object), return_inverse=True)
        order = np.lexsort((np.asarray(df["pos"]), chrom_code.reshape(-1)))
        df = Frame({c: np.asarray(v)[order] for c, v in df.data.items()})
        if runs_intervals is not None and len(runs_intervals):
            keep = (runs_intervals.end - runs_intervals.start) >= hpol_length
            runs = bedio.IntervalSet(runs_intervals.chrom[keep], runs_intervals.start[keep],
                                     runs_intervals.end[keep])
            contig_lengths = {c: fasta.get_reference_length(c) for c in fasta.references}
            coords = iops.GenomeCoords(contig_lengths)
            gpos = coords.globalize(np.asarray(df["chrom"]), np.asarray(df["pos"]) - 1)
            if len(runs):
                gs, ge = coords.globalize_intervals(runs)
                df["hpol_run"] = np.asarray(iops.distance_to_nearest(gpos, gs, ge) <= hpol_dist)
            else:
                df["hpol_run"] = False
        else:
            df["hpol_run"] = False
    return df


def _annotated_frame(table: VariantTable, fasta: FastaReader, annotate_intervals, flow_order: str, is_mutect: bool,
                     device, call_match) -> Frame:
    """The frame of one side: the calls (``call_match``: their tp flags and
    matched truth genotypes) or the truth's fns (``call_match`` None)."""
    fs = featurize(table, fasta, annotate_intervals=annotate_intervals, flow_order=flow_order,
                   extra_info_fields=["TLOD"] if is_mutect else [], device=device)
    n = len(table)
    cols: dict[str, np.ndarray] = {
        "chrom": np.asarray(table.chrom),
        "pos": table.pos,
        "ref": np.asarray(table.ref),
        "alleles": np.asarray(table.alt),
        "qual": np.nan_to_num(table.qual, nan=0.0),
        "filter": _filters_norm(table),
    }
    for f in ("dp", "af", "gq", "indel_length", "hmer_indel_length", "hmer_indel_nuc",
              "gc_content", "left_motif", "right_motif", "cycleskip_status", "sor"):
        cols[f] = np.asarray(fs.columns[f])
    cols["vaf"] = cols.pop("af")
    cols["indel"] = np.asarray(fs.columns["is_indel"], dtype=bool)
    is_ins = np.asarray(fs.columns["is_ins"], dtype=bool)
    ic = np.full(n, None, dtype=object)
    ic[is_ins] = "ins"
    ic[cols["indel"] & ~is_ins] = "del"
    cols["indel_classify"] = ic
    cols["tree_score"] = table.info_field("TREE_SCORE")
    cols["ad"] = np.asarray([",".join(f"{int(v)}" for v in row if v >= 0) for row in table.format_numeric("AD")],
                            dtype=object)
    for name in (annotate_intervals or {}):
        cols[name] = np.asarray(fs.columns[name], dtype=bool)
    if call_match is not None:
        call_tp, call_tp_gt, call_truth_gt = call_match
        cols["classify"] = np.where(call_tp, "tp", "fp").astype(object)
        cols["classify_gt"] = np.where(call_tp_gt, "tp", "fp").astype(object)
        cols["call"] = np.where(call_tp, "TP", "FP").astype(object)
        cols["base"] = np.where(call_tp, "TP", None)
        cols["gt_ultima"] = _gt_strings(table)
        cols["gt_ground_truth"] = call_truth_gt
    else:
        cols["classify"] = np.full(n, "fn", dtype=object)
        cols["classify_gt"] = np.full(n, "fn", dtype=object)
        cols["call"] = np.full(n, "NA", dtype=object)
        cols["base"] = np.full(n, "FN", dtype=object)
        cols["gt_ultima"] = np.full(n, "./.", dtype=object)
        cols["gt_ground_truth"] = _gt_strings(table)
    cols["blacklst"] = np.full(n, "", dtype=object)
    return Frame(cols)


def _filters_norm(table: VariantTable) -> np.ndarray:
    return np.asarray(["PASS" if f in (".", "", None) else f for f in table.filters], dtype=object)


def annotate_coverage(df: Frame, bw_high: list[str] | None, bw_all: list[str] | None) -> None:
    """Per-variant coverage columns from bigWig tracks (in place):
    ``well_mapped_coverage`` from the high-mapq track(s), ``coverage`` from
    the all-mapq track(s); several files a flag are read in turn, the first
    value a position keeps."""
    from variantcalling_tpu_torch.io.bigwig import BigWigReader

    max_span = 1 << 22  # decode at most 4 Mb a query window
    chrom = np.asarray(df["chrom"], dtype=object)
    pos = np.asarray(df["pos"])
    for name, paths in (("well_mapped_coverage", bw_high), ("coverage", bw_all)):
        if not paths:
            continue
        out = np.full(len(df), np.nan)
        readers = [BigWigReader(p) for p in paths]
        try:
            for contig in dict.fromkeys(chrom.tolist()):
                m = chrom == contig
                pos0 = pos[m] - 1
                order = np.argsort(pos0)
                sorted_pos = pos0[order]
                vals = np.full(m.sum(), np.nan)
                for bw in readers:
                    if bw.chroms(str(contig)) is None:
                        continue
                    # bounded windows over the sorted positions: a whole-chromosome span decodes GB-scale arrays
                    got_sorted = np.full(len(sorted_pos), np.nan)
                    i = 0
                    while i < len(sorted_pos):
                        lo = int(sorted_pos[i])
                        j = int(np.searchsorted(sorted_pos, lo + max_span, side="left"))
                        hi = int(sorted_pos[j - 1]) + 1
                        window = bw.values(str(contig), lo, hi)
                        got_sorted[i:j] = window[sorted_pos[i:j] - lo]
                        i = j
                    got = np.empty_like(got_sorted)
                    got[order] = got_sorted
                    vals = np.where(np.isnan(vals), got, vals)
                out[m] = vals
        finally:
            for bw in readers:
                bw.close()
        df[name] = out


def run(argv: list[str]) -> int:
    """Compare VCF to ground truth."""
    args = parse_args(argv)
    logging.getLogger("variantcalling_tpu_torch").setLevel(getattr(logging, args.verbosity))
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2

    with stage("ingest", device):
        paths = _input_path(args.input_prefix, args.n_parts)
        log.info("reading calls: %s", paths)
        calls = _concat_tables([read_vcf(p) for p in paths])
        truth = read_vcf(args.gtr_vcf)
        highconf = bedio.read_intervals(args.highconf_intervals)
        region = highconf
        if args.cmp_intervals:
            region = highconf.intersect(bedio.read_intervals(args.cmp_intervals))
        bedio.write_bed(args.output_interval, region)
        calls = _restrict(calls, region)
        truth = _restrict(truth, region)
    log.info("restricted to %d calls, %d truth variants", len(calls), len(truth))

    annotate = {}
    for path in args.annotate_intervals:
        name = os.path.basename(path)
        for suf in (".gz", ".bed", ".interval_list"):
            name = name[: -len(suf)] if name.endswith(suf) else name
        annotate[name] = bedio.read_intervals(path)
    runs = bedio.read_intervals(args.runs_intervals) if args.runs_intervals else None

    with FastaReader(args.reference) as fasta:
        df = build_concordance_frame(
            calls, truth, fasta,
            annotate_intervals=annotate,
            runs_intervals=runs,
            hpol_length=args.hpol_filter_length_dist[0],
            hpol_dist=args.hpol_filter_length_dist[1],
            flow_order=args.flow_order,
            is_mutect=args.is_mutect,
            reinterpret=not args.disable_reinterpretation,
            tool=args.concordance_tool,
            device=device,
        )

    if len(df) and (args.coverage_bw_high_quality or args.coverage_bw_all_quality):
        with stage("coverage", device):
            annotate_coverage(df, args.coverage_bw_high_quality, args.coverage_bw_all_quality)

    with stage("writes", device):
        if len(df):
            chrom = np.asarray(df["chrom"], dtype=object)
            write_frames(args.output_file, {str(c): df.take(chrom == c) for c in dict.fromkeys(chrom.tolist())})
        else:
            write_hdf(df, args.output_file, key="all", mode="w")
    log.info("wrote %d rows to %s on %s", len(df), args.output_file, device)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
