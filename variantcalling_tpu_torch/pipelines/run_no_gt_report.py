"""run_no_gt_report: callset statistics without ground truth.

Counterpart of ``variantcalling_tpu/pipelines/run_no_gt_report.py``, with its
three subcommands and arguments, each with ``--backend gpu|cpu`` (default
``gpu``: the card; asking for it without one exits 2):

- ``full_analysis``: the VariantEval-style tables (``reports/variant_eval``),
  the hmer indel tables, the per-type AF histogram, the SNP motifs and the
  ID83/DBS78 spectra (``reports/no_gt_stats``, ``reports/signatures``), the
  variant-type counts and the strided AF scatter, into ``<prefix>.h5`` under
  the reference's keys, columns and dtypes;
- ``variant_eval``: the eval tables alone;
- ``somatic_analysis``: the SBS96, ID83 and DBS78 matrices of the case and
  any controls as ``<prefix>.{SBS96,ID83,DBS78}.all``, then, given
  catalogs, the exposures fitted on the run's device
  (``signature_exposures``) and the case-vs-control enrichment
  (``signature_control_comparison``); without a catalog, the reference's
  SigProfilerAssignment branch (a warning where it is not installed).
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
from variantcalling_tpu_torch.io.bed import read_bed
from variantcalling_tpu_torch.io.fasta import FastaReader
from variantcalling_tpu_torch.io.vcf import read_vcf
from variantcalling_tpu_torch.reports import no_gt_stats
from variantcalling_tpu_torch.reports import signatures as sigmod
from variantcalling_tpu_torch.reports.variant_eval import compute_eval_tables, dbsnp_membership
from variantcalling_tpu_torch.utils.h5_utils import Frame, concat_frames, object_column, write_frames, write_hdf
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)

#: at most this many rows in ``af_scatter``: an even stride over the records with an AF
SCATTER_ROWS = 50_000
CATALOGS = ("SBS96", "ID83", "DBS78")


def _sample_index(table, sample_id: int | None, sample_name: str | None) -> int:
    if sample_name is not None and sample_name in table.header.samples:
        return table.header.samples.index(sample_name)
    return sample_id or 0


def value_counts(values: np.ndarray) -> tuple[list, np.ndarray]:
    """(values, counts) as ``pd.Series(values).value_counts()`` orders them:
    count descending, ties in order of first appearance."""
    uniq = no_gt_stats.unique_in_order(values)
    counts = np.array([int(np.count_nonzero(values == u)) for u in uniq], dtype=np.int64)
    order = np.argsort(-counts, kind="stable")
    return [uniq[i] for i in order], counts[order]


def _indel_records(table):
    """(chrom, pos, REF, first-ALT) of each record whose REF and first ALT differ in length."""
    chrom = np.asarray(table.chrom)
    refs = np.asarray(table.ref)
    alts = np.asarray(table.alt)
    return ((chrom[i], int(table.pos[i]), refs[i].upper(), alts[i].split(",")[0].upper())
            for i in range(len(table)) if len(refs[i]) != len(alts[i].split(",")[0]))


def _channel_frame(labels: list[str], counts: np.ndarray) -> Frame:
    return Frame({"channel": object_column(labels), "size": counts})


def _eval_frames(args, table, sample: int, device: torch.device) -> dict[str, Frame]:
    with stage("dbsnp", device):
        known = dbsnp_membership(table, args.dbsnp) if args.dbsnp else None
    with stage("eval", device):
        return compute_eval_tables(table, known=known, sample=sample, device=device)


def _af_scatter(table, af: np.ndarray, sample: int) -> Frame:
    """The AF of each record with one, and its depth (INFO/DP, else the
    sample's FORMAT/DP), at an even stride of at most :data:`SCATTER_ROWS` rows."""
    dp = table.info_field("DP")
    if np.all(np.isnan(dp)):
        dp = table.format_numeric("DP", sample=sample, max_len=1, missing=np.nan)[:, 0]
    idx = np.nonzero(~np.isnan(af))[0]
    if len(idx) > SCATTER_ROWS:
        idx = idx[:: len(idx) // SCATTER_ROWS]
    return Frame({"chrom": object_column(np.asarray(table.chrom)[idx].tolist()), "pos": table.pos[idx],
                  "af": af[idx].astype(np.float32), "dp": dp[idx].astype(np.float32)})


def run_full_analysis(args, device: torch.device) -> None:
    frames: dict[str, Frame] = {}
    if args.callable_region is not None:
        bed = read_bed(args.callable_region)
        frames["callable_size"] = Frame({"callable_size": np.array([int(np.sum(bed.end - bed.start))],
                                                                   dtype=np.int64)})
    with stage("ingest", device):
        table = read_vcf(args.input_file)
    sample = _sample_index(table, args.sample_id, args.sample_name)
    eval_tables = _eval_frames(args, table, sample, device)
    with stage("annotate", device):
        cols, windows, hmer_len, hmer_nuc = no_gt_stats._annotate(table, args.reference, device)
    with stage("statistics", device):
        ins_del = no_gt_stats.insertion_deletion_statistics(table, cols, hmer_len, hmer_nuc, sample=sample,
                                                            device=device)
        vtype = no_gt_stats.variant_type_labels(cols, hmer_len)
        af = no_gt_stats._compute_af(table, sample=sample)
        af_df = no_gt_stats.allele_freq_hist(table, vtype, sample=sample, af=af, device=device)
        motifs = no_gt_stats.snp_statistics(table, cols, windows, device=device)
    with stage("spectra", device):
        with FastaReader(args.reference) as fa:
            id83 = sigmod.id83_matrix(_indel_records(table), fa)
        dbs78 = sigmod.dbs78_matrix(table)
    frames["ins_del_hete"] = no_gt_stats.hmer_frame(ins_del["hete"])
    frames["ins_del_homo"] = no_gt_stats.hmer_frame(ins_del["homo"])
    frames["af_hist"] = af_df
    frames["snp_motifs"] = no_gt_stats.motif_frame(motifs)
    frames["id83_channels"] = _channel_frame(sigmod.id83_labels(), id83)
    frames["dbs78_channels"] = _channel_frame(sigmod.dbs78_labels(), dbs78)
    frames.update({f"eval_{name}": tbl for name, tbl in eval_tables.items()})
    types, counts = value_counts(vtype)
    frames["variants_statistics"] = Frame({"variant_type": object_column(types), "count": counts})
    frames["af_scatter"] = _af_scatter(table, af, sample)
    with stage("writes", device):
        write_frames(f"{args.output_prefix}.h5", frames)
    log.info("wrote %s.h5", args.output_prefix)


def run_eval_tables_only(args, device: torch.device) -> None:
    with stage("ingest", device):
        table = read_vcf(args.input_file)
    sample = _sample_index(table, args.sample_id, args.sample_name)
    eval_tables = _eval_frames(args, table, sample, device)
    with stage("writes", device):
        write_frames(f"{args.output_prefix}.h5", {f"eval_{name}": tbl for name, tbl in eval_tables.items()})


def _somatic_matrices(vcf_path: str, reference: str, device: torch.device) -> dict[str, tuple[list[str], np.ndarray]]:
    """{catalog: (channel labels, counts)} of one callset: SBS96 (adjacent-SNV
    doublets excluded), ID83 and DBS78."""
    table = read_vcf(vcf_path)
    cols, windows, _hmer_len, _hmer_nuc = no_gt_stats._annotate(table, reference, device)
    dbs, paired = sigmod.dbs78_matrix(table, return_paired=True)
    sbs = no_gt_stats.snp_statistics(table, cols, windows, exclude=paired, device=device)
    sbs_labels = [f"{m[0]}[{m[1]}>{a}]{m[2]}" for (m, a) in no_gt_stats.motif_index_96()]
    with FastaReader(reference) as fa:
        id83 = sigmod.id83_matrix(_indel_records(table), fa)
    return {"SBS96": (sbs_labels, sbs), "ID83": (sigmod.id83_labels(), id83), "DBS78": (sigmod.dbs78_labels(), dbs)}


def _unique_name(base: str, taken: set[str]) -> str:
    """Basename-derived sample names must not collide."""
    name, k = base, 2
    while name in taken:
        name = f"{base}_{k}"
        k += 1
    return name


def _fit_catalog(counts_by_sample: dict[str, tuple[list[str], np.ndarray]], catalog_path: str,
                 metadata: dict | None, catalog_name: str, device: torch.device) -> Frame:
    """Exposures of every sample against one catalog, fitted on ``device``."""
    labels, names, mat = sigmod.load_signature_matrix(catalog_path)
    samples = list(counts_by_sample)
    channels = counts_by_sample[samples[0]][0]
    catalog = sigmod.align_catalog(labels, mat, channels)
    counts = np.stack([counts_by_sample[s][1] for s in samples])
    exposures = sigmod.sparsify_exposures(sigmod.fit_signatures(counts, catalog, device=device))
    tbl = sigmod.assignment_table(exposures, names, metadata, samples)
    cols = list(tbl.columns)
    data = {c: tbl[c] for c in cols[:1]}
    data["catalog"] = object_column([catalog_name] * len(tbl))
    data.update({c: tbl[c] for c in cols[1:]})
    return Frame(data)


def control_comparison(tbl: Frame, case_name: str) -> Frame:
    """The reference's ``pivot_table`` enrichment: each (catalog, signature)
    in sorted order, the case's fraction (0 where it has none), the controls'
    mean fraction (each control 0 where it has none) and their ratio."""
    keys = sorted(set(zip(tbl["catalog"].tolist(), tbl["signature"].tolist())))
    samples = sorted(set(tbl["sample"].tolist()))
    pos = {k: i for i, k in enumerate(keys)}
    frac = np.zeros((len(keys), len(samples)))
    col = {s: j for j, s in enumerate(samples)}
    for c, g, s, f in zip(tbl["catalog"].tolist(), tbl["signature"].tolist(), tbl["sample"].tolist(),
                          tbl["fraction"].tolist()):
        frac[pos[(c, g)], col[s]] = f
    case = frac[:, col[case_name]] if case_name in col else np.zeros(len(keys))
    ctrl = [col[s] for s in samples if s != case_name]
    total = np.zeros(len(keys))
    for j in ctrl:  # the row sum left to right, as pandas' mean(axis=1) adds the columns
        total = total + frac[:, j]
    ctrl_mean = total / len(ctrl)
    return Frame({"catalog": object_column([k[0] for k in keys]), "signature": object_column([k[1] for k in keys]),
                  "case_fraction": case, "control_mean_fraction": ctrl_mean,
                  "enrichment": case / np.maximum(ctrl_mean, 1e-9)})


def run_somatic_analysis(args, device: torch.device) -> None:
    prefix_name = args.output_prefix.split("/")[-1]
    with stage("matrices", device):
        case = _somatic_matrices(args.input_file, args.reference, device)
        controls = {}
        for path in (args.control_vcfs or []):
            name = _unique_name(path.split("/")[-1].removesuffix(".gz").removesuffix(".vcf"),
                                set(controls) | {prefix_name})
            controls[name] = _somatic_matrices(path, args.reference, device)
    for cat in CATALOGS:
        labels, counts = case[cat]
        df = Frame({"MutationType": object_column(labels), prefix_name: counts})
        for name, mats in controls.items():
            df[name] = mats[cat][1]
        path = f"{args.output_prefix}.{cat}.all"
        df.to_csv(path, sep="\t")
        log.info("wrote %s matrix: %s", cat, path)

    catalog_paths = {"SBS96": args.signatures_file, "ID83": args.id_signatures_file,
                     "DBS78": args.dbs_signatures_file}
    if any(catalog_paths.values()):
        meta = sigmod.load_signature_metadata(args.signatures_metadata) if args.signatures_metadata else None
        tables = []
        with stage("fit", device):
            for cat, cpath in catalog_paths.items():
                if not cpath:
                    continue
                by_sample = {prefix_name: case[cat]}
                by_sample.update({name: mats[cat] for name, mats in controls.items()})
                tables.append(_fit_catalog(by_sample, cpath, meta, cat, device))
        tbl = concat_frames(tables)
        tbl.index = None  # ignore_index
        out_h5 = f"{args.output_prefix}.h5"
        with stage("writes", device):  # added to the file a full_analysis of the same prefix wrote, if any
            write_hdf(tbl, out_h5, key="signature_exposures", mode="a")
            log.info("fitted exposures over %d catalog(s), %d sample(s)", len(tables), 1 + len(controls))
            if controls:
                write_hdf(control_comparison(tbl, prefix_name), out_h5, key="signature_control_comparison",
                          mode="a")
        return
    try:  # optional external signature assignment
        from SigProfilerAssignment import Analyzer as Analyze  # type: ignore

        Analyze.cosmic_fit(samples=f"{args.output_prefix}.SBS96.all", output=f"{args.output_prefix}_sig",
                           input_type="matrix", cosmic_version=float(args.cosmic_version))
    except ImportError:
        log.warning("SigProfilerAssignment not installed and no --signatures_file given; skipping fitting")


def parse_args(argv: list[str]):
    ap = argparse.ArgumentParser(prog="run_no_gt_report", description="Collect metrics for runs without ground truth")
    sub = ap.add_subparsers(dest="cmd", required=True)

    full = sub.add_parser("full_analysis", description="Run the full analysis of no_gt_report")
    full.add_argument("--input_file", required=True)
    full.add_argument("--dbsnp", required=True)
    full.add_argument("--reference", required=True)
    full.add_argument("--output_prefix", required=True)
    full.add_argument("--sample_id", type=int, default=0)
    full.add_argument("--sample_name", type=str, default=None)
    full.add_argument("--callable_region", type=str, default=None)
    full.set_defaults(func=run_full_analysis)

    ev = sub.add_parser("variant_eval", description="Run variant eval only")
    ev.add_argument("--input_file", required=True)
    ev.add_argument("--dbsnp", required=True)
    ev.add_argument("--reference", required=True)
    ev.add_argument("--output_prefix", required=True)
    ev.add_argument("--sample_name", type=str, default=None)
    ev.add_argument("--sample_id", type=int, default=None)
    ev.add_argument("--annotation_names", nargs="*", default=None)
    ev.set_defaults(func=run_eval_tables_only)

    som = sub.add_parser("somatic_analysis", description="Run mutation signatures and motif graphs")
    som.add_argument("--input_file", required=True)
    som.add_argument("--reference", required=True, help="Reference FASTA (for motif windows)")
    som.add_argument("--reference_name", type=str, default="GRCh38")
    som.add_argument("--output_prefix", required=True)
    som.add_argument("--cosmic_version", type=str, default="3.3")
    som.add_argument("--signatures_file", default=None,
                     help="COSMIC-style SBS96 signature matrix (tsv) -> exposures fitted on the run's device")
    som.add_argument("--id_signatures_file", default=None, help="COSMIC ID83 signature matrix (tsv)")
    som.add_argument("--dbs_signatures_file", default=None, help="COSMIC DBS78 signature matrix (tsv)")
    som.add_argument("--signatures_metadata", default=None,
                     help="cosmic_signatures json (descriptions/links) for annotation")
    som.add_argument("--control_vcfs", nargs="*", default=None,
                     help="control-cohort VCFs: exposures fitted per control plus a "
                          "case-vs-control enrichment table (signature_control_comparison)")
    som.set_defaults(func=run_somatic_analysis)
    for p in (full, ev, som):
        p.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def run(argv: list[str]) -> int:
    args = parse_args(argv)
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    args.func(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
