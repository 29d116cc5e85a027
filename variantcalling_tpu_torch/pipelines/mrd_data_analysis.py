"""mrd_data_analysis — automatic MRD analysis report.

Counterpart of ``variantcalling_tpu/pipelines/mrd_data_analysis.py``, without
pandas, with the same arguments (no device program runs: no
``--backend``), and the same h5 keys and HTML:

- the filters applied: each term of the read and signature queries with its
  description -> ``filters_applied``;
- the ``mrd_analysis`` summary (tumor fraction, interval, detection call);
- the matched signature: mutation types -> ``mutation_types``, allele
  fractions -> ``allele_fractions``, and the same for each control
  signature;
- tumor fractions for filtered/unfiltered reads x filtered/unfiltered
  signature -> ``df_tf_*`` and ``df_supporting_reads_per_locus_*``;
- ML_QUAL on and off the signature -> ``ml_qual_distribution``;
- cfDNA read lengths -> ``read_lengths``.

The query options are read by ``utils/frame_ops.eval_query`` (a whitelisted
``ast`` walk, never ``eval``) over the featuremap's and signature's INFO
columns; ``(chrom, pos)`` membership is membership of int64 locus keys
(``np.isin``); ``groupby(["chrom", "pos"]).size()`` a stable sort and run
lengths. Figures through ``reports/html.add_figure_safe``.
"""

from __future__ import annotations

import argparse
import logging
import re
import sys

import numpy as np

from variantcalling_tpu_torch.io.vcf import read_vcf
from variantcalling_tpu_torch.reports.html import HtmlReport, add_figure_safe
from variantcalling_tpu_torch.utils.frame_ops import eval_query, lexsort_rows, run_codes, value_counts
from variantcalling_tpu_torch.utils.h5_utils import Frame, concat_frames, object_column, read_hdf, write_hdf

log = logging.getLogger(__name__)

#: the filter glossary of the reference's report
FILTER_DESCRIPTIONS = {
    "ug_hcr": "In UG High Confidence Region",
    "giab_hcr": "In GIAB (HG001-007) High Confidence Region",
    "ug_mrd_blacklist": "Not in UG MRD Blacklist",
    "id": "Not in dbsnp",
    "af": "Allele fraction filter",
    "filtering_ratio": "Minimum ratio of reads passing read filters in locus",
    "norm_coverage": "Filtering by coverage, normalized to median",
    "X_SCORE": "Filtering by log likelihood score (effective BQ)",
    "X_EDIST": "Filtering by edit distance from the reference",
    "max_softclip_len": "Filtering by maximal softclip length",
    "X_LENGTH": "Filtering by fragment length",
    "rq": "Filtering by read quality",
    "ML_QUAL": "Filtering by single-read model quality",
}


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="mrd_data_analysis", description=run.__doc__)
    ap.add_argument("--mrd_summary_h5", required=True, help="mrd_analysis output")
    ap.add_argument("--featuremap", default=None, help="scored featuremap (srsnv_inference)")
    ap.add_argument("--signature_vcf", default=None)
    ap.add_argument("--control_signature_vcfs", nargs="*", default=None,
                    help="control signature VCFs (notebook cells 30-34: the "
                         "signature_type != 'matched' analyses) — mutation-type "
                         "and allele-fraction sections per control")
    ap.add_argument("--read_filter_query", default=None,
                    help="pandas query over featuremap INFO columns (e.g. 'ML_QUAL >= 40')")
    ap.add_argument("--signature_filter_query", default=None,
                    help="pandas query over signature INFO columns (e.g. 'AF >= 0.05')")
    ap.add_argument("--coverage_per_locus", type=float, default=None,
                    help="tumor-fraction denominator per locus (defaults from the summary h5)")
    ap.add_argument("--read_pass_fraction", type=float, default=1.0,
                    help="SRSNV test-set read pass fraction (denominator correction, notebook cell 20)")
    ap.add_argument("--h5_output", default="mrd_report.h5")
    ap.add_argument("--html_output", required=True)
    return ap.parse_args(argv)


def _query_identifiers(query: str) -> list[str]:
    keywords = {"and", "or", "not", "in", "True", "False"}
    return [t for t in dict.fromkeys(re.findall(r"[A-Za-z_][A-Za-z0-9_.]*", query))
            if t not in keywords and not t[0].isdigit()]


def describe_filters(query: str) -> Frame:
    """One row a filter term of ``query``, with its description."""
    terms, descriptions = [], []
    for term in re.split(r"\band\b", query.replace("(", "").replace(")", "")):
        term = term.strip()
        if not term:
            continue
        name = re.split(r"[<>=!\s]", term.removeprefix("not").strip())[0].strip()
        terms.append(term)
        descriptions.append(FILTER_DESCRIPTIONS.get(name, "<Description unavailable>"))
    return Frame({"query": object_column(terms), "description": object_column(descriptions)}) if terms else Frame({})


def _info_frame(table, query: str | None, extra: tuple[str, ...] = ()) -> Frame:
    """The featuremap's or signature's chrom, pos and the INFO columns a
    query (and the report) reads."""
    fields = set(extra)
    if query:
        fields.update(_query_identifiers(query))
    df = Frame({"chrom": np.asarray(table.chrom), "pos": np.asarray(table.pos)})
    for f in sorted(fields - {"chrom", "pos"}):  # the locus columns are never replaced
        df[f] = table.info_field(f)
    return df


def _apply_query(df: Frame, query: str | None) -> np.ndarray:
    if not query:
        return np.ones(len(df), dtype=bool)
    # a failed query raises: passing everything would publish unfiltered
    # numbers under the "filtered" keys of a clinical report
    return eval_query(df.data, query, len(df))


def locus_keys(*loci: tuple) -> list[np.ndarray]:
    """One int64 key a (chrom, pos), for each ``(chrom, pos)`` pair of arrays
    given, over one vocabulary of contig names: equal loci, equal keys."""
    names = [np.asarray(c).astype(str) if len(c) else np.zeros(0, dtype="U1") for c, _ in loci]
    vocab = np.unique(np.concatenate(names)) if names else np.zeros(0, dtype="U1")
    return [(np.searchsorted(vocab, c).astype(np.int64) << 34) | np.asarray(p, dtype=np.int64)
            for c, (_, p) in zip(names, loci)]


def _loci_mask(read_keys: np.ndarray, loci: np.ndarray) -> np.ndarray:
    """Whether each read's locus key is among ``loci`` (sorted-key membership)."""
    if not len(loci):
        return np.zeros(len(read_keys), dtype=bool)
    return np.isin(read_keys, loci)


def mutation_type_counts(sig) -> Frame:
    """ref>alt counts over the signature's SNVs, in ``value_counts`` order."""
    refs = np.asarray([r.upper() if len(r) == 1 else "." for r in sig.ref])
    alts = np.asarray([a.split(",")[0].upper() if a and len(a.split(",")[0]) == 1 else "." for a in sig.alt])
    ok = (refs != ".") & (alts != ".")
    pairs = np.array([f"{r}>{a}" for r, a in zip(refs[ok], alts[ok])], dtype=object)
    if not len(pairs):
        return Frame({"mutation": object_column([]), "count": object_column([]), "fraction": object_column([])})
    mutations, counts = value_counts(pairs)
    return Frame({"mutation": object_column(mutations), "count": counts,
                  "fraction": counts / max(int(counts.sum()), 1)})


def af_histogram(sig, nbins: int = 50) -> Frame:
    af = sig.info_field("AF")
    af = af[~np.isnan(af)]
    hist, edges = np.histogram(af, bins=np.linspace(0, 1, nbins + 1))
    return Frame({"af_bin_low": edges[:-1].round(4), "n_variants": hist})


def qual_distributions(fm_df: Frame, matched: np.ndarray) -> Frame:
    bins = np.arange(0, 65, 5)
    qual = np.asarray(fm_df["ML_QUAL"]) if "ML_QUAL" in fm_df else np.full(len(fm_df), np.nan)
    populations, lows, counts = [], [], []
    for name, mask in (("on_signature", matched), ("off_signature", ~matched)):
        hist, _ = np.histogram(qual[mask & ~np.isnan(qual)], bins=bins)
        populations += [name] * len(hist)
        lows += [int(lo) for lo in bins[:-1]]
        counts += [int(n) for n in hist]
    return Frame({"population": object_column(populations), "ml_qual_bin": np.array(lows, dtype=np.int64),
                  "n_reads": np.array(counts, dtype=np.int64)})


def _per_locus(support: Frame) -> Frame:
    """``support.groupby(["chrom", "pos"]).size()`` as a frame: the loci in sorted order, a count each."""
    if not len(support):
        return Frame({"chrom": object_column([]), "pos": object_column([]), "n_supporting_reads": object_column([])})
    chrom, pos = np.asarray(support["chrom"]), np.asarray(support["pos"])
    order = lexsort_rows(chrom, pos)
    codes, n_groups = run_codes(chrom[order], pos[order])
    first = np.flatnonzero(np.r_[True, np.diff(codes) != 0])
    return Frame({"chrom": object_column(chrom[order][first].tolist()), "pos": pos[order][first],
                  "n_supporting_reads": np.bincount(codes, minlength=n_groups).astype(np.int64)})


def tumor_fraction_tables(fm_df: Frame, sig_df: Frame, read_query: str | None, sig_query: str | None,
                          denominator_per_locus: float, pass_fraction: float) -> dict[str, Frame]:
    """The reference's six tables: tumor fraction and per-locus supporting
    reads for (filtered reads x filtered signature), (unfiltered reads x
    filtered signature) and (filtered reads x unfiltered signature);
    tf = supporting reads / (loci * coverage * read-pass-fraction)."""
    read_pass = _apply_query(fm_df, read_query)
    sig_pass = _apply_query(sig_df, sig_query)
    read_keys, sig_keys = locus_keys((fm_df["chrom"], fm_df["pos"]), (sig_df["chrom"], sig_df["pos"]))
    sig_loci_all = np.unique(sig_keys)
    sig_loci_filt = np.unique(sig_keys[sig_pass])
    on_filt = _loci_mask(read_keys, sig_loci_filt)
    on_all = _loci_mask(read_keys, sig_loci_all)
    all_reads = np.ones(len(fm_df), dtype=bool)
    # the key halves name (signature filter state, featuremap/read filter state)
    combos = {
        "filt_signature_filt_featuremap": (read_pass, on_filt, sig_loci_filt),
        "unfilt_signature_filt_featuremap": (read_pass, on_all, sig_loci_all),
        "filt_signature_unfilt_featuremap": (all_reads, on_filt, sig_loci_filt),
    }
    out: dict[str, Frame] = {}
    for tag, (rmask, on, loci) in combos.items():
        support = fm_df.take(on & rmask)
        denom = max(len(loci), 1) * max(denominator_per_locus, 1e-12) * max(pass_fraction, 1e-12)
        out[f"df_tf_{tag}"] = Frame({"signature_type": object_column(["matched"]),
                                     "n_loci": np.array([len(loci)], dtype=np.int64),
                                     "n_supporting_reads": np.array([len(support)], dtype=np.int64),
                                     "tf": np.array([len(support) / denom], dtype=np.float64)})
        out[f"df_supporting_reads_per_locus_{tag}"] = _per_locus(support)
    return out


def read_length_table(fm_df: Frame, matched: np.ndarray, read_query: str | None) -> Frame | None:
    """X_LENGTH histograms for matched/unmatched x unfiltered/filtered reads."""
    if "X_LENGTH" not in fm_df or not (~np.isnan(fm_df["X_LENGTH"])).any():
        return None
    read_pass = _apply_query(fm_df, read_query)
    length = np.asarray(fm_df["X_LENGTH"])
    top = int(max(250, np.nanmax(length))) + 1
    bins = np.arange(0, top + 10, 10)
    populations, lows, counts = [], [], []
    for name, mask in (
        ("matched_unfiltered", matched),
        ("matched_filtered", matched & read_pass),
        ("unmatched_unfiltered", ~matched),
        ("unmatched_filtered", ~matched & read_pass),
    ):
        hist, _ = np.histogram(length[mask & ~np.isnan(length)], bins=bins)
        for lo, n in zip(bins[:-1].tolist(), hist.tolist()):
            if n or name.startswith("matched"):
                populations.append(name)
                lows.append(int(lo))
                counts.append(int(n))
    return Frame({"population": object_column(populations), "length_bin_low": np.array(lows, dtype=np.int64),
                  "n_reads": np.array(counts, dtype=np.int64)})


def _with_signature(frame: Frame, name: str) -> Frame:
    """``frame.assign(signature=name)``."""
    return Frame({**frame.data, "signature": object_column([name] * len(frame))}, frame.index)


def _af_fig(afh: Frame):
    def build(plt):
        fig, ax = plt.subplots(figsize=(7, 3))
        ax.bar(afh["af_bin_low"], afh["n_variants"], width=0.018)
        ax.set_xlabel("Allele fraction")
        ax.set_ylabel("# variants")
        return fig

    return build


def _control_sections(rep: HtmlReport, save, paths: list[str]) -> None:
    """The mutation-type and allele-fraction sections of each control signature."""
    seen_names: set[str] = set()
    for path in paths:
        base = path.split("/")[-1].removesuffix(".gz").removesuffix(".vcf")
        name, k = base, 2
        while name in seen_names:  # the same file name in two directories
            name = f"{base}_{k}"
            k += 1
        seen_names.add(name)
        ctrl = read_vcf(path)
        cmut = mutation_type_counts(ctrl)
        if len(cmut):
            rep.add_section(f"Control signature '{name}' — mutation types")
            rep.add_table(cmut)
            save(_with_signature(cmut, name), f"mutation_types_{name}")
        cafh = af_histogram(ctrl)
        if cafh["n_variants"].sum():
            rep.add_section(f"Control signature '{name}' — allele fractions")
            add_figure_safe(rep, _af_fig(cafh), f"AF figure ({name})")
            save(_with_signature(cafh, name), f"allele_fractions_{name}")


def _pivot(dist: Frame) -> tuple[Frame, list[str]]:
    """``dist.pivot(index="ml_qual_bin", columns="population", values="n_reads")``
    (every bin of every population present): the sorted bins as the index,
    a column a population in sorted order."""
    bins = np.unique(dist["ml_qual_bin"])
    pops = sorted(set(np.asarray(dist["population"]).tolist()))
    cols = {}
    for p in pops:
        at = np.asarray(dist["population"]) == p
        cols[p] = np.asarray(dist["n_reads"])[at][np.argsort(np.asarray(dist["ml_qual_bin"])[at], kind="stable")]
    return Frame(cols, bins), pops


def run(argv) -> int:
    """Render the automatic MRD analysis report."""
    args = parse_args(argv)
    summary = read_hdf(args.mrd_summary_h5, key="mrd_summary")
    rep = HtmlReport("MRD Automatic Data Analysis")
    mode = "w"

    def save(df: Frame, key: str) -> None:
        nonlocal mode
        write_hdf(df, args.h5_output, key=key, mode=mode)
        mode = "a"

    # --- the filters applied ------------------------------------------------
    if args.read_filter_query or args.signature_filter_query:
        rep.add_section("Filters applied")
        tabs = []
        for label, q in (("signature", args.signature_filter_query), ("reads", args.read_filter_query)):
            if q:
                t = describe_filters(q)
                tabs.append(Frame({"applies_to": object_column([label] * len(t)), **t.data}))
        filters = concat_frames(tabs)
        filters.index = None
        rep.add_table(filters)
        save(filters, "filters_applied")

    # --- the tumor fraction summary ---------------------------------------------
    rep.add_section("Tumor fraction estimate")
    rep.add_table(summary)

    def first(name):
        return np.asarray(summary[name])[0]

    rep.add_text(
        f"MRD {'DETECTED' if bool(first('mrd_detected')) else 'not detected'}: "
        f"tumor fraction {first('tumor_fraction'):.3g} "
        f"[{first('tf_ci_low'):.3g}, {first('tf_ci_high'):.3g}] from "
        f"{int(first('n_supporting_reads'))} supporting reads over "
        f"{int(first('n_signature_loci'))} signature loci."
    )
    save(summary, "mrd_summary")

    fm_df = sig = None
    if args.featuremap:
        fm_df = _info_frame(read_vcf(args.featuremap), args.read_filter_query, extra=("ML_QUAL", "X_LENGTH"))
        if args.signature_vcf:
            sig = read_vcf(args.signature_vcf)

    matched = np.zeros(len(fm_df), dtype=bool) if fm_df is not None else None
    if sig is not None and fm_df is not None:
        sig_df = _info_frame(sig, args.signature_filter_query, extra=("AF",))
        read_keys, sig_keys = locus_keys((fm_df["chrom"], fm_df["pos"]), (sig_df["chrom"], sig_df["pos"]))
        matched = _loci_mask(read_keys, np.unique(sig_keys))

        # --- the matched signature ------------------------------------------
        mut = mutation_type_counts(sig)
        if len(mut):
            rep.add_section("Matched signature — mutation types")
            rep.add_table(mut)

            def _mut_fig(plt):
                fig, ax = plt.subplots(figsize=(7, 3))
                ax.bar(list(mut["mutation"]), mut["count"])
                ax.set_ylabel("# mutations")
                return fig

            add_figure_safe(rep, _mut_fig, "mutation types figure")
            save(mut, "mutation_types")
        afh = af_histogram(sig)
        if afh["n_variants"].sum():
            rep.add_section("Matched signature — allele fractions")
            add_figure_safe(rep, _af_fig(afh), "AF figure")
            save(afh, "allele_fractions")

        _control_sections(rep, save, args.control_signature_vcfs or [])

        # --- tumor fractions, filtered x unfiltered --------------------------------
        cov = np.asarray(summary["coverage_per_locus"])[0] if "coverage_per_locus" in summary else 1.0
        denom = args.coverage_per_locus or float(cov or 1.0)
        tf_tables = tumor_fraction_tables(fm_df, sig_df, args.read_filter_query, args.signature_filter_query,
                                          denom, args.read_pass_fraction)
        rep.add_section("Tumor fractions (filtered/unfiltered reads and signature)")
        tf_summary = concat_frames([Frame({**t.data, "variant": object_column([k.removeprefix("df_tf_")] * len(t))})
                                    for k, t in tf_tables.items() if k.startswith("df_tf_")])
        tf_summary.index = None
        rep.add_table(tf_summary)
        for key, tab in tf_tables.items():
            save(tab, key)

    if fm_df is not None:
        # --- ML_QUAL on and off the signature -----------------------------------
        dist = qual_distributions(fm_df, matched)
        if dist["n_reads"].sum():
            rep.add_section("ML_QUAL distribution (on vs off signature)")
            piv, pops = _pivot(dist)
            rep.add_table(piv, index_name="ml_qual_bin", columns_name="population")

            def _qual_fig(plt):
                fig, ax = plt.subplots(figsize=(7, 3))
                x = np.arange(len(piv))
                for k, p in enumerate(pops):
                    ax.bar(x + (k - (len(pops) - 1) / 2) * 0.25, piv[p], width=0.25, label=p)
                ax.set_xticks(x)
                ax.set_xticklabels([str(b) for b in np.asarray(piv.index).tolist()], rotation=90)
                ax.legend()
                ax.set_xlabel("ML_QUAL bin")
                ax.set_ylabel("# reads")
                ax.set_yscale("symlog")
                return fig

            add_figure_safe(rep, _qual_fig, "ML_QUAL figure")
            save(dist, "ml_qual_distribution")

        # --- cfDNA read lengths -------------------------------------------------
        rl = read_length_table(fm_df, matched, args.read_filter_query)
        if rl is not None and len(rl):
            rep.add_section("cfDNA read length distributions")

            def _rl_fig(plt):
                fig, axs = plt.subplots(2, 2, figsize=(11, 5), sharex=True)
                pops = list(dict.fromkeys(np.asarray(rl["population"]).tolist()))
                for ax, pop in zip(axs.flatten(), pops):
                    at = np.asarray(rl["population"]) == pop
                    ax.bar(rl["length_bin_low"][at], rl["n_reads"][at], width=9)
                    ax.set_title(pop, fontsize=9)
                for ax in axs[-1, :]:
                    ax.set_xlabel("Read length")
                fig.tight_layout()
                return fig

            add_figure_safe(rep, _rl_fig, "read length figure")
            save(rl, "read_lengths")

    rep.write(args.html_output)
    log.info("MRD report (figures skipped %d) -> %s", rep.figures_skipped, args.html_output)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
