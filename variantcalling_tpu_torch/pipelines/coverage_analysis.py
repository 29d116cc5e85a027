"""coverage_analysis: whole-genome depth, window means, depth histograms, bedGraph and bigWig.

Counterpart of ``variantcalling_tpu/pipelines/coverage_analysis.py``, with
the same subcommands and arguments plus ``--backend gpu|cpu`` (default
``gpu``: the card; asking for it without one exits 2):

- ``full_analysis``: ``<out>.w{W}.parquet`` for each window W (default
  100, 1,000, 10,000 and 100,000 bp: chrom, chromStart, chromEnd, the mean
  coverage) and ``<out>.coverage_stats.h5`` with the frames
  ``histogram`` (depth 0-1,000 by interval category), ``stats`` and
  ``percentiles`` (Q0-Q100);
- ``collect_coverage``: a run-length bedGraph (``.bedgraph.gz`` unless the
  name says otherwise) and its sibling ``.bw``, or the ``.bw`` alone when
  the output is named so.

The host reads the BAM or CRAM into one int32 difference array a contig
(``io/bam.depth_diff_arrays``: the native engine's ``bam_depth`` /
``cram_depth``, the pure-Python reader under ``VCTPU_NO_NATIVE=1``).
Each array is uploaded once and integrated on the run's device
(``ops/coverage.depth_from_diff``); every window mean, histogram and
category mask of ``full_analysis`` is computed there, and no depth vector
comes back to the host. ``collect_coverage`` brings back the runs of
equal depth (their starts and values), from which the bedGraph text and
the bigWig sections are built. The ``.bedgraph.gz`` is BGZF (multi-member
gzip, ``gzip.open`` reads it whole) deflated by the native engine where it
serves; its inflated bytes are the reference's.

The reference's coverage plots need matplotlib and pandas, which the port
does not use: they are always skipped, recorded as the reference records
them where matplotlib is missing (``degrade.record("coverage_analysis.plots")``).
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
from variantcalling_tpu_torch import knobs, native
from variantcalling_tpu_torch.io import bed as bedio
from variantcalling_tpu_torch.io.bam import depth_diff_arrays
from variantcalling_tpu_torch.io.bgzf import BgzfWriter
from variantcalling_tpu_torch.io.bigwig import write_bigwig_runs
from variantcalling_tpu_torch.io.parquet import write_parquet
from variantcalling_tpu_torch.ops import coverage as cops
from variantcalling_tpu_torch.utils import degrade
from variantcalling_tpu_torch.utils.h5_utils import Frame, write_hdf
from variantcalling_tpu_torch.utils.stages import stage

log = logging.getLogger(__name__)

DEFAULT_WINDOWS = [100, 1000, 10000, 100000]
MIN_CONTIG_LENGTH = 1_000_000  # contigs below this are skipped, unless there are at most 3
PERCENTILE_QS = np.arange(0, 101, 5)
#: bedGraph lines rendered at once
_TEXT_LINES = 1 << 20
#: float32 holds every integer below this exactly
_F32_EXACT = 1 << 24


def parse_args(argv: list[str], command: str):
    ap = argparse.ArgumentParser(prog=command, description=run.__doc__)
    ap.add_argument("-i", "--input", required=True, help="input bam file")
    ap.add_argument("-o", "--output", required=True, help="output path/basename")
    if command == "full_analysis":
        ap.add_argument("-c", "--coverage_intervals", default=None,
                        help="tsv of (name, bed path) rows with per-interval categories")
        ap.add_argument("-w", "--windows", type=int, nargs="*", default=None)
    ap.add_argument("-r", "--region", nargs="*", default=None)
    ap.add_argument("-q", "-bq", dest="bq", type=int, default=0)
    ap.add_argument("-Q", "-mapq", dest="mapq", type=int, default=0)
    ap.add_argument("-l", dest="min_read_length", type=int, default=0)
    ap.add_argument("--reference", default=None,
                    help="reference FASTA (CRAM decode is reference-free for depth)")
    ap.add_argument("--reference-gaps", default=None)
    ap.add_argument("--centromeres", default=None)
    ap.add_argument("-j", "--jobs", type=int, default=-1, help="(accepted; the device owns parallelism)")
    ap.add_argument("--no_progress_bar", action="store_true")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def collect_depth(args, device: torch.device) -> dict[str, torch.Tensor]:
    """Each kept contig's int32 depth on ``device``: its difference array read
    on the host, uploaded once and integrated there. Kept: contigs of at
    least ``MIN_CONTIG_LENGTH``, or all when there are at most 3."""
    with stage("ingest", device):
        _, diffs = depth_diff_arrays(args.input, min_bq=args.bq, min_mapq=args.mapq,
                                     min_read_length=args.min_read_length, regions=args.region)
    keep = {c: d for c, d in diffs.items() if len(d) - 1 >= MIN_CONTIG_LENGTH or len(diffs) <= 3}
    with stage("upload", device):
        return {c: cops.depth_from_diff(torch.from_numpy(d).to(device)) for c, d in keep.items()}


def _int_text(x: np.ndarray) -> np.ndarray:
    """(w, n) uint8: column i is the decimal text of ``x[i]``, aligned to the
    bottom, its unused leading bytes 0 (dropped when the lines are
    compacted); one division a digit row."""
    x = np.asarray(x, dtype=np.int64)
    mag = np.abs(x)
    digits = len(str(int(mag.max()))) if len(mag) else 1
    rows = np.empty((digits + 1, len(x)), dtype=np.uint8)
    rows[0] = np.where(x < 0, ord("-"), 0)
    rest = mag
    for k in range(digits):
        quot = rest // 10
        rows[digits - k] = rest - quot * 10 + ord("0")
        rest = quot
    width = np.searchsorted(10 ** np.arange(1, digits, dtype=np.int64), mag, side="right") + 1
    rows[1:][np.arange(digits)[:, None] < (digits - width)[None, :]] = 0  # leading zeros
    return rows


def bedgraph_text(contig: str, starts: np.ndarray, ends: np.ndarray, vals: np.ndarray) -> bytes:
    """``f"{contig}\\t{start}\\t{end}\\t{value}\\n"`` for each run, built as
    one byte matrix and compacted (no loop over the lines). A run's end is
    the next run's start, so the ends' text is the starts' shifted by one
    where that holds."""
    n = len(starts)
    if n == 0:
        return b""
    head = np.frombuffer(contig.encode() + b"\t", dtype=np.uint8)
    tab = np.full((1, n), ord("\t"), np.uint8)
    start_text = _int_text(np.append(starts, ends[-1]))
    end_text = start_text[:, 1:] if np.array_equal(ends[:-1], starts[1:]) else _int_text(ends)
    rows = np.concatenate([np.broadcast_to(head[:, None], (len(head), n)), start_text[:, :-1], tab, end_text, tab,
                           _int_text(vals), np.full((1, n), ord("\n"), np.uint8)])
    mat = np.ascontiguousarray(rows.T)  # one line a row
    return mat[mat != 0].tobytes()


def depth_runs(depth: torch.Tensor) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(starts, ends, values) of the runs of equal depth: found on the
    depth's device, the starts (int64) and values (int32) brought back."""
    n = depth.shape[0]
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int32)
    change = torch.nonzero(depth[1:] != depth[:-1]).squeeze(1) + 1
    starts_t = torch.cat([change.new_zeros(1), change])
    starts, vals = starts_t.cpu().numpy(), depth[starts_t].cpu().numpy()
    return starts, np.append(starts[1:], n), vals


def _bigwig_runs(starts: np.ndarray, ends: np.ndarray, vals: np.ndarray):
    """The runs in float32, as the bigWig writer runs them: runs whose values
    round to the same float32 (depths of 2^24 and more) merged."""
    v32 = vals.astype(np.float32)
    if len(vals) and int(np.abs(vals).max()) >= _F32_EXACT:
        first = np.concatenate([[True], v32[1:] != v32[:-1]])
        last = np.concatenate([first[1:], [True]])
        return starts[first], ends[last], v32[first]
    return starts.astype(np.int64), ends.astype(np.int64), v32


def write_bedgraph(path: str, runs: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]]) -> None:
    """Run-length bedGraph of each contig's runs (BGZF when ``path`` ends in
    ``.gz``): the lines the reference's ``write_bedgraph`` writes, formatted
    by the native engine's ``bedgraph_lines`` (:func:`bedgraph_text`, its
    plain version, without the engine)."""
    with (BgzfWriter(path) if path.endswith(".gz") else open(path, "wb")) as out:
        for contig, (starts, ends, vals) in runs.items():
            for lo in range(0, len(starts), _TEXT_LINES):
                part = (starts[lo: lo + _TEXT_LINES], ends[lo: lo + _TEXT_LINES], vals[lo: lo + _TEXT_LINES])
                text = native.bedgraph_lines(contig, *part)
                out.write(bedgraph_text(contig, *part) if text is None else text)


def _read_categories(path: str) -> list[tuple[str, str]]:
    """(category, bed path) rows of the ``-c`` tsv (two tab-separated
    columns, no header; blank lines skipped)."""
    rows = []
    with open(path) as fh:
        for line in fh:
            fields = line.rstrip("\r\n").split("\t")
            if fields == [""]:
                continue
            if len(fields) != 2:
                raise ValueError(f"{path}: expected 2 tab-separated columns (category, bed path), got {fields}")
            rows.append((fields[0], fields[1]))
    return rows


def _interval_categories(args, depths: dict[str, torch.Tensor], device: torch.device
                         ) -> dict[str, dict[str, torch.Tensor | None]]:
    """category -> {contig: bool mask on ``device``, or None for every
    position}; always 'Genome' first. A contig a category's bed does not
    name has no entry (an empty histogram)."""
    cats: dict[str, dict[str, torch.Tensor | None]] = {"Genome": {c: None for c in depths}}
    if getattr(args, "coverage_intervals", None):
        for name, bed_path in _read_categories(args.coverage_intervals):
            by_chrom = bedio.read_intervals(bed_path).by_chrom()
            cats[name] = {c: cops.mask_from_intervals(len(d), *by_chrom[c], device=device)
                          for c, d in depths.items() if c in by_chrom}
    return cats


def _skip_plots() -> None:
    degrade.record("coverage_analysis.plots", fallback="plots skipped")
    log.warning("coverage plots skipped: the port draws no plots (matplotlib is not used)")


def full_analysis(args, device: torch.device) -> int:
    depths = collect_depth(args, device)
    if not depths:
        raise SystemExit("no contigs passed the length filter")
    os.makedirs(os.path.dirname(os.path.abspath(args.output)) or ".", exist_ok=True)
    base = args.output
    windows = sorted(args.windows if args.windows else DEFAULT_WINDOWS)

    with stage("windows", device):
        means = {w: {c: cops.binned_mean(d, w).cpu().numpy() for c, d in depths.items()} for w in windows}
    with stage("histograms", device):
        cats = _interval_categories(args, depths, device)
        hists: dict[str, torch.Tensor] = {}
        for cat, masks in cats.items():
            # per contig float32 counts summed in float64, as the reference sums them
            hist = torch.zeros(cops.MAX_DEPTH_BIN + 1, dtype=torch.float64, device=device)
            for contig, mask in masks.items():
                hist += cops.depth_histogram(depths[contig], mask).double()
            hists[cat] = hist
        stats_cols, pct_cols, stat_names = {}, {}, None
        for cat, hist in hists.items():
            h32 = hist.to(torch.float32)
            st = cops.stats_from_histogram(h32)
            stat_names = list(st)
            stats_cols[cat] = np.asarray([float(v) for v in st.values()], dtype=np.float64)
            pct_cols[cat] = cops.percentiles_from_histogram(h32, PERCENTILE_QS / 100.0).cpu().numpy()
        hist_cols = {cat: h.cpu().numpy() for cat, h in hists.items()}
    with stage("writes", device):
        for w in windows:
            parts = []
            for contig, m in means[w].items():
                n, length = len(m), len(depths[contig])
                idx = np.arange(n, dtype=np.int64)
                parts.append((np.full(n, contig.encode()), idx * w + 1, np.minimum((idx + 1) * w, length), m))
            write_parquet(f"{base}.w{w}.parquet", {
                "chrom": np.concatenate([p[0] for p in parts]) if parts else np.empty(0, "S1"),
                "chromStart": np.concatenate([p[1] for p in parts]),
                "chromEnd": np.concatenate([p[2] for p in parts]),
                "coverage": np.concatenate([p[3] for p in parts]).astype(np.float32)})
        out_h5 = f"{base}.coverage_stats.h5"
        write_hdf(Frame(hist_cols), out_h5, key="histogram", mode="w")
        write_hdf(Frame({"stat": np.asarray(stat_names, dtype=object), **stats_cols}), out_h5, key="stats",
                  mode="a")
        write_hdf(Frame({"percentile": np.asarray([f"Q{q}" for q in PERCENTILE_QS], dtype=object), **pct_cols}),
                  out_h5, key="percentiles", mode="a")
    _skip_plots()
    log.info("wrote %s (histogram/stats/percentiles) + %d binned parquets on %s", out_h5, len(windows), device)
    return 0


def collect_coverage(args, device: torch.device) -> int:
    depths = collect_depth(args, device)
    with stage("runs", device):
        runs = {c: depth_runs(d) for c, d in depths.items()}
    sizes = {c: len(d) for c, d in depths.items()}
    out = args.output
    with stage("writes", device):
        if out.endswith((".bw", ".bigwig", ".bigWig")):
            write_bigwig_runs(out, {c: _bigwig_runs(*r) for c, r in runs.items()}, sizes)
            log.info("wrote %s", out)
            return 0
        if not out.endswith((".bedgraph", ".bedgraph.gz", ".bg", ".bg.gz")):
            out = out + ".bedgraph.gz"
        write_bedgraph(out, runs)
        bw_out = out
        for suf in (".gz", ".bedgraph", ".bg"):
            bw_out = bw_out.removesuffix(suf)
        bw_out += ".bw"
        write_bigwig_runs(bw_out, {c: _bigwig_runs(*r) for c, r in runs.items()}, sizes)
    log.info("wrote %s + %s", out, bw_out)
    return 0


def run(argv: list[str]) -> int:
    """Full coverage analysis of an aligned BAM: depth, binning, histograms."""
    if not argv or argv[0] not in ("full_analysis", "collect_coverage"):
        print("usage: coverage_analysis {full_analysis,collect_coverage} [args]", file=sys.stderr)
        return 2
    command = argv[0]
    args = parse_args(argv[1:], command)
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    if command == "full_analysis":
        return full_analysis(args, device)
    return collect_coverage(args, device)


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
