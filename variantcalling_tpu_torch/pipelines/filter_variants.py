"""filter_variants_pipeline — ML filtering of a called VCF, in torch.

Counterpart of ``variantcalling_tpu/pipelines/filter_variants.py`` (its
serial batch path, which the reference runs on an accelerator): the same
flags, the same model pickles (forest, threshold and DAN families), the
same output bytes outside the ``##vctpu_*`` provenance lines (forests), or
the same scores within a stated tolerance (threshold: 1e-6, DAN: 1e-5).

Path: VCF -> columnar table -> host featurization (allele/INFO/FORMAT
columns) -> per 2^18-row chunk one torch function on the run's device
(the reference windows, gathered from the genome resident there or sent
from the host gather; the six window features; the (N, F) float32 matrix;
the family's program) -> back to the host: forest margins, finalized by
:func:`forest.finalize_margin` in numpy, or threshold and DAN scores as
they are -> FILTER assembly -> VCF writeback with TREE_SCORE, and a
``.tbi`` beside a ``.vcf.gz``.

Windows come from the resident genome (:func:`featurize.device_genome`)
when the table has at least ``GENOME_RESIDENT_MIN_VARIANTS`` records or the
genome is already resident, as in the reference; from the host gather for
smaller tables, for ``--blacklist_cg_insertions`` (which reads them on the
host), and for genomes whose positions do not pack into 4 bytes (decided
once per run from contig lengths).

The run's device is ``cuda`` unless ``--backend cpu`` is given; asking for
the card where there is none exits 2. Every ``VCTPU_*`` value is checked
against the knob registry (:mod:`knobs`) before anything is read: a
malformed one exits 2. The forest strategy (``VCTPU_FOREST_STRATEGY``) and
the model family (``VCTPU_MODEL_FAMILY``) are decided once per run and
recorded in the header; one the model cannot be served by exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import pickle
import sys
import time

import numpy as np
import torch

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import featurize as feat
from variantcalling_tpu_torch import knobs, native
from variantcalling_tpu_torch.featurize import (CENTER, DEVICE_FEATURES, classify_alleles,
                                                device_feature_dict, host_featurize)
from variantcalling_tpu_torch.io import bed as bedio
from variantcalling_tpu_torch.io import hdf5
from variantcalling_tpu_torch.io.fasta import FastaReader
from variantcalling_tpu_torch.io.vcf import FactorizedColumn, VariantTable, read_vcf, write_vcf
from variantcalling_tpu_torch.models import dan as dan_mod
from variantcalling_tpu_torch.models import forest as forest_mod
from variantcalling_tpu_torch.models import registry
from variantcalling_tpu_torch.models import threshold as threshold_mod
from variantcalling_tpu_torch.models.dan import DanModel
from variantcalling_tpu_torch.models.forest import FlatForest
from variantcalling_tpu_torch.ops import intervals as iops
from variantcalling_tpu_torch.utils import h5_utils

log = logging.getLogger("variantcalling_tpu_torch")

LOW_SCORE = "LOW_SCORE"
COHORT_FP = "COHORT_FP"
HPOL_RUN = "HPOL_RUN"
PASS = "PASS"
CHUNK = 1 << 18

# provenance lines of reference features this port does not run (mesh,
# ranks, knobs): a stale one inherited from a re-filtered input must not
# mislabel this run
_STALE_PROVENANCE = ("##vctpu_mesh=", "##vctpu_ranks=", "##vctpu_knobs=")

#: the forest-strategy header value of threshold and DAN runs, which score
#: through their torch program (the reference writes ``jit``)
TORCH_PROGRAM = "torch"

#: format of the per-stage timing log records (the stage name, then seconds)
STAGE_LOG = "stage %s %.3f s"
#: log record of the window path a table took: "genome-resident" or "host gather"
WINDOW_LOG = "window path %s"
#: log record of the bytes a table sent to the device, and its variants
TRANSFER_LOG = "sent %d bytes to the device for %d variants"


@contextlib.contextmanager
def _stage(name: str):
    """Log the host wall seconds of one pipeline stage at INFO. Stages that
    touch the device end in a device-to-host copy, so the time includes the
    device work."""
    t0 = time.perf_counter()
    yield
    log.info(STAGE_LOG, name, time.perf_counter() - t0)


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="filter_variants_pipeline", description="Filter VCF")
    ap.add_argument("--input_file", required=True, help="Name of the input VCF file")
    ap.add_argument("--model_file", required=True, help="Pickle model file")
    ap.add_argument("--model_name", required=True, help="Model name inside the pickle")
    ap.add_argument("--hpol_filter_length_dist", nargs=2, type=int, default=[10, 10],
                    help="Length and distance to the hpol run to mark")
    ap.add_argument("--runs_file", help="Homopolymer runs BED file")
    ap.add_argument("--blacklist", help="Blacklist file: bed, h5 (first key: chrom and pos columns) or pkl of loci")
    ap.add_argument("--blacklist_cg_insertions", action="store_true", help="Filter CCG/GGC insertions")
    ap.add_argument("--reference_file", required=True, help="Indexed reference FASTA file")
    ap.add_argument("--output_file", required=True, help="Output VCF file")
    ap.add_argument("--is_mutect", action="store_true", help="Input is a Mutect callset")
    ap.add_argument("--flow_order", default="TGCA", help="Sequencing flow order (4 cycle)")
    ap.add_argument("--annotate_intervals", action="append", default=[],
                    help="interval files for annotation (multiple possible)")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    ap.add_argument("--limit_to_contig", default=None, help="Process a single contig")
    return ap


def _interval_name(path: str) -> str:
    base = os.path.basename(path)
    for suffix in (".bed.gz", ".bed", ".interval_list"):
        if base.endswith(suffix):
            return base[: -len(suffix)]
    return base


class BlacklistError(ValueError):
    """A blacklist that holds no loci in the expected form (CLI exit 2)."""


def read_blacklist(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Blacklist loci -> (chrom object array, 1-based pos). Accepts bed, h5
    (the first frame key's ``chrom`` and ``pos`` columns, either layout of
    :mod:`utils.h5_utils`) and pkl. An h5 file this reader cannot read raises
    :class:`hdf5.H5Unsupported`; one without such a frame, BlacklistError."""
    if path.endswith((".bed", ".bed.gz")):
        iv = bedio.read_bed(path)
        return iv.chrom, (iv.start + 1).astype(np.int64)
    if path.endswith((".h5", ".hdf", ".hdf5")):
        keys = h5_utils.list_keys(path)
        if not keys:
            raise BlacklistError(f"blacklist {path} holds no frame")
        frame = h5_utils.read_hdf(path, key=keys[0])
        missing = [c for c in ("chrom", "pos") if c not in frame]
        if missing:  # a MultiIndex stored by the JAX package's writer ends here too
            raise BlacklistError(f"blacklist {path}: frame {keys[0]!r} has no {' or '.join(missing)} column "
                                 f"(columns: {frame.columns})")
        return _as_object(frame["chrom"]), np.asarray(frame["pos"], dtype=np.int64)
    with open(path, "rb") as fh:
        obj = pickle.load(fh)
    chroms, poss = zip(*obj) if obj else ((), ())
    return _as_object(chroms), np.asarray(poss, dtype=np.int64)


def _as_object(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = list(values)
    return out


def _is_cg_insertion(table: VariantTable, windows: np.ndarray, center: int) -> np.ndarray:
    """CCG/GGC insertion artifacts (--blacklist_cg_insertions): a single-base
    left-anchored insertion of C between C and G, or of G between G and C.
    A scanned table's allele classes say which first ALTs start with REF."""
    n = len(table)
    alle = classify_alleles(table)
    if table.aux is not None:
        prefix_ins = (table.aux.alle["aclass"] & 8).astype(bool)
        ref_len = table.aux.alle["ref_len"].astype(np.int64)
    else:
        ref_len = np.fromiter(map(len, table.ref), dtype=np.int64, count=n)
        alt0_len = np.fromiter((len(a) if "," not in a else a.index(",") for a in table.alt),
                               dtype=np.int64, count=n)
        cand = alle.is_ins & (alt0_len == ref_len + 1)
        prefix_ins = np.zeros(n, dtype=bool)
        for i in np.nonzero(cand)[0]:
            prefix_ins[i] = table.alt[i].split(",")[0].startswith(table.ref[i])
    # the window is centered on POS (first ref base): the anchor sits at
    # center + ref_len - 1 and the next reference base right after it
    cand = alle.is_ins & prefix_ins & (alle.indel_length == 1)
    anchor_idx = np.minimum(center + ref_len - 1, windows.shape[1] - 1)
    next_idx = np.minimum(anchor_idx + 1, windows.shape[1] - 1)
    rows = np.arange(n)
    anchor = windows[rows, anchor_idx].astype(np.int32)
    nxt = windows[rows, next_idx].astype(np.int32)
    ins = alle.indel_nuc  # C=1, G=2
    return cand & (((ins == 1) & (anchor == 1) & (nxt == 2)) | ((ins == 2) & (anchor == 2) & (nxt == 1)))


def _narrow_column(a: np.ndarray) -> np.ndarray:
    """Cheapest exact transfer dtype for a host feature column: uint8 when every
    value is an exact small non-negative integer, else float32."""
    a = np.asarray(a)
    if a.dtype == np.uint8 or a.dtype == np.bool_:
        return a
    if a.dtype.kind == "f" and not np.isfinite(a).all():  # the uint8 probe cast is UB
        return a.astype(np.float32, copy=False)
    small = a.astype(np.uint8)
    if np.array_equal(small.astype(a.dtype), a):
        return small
    return a.astype(np.float32, copy=False)


class FusedScorer:
    """The device half of scoring for one feature layout, one chunk at a time:
    the windows (sent from the host, or gathered from the resident genome),
    the window features, the (N, F) float32 matrix and the family's program
    (forest margins through the strategy's kernel, threshold or DAN scores).
    Counts the bytes it sends to the device (``sent_bytes``)."""

    def __init__(self, model, names: list[str], strategy: str, flow_order: str, device: torch.device):
        self.names = list(names)
        self.flow_order = flow_order
        self.device = device
        self.sent_bytes = 0
        self.finalize = None  # threshold and DAN programs return final scores
        if isinstance(model, FlatForest):
            forest = forest_mod.with_feature_order(model, names)
            self.program = forest_mod.make_margin_predictor(forest, len(names), strategy, device)
            self.finalize = lambda margin: forest_mod.finalize_margin(margin, forest)
        elif isinstance(model, DanModel):
            self.program = dan_mod.make_score_predictor(model, names, device)
        else:
            self.program = threshold_mod.make_score_predictor(model, names, device)

    def _send(self, a: np.ndarray) -> torch.Tensor:
        """``a`` copied to the device, its bytes counted."""
        a = np.ascontiguousarray(a)
        self.sent_bytes += a.nbytes
        return torch.from_numpy(a).to(self.device)

    def chunk_output(self, hf, host_cols: dict[str, np.ndarray], lo: int, hi: int,
                     genome: feat.DeviceGenome | None = None, gpos: np.ndarray | None = None) -> torch.Tensor:
        """(hi - lo,) float32 program output (margins or scores) of rows [lo, hi),
        on the device; with ``genome``, windows come from its packed ``gpos``."""
        if genome is None:
            windows = self._send(hf.windows[lo:hi])
        else:  # 4 bytes a variant, widened on the device
            windows = feat.windows_from_packed(genome.codes, self._send(gpos[lo:hi].view(np.int32)), genome.radius)
        alle = feat.allele_inputs(hf.alle, lo, hi, self.device)
        self.sent_bytes += sum(t.numel() * t.element_size() for t in alle)
        dev = device_feature_dict(windows, *alle, center=CENTER, flow_order=self.flow_order)
        cols = [dev[f] if f in dev else self._send(host_cols[f][lo:hi]) for f in self.names]
        return self.program(torch.stack([c.to(torch.float32) for c in cols], dim=1).contiguous())

    def score(self, hf, genome: feat.DeviceGenome | None = None, gpos: np.ndarray | None = None) -> np.ndarray:
        """TREE_SCORE of every row of ``hf``: chunked device programs, then the
        forest's host finalize."""
        n = len(hf.alle.n_alts)
        host_cols = {f: _narrow_column(hf.cols[f]) for f in self.names if f not in DEVICE_FEATURES}
        out = np.empty(n, dtype=np.float32)
        for lo in range(0, n, CHUNK):
            hi = min(lo + CHUNK, n)
            out[lo:hi] = self.chunk_output(hf, host_cols, lo, hi, genome, gpos).cpu().numpy()
        return out if self.finalize is None else self.finalize(out)


class FilterContext:
    """Run-level scoring state: model wiring, blacklist, hpol runs, interval sets.

    The engine, the model family, the forest strategy and whether the
    genome's positions pack into 4 bytes are decided here once per run.
    ``family`` is the run's ``VCTPU_MODEL_FAMILY`` request (None: read it).
    """

    def __init__(self, model, fasta: FastaReader, device: torch.device,
                 runs_file: str | None = None, hpol_length: int = 10, hpol_dist: int = 10,
                 blacklist: tuple[np.ndarray, np.ndarray] | None = None,
                 blacklist_cg_insertions: bool = False,
                 annotate_intervals: dict[str, bedio.IntervalSet] | None = None,
                 flow_order: str = "TGCA", is_mutect: bool = False, family: str | None = None):
        self.device = device
        self.engine = engine_mod.engine_name(device)
        forest_mod.validate_strategy_env()
        self.model_family = registry.resolve_family(
            model, registry.requested_family() if family is None else family)
        self.forest_strategy = forest_mod.resolve_strategy(model, device) \
            if isinstance(model, FlatForest) else TORCH_PROGRAM
        # before any encoding: a genome whose positions do not pack into 4
        # bytes gathers its windows on the host
        self.genome_packable = feat.genome_packable(fasta)
        log.info("engine %s, model family %s, forest strategy %s, genome positions pack into 4 bytes: %s, "
                 "host engine %s", self.engine, self.model_family, self.forest_strategy, self.genome_packable,
                 native.engine_name())
        self.model = model
        self.fasta = fasta
        self.hpol_dist = hpol_dist
        self.blacklist = blacklist
        self.blacklist_cg_insertions = blacklist_cg_insertions
        self.annotate_intervals = annotate_intervals
        self.flow_order = flow_order
        self.is_mutect = is_mutect
        # default_left forests are defined on NaN: zero-filling absent fields
        # would walk the wrong branch
        self.keep_nan = getattr(model, "default_left", None) is not None
        self.extra_info = ["TLOD"] if is_mutect else []
        self._runs: bedio.IntervalSet | None = None
        if runs_file:
            runs = bedio.read_bed(runs_file)
            keep = (runs.end - runs.start) >= hpol_length
            self._runs = bedio.IntervalSet(runs.chrom[keep], runs.start[keep], runs.end[keep])

    def _hpol_near(self, table: VariantTable) -> np.ndarray | None:
        if self._runs is None or not len(self._runs):
            return None
        coords = iops.GenomeCoords(table.header.contig_lengths or {
            c: self.fasta.get_reference_length(c) for c in self.fasta.references})
        gs, ge = coords.globalize_intervals(self._runs)
        gpos = coords.globalize(np.asarray(table.chrom), table.pos - 1)
        return iops.distance_to_nearest(gpos, gs, ge) <= self.hpol_dist

    def genome_resident(self, table: VariantTable) -> bool:
        """Whether this table's windows come from the resident genome: host
        windows are needed for ``--blacklist_cg_insertions``, for genomes that
        do not pack, and for a small table that finds no genome resident."""
        return (self.genome_packable and not self.blacklist_cg_insertions
                and feat._genome_resident_worthwhile(table, self.fasta, self.device))

    def host_features(self, table: VariantTable, compute_windows: bool = True):
        hf = host_featurize(table, self.fasta, annotate_intervals=self.annotate_intervals,
                            extra_info_fields=self.extra_info, compute_windows=compute_windows,
                            keep_nan=self.keep_nan)
        if self.is_mutect and "TLOD" in hf.cols:
            hf.cols["tlod"] = hf.cols.pop("TLOD")
            hf.names[hf.names.index("TLOD")] = "tlod"
        return hf

    def score_table(self, table: VariantTable) -> tuple[np.ndarray, FactorizedColumn]:
        """(TREE_SCORE float32 array, FILTER column) of one table."""
        resident = self.genome_resident(table)
        with _stage("host_featurize"):
            hf = self.host_features(table, compute_windows=not resident)
        genome = gpos = None
        if resident:
            with _stage("genome"):
                genome = feat.device_genome(self.fasta, self.device)
                gpos = feat.pack_global_positions(feat.globalize_positions(table, genome), genome)
        log.info(WINDOW_LOG, "genome-resident" if resident else "host gather")
        with _stage("device_score"):
            scorer = FusedScorer(self.model, hf.names, self.forest_strategy, self.flow_order, self.device)
            score = scorer.score(hf, genome, gpos)
        log.info(TRANSFER_LOG, scorer.sent_bytes, len(table))
        with _stage("filters"):
            return score, self.assemble_filters(table, score, hf)

    def assemble_filters(self, table: VariantTable, score: np.ndarray, hf) -> FactorizedColumn:
        """FILTER from scores: COHORT_FP beats LOW_SCORE; HPOL_RUN appends with ';'."""
        n = len(table)
        low = score < self.model.pass_threshold
        cohort_fp = np.zeros(n, dtype=bool)
        blacklist = self.blacklist
        if blacklist is not None and len(blacklist[0]):
            # (chrom, pos) join: chroms to small ints, one int64 key, sorted membership
            chroms = {c: i for i, c in enumerate(dict.fromkeys(
                np.concatenate([blacklist[0], table.chrom]).tolist()))}
            cidx_bl = np.fromiter((chroms[c] for c in blacklist[0]), dtype=np.int64,
                                  count=len(blacklist[0]))
            cidx_tb = np.fromiter((chroms[c] for c in table.chrom), dtype=np.int64, count=n)
            key_bl = np.sort((cidx_bl << 40) | blacklist[1].astype(np.int64))
            key_tb = (cidx_tb << 40) | table.pos.astype(np.int64)
            loc = np.minimum(np.searchsorted(key_bl, key_tb), len(key_bl) - 1)
            cohort_fp = key_bl[loc] == key_tb
        if self.blacklist_cg_insertions:
            cohort_fp |= _is_cg_insertion(table, hf.windows, CENTER)
        near = self._hpol_near(table)
        hpol_near = near if near is not None else np.zeros(n, dtype=bool)
        base_idx = np.where(cohort_fp, 1, np.where(low, 2, 0)).astype(np.int32)
        return FactorizedColumn(base_idx + 3 * hpol_near, [
            PASS, COHORT_FP, LOW_SCORE, HPOL_RUN, f"{COHORT_FP};{HPOL_RUN}", f"{LOW_SCORE};{HPOL_RUN}"])


def _replace_or_append_meta(header, prefix: str, line: str) -> None:
    replaced = False
    for i, old in enumerate(header.lines):
        if old.startswith(prefix):
            header.lines[i] = line
            replaced = True
    if not replaced:
        header.add_meta_line(line)


def _ensure_output_header(header, engine: str, strategy: str, family: str) -> None:
    """The pipeline's header additions: FILTER/INFO definitions, then the
    engine and forest-strategy provenance lines, and the model family's
    line for threshold and DAN runs (forest runs write none and strip a
    stale one, so their bytes stay the reference's)."""
    header.ensure_filter(LOW_SCORE, "Model score below threshold")
    header.ensure_filter(COHORT_FP, "Blacklisted cohort false-positive locus")
    header.ensure_filter(HPOL_RUN, "Variant close to long homopolymer run")
    header.ensure_info("TREE_SCORE", "1", "Float", "Filtering model confidence score")
    _replace_or_append_meta(header, f"##{engine_mod.HEADER_KEY}=", engine_mod.header_line(engine))
    key = forest_mod.STRATEGY_HEADER_KEY
    _replace_or_append_meta(header, f"##{key}=", f"##{key}={strategy}")
    fam_prefix = f"##{dan_mod.FAMILY_HEADER_KEY}="
    if family != "forest":
        _replace_or_append_meta(header, fam_prefix, f"{fam_prefix}{family}")
    else:
        header.lines[:] = [ln for ln in header.lines if not ln.startswith(fam_prefix)]
    header.lines[:] = [ln for ln in header.lines if not ln.startswith(_STALE_PROVENANCE)]


def run(argv: list[str]) -> int:
    args = get_parser().parse_args(argv)
    try:
        knobs.validate_all()  # every VCTPU_* value, before anything is read
        family = registry.requested_family()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    try:
        model = registry.load_model(args.model_file, args.model_name)
        blacklist = read_blacklist(args.blacklist) if args.blacklist else None
    except (NotImplementedError, ModuleNotFoundError, hdf5.H5Unsupported, BlacklistError) as e:
        log.error("%s", e)
        return 2
    annotate = {_interval_name(p): bedio.read_intervals(p) for p in args.annotate_intervals}
    with FastaReader(args.reference_file) as fasta:
        try:
            return run_loaded(args, model, fasta, annotate, blacklist, device, family)
        except (NotImplementedError, engine_mod.EngineError) as e:
            log.error("%s", e)
            return 2


def run_loaded(args, model, fasta: FastaReader, annotate, blacklist, device: torch.device,
               family: str | None = None) -> int:
    """The filter pipeline over already-loaded resources; ``family``: the
    run's ``VCTPU_MODEL_FAMILY`` request (None: read it)."""
    ctx = FilterContext(
        model, fasta, device, runs_file=args.runs_file,
        hpol_length=args.hpol_filter_length_dist[0], hpol_dist=args.hpol_filter_length_dist[1],
        blacklist=blacklist, blacklist_cg_insertions=args.blacklist_cg_insertions,
        annotate_intervals=annotate, flow_order=args.flow_order, is_mutect=args.is_mutect,
        family=family)
    log.info("reading %s", args.input_file)
    with _stage("ingest"):
        table = read_vcf(args.input_file)
    if args.limit_to_contig:
        table = table.subset(np.asarray(table.chrom) == args.limit_to_contig)
    score, filters = ctx.score_table(table)
    _ensure_output_header(table.header, ctx.engine, ctx.forest_strategy, ctx.model_family)
    with _stage("writeback"):  # rounding stays in numpy, as in the reference
        # this pipeline edits none of CHROM..QUAL: a scanned table's records
        # are spliced from its text by the native engine
        write_vcf(args.output_file, table, new_filters=filters,
                  extra_info={"TREE_SCORE": np.round(score, 4)}, verbatim_core=True)
    log.info("wrote %s: %d variants, %d PASS", args.output_file, len(table),
             int(np.sum(filters == PASS)))
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
