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

By default the run streams (:func:`run_streaming`, the reference's
streaming executor): the callset is read in line-aligned chunks
(``VCTPU_STREAM_CHUNK_BYTES``), each chunk scanned, featurized, scored on
the run's device and rendered, chunk bodies on the IO worker pool
(``VCTPU_IO_THREADS``) or on stage threads, and the rendered chunks written
in order into ``<out>.partial.*`` and renamed onto the output at the end,
with a resume journal (``.vcf`` outputs), an optional chunk cache
(``VCTPU_CACHE``) and quarantine (``VCTPU_QUARANTINE``). The bytes are the
serial path's. ``VCTPU_STREAM=0``, ``VCTPU_THREADS=1``,
``--limit_to_contig`` or a missing native engine select the serial path
(the whole table read, scored and written at once). On the card, every
chunk of a streaming run takes its windows from the resident genome,
built on the ``genome-prefetch`` thread; a chunk that comes first waits
for it. The device half of each chunk runs one chunk at a time, under one
lock.

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
import threading
import time
import zlib

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
from variantcalling_tpu_torch.io.vcf import (FactorizedColumn, VariantTable, VcfChunkReader, assemble_table_bytes,
                                             read_vcf, render_table_bytes_python, write_tabix, write_vcf)
from variantcalling_tpu_torch.models import dan as dan_mod
from variantcalling_tpu_torch.models import forest as forest_mod
from variantcalling_tpu_torch.models import registry
from variantcalling_tpu_torch.models import threshold as threshold_mod
from variantcalling_tpu_torch.models.dan import DanModel
from variantcalling_tpu_torch.models.forest import FlatForest
from variantcalling_tpu_torch.ops import intervals as iops
from variantcalling_tpu_torch.parallel import pipeline as pipeline_mod
from variantcalling_tpu_torch.utils import degrade, faults, h5_utils

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
#: log record of a streaming run's end: output, layout, chunks, chunks resumed,
#: chunks quarantined, records, cache hits, peak device memory allocated
#: (bytes; -1 off the card)
STREAM_LOG = "streamed %s: layout %s, %d chunks, %d resumed, %d quarantined, %d records, %d cache hits, " \
             "peak device memory %d bytes"

#: sidecar of the original records of quarantined chunks (``VCTPU_QUARANTINE=1``)
QUARANTINE_SUFFIX = ".quarantine"


class DeviceFault(pipeline_mod.LadderEscalation):
    """A sticky failure of the card (an illegal address, a failed launch):
    the context cannot run the chunk again, so the run fails (exit 1) with
    its journal kept for a resume, never retried, quarantined or moved to
    the CPU."""


def _sticky_device_error(e: BaseException) -> bool:
    """Whether ``e`` is a CUDA error that poisons the context. Device OOM is
    not: it takes the recovery ladder (bounded re-dispatch, then fail)."""
    if isinstance(e, torch.OutOfMemoryError):
        return False
    if isinstance(e, torch.AcceleratorError):
        return True
    text = str(e)
    return isinstance(e, RuntimeError) and ("CUDA error" in text or "cudaError_t" in text)


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
        self._sent_lock = threading.Lock()
        self.finalize = None  # threshold and DAN programs return final scores
        if isinstance(model, FlatForest):
            forest = forest_mod.with_feature_order(model, names)
            self.program = forest_mod.make_margin_predictor(forest, len(names), strategy, device)
            self.finalize = lambda margin: forest_mod.finalize_margin(margin, forest)
        elif isinstance(model, DanModel):
            self.program = dan_mod.make_score_predictor(model, names, device)
        else:
            self.program = threshold_mod.make_score_predictor(model, names, device)

    def _count_sent(self, nbytes: int) -> None:
        with self._sent_lock:
            self.sent_bytes += nbytes

    def _send(self, a: np.ndarray) -> torch.Tensor:
        """``a`` copied to the device, its bytes counted."""
        a = np.ascontiguousarray(a)
        self._count_sent(a.nbytes)
        return torch.from_numpy(a).to(self.device)

    def warm_up(self) -> None:
        """On the card: the first use of the device programs, before a stream
        starts, so that no chunk body pays it under the watchdog: the window
        features over one row, the kernel's library loaded (no launch, so no
        count), the threshold or DAN program, or the gather walk, over one
        row."""
        if self.device.type != "cuda":
            return
        windows = torch.full((1, 2 * feat.WINDOW_RADIUS + 1), 4, dtype=torch.uint8, device=self.device)
        flag = torch.zeros(1, dtype=torch.bool, device=self.device)
        code = torch.zeros(1, dtype=torch.int32, device=self.device)
        device_feature_dict(windows, flag, code, code, code, flag, center=CENTER, flow_order=self.flow_order)
        load = getattr(self.program, "load", None)
        if load is not None:
            load()
        else:
            self.program(torch.zeros((1, len(self.names)), dtype=torch.float32, device=self.device))
        torch.cuda.synchronize(self.device)

    def chunk_output(self, hf, host_cols: dict[str, np.ndarray], lo: int, hi: int,
                     genome: feat.DeviceGenome | None = None, gpos: np.ndarray | None = None) -> torch.Tensor:
        """(hi - lo,) float32 program output (margins or scores) of rows [lo, hi),
        on the device; with ``genome``, windows come from its packed ``gpos``."""
        if genome is None:
            windows = self._send(hf.windows[lo:hi])
        else:  # 4 bytes a variant, widened on the device
            windows = feat.windows_from_packed(genome.codes, self._send(gpos[lo:hi].view(np.int32)), genome.radius)
        alle = feat.allele_inputs(hf.alle, lo, hi, self.device)
        self._count_sent(sum(t.numel() * t.element_size() for t in alle))
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
        #: the feature order host featurization gives (TLOD is named tlod)
        self.feature_names = [*feat.BASE_FEATURES, *(["tlod"] if is_mutect else []), *(annotate_intervals or {})]
        #: set by a streaming run on the card: every chunk's windows come
        #: from the resident genome (see :meth:`genome_resident`)
        self.stream_resident = False
        #: the device half of scoring runs one table at a time
        self._device_lock = threading.Lock()
        self._scorers: dict[tuple, FusedScorer] = {}
        self._scorer_lock = threading.Lock()
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
        windows are needed for ``--blacklist_cg_insertions`` and for genomes
        that do not pack; otherwise every chunk of a streaming run on the
        card (:attr:`stream_resident`) and any table that finds the genome
        resident or has at least ``GENOME_RESIDENT_MIN_VARIANTS`` records."""
        return (self.genome_packable and not self.blacklist_cg_insertions
                and (self.stream_resident or feat._genome_resident_worthwhile(table, self.fasta, self.device)))

    @property
    def stream_resident_possible(self) -> bool:
        """Whether a streaming run takes every chunk's windows from the
        resident genome: on the card, where the genome packs and no host
        windows are needed."""
        return self.device.type == "cuda" and self.genome_packable and not self.blacklist_cg_insertions

    def scorer(self, names: list[str]) -> FusedScorer:
        """The run's device scorer for feature order ``names``, built once."""
        key = tuple(names)
        with self._scorer_lock:
            if key not in self._scorers:
                self._scorers[key] = FusedScorer(self.model, names, self.forest_strategy, self.flow_order,
                                                 self.device)
            return self._scorers[key]

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
            scorer = self.scorer(hf.names)
            try:
                with self._device_lock:
                    sent = scorer.sent_bytes
                    score = scorer.score(hf, genome, gpos)
                    sent = scorer.sent_bytes - sent
            except Exception as e:  # noqa: BLE001 — classified and re-raised
                if _sticky_device_error(e):
                    raise DeviceFault(f"the device failed scoring {len(table)} records: {e}") from e
                raise
        log.info(TRANSFER_LOG, sent, len(table))
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


def quarantine_path(out_path: str) -> str:
    return str(out_path) + QUARANTINE_SUFFIX


def _guard_chunk(table: VariantTable, what: str, body):
    """The quarantine rung of the recovery ladder for one chunk body: runs
    ``body()``; on failure re-raises (the default: a poison chunk fails the
    run) or, with ``VCTPU_QUARANTINE=1`` on the last re-dispatch attempt,
    returns None: the render stage then writes the chunk's original records
    to ``<out>.quarantine`` and nothing to the output. ``EngineError``, the
    watchdog's error and :class:`DeviceFault` always fail the run."""
    try:
        # injection point: a deterministic per-chunk poison
        faults.check("pipeline.chunk")
        return body()
    except (engine_mod.EngineError, pipeline_mod.StageTimeoutError, pipeline_mod.LadderEscalation):
        raise
    except Exception as e:  # noqa: BLE001 — opt-in quarantine is recorded; otherwise re-raised
        if not knobs.get_bool("VCTPU_QUARANTINE") or not pipeline_mod.on_final_attempt():
            raise
        pipeline_mod.record_quarantine(what, len(table), e)
        return None


def streaming_eligible(args_limit_to_contig=None) -> bool:
    """The streaming executor runs where host threads are available
    (``VCTPU_THREADS`` != 1, ``VCTPU_STREAM`` on), the native engine is
    built, and the job is the whole file. Anything else selects the serial
    path."""
    if not knobs.get_bool("VCTPU_STREAM") or pipeline_mod.resolve_threads() <= 1:
        return False
    return native.available() and not args_limit_to_contig


def _sink_write(sink, data) -> None:
    """Write ``data`` to an output sink with bounded retry on transient IO
    errors (ENOSPC, EIO). A rewindable sink (a plain file) is restored to
    its position before each retry, so a half-written attempt cannot
    duplicate bytes; any other sink is not retried."""
    try:
        pos = sink.tell()
    except (AttributeError, OSError):
        pos = None

    def attempt() -> None:
        if pos is not None and sink.tell() != pos:
            sink.seek(pos)
            sink.truncate()
        # injection point "io.writeback": fires before bytes move
        faults.check("io.writeback")
        sink.write(data)

    pipeline_mod.retry_transient(attempt, "output writeback", attempts=None if pos is not None else 1)


def _prefetch_genome(ctx: FilterContext, cancel: threading.Event) -> None:
    """The ``genome-prefetch`` thread's work: on the card, the resident genome
    (a chunk that needs it first waits for this build); elsewhere the host
    encode of every contig (and the ``.venc`` sidecar), where the genome fits
    ``VCTPU_FASTA_CACHE_BYTES``. A failure is the chunks' to report: they
    build for themselves and raise."""
    try:
        if ctx.stream_resident:
            feat.device_genome(ctx.fasta, ctx.device)
        elif ctx.fasta.genome_bytes() <= knobs.get_int("VCTPU_FASTA_CACHE_BYTES"):
            ctx.fasta.encode_all(cancel=cancel)
    except Exception as e:  # noqa: BLE001 — recorded; the chunk bodies raise it again
        degrade.record("stream.genome_prefetch", e, warn=True, fallback="the chunks build the genome themselves")


def run_streaming(args, ctx: FilterContext) -> dict:
    """Chunked streaming execution: chunk ingest, featurize and score on the
    run's device, ordered writeback, overlapped on the stage executor
    (:mod:`parallel.pipeline`). Counterpart of the reference's
    ``run_streaming`` on one device and one rank. The output bytes are the
    serial path's: chunks are sequence-numbered, written strictly in order,
    and each runs the code the whole-table path runs.

    Failure semantics:

    - the output is committed atomically: bytes accumulate in
      ``<out>.partial.<pid>-<hex>`` and are renamed onto the destination
      after the last chunk;
    - ``.vcf`` outputs keep a chunk journal (``<out>.journal``), so an
      interrupted run resumes (``VCTPU_RESUME``, checked per
      ``VCTPU_RESUME_VERIFY``); ``.vcf.gz`` outputs restart;
    - transient ingest and writeback IO errors are retried with backoff
      (``VCTPU_IO_RETRIES``, ``VCTPU_IO_BACKOFF_S``), a failed chunk body is
      re-dispatched (``VCTPU_CHUNK_RETRIES``) and then fails the run or,
      with ``VCTPU_QUARANTINE=1``, goes to the ``.quarantine`` sidecar; a
      hung stage trips the watchdog (``VCTPU_STAGE_TIMEOUT_S``); a sticky
      device fault fails the run at once (:class:`DeviceFault`);
    - every exit joins the prefetch thread and the stage workers.

    The caller has checked :func:`streaming_eligible`. Returns the run's
    counts (records, chunks, resumed, quarantined, cache traffic, layout,
    peak device memory).
    """
    ctx.stream_resident = ctx.stream_resident_possible
    lease = feat.lease_genome(ctx.fasta, ctx.device) if ctx.stream_resident else contextlib.nullcontext()
    try:
        with lease:
            return _run_streaming_impl(args, ctx)
    finally:
        ctx.stream_resident = False


def _run_streaming_impl(args, ctx: FilterContext) -> dict:
    on_card = ctx.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    # the device's first use (kernel libraries, the window features' and the
    # families' programs) before the stream, outside any chunk's watchdog
    ctx.scorer(ctx.feature_names).warm_up()
    reader = VcfChunkReader(args.input_file)
    prefetch_cancel = threading.Event()
    prefetch = threading.Thread(target=_prefetch_genome, args=(ctx, prefetch_cancel), name="genome-prefetch",
                                daemon=True)
    prefetch.start()
    try:
        return _stream(args, ctx, reader)
    finally:
        # on every exit the IO pool is shut down and the prefetch cancelled
        # and joined (a dying run must not cut a sidecar write short)
        reader.close()
        prefetch_cancel.set()
        prefetch.join()


def _stream(args, ctx: FilterContext, reader: VcfChunkReader) -> dict:
    """:func:`_run_streaming_impl` past its set-up: the stage pipeline, the
    sequenced commit, the atomic rename and the ``.tbi``."""
    from variantcalling_tpu_torch.io import chunk_cache as chunk_cache_mod
    from variantcalling_tpu_torch.io import identity as identity_mod
    from variantcalling_tpu_torch.io import journal as journal_mod

    header = reader.header
    _ensure_output_header(header, ctx.engine, ctx.forest_strategy, ctx.model_family)

    def score_stage(table):
        # the chunk body rides the recovery ladder: the executor (serial IO)
        # or raw_chunk_worker (pooled) re-dispatches; the guard quarantines
        out = _guard_chunk(table, "score_stage", lambda: ctx.score_table(table))
        return (table, None, None) if out is None else (table, *out)

    def render_stage(item):
        table, score, filters = item
        if score is None:
            # quarantined chunk: nothing to the output, the original records
            # (no TREE_SCORE, the original FILTER) to the sidecar
            qbody = assemble_table_bytes(table)
            if qbody is None:
                qbody = render_table_bytes_python(table)
            return b"", len(table), 0, bytes(qbody)
        extra = {"TREE_SCORE": np.round(score, 4)}
        body = assemble_table_bytes(table, new_filters=filters, extra_info=extra)
        if body is None:
            body = render_table_bytes_python(table, new_filters=filters, extra_info=extra)
        return body, len(table), int(np.sum(filters.codes == 0)), None

    def raw_chunk_worker(item):
        """One chunk's whole body over its raw buffer: parse, score, render,
        inside the chunk's re-dispatch budget. With the cache on, the raw
        span is keyed first: a hit returns the stored rendered body; a miss
        computes and stages its result for publication at commit."""
        seq, (buf_np, lazy_buf) = item
        ckey = None
        if cache_session is not None:
            ckey = cache_session.key_of(buf_np)
            hit = cache_session.get(ckey)
            if hit is not None:
                body, k, p = hit
                return body, k, p, None

        def body():
            faults.check("pipeline.stage")
            faults.check("pipeline.stage_hang")
            return render_stage(score_stage(reader.parse_chunk(buf_np, lazy_buf)))

        out = pipeline_mod.retry_chunk(body, "chunk_worker", seq=seq)
        if ckey is not None and out[3] is None:
            # clean chunks only: a quarantined chunk's empty body is not a
            # function of its input
            cache_session.stage(seq, ckey, out[0], out[1], out[2])
        return out

    out_path = str(args.output_file)
    gz = out_path.endswith(".gz")
    header_bytes = (b"".join((line + "\n").encode() for line in header.lines)
                    + (header.column_header() + "\n").encode())

    compressor = None
    if gz:
        from variantcalling_tpu_torch.io.bgzf import BgzfChunkCompressor

        compressor = BgzfChunkCompressor(pool=reader.shared_pool() if reader.io_threads > 1 else None)

        def compress_stage(item):
            body, k, p, q = item
            if not len(body):  # a quarantined chunk: nothing to compress
                return b"", k, p, q
            return compressor.add(memoryview(body) if isinstance(body, np.ndarray) else body), k, p, q

        # the one stage that is not a pure chunk body: the BGZF carry takes
        # every byte it sees, so it runs exactly once a chunk and a failure
        # fails the run
        compress_stage.retry_safe = False

    scoring_cfg = identity_mod.scoring_config(
        args, engine=ctx.engine, forest_strategy=ctx.forest_strategy, model_family=ctx.model_family,
        model_digest=dan_mod.weights_digest(ctx.model) if isinstance(ctx.model, DanModel) else None)

    # resume only for plain-text outputs: a killed BGZF writer's block
    # state is lost, so .gz runs restart (still atomically)
    resume_enabled = not gz and knobs.get_bool("VCTPU_RESUME")
    resume = journal = meta = None
    if resume_enabled:
        meta = identity_mod.resume_meta(args, chunk_bytes=reader.chunk_bytes, header_bytes=header_bytes,
                                        config=scoring_cfg)
        resume = journal_mod.try_resume(out_path, meta, claim=True)

    n_total = n_pass = n_chunks = 0
    q_path = quarantine_path(out_path)
    if resume is None:
        # a fresh run: an older run's quarantine sidecar must not mix with
        # this run's (a resumed run keeps it: its journaled chunks are skipped)
        try:
            os.remove(q_path)
        except OSError:
            pass
    # the partial's token is claimed before the file exists, and released
    # on every exit from here on
    part_token = None
    try:
        if resume is not None:
            n_chunks, n_total, n_pass = resume.chunks, resume.n_records, resume.n_pass
            part_token = resume.partial_token  # re-tokened and claimed by try_resume
            reader.skip(resume.chunks)
            sink = journal_mod.open_partial(out_path, part_token, "ab")  # truncated to the watermark
            journal = journal_mod.ChunkJournal(out_path)
            journal.reopen()
            log.info("streaming resume: %d chunks (%d records) already committed", resume.chunks, resume.n_records)
        else:
            journal_mod.discard(out_path)  # leftovers of older runs
            part_token = journal_mod.new_partial_token()
            journal_mod.claim_token(part_token)
            sink = journal_mod.open_partial(out_path, part_token, "wb")
            if resume_enabled:
                journal = journal_mod.ChunkJournal(out_path)
                journal.begin(dict(meta, partial=part_token))
    except BaseException:
        if part_token is not None:
            journal_mod.release_token(part_token)
        raise

    # chunk-result cache: opened after the resume decision, so sequence
    # numbers count post-skip delivery order on both sides
    cache_session = chunk_cache_mod.open_session(scoring_cfg)
    if reader.io_threads > 1:
        # pooled: each chunk's whole body (parse, score, render) is one task
        # over its raw buffer on the IO pool, reassembled in order
        layout = "pooled"
        source = pipeline_mod.imap_ordered(reader.shared_pool(), raw_chunk_worker, enumerate(reader.iter_raw()),
                                           window=reader.io_threads + 2)
        stages = []
    elif cache_session is not None:
        # serial IO with the cache: the same raw-buffer body, inline on the
        # feed (lookups key the raw span)
        layout = "serial-io-cached"
        source = map(raw_chunk_worker, enumerate(reader.iter_raw()))
        stages = []
    else:
        layout = "serial-io"
        source = reader
        stages = [score_stage, render_stage]
    if compressor is not None:
        stages.append(compress_stage)
    pipe = pipeline_mod.StagePipeline(stages, queue_depth=2, recover=True)
    gen = pipe.run(source)
    ok = False
    resumed_chunks = n_chunks
    n_quar_chunks = n_quar_records = 0
    qsink = None
    try:
        with sink:
            if resume is None:
                # the header rides the block stream the bodies do, as the
                # serial writer's buffer takes it
                _sink_write(sink, compressor.add(header_bytes) if compressor is not None else header_bytes)
            for body, k, p, qbody in gen:
                if qbody:
                    # the sidecar is appended before the journal claims the
                    # chunk: a kill between them can duplicate records in it
                    # on resume, never lose them
                    if qsink is None:
                        qsink = open(q_path, "ab")
                    _sink_write(qsink, qbody)
                    qsink.flush()
                    n_quar_chunks += 1
                    n_quar_records += k
                data = memoryview(body) if isinstance(body, np.ndarray) else body
                _sink_write(sink, data)
                n_total += k
                n_pass += p
                n_chunks += 1
                if journal is not None:
                    # the journal never claims bytes still in the write buffer
                    sink.flush()
                    if journal_mod.fsync_enabled():
                        os.fsync(sink.fileno())
                    journal.append(n_chunks - 1, k, p, len(data), zlib.crc32(data),
                                   in_end=reader.chunk_end(n_chunks - 1))
                if cache_session is not None:
                    # committed-prefix publication
                    cache_session.publish_up_to(n_chunks - resumed_chunks - 1)
            if compressor is not None:
                _sink_write(sink, compressor.finish())  # the last partial block and the EOF block
        ok = True
    finally:
        # every exit: the stage workers drained and joined, the journal closed
        gen.close()
        if qsink is not None:
            qsink.close()
        if journal is not None:
            journal.close()
        if cache_session is not None and not ok:
            cache_session.discard()
        if not ok:
            journal_mod.release_token(part_token)
            if journal is None:
                journal_mod.remove_partial(out_path, part_token)  # nothing to resume: no droppings
            else:
                log.info("streaming run failed after %d chunks; partial output and journal kept for resume",
                         n_chunks)

    def _commit():
        # injection point "io.commit": fires before the rename, so a
        # persistent failure leaves the journal and partial for a resume
        faults.check("io.commit")
        journal_mod.commit_partial(out_path, part_token)

    try:
        pipeline_mod.retry_transient(_commit, "output commit")
    except BaseException:
        journal_mod.release_token(part_token)
        if journal is None:
            journal_mod.remove_partial(out_path, part_token)
        else:
            log.info("output commit failed after %d chunks; partial output and journal kept for resume", n_chunks)
        raise
    journal_mod.release_token(part_token)
    if journal is not None:
        journal.finish()
    if n_quar_chunks:
        log.warning("quarantine: %d chunk(s), %d record(s) diverted to %s — the output lacks that many records",
                    n_quar_chunks, n_quar_records, q_path)
    if gz:
        write_tabix(out_path)
    stats = {"n": n_total, "n_pass": n_pass, "chunks": n_chunks, "layout": layout,
             "resumed_chunks": resume.chunks if resume is not None else 0,
             "quarantined_chunks": n_quar_chunks, "quarantined_records": n_quar_records,
             "cache": cache_session.stats() if cache_session is not None else None,
             "peak_device_bytes": torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else -1}
    log.info(STREAM_LOG, out_path, layout, n_chunks, stats["resumed_chunks"], n_quar_chunks, n_total,
             stats["cache"]["hits"] if stats["cache"] else 0, stats["peak_device_bytes"])
    return stats


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
        except DeviceFault as e:
            log.error("%s", e)
            return 1


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
    if streaming_eligible(args.limit_to_contig):
        log.info("streaming %s", args.input_file)
        stats = run_streaming(args, ctx)
        log.info("wrote %s: %d variants, %d PASS", args.output_file, stats["n"], stats["n_pass"])
        return 0
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
