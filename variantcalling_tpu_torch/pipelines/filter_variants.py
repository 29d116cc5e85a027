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

Under a pod launch (``VCTPU_RANK`` with ``VCTPU_NUM_PROCESSES``, or an
elastic worker's ``VCTPU_SPAN``; ``parallel/rank_plan``) the run is one
worker of N: it streams its line-aligned span of the input into its segment
beside the output, seals it with a ``.done`` marker and never writes the
output itself; ``merge-ranks`` or the pod launcher (``parallel/podrun``)
commits. A launch that cannot stream exits 2.

A process builds each model's predictor once (:func:`predictor_for`: a
forest's kernel with its tables on the card), so a resident process such as
the serving daemon pays no table build or upload on a warm request; inside
one of its requests the run polls the request's cancel token
(``utils/cancellation``) at every chunk it commits, or at the serial path's
stage boundaries.

Telemetry: with ``VCTPU_OBS=1`` the run writes its obs stream
(:mod:`obs`) to ``<output_file>.obs.jsonl`` (or ``VCTPU_OBS_PATH``): the
manifest, the resolved engine, strategy and family, one causal trace a
chunk (``ingest``, ``score_stage``, ``render_stage``, ``compress_stage``,
``writeback`` spans), heartbeats, the stage profiler's attribution and the
forest kernel's counted work (``cost_analysis``); the output bytes are the
same either way, and no span synchronizes the card.

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
from variantcalling_tpu_torch import knobs, native, obs
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
from variantcalling_tpu_torch.utils import cancellation, degrade, faults, h5_utils, trace
from variantcalling_tpu_torch.utils.keyed_cache import KeyedCache
from variantcalling_tpu_torch.utils.stages import stage

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


#: built predictors: a forest's kernel with its tables on the device (or the
#: gather walk) and its host finalize, or a family's program, keyed by the
#: model's identity, the feature order, the resolved strategy and the device.
#: A process that scores many runs of one model (the serving daemon) builds
#: and uploads the tables once. Each entry holds its model, so the model's id
#: in the key stays its own while the entry lives. Bounded FIFO.
PREDICTOR_CACHE_MAX = 8
_PREDICTORS = KeyedCache("predictor", PREDICTOR_CACHE_MAX)


def _build_predictor(model, names: list[str], strategy: str, device: torch.device):
    """(model, program, host finalize or None) of one cache entry."""
    if isinstance(model, FlatForest):
        forest = forest_mod.with_feature_order(model, names)
        program = forest_mod.make_margin_predictor(forest, len(names), strategy, device)
        return model, program, (lambda margin: forest_mod.finalize_margin(margin, forest))
    if isinstance(model, DanModel):
        return model, dan_mod.make_score_predictor(model, names, device), None
    return model, threshold_mod.make_score_predictor(model, names, device), None


def predictor_for(model, names: list[str], strategy: str, device: torch.device):
    """(program, host finalize or None) for ``model`` over feature order
    ``names`` with ``strategy`` on ``device``, built on the first request."""
    key = (id(model), tuple(names), strategy, str(device))
    _, program, finalize = _PREDICTORS.get(key, lambda: _build_predictor(model, names, strategy, device))
    return program, finalize


def predictor_cache_stats() -> dict:
    """Entries, hits and misses (each miss one build) of the predictor cache."""
    return _PREDICTORS.stats()


class FusedScorer:
    """The device half of scoring for one feature layout, one chunk at a time:
    the windows (sent from the host, or gathered from the resident genome),
    the window features, the (N, F) float32 matrix and the family's program
    (forest margins through the strategy's kernel, threshold or DAN scores;
    built once a process, :func:`predictor_for`). Counts the bytes it sends
    to the device (``sent_bytes``)."""

    def __init__(self, model, names: list[str], strategy: str, flow_order: str, device: torch.device):
        self.names = list(names)
        self.flow_order = flow_order
        self.device = device
        self.sent_bytes = 0
        self._sent_lock = threading.Lock()
        self.strategy = strategy
        # finalize: None for the threshold and DAN programs, which return final scores
        self.program, self.finalize = predictor_for(model, self.names, strategy, device)

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
        if n and obs.active() and hasattr(self.program, "work"):
            # the forest kernel's counted work, once a run and strategy
            from variantcalling_tpu_torch.obs import profile as profile_mod

            profile_mod.record_scoring_cost(self.strategy, self.program, n)
        return out if self.finalize is None else self.finalize(out)


class FilterContext:
    """Run-level scoring state: model wiring, blacklist, hpol runs, interval sets.

    The engine, the model family, the forest strategy and whether the
    genome's positions pack into 4 bytes are decided here once per run.
    ``family`` is the run's ``VCTPU_MODEL_FAMILY`` request (None: read it);
    ``rank_plan`` its ``parallel/rank_plan.RankPlan`` (None: resolved from
    the environment; a malformed one raises ``EngineError``).
    """

    def __init__(self, model, fasta: FastaReader, device: torch.device,
                 runs_file: str | None = None, hpol_length: int = 10, hpol_dist: int = 10,
                 blacklist: tuple[np.ndarray, np.ndarray] | None = None,
                 blacklist_cg_insertions: bool = False,
                 annotate_intervals: dict[str, bedio.IntervalSet] | None = None,
                 flow_order: str = "TGCA", is_mutect: bool = False, family: str | None = None, rank_plan=None):
        from variantcalling_tpu_torch.parallel import rank_plan as rank_plan_mod

        self.device = device
        # the run's rank layout: the one run_scaleout partitioned by,
        # else resolved here, so the reader's span and the header's
        # ##vctpu_ranks= line never disagree
        self.rank_plan = rank_plan if rank_plan is not None else rank_plan_mod.resolve()
        rank_plan_mod.log_plan(self.rank_plan)
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
        if obs.active():
            # the run's decisions, once a run, beside the stream's spans
            obs.event("resolve", "engine", value=self.engine, requested=device.type,
                      reason=f"the run's device is {device}")
            obs.event("resolve", "forest_strategy", value=self.forest_strategy,
                      requested=forest_mod.requested_strategy() if isinstance(model, FlatForest) else "-",
                      reason=f"model type {type(model).__name__}")
            obs.event("resolve", "model_family", value=self.model_family,
                      requested=registry.requested_family() if family is None else family,
                      reason=f"model type {type(model).__name__}")
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
        with stage("host_featurize"):
            hf = self.host_features(table, compute_windows=not resident)
        genome = gpos = None
        if resident:
            with stage("genome"):
                genome = feat.device_genome(self.fasta, self.device)
                gpos = feat.pack_global_positions(feat.globalize_positions(table, genome), genome)
        log.info(WINDOW_LOG, "genome-resident" if resident else "host gather")
        with stage("device_score"):
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
        with stage("filters"):
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


def _ensure_output_header(header, engine: str, strategy: str, family: str, rank_plan=None) -> None:
    """The pipeline's header additions: FILTER/INFO definitions, then the
    engine and forest-strategy provenance lines, and the model family's
    line for threshold and DAN runs (forest runs write none and strip a
    stale one, so their bytes stay the reference's). A run of more than one
    rank records ``##vctpu_ranks=n=N`` (``rank_plan.header_line``: N, never
    the rank, so every rank's segment carries the same header bytes); other
    runs strip a stale one."""
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
    if rank_plan is not None and rank_plan.ranks > 1:
        header.add_meta_line(rank_plan.header_line())


def quarantine_path(out_path: str) -> str:
    return str(out_path) + QUARANTINE_SUFFIX


def _traced_chunks(tables):
    """The causal-tracing ingest boundary of the serial-IO layout: every
    chunk table gets a run-scoped trace id, carried on the table
    (``_obs_trace``), and its root ``ingest`` span, so every later stage of
    the chunk (score, render, compress, the sequenced commit) and every
    recovery event links to it. Ids are allocated in chunk order. A
    pass-through when tracing is off (``obs.new_trace`` returns None)."""
    it = iter(tables)
    while True:
        t0 = time.perf_counter()
        try:
            table = next(it)
        except StopIteration:
            return
        tid = obs.new_trace()
        if tid is not None:
            table._obs_trace = tid
            obs.trace_span(tid, "ingest", time.perf_counter() - t0, records=len(table))
        yield table


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


def streaming_eligible(args_limit_to_contig=None, allow_multiprocess: bool = False) -> bool:
    """The streaming executor runs where host threads are available
    (``VCTPU_THREADS`` != 1, ``VCTPU_STREAM`` on), the native engine is
    built, and the job is the whole file in one process. Anything else
    selects the serial path. ``allow_multiprocess``: the rank-partitioned
    path's opt-in (``parallel/rank_plan``): a rank is one of N processes
    by design, streaming over its own span. Without it, a process of an
    initialized ``torch.distributed`` group of more than one is not
    eligible, as the reference's check of ``jax.process_count`` decides."""
    if not knobs.get_bool("VCTPU_STREAM") or pipeline_mod.resolve_threads() <= 1:
        return False
    if not native.available() or args_limit_to_contig:
        return False
    if not allow_multiprocess and torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size() <= 1
    return True


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
    ``run_streaming`` on one device. The output bytes are the serial path's:
    chunks are sequence-numbered, written strictly in order, and each runs
    the code the whole-table path runs. Under a rank or span plan
    (``ctx.rank_plan``) the run reads only its span of the input and writes
    it with a ``##vctpu_ranks=n=N`` line (N > 1); its output is then a rank
    segment (``parallel/rank_plan.run_scaleout``).

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
    # telemetry: a caller that came through run() already opened the obs run
    # (start_run returns None and the events join it); a direct caller gets
    # its own stream here
    obs_run = obs.start_run("filter_variants_pipeline", default_path=str(args.output_file) + ".obs.jsonl",
                            inputs={"input": args.input_file}, device=str(ctx.device))
    ctx.stream_resident = ctx.stream_resident_possible
    lease = feat.lease_genome(ctx.fasta, ctx.device) if ctx.stream_resident else contextlib.nullcontext()
    try:
        with lease:
            stats = _run_streaming_impl(args, ctx)
    except BaseException as e:
        obs.end_run(obs_run, f"error: {type(e).__name__}")
        raise
    finally:
        ctx.stream_resident = False
    obs.end_run(obs_run, "ok")
    return stats


def _run_streaming_impl(args, ctx: FilterContext) -> dict:
    on_card = ctx.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    # the device's first use (kernel libraries, the window features' and the
    # families' programs) before the stream, outside any chunk's watchdog
    ctx.scorer(ctx.feature_names).warm_up()
    from variantcalling_tpu_torch.obs import profile as profile_mod
    from variantcalling_tpu_torch.obs import sampler as sampler_mod

    # the stage profiler, made before the reader so the IO pool's inflate
    # and parse work is attributed from the first shard; the executor feeds
    # each stage's work and waits into it, the commit loop its writeback
    prof = profile_mod.StageProfiler() if profile_mod.enabled() else None
    # this thread runs the sequenced commit for the run
    sampler_mod.register_current("committer")
    # a rank's reader takes only its line-aligned span (a rank fraction, or an
    # elastic worker's absolute targets); its chunks, journal and segment are
    # the rank's own
    plan = ctx.rank_plan
    reader = VcfChunkReader(args.input_file, profiler=prof,
                            rank_span=(plan.rank, plan.ranks) if plan.ranks > 1 else None, span_targets=plan.span)
    prefetch_cancel = threading.Event()
    prefetch = threading.Thread(target=_prefetch_genome, args=(ctx, prefetch_cancel), name="genome-prefetch",
                                daemon=True)
    prefetch.start()
    try:
        return _stream(args, ctx, reader, prof)
    finally:
        # on every exit the IO pool is shut down and the prefetch cancelled
        # and joined (a dying run must not cut a sidecar write short)
        reader.close()
        prefetch_cancel.set()
        prefetch.join()


def _stream(args, ctx: FilterContext, reader: VcfChunkReader, prof=None) -> dict:
    """:func:`_run_streaming_impl` past its set-up: the stage pipeline, the
    sequenced commit, the atomic rename and the ``.tbi``. Each chunk's item
    carries its trace id from render on (the table is dropped there)."""
    from variantcalling_tpu_torch.io import chunk_cache as chunk_cache_mod
    from variantcalling_tpu_torch.io import identity as identity_mod
    from variantcalling_tpu_torch.io import journal as journal_mod

    header = reader.header
    _ensure_output_header(header, ctx.engine, ctx.forest_strategy, ctx.model_family, ctx.rank_plan)

    def score_stage(table):
        # the chunk body rides the recovery ladder: the executor (serial IO)
        # or raw_chunk_worker (pooled) re-dispatches; the guard quarantines.
        # The chunk's trace is bound to the thread meanwhile, so the ladder's
        # events name it
        tid = getattr(table, "_obs_trace", None)
        with obs.trace_scope(tid):
            t0 = time.perf_counter()
            out = _guard_chunk(table, "score_stage", lambda: ctx.score_table(table))
            if tid is not None:
                obs.trace_span(tid, "score_stage", time.perf_counter() - t0, records=len(table))
        return (table, None, None) if out is None else (table, *out)

    def render_stage(item):
        table, score, filters = item
        # the trace id rides the rendered tuple from here on
        tid = getattr(table, "_obs_trace", None)
        t0 = time.perf_counter()
        if score is None:
            # quarantined chunk: nothing to the output, the original records
            # (no TREE_SCORE, the original FILTER) to the sidecar
            qbody = assemble_table_bytes(table)
            if qbody is None:
                qbody = render_table_bytes_python(table)
            out = b"", len(table), 0, bytes(qbody), tid
        else:
            extra = {"TREE_SCORE": np.round(score, 4)}
            body = assemble_table_bytes(table, new_filters=filters, extra_info=extra)
            if body is None:
                body = render_table_bytes_python(table, new_filters=filters, extra_info=extra)
            out = body, len(table), int(np.sum(filters.codes == 0)), None, tid
        if tid is not None:
            obs.trace_span(tid, "render_stage", time.perf_counter() - t0, records=len(table))
        return out

    def _timed_worker(fn, stage_name, item, n_records):
        """One stage callable on an IO-pool worker, with the span and
        histogram the executor gives a stage, and the worker's own
        attribution row (``<stage>.w<idx>``)."""
        if not obs.active():
            return fn(item)
        t0 = time.perf_counter()
        out = fn(item)
        dt = time.perf_counter() - t0
        tname = threading.current_thread().name
        obs.span(stage_name, dt, tname)
        obs.histogram(f"stage.{stage_name}.s").observe(dt)
        if prof is not None:
            prof.stage(f"{stage_name}.{tname.rsplit('-', 1)[-1]}").add_work(dt, records=n_records)
        return out

    def raw_chunk_worker(item):
        """One chunk's whole body over its raw buffer: parse, score, render,
        inside the chunk's re-dispatch budget. With the cache on, the raw
        span is keyed first: a hit returns the stored rendered body (its
        trace: one ``cache_hit`` span and the commit's); a miss computes and
        stages its result for publication at commit. The trace id was
        allocated at the raw feed; the ``ingest`` span, the parse, is
        emitted once a chunk whatever the retries spend."""
        seq, (buf_np, lazy_buf), tid = item
        ckey = None
        if cache_session is not None:
            ckey = cache_session.key_of(buf_np)
            hit = cache_session.get(ckey)
            if hit is not None:
                body, k, p = hit
                if tid is not None:
                    obs.trace_span(tid, "cache_hit", 0.0, records=k)
                return body, k, p, None, tid
        ingest_span_emitted = [False]

        def body():
            faults.check("pipeline.stage")
            faults.check("pipeline.stage_hang")
            t0 = time.perf_counter()
            table = reader.parse_chunk(buf_np, lazy_buf)
            if tid is not None:
                table._obs_trace = tid
                if not ingest_span_emitted[0]:
                    ingest_span_emitted[0] = True
                    obs.trace_span(tid, "ingest", time.perf_counter() - t0, records=len(table))
            scored = _timed_worker(score_stage, "score_stage", table, len(table))
            return _timed_worker(render_stage, "render_stage", scored, len(table))

        with obs.trace_scope(tid):
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
            body, k, p, q, tid = item
            if not len(body):  # a quarantined chunk: nothing to compress
                return b"", k, p, q, tid
            data = memoryview(body) if isinstance(body, np.ndarray) else body
            t0 = time.perf_counter()
            out = compressor.add(data)
            if tid is not None:
                obs.trace_span(tid, "compress_stage", time.perf_counter() - t0, bytes_in=len(data))
            return out, k, p, q, tid

        # the one stage that is not a pure chunk body: the BGZF carry takes
        # every byte it sees, so it runs exactly once a chunk and a failure
        # fails the run
        compress_stage.retry_safe = False

    scoring_cfg = identity_mod.scoring_config(
        args, engine=ctx.engine, forest_strategy=ctx.forest_strategy, model_family=ctx.model_family,
        model_digest=dan_mod.weights_digest(ctx.model) if isinstance(ctx.model, DanModel) else None,
        rank=ctx.rank_plan.rank, ranks=ctx.rank_plan.ranks, span=ctx.rank_plan.span)

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
            if obs.active():
                obs.event("journal", "resume_decision", outcome="resumed", chunks=resume.chunks,
                          records=resume.n_records, watermark=resume.watermark)
        else:
            journal_mod.discard(out_path)  # leftovers of older runs
            part_token = journal_mod.new_partial_token()
            journal_mod.claim_token(part_token)
            sink = journal_mod.open_partial(out_path, part_token, "wb")
            if resume_enabled:
                journal = journal_mod.ChunkJournal(out_path)
                journal.begin(dict(meta, partial=part_token))
            if obs.active():
                if gz:
                    obs.event("journal", "resume_decision", outcome="disabled",
                              reason="gz output: BGZF block state does not survive a kill")
                else:
                    obs.event("journal", "resume_decision", outcome="fresh" if resume_enabled else "opted_out",
                              journaling=resume_enabled)
    except BaseException:
        if part_token is not None:
            journal_mod.release_token(part_token)
        raise

    # chunk-result cache: opened after the resume decision, so sequence
    # numbers count post-skip delivery order on both sides
    cache_session = chunk_cache_mod.open_session(scoring_cfg)

    def traced_raw(raws):
        # trace ids allocated at the raw feed, in chunk order (the pooled
        # workers parse concurrently); the sequence number is the cache's
        # staging key
        for seq, raw in enumerate(raws):
            yield seq, raw, obs.new_trace()

    if reader.io_threads > 1:
        # pooled: each chunk's whole body (parse, score, render) is one task
        # over its raw buffer on the IO pool, reassembled in order
        layout = "pooled"
        source = pipeline_mod.imap_ordered(reader.shared_pool(), raw_chunk_worker, traced_raw(reader.iter_raw()),
                                           window=reader.io_threads + 2)
        stages = []
    elif cache_session is not None:
        # serial IO with the cache: the same raw-buffer body, inline on the
        # feed (lookups key the raw span)
        layout = "serial-io-cached"
        source = map(raw_chunk_worker, traced_raw(reader.iter_raw()))
        stages = []
    else:
        layout = "serial-io"
        source = _traced_chunks(reader)
        stages = [score_stage, render_stage]
    if compressor is not None:
        stages.append(compress_stage)
    # the feed of the raw-buffer layouts attributes its own work (the chunk
    # bodies on the workers), so time blocked in it is wait, not work
    pipe = pipeline_mod.StagePipeline(stages, queue_depth=2, recover=True, profiler=prof, source_name="ingest",
                                      consumer_name="writeback", source_pooled=layout != "serial-io")
    gen = pipe.run(source)
    wb = prof.stage("writeback") if prof is not None else None
    # heartbeats: progress counts every committed chunk, resumed ones too;
    # the rate counts the records this run scored over its elapsed time. A .gz
    # input's chunks count inflated bytes, so its heartbeats carry no pct
    bytes_comparable = not args.input_file.endswith(".gz")
    # a rank's reader takes its span only: progress is over the span's bytes
    input_bytes = reader.span_bytes if reader.span_bytes is not None else os.path.getsize(args.input_file)
    resumed_records = n_total
    t_start = time.perf_counter()
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
            for body, k, p, qbody, trace_id in gen:
                # cooperative cancellation (a serving daemon's deadline or drain): chunk-granular,
                # raising here unwinds through the failure teardown below, never a torn commit
                cancellation.check("streaming filter run")
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
                if wb is not None or trace_id is not None:
                    t0 = time.perf_counter()
                    _sink_write(sink, data)
                    dt = time.perf_counter() - t0
                    if wb is not None:
                        wb.add_work(dt, bytes_out=len(data))
                    if trace_id is not None:
                        # the sequenced commit: the terminal span of the chunk's DAG
                        obs.trace_span(trace_id, "writeback", dt, chunk=n_chunks, bytes_out=len(data))
                        obs.end_trace(trace_id)
                else:
                    _sink_write(sink, data)
                n_total += k
                n_pass += p
                n_chunks += 1
                if obs.active():
                    _heartbeat(k, p, n_chunks, n_total, n_pass, resumed_chunks, resumed_records,
                               time.perf_counter() - t_start, reader.chunk_bytes,
                               input_bytes if bytes_comparable else None)
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
            # failure or cancellation: every unpublished chunk is dropped
            cache_session.discard()
        if not ok:
            journal_mod.release_token(part_token)
            if journal is None:
                journal_mod.remove_partial(out_path, part_token)  # nothing to resume: no droppings
            else:
                log.info("streaming run failed after %d chunks; partial output and journal kept for resume",
                         n_chunks)
                if obs.active():
                    obs.event("journal", "kept_for_resume", chunks=n_chunks)

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
    if cache_session is not None:
        cache_session.finish()
    if obs.active():
        obs.event("journal", "committed", chunks=n_chunks, records=n_total)
    if n_quar_chunks:
        log.warning("quarantine: %d chunk(s), %d record(s) diverted to %s — the output lacks that many records",
                    n_quar_chunks, n_quar_records, q_path)
    if prof is not None:
        # ingest bytes: the reader takes chunk_bytes of (inflated) text a
        # chunk, capped at the file's size where the two compare
        approx = n_chunks * reader.chunk_bytes
        prof.stage("ingest").bytes_in = min(approx, input_bytes) if bytes_comparable else approx
        prof.emit(wall_s=time.perf_counter() - t_start, records=n_total - resumed_records)
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


def _heartbeat(k: int, p: int, n_chunks: int, n_total: int, n_pass: int, resumed_chunks: int,
               resumed_records: int, elapsed: float, chunk_bytes: int, input_bytes: int | None) -> None:
    """The streaming run's counters and progress event after committing a
    chunk of ``k`` records (``p`` passing): records, the variants a second
    this run scored, and, where the input's size compares with its chunks'
    (``input_bytes``), the percent done and the seconds left."""
    obs.counter("records").add(k)
    obs.counter("records_pass").add(p)
    obs.histogram("chunk.records").observe(k)
    hb = {"chunks": n_chunks, "records": n_total, "records_pass": n_pass,
          "vps": round((n_total - resumed_records) / elapsed) if elapsed > 0 else 0}
    if input_bytes:
        done = min(n_chunks * chunk_bytes, input_bytes)
        session_done = min((n_chunks - resumed_chunks) * chunk_bytes, input_bytes)
        hb["pct"] = round(100.0 * done / input_bytes, 2)
        hb["eta_s"] = round(elapsed * (input_bytes - done) / session_done, 2) \
            if 0 < session_done and done < input_bytes else 0.0
    obs.event("heartbeat", "stream", **hb)


def run(argv: list[str]) -> int:
    args = get_parser().parse_args(argv)
    try:
        knobs.validate_all()  # every VCTPU_* value, before anything is read
        family = registry.requested_family()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    # the run manifest opens the telemetry stream (VCTPU_OBS=1); the output
    # bytes are the same either way
    obs_run = obs.start_run("filter_variants_pipeline", default_path=str(args.output_file) + ".obs.jsonl",
                            argv=argv, inputs={"input": args.input_file, "model": args.model_file,
                                               "reference": args.reference_file}, device=str(device))
    status = "error"
    try:
        rc = _run_impl(args, device, family)
        status = "ok" if rc == 0 else f"exit {rc}"
        return rc
    except BaseException as e:
        status = f"error: {type(e).__name__}"
        raise
    finally:
        obs.end_run(obs_run, status)


def _run_impl(args, device: torch.device, family: str | None) -> int:
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
    run's ``VCTPU_MODEL_FAMILY`` request (None: read it).

    A rank or span launch (``parallel/rank_plan.resolve``) runs this process
    as one worker of a pod first: its span streamed into its segment, never
    the whole output (``rank_plan.run_scaleout``). A worker that lost its
    span's lease returns 6; a launch that cannot stream (``VCTPU_THREADS=1``,
    ``VCTPU_STREAM=0``, ``--limit_to_contig``, no native engine) raises
    ``EngineError`` (exit 2) before writing anything."""
    from variantcalling_tpu_torch.parallel import elastic
    from variantcalling_tpu_torch.parallel import rank_plan as rank_plan_mod

    plan = rank_plan_mod.resolve()
    partitioned = plan.ranks > 1 or plan.span is not None
    if partitioned and not rank_plan_mod.scaleout_eligible(args):
        # a launched worker has no collective to merge scores through: the
        # whole output from each of N workers would race on one destination
        raise engine_mod.EngineError(
            f"VCTPU_{'SPAN' if plan.span is not None else 'RANK'} is set but this job cannot run the "
            "rank-partitioned streaming executor (it needs the native engine, VCTPU_STREAM=1, VCTPU_THREADS>1 "
            "and no --limit_to_contig) — unset it or fix the configuration")
    ctx = FilterContext(
        model, fasta, device, runs_file=args.runs_file,
        hpol_length=args.hpol_filter_length_dist[0], hpol_dist=args.hpol_filter_length_dist[1],
        blacklist=blacklist, blacklist_cg_insertions=args.blacklist_cg_insertions,
        annotate_intervals=annotate, flow_order=args.flow_order, is_mutect=args.is_mutect,
        family=family, rank_plan=plan)
    if partitioned:
        if plan.span is not None:
            log.info("elastic scale-out: span [%d,%d) gen %d", plan.span[0], plan.span[1], plan.gen)
        else:
            log.info("rank-partitioned scale-out: rank %d of %d (%s)", plan.rank, plan.ranks, plan.source)
        try:
            with stage("scaleout"):
                return rank_plan_mod.run_scaleout(args, ctx, plan=plan)
        except elastic.LeaseLost as e:
            # benign: another worker holds this (span, generation) lease
            log.info("%s — yielding (exit %d)", e, elastic.EXIT_LEASE_LOST)
            return elastic.EXIT_LEASE_LOST
    if streaming_eligible(args.limit_to_contig):
        log.info("streaming %s", args.input_file)
        with stage("stream"):
            stats = run_streaming(args, ctx)
        log.debug("%s", trace.report())
        log.info("wrote %s: %d variants, %d PASS", args.output_file, stats["n"], stats["n_pass"])
        return 0
    log.info("reading %s", args.input_file)
    with stage("ingest"):
        table = read_vcf(args.input_file)
    # the serial path polls cancellation at its stage boundaries (streaming: every chunk)
    cancellation.check("filter run")
    if args.limit_to_contig:
        table = table.subset(np.asarray(table.chrom) == args.limit_to_contig)
    score, filters = ctx.score_table(table)
    cancellation.check("filter run")
    _ensure_output_header(table.header, ctx.engine, ctx.forest_strategy, ctx.model_family)
    with stage("writeback"):  # rounding stays in numpy, as in the reference
        # this pipeline edits none of CHROM..QUAL: a scanned table's records
        # are spliced from its text by the native engine
        write_vcf(args.output_file, table, new_filters=filters,
                  extra_info={"TREE_SCORE": np.round(score, 4)}, verbatim_core=True)
    log.info("wrote %s: %d variants, %d PASS", args.output_file, len(table),
             int(np.sum(filters == PASS)))
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
