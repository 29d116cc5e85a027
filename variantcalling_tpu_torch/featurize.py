"""Variant featurization: VariantTable + reference genome -> feature columns.

Counterpart of ``variantcalling_tpu/featurize.py``. The host computes the
allele and INFO/FORMAT columns (a table from the native scan gives them as
arrays: no string is parsed); the fixed-width reference windows around
each variant ((N, 41) uint8, A0 C1 G2 T3 N4) come either from the host
gather (:func:`gather_windows`, one ``native.gather_windows_contig`` a
contig) or, for large tables, from the encoded genome resident on the
run's device (:func:`device_genome`), gathered there from one packed
4-byte position a variant (:func:`windows_from_packed`). The six window features
(:data:`DEVICE_FEATURES`) are torch ops on the run's device
(:func:`device_feature_dict`).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import native
from variantcalling_tpu_torch.io.bed import IntervalSet
from variantcalling_tpu_torch.io.fasta import FastaReader
from variantcalling_tpu_torch.io.vcf import VariantTable
from variantcalling_tpu_torch.ops import features as fops
from variantcalling_tpu_torch.ops import intervals as iops

log = logging.getLogger(__name__)

WINDOW_RADIUS = 20  # bases either side of the anchor in the gathered window
CENTER = WINDOW_RADIUS

# feature order of the assembled matrix; models store this list as metadata
BASE_FEATURES = [
    "qual",
    "dp",
    "sor",
    "af",
    "gq",
    "is_het",
    "is_snp",
    "is_indel",
    "is_ins",
    "indel_length",
    "hmer_indel_length",
    "hmer_indel_nuc",
    "gc_content",
    "cycleskip_status",
    "left_motif",
    "right_motif",
    "ref_code",
    "alt_code",
    "n_alts",
]

# feature columns computed from the windows on the run's device; everything
# else in BASE_FEATURES comes from host-side allele/FORMAT/INFO columns
DEVICE_FEATURES = (
    "hmer_indel_length",
    "hmer_indel_nuc",
    "gc_content",
    "cycleskip_status",
    "left_motif",
    "right_motif",
)


@dataclass
class AlleleColumns:
    """Host-derived per-variant allele scalars (first ALT; multiallelics flagged by n_alts)."""

    is_snp: np.ndarray
    is_indel: np.ndarray
    is_ins: np.ndarray
    indel_length: np.ndarray
    indel_nuc: np.ndarray  # 0..3 if the indel's inserted/deleted bases are one nucleotide, else 4
    ref_code: np.ndarray  # anchor base code for SNPs (else 4)
    alt_code: np.ndarray
    n_alts: np.ndarray


def classify_alleles(table: VariantTable) -> AlleleColumns:
    """Indel/SNP classification from the REF/ALT strings, or from the native
    scan's allele classes (``aux.alle``) for a scanned table."""
    if table.aux is not None:
        a = table.aux.alle
        cls = a["aclass"]
        return AlleleColumns((cls & 1).astype(bool), (cls & 2).astype(bool), (cls & 4).astype(bool),
                             *(a[k].copy() for k in ("indel_length", "indel_nuc", "ref_code", "alt_code", "n_alts")))
    n = len(table)
    is_snp = np.zeros(n, dtype=bool)
    is_indel = np.zeros(n, dtype=bool)
    is_ins = np.zeros(n, dtype=bool)
    indel_length = np.zeros(n, dtype=np.int32)
    indel_nuc = np.full(n, 4, dtype=np.int32)
    ref_code = np.full(n, 4, dtype=np.int32)
    alt_code = np.full(n, 4, dtype=np.int32)
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    for i in range(n):
        ref = table.ref[i]
        alt_s = table.alt[i]
        if alt_s in (".", ""):
            continue
        alt = alt_s.split(",")[0]
        if alt.startswith("<"):
            continue
        if len(ref) == len(alt) == 1:
            is_snp[i] = True
            ref_code[i] = code.get(ref.upper(), 4)
            alt_code[i] = code.get(alt.upper(), 4)
        elif len(ref) != len(alt):
            is_indel[i] = True
            if len(alt) > len(ref):
                is_ins[i] = True
                diff = alt[len(ref):] if alt.startswith(ref) else alt[1:]
            else:
                diff = ref[len(alt):] if ref.startswith(alt) else ref[1:]
            indel_length[i] = abs(len(alt) - len(ref))
            u = set(diff.upper())
            if len(u) == 1:
                indel_nuc[i] = code.get(next(iter(u)), 4)
    return AlleleColumns(is_snp, is_indel, is_ins, indel_length, indel_nuc, ref_code,
                         alt_code, table.n_alts())


def _contig_runs(table: VariantTable, n: int):
    """(codes, uniques, bounds) of the table's CHROM column (from the native
    scan's dictionary codes where it has them), uniques in order of first
    appearance; ``bounds`` are the run limits when each contig forms one
    contiguous run (a sorted VCF), else None."""
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, dtype=object), np.zeros(1, np.int64)
    names = table.chrom_codes is not None
    values = table.chrom_codes if names else np.asarray(table.chrom)
    uniq, first, inv = np.unique(values, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    codes = rank[inv.reshape(-1)]
    uniques = table.chrom_names[uniq[order]] if names else uniq[order]
    change = np.flatnonzero(codes[1:] != codes[:-1]) + 1
    contiguous = len(change) == len(uniques) - 1
    bounds = np.concatenate([[0], change, [n]]) if contiguous else None
    return codes, uniques, bounds


def _gather_contig(seq: np.ndarray, pos0: np.ndarray, radius: int, out: np.ndarray | None = None) -> np.ndarray:
    """The windows of one contig: ``native.gather_windows_contig`` (into
    ``out`` where it is a contiguous slice), else a padded numpy gather."""
    rows = native.gather_windows_contig(seq, pos0, radius, out=out)
    if rows is None:
        padded = np.concatenate([np.full(radius, 4, np.uint8), seq, np.full(radius, 4, np.uint8)])
        idx = (pos0 + radius)[:, None] + np.arange(-radius, radius + 1, dtype=np.int64)[None, :]
        valid = (idx >= 0) & (idx < len(padded))
        rows = np.where(valid, padded[np.clip(idx, 0, len(padded) - 1)], 4)
    return rows


def gather_windows(table: VariantTable, fasta: FastaReader, radius: int = WINDOW_RADIUS) -> np.ndarray:
    """(N, 2*radius+1) uint8 reference windows centered on each variant's POS.

    Positions past a contig's end and contigs missing from the FASTA read N.
    """
    n = len(table)
    out = np.full((n, 2 * radius + 1), 4, dtype=np.uint8)
    codes, uniques, bounds = _contig_runs(table, n)
    pos0 = table.pos.astype(np.int64) - 1
    for ui, contig in enumerate(uniques):
        if contig not in fasta.references:
            continue
        seq = fasta.fetch_encoded(contig)
        if bounds is not None:
            lo, hi = int(bounds[ui]), int(bounds[ui + 1])
            target = out[lo:hi]
            rows = _gather_contig(seq, pos0[lo:hi], radius, out=target)
            if rows is not target:
                target[:] = rows
        else:
            m = codes == ui
            out[m] = _gather_contig(seq, pos0[m], radius)
    return out


# The device-resident genome: every contig encoded into one uint8 tensor on
# the run's device, with 2*radius N bases before, between and after the
# contigs so that a window never reads across a contig boundary. Each
# variant then sends one 4-byte global position instead of a 41-byte window
# row. Torch indexes with int64, so one flat layout serves every genome
# whose positions pack into 4 bytes (the reference splits larger genomes
# into 2^20-base blocks because XLA indexes with int32; both layouts give
# the same windows). Cached per process by (FASTA path, radius, device).
_DEVICE_GENOME_CACHE: dict = {}
_DEVICE_GENOME_MAX = 2
#: guards the cache's dicts; a build holds only its own key's lock
_DEVICE_GENOME_LOCK = threading.Lock()
_DEVICE_GENOME_KEYLOCKS: dict = {}
#: key -> runs holding it (:func:`lease_genome`): never evicted meanwhile
_DEVICE_GENOME_LEASES: dict = {}
# tables below this size gather windows on the host: a small job must not
# pay a whole-genome encode and upload
GENOME_RESIDENT_MIN_VARIANTS = 100_000
#: log record of a genome upload: device, bytes, where the codes came from
#: ("encoded" from the FASTA text, the sidecar then written, or "sidecar":
#: memory-mapped from the FASTA's ``.venc``), those host seconds, upload seconds
GENOME_LOG = "device genome on %s: %d bytes, %s in %.3f s, uploaded in %.3f s"
# the reference's limits for its 4-byte packing (a flat genome below
# _FLAT_MAX bases, else 2^20-base blocks with three blocks of headroom
# below 2^32); the port packs under the same bound, so both packages take
# the same window path for the same FASTA
_GBLOCK = 1 << 20
_FLAT_MAX = (1 << 31) - 4 * _GBLOCK


@dataclass
class DeviceGenome:
    """The encoded genome on one device and where each contig starts in it."""

    codes: torch.Tensor  # 1-D uint8 on the device
    offsets: dict[str, int]
    lengths: dict[str, int]
    radius: int
    source: str  # "encoded" (from the FASTA text) or "sidecar" (the .venc memory map)
    encode_s: float  # host seconds to fill the flat codes (and write the sidecar after an encode)
    upload_s: float  # host seconds of the copy to the device, synchronized

    @property
    def nbytes(self) -> int:
        return int(self.codes.numel())


def _genome_key(fasta: FastaReader, radius: int, device: torch.device) -> tuple:
    return (getattr(fasta, "path", id(fasta)), radius, str(device))


def _genome_resident_worthwhile(table: VariantTable, fasta: FastaReader, device: torch.device,
                                radius: int = WINDOW_RADIUS) -> bool:
    """True when this genome is already resident on ``device``, or the table is
    large enough to pay for the upload."""
    return (_genome_key(fasta, radius, device) in _DEVICE_GENOME_CACHE
            or len(table) >= GENOME_RESIDENT_MIN_VARIANTS)


def genome_packable(fasta: FastaReader, radius: int = WINDOW_RADIUS) -> bool:
    """Whether the genome's positions fit 4-byte packing, from contig lengths
    alone (before any encoding or upload)."""
    gap = 2 * radius
    total = gap + sum(fasta.get_reference_length(c) + gap for c in fasta.references)
    if total < _FLAT_MAX:
        return True
    n_blocks = -(-total // _GBLOCK)
    return (n_blocks + 3) * _GBLOCK <= (1 << 32)


def device_genome(fasta: FastaReader, device: torch.device, radius: int = WINDOW_RADIUS) -> DeviceGenome:
    """The resident genome of ``fasta`` on ``device``, built on first use.

    Single-flight: concurrent first calls for one key (the streaming
    executor's workers and its ``genome-prefetch`` thread) build it once,
    the others wait for that build; builds of other keys go on in parallel.
    A new entry evicts the oldest ones past :data:`_DEVICE_GENOME_MAX`, but
    never one a run holds (:func:`lease_genome`)."""
    key = _genome_key(fasta, radius, device)
    with _DEVICE_GENOME_LOCK:
        hit = _DEVICE_GENOME_CACHE.get(key)
        if hit is not None:
            return hit
        key_lock = _DEVICE_GENOME_KEYLOCKS.setdefault(key, threading.Lock())
    with key_lock:
        with _DEVICE_GENOME_LOCK:
            hit = _DEVICE_GENOME_CACHE.get(key)
        if hit is not None:  # built by the caller this one waited for
            return hit
        hit = _build_device_genome(fasta, device, radius)
        with _DEVICE_GENOME_LOCK:
            idle = [k for k in _DEVICE_GENOME_CACHE if not _DEVICE_GENOME_LEASES.get(k)]
            for k in idle[: max(0, len(_DEVICE_GENOME_CACHE) + 1 - _DEVICE_GENOME_MAX)]:
                del _DEVICE_GENOME_CACHE[k]
            _DEVICE_GENOME_CACHE[key] = hit
    return hit


@contextlib.contextmanager
def lease_genome(fasta: FastaReader, device: torch.device, radius: int = WINDOW_RADIUS):
    """Hold the resident genome of ``fasta`` on ``device`` in the cache for
    the ``with`` block: no other key's build evicts it meanwhile."""
    key = _genome_key(fasta, radius, device)
    with _DEVICE_GENOME_LOCK:
        _DEVICE_GENOME_LEASES[key] = _DEVICE_GENOME_LEASES.get(key, 0) + 1
    try:
        yield
    finally:
        with _DEVICE_GENOME_LOCK:
            _DEVICE_GENOME_LEASES[key] -= 1
            if not _DEVICE_GENOME_LEASES[key]:
                del _DEVICE_GENOME_LEASES[key]


def _build_device_genome(fasta: FastaReader, device: torch.device, radius: int) -> DeviceGenome:
    """The flat codes from the FASTA's sidecar when one serves the reader,
    else encoded from the text, and then written as the sidecar. (The
    reference's resident build encodes from the text every time and reads
    the sidecar only on its host gather; the codes are the same.)"""
    t0 = time.perf_counter()
    gap = 2 * radius
    offsets: dict[str, int] = {}
    lengths: dict[str, int] = {}
    cur = gap
    for contig in fasta.references:
        offsets[contig] = cur
        lengths[contig] = fasta.get_reference_length(contig)
        cur += lengths[contig] + gap
    flat = np.full(cur, 4, dtype=np.uint8)
    source = "sidecar" if fasta.has_sidecar else "encoded"
    for contig, off in offsets.items():
        view = flat[off: off + lengths[contig]]
        view[:] = fasta.sidecar_codes(contig) if source == "sidecar" else fasta.encode_contig(contig)
    if source == "encoded":
        fasta.persist_encoded({c: flat[off: off + lengths[c]] for c, off in offsets.items()})
    t1 = time.perf_counter()
    codes = torch.from_numpy(flat).to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    genome = DeviceGenome(codes, offsets, lengths, radius, source, t1 - t0, time.perf_counter() - t1)
    log.info(GENOME_LOG, device, genome.nbytes, source, genome.encode_s, genome.upload_s)
    return genome


def globalize_positions(table: VariantTable, genome: DeviceGenome) -> np.ndarray:
    """int64 global position of each record's POS in the resident genome.

    Unknown contigs, POS < 1, and positions past a contig's end by the
    radius or more get :func:`packed_position_fill`, so their windows read
    all N, as the host gather's do past the end. Positions within the
    radius past the end land in the N gap after the contig, as in the host
    gather.
    """
    n = len(table)
    codes, uniques, _ = _contig_runs(table, n)
    off = np.asarray([genome.offsets.get(c, -1) for c in uniques], dtype=np.int64)[codes]
    clen = np.asarray([genome.lengths.get(c, -1) for c in uniques], dtype=np.int64)[codes]
    pos0 = table.pos.astype(np.int64) - 1
    bad = (off < 0) | (pos0 < 0) | (pos0 >= clen + genome.radius)
    return np.where(bad, packed_position_fill(genome), pos0 + off)


def packed_position_fill(genome: DeviceGenome) -> int:
    """The packed position of a row whose window reads all N (an unknown
    contig, a position past its contig's end): every base of its window lies
    past the genome's end."""
    return genome.nbytes + genome.radius


def pack_global_positions(gpos: np.ndarray, genome: DeviceGenome) -> np.ndarray | None:
    """Global positions as one uint32 each, or None where they do not fit."""
    if packed_position_fill(genome) >= 1 << 32:
        return None
    return gpos.astype(np.uint32)


def windows_from_packed(genome_codes: torch.Tensor, gpos: torch.Tensor,
                        radius: int = WINDOW_RADIUS) -> torch.Tensor:
    """(N, 2*radius+1) uint8 windows gathered on the genome's device.

    ``gpos`` holds the uint32 packed positions as an int32 view (torch's
    uint32 support is thin); it is widened here with ``& 0xFFFFFFFF``.
    Indices outside the genome read N (4).
    """
    g = gpos.to(torch.int64) & 0xFFFFFFFF
    idx = g[:, None] + torch.arange(-radius, radius + 1, device=g.device)[None, :]
    glen = genome_codes.shape[0]
    valid = (idx >= 0) & (idx < glen)
    return genome_codes[idx.clamp_(0, glen - 1)].masked_fill_(~valid, 4)


def _compute_af(table: VariantTable) -> np.ndarray:
    """Allele fraction per record: FORMAT AD (alt/sum) where present, else INFO
    AF; a scanned table's AD comes from the scan (``aux.ad``)."""
    info_af = table.info_field("AF", dtype=np.float64).astype(np.float32)
    if table.aux is not None:
        ad1, tot = table.aux.ad[:, 1], table.aux.ad[:, 2]
        tot = np.where(np.isnan(tot), 0, tot)
        alt = np.where(np.isnan(ad1) | (ad1 < 0), 0, ad1)
    else:
        ad = table.format_numeric("AD")
        if ad.shape[1] < 2:
            return info_af
        tot = np.sum(np.where(ad > 0, ad, 0), axis=1)
        alt = np.where(ad[:, 1] > 0, ad[:, 1], 0)
    with np.errstate(invalid="ignore", divide="ignore"):
        ad_af = np.where(tot > 0, alt / np.maximum(tot, 1), np.nan).astype(np.float32)
    return np.where(np.isnan(ad_af), info_af, ad_af)


@dataclass
class HostFeatures:
    """Host half of featurization: windows + every non-window column.

    ``names`` is the full feature order (host and device columns
    interleaved per BASE_FEATURES, then extra INFO fields and annotations).
    """

    alle: AlleleColumns
    windows: np.ndarray | None  # (N, 2*WINDOW_RADIUS+1) uint8; None: gathered on the device
    cols: dict[str, np.ndarray]  # host columns only
    names: list[str]


def host_featurize(table: VariantTable, fasta: FastaReader,
                   annotate_intervals: dict[str, IntervalSet] | None = None,
                   extra_info_fields: list[str] | None = None,
                   compute_windows: bool = True,
                   keep_nan: bool = False) -> HostFeatures:
    """``compute_windows=False`` skips the host window gather, for the path
    that gathers windows from the resident genome.

    ``keep_nan=True`` keeps NaN for absent QUAL/INFO/FORMAT values instead of
    zero-filling them (forests with default_left routing are defined on NaN)."""
    alle = classify_alleles(table)
    windows = gather_windows(table, fasta) if compute_windows else None
    gts = table.genotypes()
    is_het = (gts[:, 0] != gts[:, 1]) & (gts[:, 1] >= 0)
    gq = table.format_numeric("GQ", max_len=1, missing=np.nan)[:, 0]

    def missing(a):
        return a if keep_nan else np.nan_to_num(a, nan=0.0)

    cols: dict[str, np.ndarray] = {
        "qual": missing(table.qual),
        "dp": missing(table.info_field("DP")),
        "sor": missing(table.info_field("SOR")),
        "af": missing(_compute_af(table)),
        "gq": missing(gq),
        "is_het": is_het.astype(np.float32),
        "is_snp": alle.is_snp.astype(np.float32),
        "is_indel": alle.is_indel.astype(np.float32),
        "is_ins": alle.is_ins.astype(np.float32),
        "indel_length": alle.indel_length,
        "ref_code": alle.ref_code,
        "alt_code": alle.alt_code,
        "n_alts": alle.n_alts,
    }
    names = list(BASE_FEATURES)
    for f in extra_info_fields or []:
        cols[f] = missing(table.info_field(f)).astype(np.float32)
        names.append(f)
    if annotate_intervals:
        coords = iops.GenomeCoords(
            table.header.contig_lengths
            or {c: fasta.get_reference_length(c) for c in fasta.references})
        gpos = coords.globalize(np.asarray(table.chrom), table.pos - 1)
        for name, iv in annotate_intervals.items():
            gs, ge = coords.globalize_intervals(iv)
            cols[name] = iops.membership(gpos, gs, ge).astype(np.float32)
            names.append(name)
    return HostFeatures(alle=alle, windows=windows, cols=cols, names=names)


def device_feature_dict(windows: torch.Tensor, is_indel: torch.Tensor, indel_nuc: torch.Tensor,
                        ref_code: torch.Tensor, alt_code: torch.Tensor, is_snp: torch.Tensor,
                        *, center: int, flow_order: str) -> dict[str, torch.Tensor]:
    """The six window features, on the device the inputs live on.

    ``is_indel``/``is_snp`` are bool tensors, the codes integer tensors.
    """
    gc = fops.gc_content(windows, center, radius=10)
    hmer_len, hmer_nuc = fops.hmer_indel_features(windows, center, is_indel, indel_nuc)
    left_motif, right_motif = fops.motif_codes(windows, center, k=5)
    cyc = fops.cycle_skip_status(windows, center, ref_code, alt_code, is_snp, flow_order=flow_order)
    return {
        "hmer_indel_length": hmer_len,
        "hmer_indel_nuc": hmer_nuc,
        "gc_content": gc,
        "cycleskip_status": cyc,
        "left_motif": left_motif,
        "right_motif": right_motif,
    }


_NUMPY_DTYPE = {torch.bool: np.bool_, torch.int32: np.int32, torch.uint8: np.uint8}


def _rows(x: np.ndarray, lo: int, hi: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Rows [lo, hi) of ``x`` in ``dtype`` (converted on the host), on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(x[lo:hi], dtype=_NUMPY_DTYPE[dtype])).to(device)


def allele_inputs(alle: AlleleColumns, lo: int, hi: int, device: torch.device) -> tuple:
    """Rows [lo, hi) of the allele inputs of the window features (is_indel,
    indel_nuc, ref_code, alt_code, is_snp), as tensors on ``device``."""
    return (_rows(alle.is_indel, lo, hi, device, torch.bool), _rows(alle.indel_nuc, lo, hi, device, torch.int32),
            _rows(alle.ref_code, lo, hi, device, torch.int32), _rows(alle.alt_code, lo, hi, device, torch.int32),
            _rows(alle.is_snp, lo, hi, device, torch.bool))


def device_inputs(hf: HostFeatures, lo: int, hi: int, device: torch.device) -> tuple:
    """Rows [lo, hi) of the window-feature inputs (host windows first), as
    tensors on ``device``."""
    return (_rows(hf.windows, lo, hi, device, torch.uint8), *allele_inputs(hf.alle, lo, hi, device))


@dataclass
class FeatureSet:
    """Named per-variant feature columns + assembly into an (N, F) float32 matrix."""

    columns: dict[str, np.ndarray]
    feature_names: list[str]

    def matrix(self, names: list[str] | None = None) -> np.ndarray:
        names = names or self.feature_names
        return np.stack([np.asarray(self.columns[f], dtype=np.float32) for f in names], axis=1)


def materialize_features(hf: HostFeatures, flow_order: str = fops.DEFAULT_FLOW_ORDER,
                         device: torch.device | str = "gpu") -> FeatureSet:
    """Run the window features over a HostFeatures batch and merge the columns.

    The window features run on the card unless ``device`` is the CPU.
    """
    dev = device_feature_dict(*device_inputs(hf, 0, len(hf.windows), device_mod.as_device(device)),
                              center=CENTER, flow_order=flow_order)
    cols = dict(hf.cols)
    cols.update({k: v.cpu().numpy() for k, v in dev.items()})
    return FeatureSet(columns=cols, feature_names=hf.names)
