"""Pileup SNV caller and variant hit fractions (the fingerprinting core).

Counterpart of ``variantcalling_tpu/comparison/pileup_caller.py``:

- :func:`pileup_counts`: (L, 4) A/C/G/T counts of the aligned bases over a
  window of one contig (unmapped, secondary, QC-fail and duplicate reads
  skipped; M, = and X bases only; each count capped at :data:`MAX_DEPTH`).
  A BAM is inflated and walked by the native engine's ``bam_pileup``;
  :func:`_bam_pileup_plain`, the reference's walk over every record in
  Python, is its plain version (``VCTPU_NO_NATIVE=1``). A CRAM goes to the
  engine's ``cram_pileup`` (no plain version: CRAM decodes natively only);
- :func:`call_snvs`: the AF gate and the major alt on the run's device;
- :class:`VariantHitFractionCaller` and :func:`snp_set_from_vcf`: the called
  and truth SNP sets and their join.
"""

from __future__ import annotations

import numpy as np
import torch

from variantcalling_tpu_torch import native
from variantcalling_tpu_torch.io.bam import EXCLUDE_FLAGS, BamReader, inflate_bam

_M_OPS = {0, 7, 8}  # CIGAR ops that consume both read and ref (M, =, X)
_BASES = "ACGT"
MAX_DEPTH = 500  # matches bcftools mpileup -d 500


def _cram_pileup_counts(cram_path: str, chrom: str, start: int, end: int, ref_path: str | None) -> np.ndarray:
    """CRAM pileup through the native decoder's base reconstruction."""
    from variantcalling_tpu_torch.io.cram import header_from_buffer
    from variantcalling_tpu_torch.io.fasta import FastaReader

    if ref_path is None:
        raise ValueError("CRAM pileup needs the reference FASTA (ref_path)")
    with open(cram_path, "rb") as fh:
        buf = fh.read()
    header = header_from_buffer(buf, cram_path)
    if chrom not in header.references:
        return np.zeros((end - start, 4), dtype=np.int32)
    tid = header.references.index(chrom)
    with FastaReader(ref_path) as fa:
        ref_seq = fa.fetch(chrom, 0, fa.get_reference_length(chrom))
    counts = native.cram_pileup(buf, tid, start, end, ref_seq)
    if counts is None:
        raise ValueError(f"cannot pile up CRAM {cram_path}: unsupported codec or malformed "
                         "stream (supported: CRAM 3.0, raw/gzip/rANS-4x8)")
    np.minimum(counts, MAX_DEPTH, out=counts)
    return counts


def _bam_pileup_native(bam_path: str, chrom: str, start: int, end: int) -> np.ndarray | None:
    """The engine's walk (``bam_pileup`` over the inflated file); None where the engine is off or declines."""
    if not native.available():
        native.note_plain("bam_pileup")
        return None
    inflated = inflate_bam(bam_path)
    if inflated is None:
        native.note_plain("bam_pileup")
        return None
    header, arr, off = inflated
    if chrom not in header.references:
        return np.zeros((end - start, 4), dtype=np.int32)
    return native.bam_pileup(arr[off:], header.references.index(chrom), start, end, EXCLUDE_FLAGS)


def _bam_pileup_plain(bam_path: str, chrom: str, start: int, end: int) -> np.ndarray:
    """The reference's walk over every record in Python (an op that would read
    past SEQ's end counts the bases SEQ has, as the engine's walk does; the
    reference's walk raises there)."""
    counts = np.zeros((end - start, 4), dtype=np.int32)
    with BamReader(bam_path, decode_seq=True) as reader:
        try:
            tid = reader.header.references.index(chrom)
        except ValueError:
            return counts
        for aln in reader:
            if aln.ref_id != tid or aln.flag & EXCLUDE_FLAGS or aln.seq is None:
                continue
            if aln.pos >= end:
                continue
            rpos = aln.pos
            qpos = 0
            for op, ln in aln.cigar:
                if op in _M_OPS:
                    lo = max(rpos, start)
                    hi = min(rpos + ln, end)
                    if hi > lo:
                        q0 = qpos + (lo - rpos)
                        codes = aln.seq[q0: q0 + (hi - lo)]
                        valid = codes < 4
                        idx = np.arange(lo - start, lo - start + len(codes))[valid]
                        np.add.at(counts, (idx, codes[valid].astype(np.int64)), 1)
                    rpos += ln
                    qpos += ln
                elif op in (1, 4):  # I, S consume read
                    qpos += ln
                elif op in (2, 3):  # D, N consume ref
                    rpos += ln
    return counts


def pileup_counts(bam_path: str, chrom: str, start: int, end: int, ref_path: str | None = None) -> np.ndarray:
    """(L, 4) int32 base counts over [start, end) of ``chrom`` (0-based), each capped at :data:`MAX_DEPTH`.

    CRAM inputs reconstruct bases natively and need ``ref_path``."""
    if str(bam_path).endswith(".cram"):
        return _cram_pileup_counts(bam_path, chrom, start, end, ref_path)
    counts = _bam_pileup_native(bam_path, chrom, start, end)
    if counts is None:
        counts = _bam_pileup_plain(bam_path, chrom, start, end)
    np.minimum(counts, MAX_DEPTH, out=counts)
    return counts


def call_snvs(counts: np.ndarray, ref_codes: np.ndarray, min_af: float,
              device: torch.device | str = "cpu") -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(offsets, major alt code, float32 alt fraction) of the loci whose best
    non-reference allele has ``count / depth >= float32(min_af)`` (the
    reference's ``AD[0:1]/DP >= af`` gate, in float32 as the reference's
    device program divides), depth > 0 and a reference base; a tie for the
    major alt takes the first base in A, C, G, T order."""
    device = torch.device(device)
    c = torch.from_numpy(np.ascontiguousarray(counts, dtype=np.int32)).to(device)
    ref = torch.from_numpy(np.ascontiguousarray(ref_codes)).to(device).to(torch.int64)
    depth = c.sum(dim=1)
    masked = torch.where(torch.arange(4, device=device)[None, :] == ref[:, None], torch.full_like(c, -1), c)
    alt_count = masked.amax(dim=1)
    alt = masked.argmax(dim=1).to(torch.int32)
    af = torch.where(depth > 0, alt_count.to(torch.float32) / torch.clamp(depth, min=1).to(torch.float32),
                     torch.zeros((), dtype=torch.float32, device=device))
    gate = torch.tensor(np.float32(min_af), device=device)
    hit = (af >= gate) & (depth > 0) & (ref < 4) & (alt_count > 0)
    offs = torch.nonzero(hit).flatten()
    return offs.cpu().numpy(), alt[offs].cpu().numpy(), af[offs].cpu().numpy()


class VariantHitFractionCaller:
    """Drop-in surface of the reference class; calls run on ``device``."""

    def __init__(self, ref: str, out_dir: str, min_af_snps: float, region: str,
                 device: torch.device | str = "cpu"):
        self.ref = ref
        self.out_dir = out_dir
        self.min_af_snps = min_af_snps
        self.region = region
        self.device = torch.device(device)

    def call_variants(self, bam: str, chrom: str, start: int, end: int,
                      min_af: float) -> set[tuple[str, int, str, str]]:
        """Called SNVs as {(chrom, pos_1based, ref_base, major_alt)}."""
        from variantcalling_tpu_torch.io.fasta import FastaReader

        counts = pileup_counts(bam, chrom, start, end, ref_path=self.ref)
        with FastaReader(self.ref) as fa:
            ref_seq = fa.fetch(chrom, start, min(end, fa.get_reference_length(chrom)))
        codes = np.full(end - start, 4, dtype=np.int8)
        for i, b in enumerate(ref_seq.upper()):
            if b in _BASES:
                codes[i] = _BASES.index(b)
        offs, alts, _af = call_snvs(counts, codes, min_af, self.device)
        return {(chrom, start + int(o) + 1, _BASES[codes[o]], _BASES[int(a)]) for o, a in zip(offs, alts)}

    @staticmethod
    def calc_hit_fraction(called: set[tuple[str, int, str, str]],
                          ground_truth: set[tuple[str, int, str, str]]) -> tuple[float, int, int]:
        """(hit_fraction, hit_count, ground_truth_count); +0.001 guard as the reference."""
        hits = len(called & ground_truth)
        n_gt = len(ground_truth)
        return hits / (n_gt + 0.001), hits, n_gt

    @staticmethod
    def add_args_to_parser(parser) -> None:
        parser.add_argument("--max_vars", type=int, default=2000,
                            help="max number of variants to check for concordance")
        parser.add_argument("--min_af_snps", type=float, default=0.03,
                            help="min allele frequency to count as a ground-truth hit")
        parser.add_argument("--min_af_germline_snps", type=float, default=0.1,
                            help="min allele frequency to count a snp as germline snp, for normal-in-tumor <-> "
                                 "normal matching")
        parser.add_argument("--min_hit_fraction_target", type=float, default=0.99,
                            help="fraction of ground-truth variants which has hits in target samples")


def snp_set_from_vcf(vcf_path: str, region: tuple[str, int, int] | None, hcr=None) -> set[tuple[str, int, str, str]]:
    """Ground-truth SNP keys (chrom, pos, ref, first_alt) within region ∩ HCR."""
    from variantcalling_tpu_torch.io.vcf import read_vcf

    table = read_vcf(vcf_path, region=region, drop_format=True)
    out: set[tuple[str, int, str, str]] = set()
    hcr_by_chrom = hcr.merged().by_chrom() if hcr is not None else None
    for i in range(len(table)):
        ref = table.ref[i]
        major = table.alt[i].split(",")[0]
        if len(ref) != 1 or len(major) != 1 or major not in _BASES or ref not in _BASES:
            continue
        chrom, pos = str(table.chrom[i]), int(table.pos[i])
        if hcr_by_chrom is not None:
            if chrom not in hcr_by_chrom:
                continue
            s, e = hcr_by_chrom[chrom]
            j = np.searchsorted(s, pos - 1, side="right") - 1
            if j < 0 or pos - 1 >= e[j]:
                continue
        out.add((chrom, pos, ref, major))
    return out
