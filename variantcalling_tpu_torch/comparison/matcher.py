"""Haplotype-aware variant matching (the vcfeval-equivalent core).

Counterpart of ``variantcalling_tpu/comparison/matcher.py``, a copy: host
code, no device program. :func:`match_contig` runs the native engine's
matcher (``native.match_contig_native``, counted in ``native.CALLS``), and
this module's Python (:func:`_match_contig_py`) where the engine is off
(``VCTPU_NO_NATIVE=1``) or cannot be built: the specification, which the
tests hold both engines to.

The original tool delegates TP/FP/FN matching to rtg-tools vcfeval as a black
box (docs/run_comparison_pipeline.md:3-5, SURVEY §2.5). This module is a
native re-derivation of the *behavior*: two callsets match when some
assignment of their variants onto haplotypes yields identical sequence —
so different representations (split/joined multiallelics, shifted indels)
still pair up.

Pipeline per contig:

1. **normalize** every variant (trim shared suffix then prefix per allele)
   so trivially different encodings share a key;
2. **exact match** on (pos, ref, alt-set) — resolves the overwhelming
   majority of loci in one vectorized join;
3. **local haplotype search** for the residue: cluster unmatched call +
   truth variants within a merge window, then try all diploid phasings of
   each side (capped combinatorics, as vcfeval caps its search) and accept
   clusters whose {hap1, hap2} sequence sets agree. Matched clusters mark
   their variants tp (genotype-consistent by construction).

Genotype-ignoring classification (`classify`) counts allele-level hits;
`classify_gt` additionally requires genotype equality (exact stage) or
phase-consistency (haplotype stage).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAX_CLUSTER_VARIANTS = 16  # per side; larger clusters fall back to exact-only
MAX_HETS = 12  # het edits per side considered by the phasing search
#: state cap for the dedup-BFS phasing search (_diploid_haplotypes): states
#: are UNORDERED partial haplotype pairs deduplicated per step, so the
#: mask/~mask symmetry plus equal-prefix merges keep real clusters far
#: below 2^hets; 4096 admits every h <= 13 exactly and more when merges
#: occur. Overflow falls back to exact-only matching (counted in stats).
PHASING_BEAM = 4096
CLUSTER_GAP = 30  # bp between cluster members
FLANK = 10  # reference padding around a cluster


def normalize_variant(pos: int, ref: str, alt: str) -> tuple[int, str, str]:
    """Trim shared suffix, then shared prefix (VT/bcftools-norm semantics).

    1-based pos; returns the minimal (pos, ref, alt) representation.
    """
    while len(ref) > 1 and len(alt) > 1 and ref[-1] == alt[-1]:
        ref = ref[:-1]
        alt = alt[:-1]
    while len(ref) > 1 and len(alt) > 1 and ref[0] == alt[0]:
        ref = ref[1:]
        alt = alt[1:]
        pos += 1
    return pos, ref, alt


@dataclass
class SideVariants:
    """Per-contig columnar view of one side (calls or truth)."""

    pos: np.ndarray  # int64, 1-based (original)
    ref: list[str]
    alts: list[list[str]]
    gt: np.ndarray  # (n, 2) int8, -1 = missing
    _norm_keys: list[frozenset] | None = None  # lazy: Python matcher only

    @property
    def norm_keys(self) -> list[frozenset]:
        """Per-variant set of normalized (pos, ref, alt) — computed on first
        use so the native matcher path never pays for the Python loop."""
        if self._norm_keys is None:
            keys = []
            for i in range(len(self.pos)):
                ks = []
                for a in self.alts[i]:
                    if a in (".", "", "*", "<NON_REF>") or a.startswith("<"):
                        continue
                    ks.append(normalize_variant(int(self.pos[i]), self.ref[i], a))
                keys.append(frozenset(ks))
            self._norm_keys = keys
        return self._norm_keys


def make_side(pos: np.ndarray, ref: list[str], alts: list[list[str]], gt: np.ndarray) -> SideVariants:
    return SideVariants(np.asarray(pos, dtype=np.int64), list(ref), [list(a) for a in alts],
                        np.asarray(gt, dtype=np.int8))


def _called_allele_keys(side: SideVariants, i: int) -> frozenset:
    """Normalized keys of the alleles the genotype actually calls (all alts if no GT)."""
    g = side.gt[i]
    called_idx = {int(a) for a in g if a > 0}
    if not called_idx:
        return side.norm_keys[i]
    out = []
    for ai in sorted(called_idx):
        if ai - 1 < len(side.alts[i]):
            a = side.alts[i][ai - 1]
            if a in (".", "", "*", "<NON_REF>") or a.startswith("<"):
                continue
            out.append(normalize_variant(int(side.pos[i]), side.ref[i], a))
    return frozenset(out)


@dataclass
class MatchResult:
    call_tp: np.ndarray  # bool per call: allele-level match
    call_tp_gt: np.ndarray  # bool per call: genotype-level match
    truth_tp: np.ndarray  # bool per truth
    truth_tp_gt: np.ndarray
    # per-call index of matched truth record (-1 = none) for gt/error columns
    call_truth_idx: np.ndarray
    # search-cap accounting (allele pass): clusters that degraded to
    # exact-only because of MAX_CLUSTER_VARIANTS / MAX_HETS / PHASING_BEAM,
    # and the variants they contained
    fallback_clusters: int = 0
    fallback_variants: int = 0


def match_contig(calls: SideVariants, truth: SideVariants, ref_seq: str,
                 haplotype_rescue: bool = True) -> MatchResult:
    """Per-contig match: the native (C++) engine where it is built, else
    this module's Python, the specification (``tests/test_torch_run_comparison.py``
    holds the two to each other and to the JAX package's)."""
    native_res = _match_contig_native(calls, truth, ref_seq, haplotype_rescue)
    if native_res is not None:
        return native_res
    return _match_contig_py(calls, truth, ref_seq, haplotype_rescue)


def _match_contig_native(calls: SideVariants, truth: SideVariants, ref_seq: str,
                         haplotype_rescue: bool) -> MatchResult | None:
    from variantcalling_tpu_torch import native

    out = native.match_contig_native(
        ref_seq,
        # "" joined list = no alts; empty-string entries map to "." (both
        # are symbolic to the spec) so [""] round-trips unambiguously
        calls.pos, calls.ref, [",".join(x or "." for x in a) for a in calls.alts], calls.gt,
        truth.pos, truth.ref, [",".join(x or "." for x in a) for a in truth.alts], truth.gt,
        haplotype_rescue=haplotype_rescue,
    )
    if out is None:
        return None
    call_tp, call_tp_gt, truth_tp, truth_tp_gt, idx, stats = out
    return MatchResult(call_tp, call_tp_gt, truth_tp, truth_tp_gt, idx,
                       fallback_clusters=int(stats[0]), fallback_variants=int(stats[1]))


def _match_contig_py(calls: SideVariants, truth: SideVariants, ref_seq: str,
                     haplotype_rescue: bool = True) -> MatchResult:
    nc, nt = len(calls.pos), len(truth.pos)
    call_tp = np.zeros(nc, dtype=bool)
    call_tp_gt = np.zeros(nc, dtype=bool)
    truth_tp = np.zeros(nt, dtype=bool)
    truth_tp_gt = np.zeros(nt, dtype=bool)
    call_truth_idx = np.full(nc, -1, dtype=np.int64)

    # ---- stage 2: exact normalized-key join ------------------------------
    truth_by_key: dict = {}
    for j in range(nt):
        for k in _called_allele_keys(truth, j):
            truth_by_key.setdefault(k, j)
    for i in range(nc):
        ck = _called_allele_keys(calls, i)
        if not ck:
            continue
        hits = {k: truth_by_key[k] for k in ck if k in truth_by_key}
        if len(hits) == len(ck):  # every called allele present in truth
            j = next(iter(hits.values()))
            call_tp[i] = True
            call_truth_idx[i] = j
            for jj in set(hits.values()):
                truth_tp[jj] = True
            # genotype equality: same multiset of normalized called alleles
            # AND same zygosity pattern
            if len(set(hits.values())) == 1 and _gt_equivalent(calls, i, truth, j):
                call_tp_gt[i] = True
                truth_tp_gt[j] = True

    # ---- stage 3: local haplotype search on the residue ------------------
    # Two passes with the same bounded search. Pass 1 clusters the
    # allele-level residue (exact-join misses): a match sets both levels.
    # Pass 2 clusters the remaining genotype-level residue — a cluster whose
    # diploid haplotype sets agree is genotype-consistent by construction,
    # so split-vs-joined multiallelics (call het G + het T vs truth G/T)
    # recover classify_gt (vcfeval semantics). Running the allele pass first
    # keeps genotype errors (allele-matched, gt-mismatched sites) from
    # joining — and poisoning — allele-level clusters.
    if not haplotype_rescue:
        # representation-strict mode: exact normalized-key joins only — the
        # run_comparison --disable_reinterpretation contract (the reference's
        # "reinterpretation" stage repairs vcfeval representation artifacts;
        # here that repair IS the haplotype search, so disabling maps to
        # skipping stage 3; docs/run_comparison_pipeline.md:78)
        return MatchResult(call_tp, call_tp_gt, truth_tp, truth_tp_gt, call_truth_idx)

    fb_clusters = fb_variants = 0
    failed: set = set()  # pass-1 clusters that already failed; identical
    # pass-2 clusters (no gt-only members joined) are skipped, not re-searched
    for level in ("allele", "genotype"):
        if level == "allele":
            un_c = np.nonzero(~call_tp)[0]
            un_t = np.nonzero(~truth_tp)[0]
        else:
            un_c = np.nonzero(~call_tp_gt)[0]
            un_t = np.nonzero(~truth_tp_gt)[0]
        for c_idx, t_idx in _clusters(calls, truth, un_c, un_t):
            if not c_idx or not t_idx:
                continue
            ckey = (tuple(c_idx), tuple(t_idx))
            if ckey in failed:
                continue
            if level == "allele":
                failed.add(ckey)  # removed below on success
            if len(c_idx) > MAX_CLUSTER_VARIANTS or len(t_idx) > MAX_CLUSTER_VARIANTS:
                if level == "allele":
                    fb_clusters += 1
                    fb_variants += len(c_idx) + len(t_idx)
                continue
            lo = min(min(int(calls.pos[i]) for i in c_idx), min(int(truth.pos[j]) for j in t_idx)) - FLANK
            hi = max(
                max(int(calls.pos[i]) + len(calls.ref[i]) for i in c_idx),
                max(int(truth.pos[j]) + len(truth.ref[j]) for j in t_idx),
            ) + FLANK
            lo = max(lo, 1)
            window = ref_seq[lo - 1 : hi - 1]
            haps_c, capped_c = _diploid_haplotypes(calls, c_idx, lo, window)
            haps_t, capped_t = _diploid_haplotypes(truth, t_idx, lo, window)
            if haps_c is None or haps_t is None:
                if (capped_c or capped_t) and level == "allele":
                    fb_clusters += 1
                    fb_variants += len(c_idx) + len(t_idx)
                continue
            if haps_c & haps_t:
                failed.discard(ckey)
                for i in c_idx:
                    call_tp[i] = True
                    call_tp_gt[i] = True
                for j in t_idx:
                    truth_tp[j] = True
                    truth_tp_gt[j] = True

    return MatchResult(call_tp, call_tp_gt, truth_tp, truth_tp_gt, call_truth_idx,
                       fallback_clusters=fb_clusters, fallback_variants=fb_variants)


def match_tables(calls, truth, fasta) -> MatchResult:
    """Whole-genome match of two VariantTables: per-contig match_contig sweep.

    Returns a MatchResult over the full (unsplit) record order of each
    table. Shared by run_comparison and vcfeval_flavors.
    """
    contigs = list(dict.fromkeys(list(calls.chrom) + list(truth.chrom)))
    nc, nt = len(calls), len(truth)
    res = MatchResult(
        np.zeros(nc, dtype=bool),
        np.zeros(nc, dtype=bool),
        np.zeros(nt, dtype=bool),
        np.zeros(nt, dtype=bool),
        np.full(nc, -1, dtype=np.int64),
    )
    for contig in contigs:
        cm = np.asarray(calls.chrom) == contig
        tm = np.asarray(truth.chrom) == contig
        if contig not in fasta.references:
            continue
        seq = fasta.fetch(contig, 0, fasta.get_reference_length(contig))
        cs = make_side(
            calls.pos[cm],
            list(calls.ref[cm]),
            [a.split(",") if a not in (".", "") else [] for a in calls.alt[cm]],
            calls.genotypes()[cm],
        )
        ts = make_side(
            truth.pos[tm],
            list(truth.ref[tm]),
            [a.split(",") if a not in (".", "") else [] for a in truth.alt[tm]],
            truth.genotypes()[tm],
        )
        r = match_contig(cs, ts, seq)
        res.call_tp[cm] = r.call_tp
        res.call_tp_gt[cm] = r.call_tp_gt
        res.truth_tp[tm] = r.truth_tp
        res.truth_tp_gt[tm] = r.truth_tp_gt
        res.fallback_clusters += r.fallback_clusters
        res.fallback_variants += r.fallback_variants
        # remap per-contig truth indices to global
        t_global = np.nonzero(tm)[0]
        matched = r.call_truth_idx >= 0
        glob = np.full(len(r.call_truth_idx), -1, dtype=np.int64)
        glob[matched] = t_global[r.call_truth_idx[matched]]
        res.call_truth_idx[cm] = glob
    return res


def _gt_equivalent(calls: SideVariants, i: int, truth: SideVariants, j: int) -> bool:
    """Same zygosity over equivalent alleles (allele indices may differ)."""

    def pattern(side: SideVariants, k: int) -> tuple:
        g = [int(a) for a in side.gt[k] if a >= 0]
        if not g:
            return ("any",)
        keys = []
        for a in sorted(g):
            if a == 0:
                keys.append(("ref",))
            elif a - 1 < len(side.alts[k]):
                keys.append(normalize_variant(int(side.pos[k]), side.ref[k], side.alts[k][a - 1]))
        return tuple(sorted(map(str, keys)))

    pc, pt = pattern(calls, i), pattern(truth, j)
    return pc == pt or pc == ("any",) or pt == ("any",)


def _clusters(calls: SideVariants, truth: SideVariants, un_c: np.ndarray, un_t: np.ndarray):
    """Group leftover variants (both sides) into gap-bounded position clusters."""
    events = [(int(calls.pos[i]), 0, int(i)) for i in un_c] + [(int(truth.pos[j]), 1, int(j)) for j in un_t]
    events.sort()
    cur_c: list[int] = []
    cur_t: list[int] = []
    last = None
    for pos, side, idx in events:
        if last is not None and pos - last > CLUSTER_GAP and (cur_c or cur_t):
            yield cur_c, cur_t
            cur_c, cur_t = [], []
        (cur_c if side == 0 else cur_t).append(idx)
        last = pos
    if cur_c or cur_t:
        yield cur_c, cur_t


def _extend_hap(hap: tuple[str, int], window: str, s0: int, e0: int, alt: str):
    """Append one edit to a partial haplotype (built string, consumed-ref
    position); None on overlap/out-of-window — the incremental equivalent
    of :func:`_apply`'s validity check."""
    built, cur = hap
    if s0 < cur or e0 > len(window) or s0 < 0:
        return None
    return (built + window[cur:s0] + alt, e0)


def _diploid_haplotypes(side: SideVariants, idx: list[int], lo: int, window: str) -> set | None:
    """All {hap_a, hap_b} sequence pairs over the window, one per phasing.

    Enumerated by a dedup-BFS over sorted edits instead of 2^hets masks:
    the state set holds UNORDERED partial-haplotype pairs, so the
    mask/~mask symmetry and equal-prefix merges collapse the space —
    exact (not approximate) whenever the state count stays within
    PHASING_BEAM, which covers every cluster the old exhaustive search
    could do and far larger ones. Returns (pairs, capped): pairs is None
    when no phasing can be replayed OR the search was capped (MAX_HETS /
    beam overflow); capped distinguishes the two so callers can count the
    exact-only degradations.
    """
    n_hets = 0
    applied = []  # (start0, end0, alt, both_haps)
    for k in idx:
        g = [int(a) for a in side.gt[k] if a >= 0]
        alleles = sorted({a for a in g if a > 0}) or ([1] if side.alts[k] else [])
        for ai in alleles:
            if ai - 1 >= len(side.alts[k]):
                return None, False
            alt = side.alts[k][ai - 1]
            if alt in (".", "", "*", "<NON_REF>") or alt.startswith("<"):
                continue
            s0 = int(side.pos[k]) - lo
            e0 = s0 + len(side.ref[k])
            hom = len(g) >= 2 and g.count(ai) == len([a for a in g if a > 0]) and 0 not in g
            applied.append((s0, e0, alt, hom))
            n_hets += not hom
    if n_hets > MAX_HETS:
        return None, True

    # sorted edit order == _apply's replay order, so incremental overlap
    # rejection drops exactly the phasings the exhaustive search dropped
    applied.sort(key=lambda e: (e[0], e[1], e[2]))
    states: set = {(("", 0), ("", 0))}
    for s0, e0, alt, both in applied:
        new: set = set()
        for a, b in states:
            if both:
                na = _extend_hap(a, window, s0, e0, alt)
                nb = _extend_hap(b, window, s0, e0, alt)
                if na is not None and nb is not None:
                    new.add((na, nb) if na <= nb else (nb, na))
            else:
                na = _extend_hap(a, window, s0, e0, alt)
                if na is not None:
                    new.add((na, b) if na <= b else (b, na))
                nb = _extend_hap(b, window, s0, e0, alt)
                if nb is not None:
                    new.add((a, nb) if a <= nb else (nb, a))
        if not new:
            return None, False  # no phasing can replay these edits
        if len(new) > PHASING_BEAM:
            return None, True  # search capped: caller degrades to exact-only
        states = new

    out = set()
    for (abuilt, acur), (bbuilt, bcur) in states:
        a = abuilt + window[acur:]
        b = bbuilt + window[bcur:]
        out.add(frozenset((a, b)) if a != b else frozenset((a,)))
    return (out if out else None), False


def _apply(window: str, edits: list[tuple[int, int, str]]) -> str | None:
    """Apply non-overlapping (start0, end0, alt) edits; None on overlap/ooband."""
    edits = sorted(edits)
    out = []
    cur = 0
    for s0, e0, alt in edits:
        if s0 < cur or e0 > len(window) or s0 < 0:
            return None
        out.append(window[cur:s0])
        out.append(alt)
        cur = e0
    out.append(window[cur:])
    return "".join(out)
