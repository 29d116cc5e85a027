"""Seeded worlds of the report and fingerprinting tools.

Each writer makes its files from one ``numpy`` seed and returns their paths
and what it planted, so that a run's outputs can be held to the plant:

- :func:`write_report_world`: a reference genome, a 30x callset (the case,
  ``GT:GQ:DP:AD:VAF``, 1-3 alts) whose isolated SNVs follow a planted
  mixture of SBS96 signatures, with hmer and non-hmer indels, adjacent-SNV
  doublets, runs of three adjacent SNVs (which enter no catalog) and 2-bp MNP
  records; control callsets of other mixtures on the same genome; a dbSNP
  of a share of the case's sites and other sites; a callable BED; seeded
  signature catalogs of COSMIC v3.3's shapes (SBS 96x79, ID 83x18, DBS
  78x11) and their metadata JSON. The genome around each event is written
  to fit it (the trinucleotide of an SNV, the run after an indel's anchor),
  so every expected count is known from the plant alone;
- :func:`write_dbsnp`: a dbSNP-like sites VCF over any callset's sites;
- :func:`write_motif_h5`: a substitution-error motif table (both strands of
  the 96 channels, some missing on one strand, some without errors) and a
  per-read-position table, in shuffled row order;
- :func:`write_fingerprint_world`: a reference genome, truth VCFs of
  individuals A, B and C (about one SNV in ``snv_every`` bp of a region, 60 %
  het), HCR and training-interval BEDs, and 30x BAMs and CRAMs of 150-bp
  reads of four samples: A and B as their truths, C holding individual X's
  reads (so it matches no truth) and D a mix of X and A.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from variantcalling_tpu_torch.reports import no_gt_stats
from variantcalling_tpu_torch.reports import signatures as sigmod
from variantcalling_tpu_torch.synthetic import _genome, _write_fasta
from variantcalling_tpu_torch.utils.h5_utils import Frame, write_frames

_B = "ACGT"
_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
_CODE = {b: i for i, b in enumerate(_B)}

#: the report world of ``chip_smoke.py`` phase 14: a 30x chr20 callset of 104,000 records, two
#: controls of 20,000, a dbSNP of 40 % of the case's sites and 500,000 others
REPORT_WORLD = dict(seed=2038, length=64_444_167, n_records=104_000, control_records=20_000, n_extra_dbsnp=500_000)
#: the fingerprinting world of phase 14: a 200 kbp region of chr20 (the tool's region span) at 30x
FINGERPRINT_WORLD = dict(seed=2039, length=64_444_167, region=(26_000_000, 26_200_000), depth=30.0, snv_every=1_000)
#: signatures a catalog: COSMIC v3.3's SBS, ID and DBS catalogs
CATALOG_SHAPES = {"SBS96": 79, "ID83": 18, "DBS78": 11}
#: planted SBS96 mixtures: (signature columns, weights) of the case and of each control
CASE_MIXTURE = ((0, 3, 7, 12), (0.4, 0.3, 0.2, 0.1))
CONTROL_MIXTURES = (((0, 20, 33), (0.5, 0.3, 0.2)), ((3, 40), (0.6, 0.4)))
#: event shares of a callset: SNV (multi-allelic among them), hmer indel, other indel, doublet, run of three, MNP
EVENT_SHARES = (0.78, 0.08, 0.07, 0.04, 0.01, 0.02)
_CELL = 32  # bp a planted event owns; its anchor at offset 8


def _rc(s: str) -> str:
    return "".join(_COMP[c] for c in reversed(s))


def sbs96_labels() -> list[str]:
    return [f"{m[0]}[{m[1]}>{a}]{m[2]}" for (m, a) in no_gt_stats.motif_index_96()]


def catalog_labels() -> dict[str, list[str]]:
    return {"SBS96": sbs96_labels(), "ID83": sigmod.id83_labels(), "DBS78": sigmod.dbs78_labels()}


def report_catalogs(seed: int) -> dict[str, tuple[list[str], list[str], np.ndarray]]:
    """{catalog: (channel labels, signature names, (channels, signatures) float64
    matrix, columns summing to 1)}: peaky random signatures of COSMIC v3.3's shapes."""
    rng = np.random.default_rng(seed)
    out = {}
    for cat, labels in catalog_labels().items():
        k = CATALOG_SHAPES[cat]
        m = rng.random((len(labels), k)) ** 3
        m /= m.sum(axis=0, keepdims=True)
        prefix = {"SBS96": "SBS", "ID83": "ID", "DBS78": "DBS"}[cat]
        out[cat] = (labels, [f"{prefix}{i + 1}" for i in range(k)], m)
    return out


def write_catalog(path: str, labels: list[str], names: list[str], mat: np.ndarray) -> None:
    """A COSMIC-style TSV: ``Type`` then one column a signature."""
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\t".join(["Type", *names]) + "\n")
        for lab, row in zip(labels, mat):
            fh.write("\t".join([lab, *(f"{v:.10g}" for v in row)]) + "\n")


def _vcf_header(contig: str, length: int, sample: str | None) -> str:
    lines = ["##fileformat=VCFv4.2",
             '##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">',
             '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
             '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
             '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
             '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths">',
             '##FORMAT=<ID=VAF,Number=A,Type=Float,Description="Variant allele fraction">',
             f"##contig=<ID={contig},length={length}>"]
    cols = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
    return "\n".join(lines) + "\n" + (cols + f"\tFORMAT\t{sample}" if sample else cols) + "\n"


class _Callset:
    """Records of one callset and the counts its plant implies."""

    def __init__(self, name: str):
        self.name = name
        self.records: list[tuple[int, str, str, str]] = []  # (pos 1-based, ref, alt, GT)
        self.sbs = np.zeros(96, np.int64)  # isolated SNVs by channel
        self.dbs = np.zeros(78, np.int64)
        self.hmer = {"homo": np.zeros((4, 12), np.int64), "hete": np.zeros((4, 12), np.int64)}
        self.id_1bp = np.zeros(24, np.int64)  # the 24 one-base ID83 channels
        self.n_indels = 0
        self.n_snv_records = 0


def _plant(rng, genome: np.ndarray, cells: np.ndarray, cs: _Callset, mixture, sbs_cat: np.ndarray) -> None:
    """Plant one callset's events in ``cells`` (the genome written to fit each)."""
    sigs, weights = mixture
    p_sbs = sbs_cat[:, list(sigs)] @ np.asarray(weights)
    p_sbs /= p_sbs.sum()
    motifs = no_gt_stats.motif_index_96()
    dbs_labels = sigmod.dbs78_labels()
    id_index = {lab: i for i, lab in enumerate(sigmod.id83_labels()[:24])}
    kinds = rng.choice(len(EVENT_SHARES), size=len(cells), p=np.asarray(EVENT_SHARES) / sum(EVENT_SHARES))
    channels = rng.choice(96, size=len(cells), p=p_sbs)

    def put(p0: int, seq: str) -> None:
        genome[p0: p0 + len(seq)] = [_CODE[c] for c in seq]

    def gt_of(hom_share: float = 0.35) -> str:
        return "1/1" if rng.random() < hom_share else "0/1"

    for cell, kind, ch in zip(cells.tolist(), kinds.tolist(), channels.tolist()):
        p0 = cell * _CELL + 8  # the event's first base, 0-based
        if kind == 0:  # an isolated SNV of a channel drawn from the mixture
            motif, alt = motifs[ch]
            if rng.random() < 0.5:
                motif, alt = _rc(motif), _COMP[alt]
            put(p0 - 1, motif)
            alts = [alt]
            if rng.random() < 0.06:  # 2-3 alts: the channel is the first one's
                alts += [b for b in _B if b not in (motif[1], alt)][: int(rng.integers(1, 3))]
            gt = "1/2" if len(alts) > 1 else gt_of()
            cs.records.append((p0 + 1, motif[1], ",".join(alts), gt))
            cs.sbs[ch] += 1
            cs.n_snv_records += 1
        elif kind == 1:  # an hmer indel: one base X inserted or deleted at a run of X of length L
            x = _B[int(rng.integers(4))]
            run = int(rng.integers(1, 11))
            anchor = _B[(_CODE[x] + int(rng.integers(1, 4))) % 4]
            after = _B[(_CODE[x] + int(rng.integers(1, 4))) % 4]
            put(p0, anchor + x * run + after)
            ins = rng.random() < 0.5
            gt = gt_of()
            cs.records.append((p0 + 1, anchor, anchor + x, gt) if ins else (p0 + 1, anchor + x, anchor, gt))
            cls = (0 if x in "AT" else 1) + (0 if ins else 2)
            cs.hmer["homo" if gt == "1/1" else "hete"][cls, run - 1] += 1
            fold = x if x in "CT" else _COMP[x]
            n = min(run if ins else run - 1, 5)
            cs.id_1bp[id_index[f"1:{'Ins' if ins else 'Del'}:{fold}:{n}"]] += 1
            cs.n_indels += 1
        elif kind == 2:  # another indel: 2-4 bases of two kinds at least, or one base the run does not hold
            anchor = _B[int(rng.integers(4))]
            ln = int(rng.integers(1, 5))
            while True:
                unit = "".join(_B[i] for i in rng.integers(0, 4, ln))
                if ln == 1 or len(set(unit)) > 1:
                    break
            after = _B[(_CODE[unit[0]] + int(rng.integers(1, 4))) % 4]
            gt = gt_of()
            if ln == 1:  # a one-base insertion before a base it differs from
                put(p0, anchor + after)
                cs.records.append((p0 + 1, anchor, anchor + unit, gt))
                fold = unit if unit in "CT" else _COMP[unit]
                cs.id_1bp[id_index[f"1:Ins:{fold}:0"]] += 1
            elif rng.random() < 0.5:
                put(p0, anchor + after)
                cs.records.append((p0 + 1, anchor, anchor + unit, gt))
            else:
                put(p0, anchor + unit + after)
                cs.records.append((p0 + 1, anchor + unit, anchor, gt))
            cs.n_indels += 1
        elif kind == 3:  # an adjacent-SNV doublet of a DBS78 channel
            ch = int(rng.integers(78))
            ref, alt = dbs_labels[ch].split(">")
            if rng.random() < 0.5:
                ref, alt = _rc(ref), _rc(alt)
            put(p0, ref)
            gt = gt_of()
            cs.records += [(p0 + 1, ref[0], alt[0], gt), (p0 + 2, ref[1], alt[1], gt)]
            cs.dbs[ch] += 1
            cs.n_snv_records += 2
        elif kind == 4:  # three adjacent SNVs: a multi-base substitution, in no catalog
            ref = "".join(_B[i] for i in rng.integers(0, 4, 3))
            put(p0, ref)
            gt = gt_of()
            cs.records += [(p0 + 1 + k, ref[k], _B[(_CODE[ref[k]] + int(rng.integers(1, 4))) % 4], gt)
                           for k in range(3)]
            cs.n_snv_records += 3
        else:  # an explicit 2-bp MNP record of a DBS78 channel
            ch = int(rng.integers(78))
            ref, alt = dbs_labels[ch].split(">")
            if rng.random() < 0.5:
                ref, alt = _rc(ref), _rc(alt)
            put(p0, ref)
            cs.records.append((p0 + 1, ref, alt, gt_of()))
            cs.dbs[ch] += 1


def _write_callset(path: str, rng, contig: str, length: int, cs: _Callset) -> None:
    """The callset as a VCF: AD and VAF drawn from the genotype, INFO/DP."""
    lines = [_vcf_header(contig, length, cs.name)]
    for pos, ref, alt, gt in cs.records:
        n_alt = alt.count(",") + 1
        dp = int(rng.integers(15, 61))
        share = {"0/1": 0.5, "1/1": 0.97, "1/2": 0.45}[gt]
        ad_alt = [int(rng.binomial(dp, share))] + [int(rng.integers(0, 6)) for _ in range(n_alt - 1)]
        ad_ref = max(dp - sum(ad_alt), 0)
        vaf = ",".join(f"{a / dp:.4g}" for a in ad_alt)
        ad = ",".join(str(v) for v in [ad_ref, *ad_alt])
        qual = f"{rng.uniform(20, 900):.2f}"
        lines.append(f"{contig}\t{pos}\t.\t{ref}\t{alt}\t{qual}\tPASS\tDP={dp}\tGT:GQ:DP:AD:VAF\t"
                     f"{gt}:{int(rng.integers(20, 100))}:{dp}:{ad}:{vaf}\n")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("".join(lines))


def write_dbsnp(path: str, seed: int, contig: str, length: int, sites: list[tuple[int, str, str]],
                genome: np.ndarray | None = None, share: float = 0.4, n_extra: int = 500_000) -> int:
    """A sites-only dbSNP VCF: ``share`` of ``sites`` (pos 1-based, ref, alt)
    and ``n_extra`` other SNV sites (the genome's base as REF where given),
    sorted by position; the records it holds."""
    rng = np.random.default_rng(seed)
    keep = [s for s, r in zip(sites, rng.random(len(sites))) if r < share]
    taken = {s[0] for s in sites}
    extra = np.unique(rng.integers(1, length + 1, n_extra + n_extra // 8))
    extra = extra[~np.isin(extra, np.fromiter(taken, dtype=np.int64, count=len(taken)))][:n_extra]
    ref_codes = genome[extra - 1] if genome is not None else rng.integers(0, 4, len(extra))
    ref_codes = np.minimum(ref_codes, 3)
    alt_codes = (ref_codes + rng.integers(1, 4, len(extra))) % 4
    rows = [(p, r, a) for p, r, a in keep]
    rows += list(zip(extra.tolist(), (_B[c] for c in ref_codes.tolist()), (_B[c] for c in alt_codes.tolist())))
    rows.sort(key=lambda t: t[0])
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(_vcf_header(contig, length, None))
        fh.write("".join(f"{contig}\t{p}\trs{i + 1}\t{r}\t{a}\t.\t.\t.\n" for i, (p, r, a) in enumerate(rows)))
    return len(rows)


def write_report_world(d: str, seed: int, length: int = 64_444_167, n_records: int = 104_000,
                       control_records: int = 20_000, n_extra_dbsnp: int = 500_000, contig: str = "chr20") -> dict:
    """Write the report world under ``d`` (see the module docstring). Returns
    the paths and, for the case and each control, the counts the plant
    implies: ``sbs`` (isolated SNVs by SBS96 channel), ``dbs`` (DBS78),
    ``hmer`` (the two (4, 12) hmer tables), ``id_1bp`` (the 24 one-base ID83
    channels), ``n_indels``, ``n_snv_records``, ``records``."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    genome = _genome(rng, length)
    catalogs = report_catalogs(seed + 1)
    sizes = [n_records, *([control_records] * len(CONTROL_MIXTURES))]
    n_cells = length // _CELL - 2
    cells = np.sort(rng.choice(np.arange(1, n_cells), size=sum(sizes), replace=False))
    owner = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    sets = []
    for k, mixture in enumerate([CASE_MIXTURE, *CONTROL_MIXTURES]):
        cs = _Callset("case" if k == 0 else f"control{k}")
        _plant(rng, genome, cells[owner == k], cs, mixture, catalogs["SBS96"][2])
        sets.append(cs)
    fasta = os.path.join(d, "ref.fa")
    _write_fasta(fasta, [(contig, genome)])
    paths = {"fasta": fasta}
    for k, cs in enumerate(sets):
        key = "case" if k == 0 else f"control{k}"
        paths[key] = os.path.join(d, f"{cs.name}.vcf")
        _write_callset(paths[key], rng, contig, length, cs)
    sites = [(p, r, a) for p, r, a, _ in sets[0].records]
    paths["dbsnp"] = os.path.join(d, "dbsnp.vcf")
    paths["dbsnp_records"] = write_dbsnp(paths["dbsnp"], seed + 2, contig, length, sites, genome,
                                         n_extra=n_extra_dbsnp)
    paths["callable"] = os.path.join(d, "callable.bed")
    starts = np.sort(rng.choice(length // 100_000, size=max(1, length // 400_000), replace=False)) * 100_000
    with open(paths["callable"], "w", encoding="utf-8") as fh:
        fh.write("".join(f"{contig}\t{s}\t{s + int(e)}\n"
                         for s, e in zip(starts.tolist(), rng.integers(20_000, 90_000, len(starts)))))
    for cat, (labels, names, mat) in catalogs.items():
        paths[f"catalog_{cat}"] = os.path.join(d, f"catalog_{cat}.tsv")
        write_catalog(paths[f"catalog_{cat}"], labels, names, mat)
    paths["metadata"] = os.path.join(d, "cosmic_signatures.json")
    with open(paths["metadata"], "w", encoding="utf-8") as fh:
        json.dump({f"SBS{i}": {"description": f"planted signature {i}", "link": ""} for i in (1, 4, 8, 21)}, fh)
    paths["planted"] = {cs.name: {"sbs": cs.sbs, "dbs": cs.dbs, "hmer": cs.hmer, "id_1bp": cs.id_1bp,
                                  "n_indels": cs.n_indels, "n_snv_records": cs.n_snv_records,
                                  "records": len(cs.records)} for cs in sets}
    return paths


def write_motif_h5(path: str, seed: int, read_len: int = 150) -> dict:
    """A substitution-error h5: ``motif_1`` with both strands of the 96
    channels (ref, alt, left_motif, right_motif, n_errors, n_bases; 4 rows
    missing their other strand, 6 without errors), ``by_position`` with
    ``read_len`` read positions; rows shuffled."""
    rng = np.random.default_rng(seed)
    rows = [(r, a, left, right) for r in _B for a in _B if a != r for left in _B for right in _B]
    order = rng.permutation(len(rows))
    drop = set(order[:4].tolist())
    kept = [rows[i] for i in order.tolist() if i not in drop]
    n_bases = rng.integers(1_000_000, 50_000_000, len(kept))
    rate = rng.lognormal(np.log(2e-4), 1.0, len(kept))
    n_errors = rng.binomial(n_bases, np.minimum(rate, 0.5))
    n_errors[rng.choice(len(kept), 6, replace=False)] = 0
    col = lambda j: np.array([r[j] for r in kept], dtype=object)  # noqa: E731
    motif = Frame({"ref": col(0), "alt": col(1), "left_motif": col(2), "right_motif": col(3),
                   "n_errors": n_errors.astype(np.int64), "n_bases": n_bases.astype(np.int64)})
    pos = rng.permutation(read_len)
    pb = rng.integers(5_000_000, 9_000_000, read_len)
    by_pos = Frame({"position": pos.astype(np.int64), "n_errors": rng.binomial(pb, 3e-4).astype(np.int64),
                    "n_bases": pb.astype(np.int64)})
    write_frames(path, {"motif_1": motif, "by_position": by_pos})
    return {"path": path, "rows": len(kept)}


# -- the fingerprinting world --------------------------------------------------------------------------

_READ_LEN = 150
#: (CIGAR as (op, length), share): 150M and four shapes with I, D and S ops
FINGERPRINT_SHAPES = ((((0, 150),), 0.80), (((0, 70), (1, 2), (0, 78)), 0.05), (((0, 60), (2, 3), (0, 90)), 0.05),
                      (((4, 5), (0, 145)), 0.05), (((4, 8), (0, 90), (2, 2), (0, 52)), 0.05))
_NIB = {"A": 1, "C": 2, "G": 4, "T": 8, "N": 15}


def _truth_snvs(rng, genome: np.ndarray, lo: int, hi: int, n: int, taken: set) -> list[tuple[int, str, str, str]]:
    """``n`` SNVs (0-based pos, ref, alt, GT) at distinct positions of [lo, hi) not in ``taken``."""
    out = []
    while len(out) < n:
        p = int(rng.integers(lo, hi))
        if any(p + k in taken for k in range(-2, 3)):
            continue
        taken.add(p)
        ref = _B[int(genome[p]) % 4]
        alt = _B[(_CODE[ref] + int(rng.integers(1, 4))) % 4]
        out.append((p, ref, alt, "0/1" if rng.random() < 0.6 else "1/1"))
    return sorted(out)


def _haplotypes(genome: np.ndarray, snvs) -> list[np.ndarray]:
    haps = [genome.copy(), genome.copy()]
    for p, _ref, alt, gt in snvs:
        for h in ((0, 1) if gt == "1/1" else (int(p % 2),)):
            haps[h][p] = _CODE[alt]
    return haps


def _reads(rng, sources: list[tuple[list[np.ndarray], float]], lo: int, hi: int, depth: float,
           error_rate: float) -> list[dict]:
    """Reads over [lo, hi), sorted by position: each from a haplotype of a
    source drawn by the sources' shares, a shape from
    :data:`FINGERPRINT_SHAPES`, 3 % duplicates, 1 % secondary, a quarter
    reverse; bases substituted at ``error_rate``."""
    n = int(round(depth * (hi - lo) / _READ_LEN))
    starts = np.sort(rng.integers(lo, hi - 160, n))
    shares = np.array([s for _, s in sources])
    src = rng.choice(len(sources), size=n, p=shares / shares.sum())
    shape = rng.choice(len(FINGERPRINT_SHAPES), size=n, p=[s for _, s in FINGERPRINT_SHAPES])
    kind = rng.random(n)
    flags = np.where(kind < 0.03, 0x400, np.where(kind < 0.04, 0x100, 0))
    flags[(flags == 0) & (rng.random(n) < 0.25)] = 0x10
    out = []
    for i in range(n):
        hap = sources[src[i]][0][int(rng.integers(2))]
        cigar = FINGERPRINT_SHAPES[shape[i]][0]
        seq, rpos = [], int(starts[i])
        for op, ln in cigar:
            if op == 0:
                seq.append(hap[rpos: rpos + ln])
                rpos += ln
            elif op in (1, 4):
                seq.append(rng.integers(0, 4, ln).astype(np.uint8))
            else:
                rpos += ln
        codes = np.concatenate(seq)
        err = rng.random(len(codes)) < error_rate
        codes[err] = (codes[err] + rng.integers(1, 4, int(err.sum()))) % 4
        out.append({"pos": int(starts[i]), "flag": int(flags[i]), "cigar": cigar, "codes": codes})
    return out


def _write_bam(path: str, contig: str, length: int, reads: list[dict]) -> None:
    from variantcalling_tpu_torch.io.bgzf import BgzfWriter

    text = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{contig}\tLN:{length}\n"
    head = b"BAM\x01" + struct.pack("<i", len(text)) + text.encode() + struct.pack("<i", 1)
    head += struct.pack("<i", len(contig) + 1) + contig.encode() + b"\x00" + struct.pack("<i", length)
    nib = np.array([1, 2, 4, 8], np.uint8)
    parts = [head]
    for i, r in enumerate(reads):
        name = f"r{i:08d}".encode() + b"\x00"
        codes = nib[r["codes"]]
        if len(codes) % 2:
            codes = np.append(codes, 0)
        seq = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
        cig = b"".join(struct.pack("<I", (ln << 4) | op) for op, ln in r["cigar"])
        l_seq = len(r["codes"])
        body = struct.pack("<iiIIiiii", 0, r["pos"], (4680 << 16) | (60 << 8) | len(name),
                           (r["flag"] << 16) | len(r["cigar"]), l_seq, -1, -1, 0)
        body += name + cig + seq + bytes([30]) * l_seq
        parts.append(struct.pack("<i", len(body)) + body)
    with BgzfWriter(path, level=1) as out:
        out.write(b"".join(parts))


def _cram_records(reads: list[dict], genome: np.ndarray) -> list[dict]:
    """The reads as ``tests/cram_fixtures.write_cram`` records: S and I with
    their bases, D with its length, X where an aligned base differs from the
    genome (BS: its index among A, C, G, T, N without the genome's base)."""
    out = []
    for i, r in enumerate(reads):
        feats, rp, rpos, q = [], 1, r["pos"], 0
        codes = r["codes"]
        for op, ln in r["cigar"]:
            if op == 0:
                ref = genome[rpos: rpos + ln]
                for j in np.flatnonzero(codes[q: q + ln] != ref).tolist():
                    alts = [c for c in range(5) if c != int(ref[j])]
                    feats.append(("X", rp + j, alts.index(int(codes[q + j]))))
                rp += ln
                q += ln
                rpos += ln
            elif op in (1, 4):
                feats.append(("I" if op == 1 else "S", rp, "".join(_B[c] for c in codes[q: q + ln].tolist()).encode()))
                rp += ln
                q += ln
            else:
                feats.append(("D", rp, ln))
                rpos += ln
        out.append({"flag": r["flag"], "pos": r["pos"] + 1, "read_len": len(codes), "mapq": 60,
                    "name": f"r{i:08d}", "features": feats})
    return out


def write_fingerprint_world(d: str, seed: int, length: int = 64_444_167, region: tuple[int, int] = (26_000_000,
                            26_200_000), depth: float = 30.0, snv_every: int = 1_000, contig: str = "chr20",
                            error_rate: float = 1e-4, cram_writer=None) -> dict:
    """Write the fingerprinting world under ``d`` (see the module docstring);
    ``region`` is 0-based half-open. ``cram_writer(path, sam_header,
    records)``, where given, writes each sample's CRAM from records of
    ``tests/cram_fixtures.write_cram``'s form. Returns the paths (``bam`` and
    ``cram`` by sample, ``truth`` by individual, ``hcr``, ``intervals``,
    ``fasta``), the region string the tools take and the truth SNVs."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    genome = _genome(rng, length)
    lo, hi = region
    n_snv = max(4, (hi - lo) // snv_every)
    taken: set = set()
    truth = {ind: _truth_snvs(rng, genome, lo + 500, hi - 500, n_snv, taken) for ind in ("A", "B", "C", "X")}
    haps = {ind: _haplotypes(genome, snvs) for ind, snvs in truth.items()}
    fasta = os.path.join(d, "ref.fa")
    _write_fasta(fasta, [(contig, genome)])
    out = {"fasta": fasta, "region_str": f"{contig}:{lo + 1}-{hi}", "truth_snvs": truth, "bam": {}, "cram": {},
           "truth": {}}
    for ind in ("A", "B", "C"):
        path = os.path.join(d, f"truth_{ind}.vcf")
        lines = [_vcf_header(contig, length, ind)]
        extra = [(lo - 5_000, genome[lo - 5_000], "indel"), (lo + 300, genome[lo + 300], "indel")]
        recs = [(p + 1, ref, alt, f"GT\t{gt}") for p, ref, alt, gt in truth[ind]]
        recs += [(p + 1, _B[int(b)], _B[int(b)] + "T", "GT\t0/1") for p, b, _ in extra]  # indels: not SNP keys
        recs.append((hi + 2_000, _B[int(genome[hi + 1_999])], _B[(int(genome[hi + 1_999]) + 1) % 4], "GT\t0/1"))
        for pos, ref, alt, fmt in sorted(recs):
            lines.append(f"{contig}\t{pos}\t.\t{ref}\t{alt}\t50\tPASS\t.\t{fmt}\n")
        with open(path, "w", encoding="utf-8") as fh:
            fh.write("".join(lines))
        out["truth"][ind] = path
    samples = {"A": [(haps["A"], 1.0)], "B": [(haps["B"], 1.0)], "C": [(haps["X"], 1.0)],
               "D": [(haps["X"], 0.5), (haps["A"], 0.5)]}
    header = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{contig}\tLN:{length}\n"
    for name, sources in samples.items():
        reads = _reads(rng, sources, lo - 200, hi + 200, depth, error_rate)
        out["bam"][name] = os.path.join(d, f"{name}.bam")
        _write_bam(out["bam"][name], contig, length, reads)
        if cram_writer is not None:
            out["cram"][name] = os.path.join(d, f"{name}.cram")
            cram_writer(out["cram"][name], header, _cram_records(reads, genome))
    out["hcr"] = os.path.join(d, "hcr.bed")
    with open(out["hcr"], "w", encoding="utf-8") as fh:  # the region but a 2 kbp hole
        mid = (lo + hi) // 2
        fh.write(f"{contig}\t{lo}\t{mid}\n{contig}\t{mid + 2_000}\t{hi}\n")
    out["intervals"] = os.path.join(d, "training.bed")
    with open(out["intervals"], "w", encoding="utf-8") as fh:
        fh.write(f"{contig}\t{lo - 10_000}\t{hi + 10_000}\n")
    return out


def fingerprint_confs(world: dict, d: str, formats=("bam", "cram")) -> dict:
    """The two tools' JSON confs over a fingerprinting world, and the errors
    each must raise (as (file, start of the message) pairs, in order):

    - ``quick_fingerprinting``: samples A-D with their files, truths of A, B
      and C: C's files miss their own truth, D's match A's;
    - ``training_set_consistency_check``, two subsets: truth A with targets
      A (both files) and C's BAM (individual X: a suspected normal-in-tumor
      sample) and normal C's CRAM (X: complementary, and C's BAM matches
      its germline); truth B with targets B's CRAM and D's BAM (suspected,
      but X and A match no normal) and normal B's BAM (not complementary)."""
    files = {s: [world[f][s] for f in formats] for s in ("A", "B", "C", "D")}
    qf = {"cram_files": files, "ground_truth_vcf_files": dict(world["truth"]),
          "ground_truth_hcr_files": {s: world["hcr"] for s in world["truth"]},
          "references": {"ref_fasta": world["fasta"]}}
    last = formats[-1]
    tscc = {"fingerprint.references": {"ref_fasta": world["fasta"]},
            "fingerprint.cram_files": [[*files["A"], world["bam"]["C"]], [world[last]["B"], world["bam"]["D"]]],
            "fingerprint.background_cram_files": [[world[last]["C"]], [world["bam"]["B"]]],
            "fingerprint.ground_truth_vcf_files": [world["truth"]["A"], world["truth"]["B"]],
            "fingerprint.training_hcr_files": [world["hcr"], world["hcr"]],
            "fingerprint.training_intervals": [world["intervals"], world["intervals"]]}
    out = {"qf": os.path.join(d, "quick_fingerprinting.json"), "tscc": os.path.join(d, "training_set.json")}
    for key, conf in (("qf", qf), ("tscc", tscc)):
        with open(out[key], "w", encoding="utf-8") as fh:
            json.dump(conf, fh)
    out["qf_errors"] = [(f, f"{f} - C does not match it's ground truth") for f in files["C"]] + \
        [(f, f"{f} - D matched ground truth of A") for f in files["D"]]
    out["tscc_errors"] = [(world["bam"]["B"], f"{world['bam']['B']} - normal sample is not complementary"),
                          (world["bam"]["D"], f"{world['bam']['D']} - suspected normal-in-tumor sample does not "
                                              "match any normal sample")]
    return out
