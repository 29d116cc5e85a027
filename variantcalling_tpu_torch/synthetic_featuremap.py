"""Seeded worlds of the single-read SNV, MRD, LPR, bridging and methylation tools.

Each world is written from a seed with numpy alone (the card's machine has
no pandas), at the sizes ``chip_smoke.py`` drives (:data:`FEATUREMAP_WORLD`,
:data:`BRIDGING_WORLD`, :data:`METHYL_WORLD`) or cut down for the CPU tests:

- :func:`write_featuremap_world`: a synthetic chr20 and its FASTA; a TP and
  an FP featuremap (one record a read, the INFO keys of a featuremap:
  ``X_SCORE``, ``X_EDIST``, ``X_LENGTH``, ``X_MAPQ``, ``X_INDEX``,
  ``X_READ_COUNT``, ``X_FILTERED_COUNT``, ``rq``) whose true reads and error
  reads differ by a planted shift; a tumor signature VCF of SNVs; a cfDNA
  featuremap with ``round(loci * depth * tf / 2)`` tumor reads at the
  signature loci (the clearest true-read features), error reads there (the
  clearest error features) and background error reads elsewhere, and its
  control without the tumor reads; an LPR featuremap of loci at AF 1
  (germline-like), at AF 1/30 (noise) and between, and a calls VCF holding
  those loci among other records.
- :func:`write_bridging_world`: a somatic VCF (``GT:AD:DP:BG_AD:BG_DP``) with
  planted filtered SNVs that bridge two homopolymers (to rescue), tandem
  repeats and high normal VAFs at such sites (not to rescue), and PASS
  records (untouched); the other filtered records fail the VAF test.
- :func:`write_methyl_world`: MethylDackel outputs: a CpG extract bedGraph
  of both strands (a ``track`` line, zero-coverage sites, rows of an alt
  contig whose name holds a ``t``), cut into shards that overlap; a CHH
  extract; an mbias table with planted 5' and 3' bias; a perRead table.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from variantcalling_tpu_torch.synthetic import _BASES, _cat, _fixed, _genome, _text, _write_fasta, _write_lines

#: chip_smoke.py phase 15's worlds: one chr20, featuremaps a few times smaller than a 30x chr20 run's
FEATUREMAP_WORLD = dict(seed=2040, length=64_444_167, n_tp=500_000, n_fp=500_000, n_cfdna=1_000_000,
                        n_signature=2_000, depth=30, tumor_fraction=1e-3, n_lpr_loci=12_000, lpr_reads=300_000,
                        n_calls=104_000)
BRIDGING_WORLD = dict(seed=2041, length=64_444_167, n_records=104_000, n_rescue=1_000, n_tandem=500,
                      n_high_normal=500)
METHYL_WORLD = dict(seed=2042, length=64_444_167, n_cpg_sites=950_000, n_shards=4, n_chh=1_000_000,
                    n_reads=1_000_000, n_alt_rows=200)

FEATURE_KEYS = ("X_SCORE", "X_EDIST", "X_LENGTH", "X_MAPQ", "X_INDEX", "X_READ_COUNT", "X_FILTERED_COUNT", "rq")
CONTIG = "chr20"
ALT_CONTIG = "chr20_KI270869v1_alt"  # a GRCh38 alt contig name: it holds a "t"


def _featuremap_header(length: int) -> bytes:
    types = {"X_SCORE": "Float", "rq": "Float"}
    lines = ["##fileformat=VCFv4.2", '##FILTER=<ID=PASS,Description="All filters passed">',
             *(f'##INFO=<ID={k},Number=1,Type={types.get(k, "Integer")},Description="{k}">' for k in FEATURE_KEYS),
             f"##contig=<ID={CONTIG},length={length}>", "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    return ("\n".join(lines) + "\n").encode()


def _read_features(rng: np.random.Generator, n: int, kind: str, read_count: np.ndarray) -> np.ndarray:
    """INFO text of ``n`` reads: ``true`` and ``error`` reads overlap; ``tumor``
    and ``artifact`` reads are the clearest of each."""
    shift = {"true": 0.0, "error": 1.0, "tumor": -0.6, "artifact": 1.6}[kind]
    score = np.clip(rng.normal(7.0 - 4.0 * shift, 1.3, n), 0, 20)
    edist = np.minimum(rng.poisson(1.0 + 2.5 * max(shift, 0.0), n), 20)
    length = rng.integers(80, 250, n)
    mapq = np.where(rng.random(n) < (0.97 if shift <= 0 else 0.6), 60, rng.integers(0, 60, n))
    index = rng.integers(0, 150, n)
    filtered = np.minimum(rng.binomial(np.maximum(read_count, 1), 0.05), read_count)
    rq = np.clip(rng.uniform(0.93 - 0.25 * max(shift, 0.0), 1.0, n), 0, 1)
    if kind == "tumor":
        score, edist, mapq, rq = np.maximum(score, 9.0), np.zeros(n, np.int64), np.full(n, 60), np.maximum(rq, 0.98)
    if kind == "artifact":
        score, edist, rq = np.minimum(score, 1.0), np.maximum(edist, 5), np.minimum(rq, 0.6)
    return _cat(b"X_SCORE=", _fixed(score, 2), b";X_EDIST=", _text(edist), b";X_LENGTH=", _text(length),
                b";X_MAPQ=", _text(mapq), b";X_INDEX=", _text(index), b";X_READ_COUNT=", _text(read_count),
                b";X_FILTERED_COUNT=", _text(filtered), b";rq=", _fixed(rq, 3))


def _snv_alleles(rng: np.random.Generator, genome: np.ndarray, pos0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    ref = np.minimum(genome[pos0], 3)
    alt = (ref + rng.integers(1, 4, len(pos0))) % 4
    return _BASES[ref], _BASES[alt]


def _records(pos0: np.ndarray, ref: np.ndarray, alt: np.ndarray, info: np.ndarray, qual=b".",
             filt=b"PASS", contig: bytes = CONTIG.encode()) -> np.ndarray:
    tab = b"\t"
    return _cat(contig, tab, _text(pos0 + 1), tab, b".", tab, ref, tab, alt, tab, qual, tab, filt, tab, info)


def _loci(rng: np.random.Generator, length: int, n: int, taken: np.ndarray | None = None) -> np.ndarray:
    """``n`` distinct sorted 0-based positions away from the contig's ends (and from ``taken``)."""
    pos = np.unique(rng.integers(1_000, length - 1_000, int(n * 1.3) + 16))
    if taken is not None:
        pos = np.setdiff1d(pos, taken)
    return np.sort(rng.choice(pos, n, replace=False))


def write_featuremap_world(d: str, seed: int, length: int = 64_444_167, n_tp: int = 500_000, n_fp: int = 500_000,
                           n_cfdna: int = 1_000_000, n_signature: int = 2_000, depth: int = 30,
                           tumor_fraction: float = 1e-3, n_lpr_loci: int = 12_000, lpr_reads: int = 300_000,
                           n_calls: int = 104_000) -> dict:
    """The featuremap world (see the module's docstring); returns its paths
    and what it planted (``n_tumor_reads``, ``n_signature``, ``depth``). Its
    four parts (the TP map, the FP map, the signature with the cfDNA map
    and its control, the LPR map with its calls) draw from streams of their
    own spawned from ``seed``, and are written on four threads."""
    os.makedirs(d, exist_ok=True)
    g_rng, tp_rng, fp_rng, sig_rng, lpr_rng = (np.random.default_rng(s) for s in np.random.SeedSequence(seed).spawn(5))
    genome = _genome(g_rng, length)
    out = {"fasta": os.path.join(d, "ref.fa")}
    _write_fasta(out["fasta"], [(CONTIG, genome)])
    header = _featuremap_header(length)
    sig_header = ("\n".join(["##fileformat=VCFv4.2", f"##contig=<ID={CONTIG},length={length}>",
                             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]) + "\n").encode()

    def part_lines(rng, pos0: np.ndarray, kind: str, ref=None, alt=None) -> tuple[np.ndarray, np.ndarray]:
        if ref is None:
            ref, alt = _snv_alleles(rng, genome, pos0)
        rc = np.maximum(rng.poisson(depth, len(pos0)), 1)
        return pos0, _records(pos0, ref, alt, _read_features(rng, len(pos0), kind, rc)) if len(pos0) else pos0

    def featuremap(name: str, parts: list[tuple[np.ndarray, np.ndarray]], cut: int = 0) -> dict:
        """The featuremap of ``parts`` (positions, lines), sorted; with ``cut``
        also ``<name>_cut``: its first ``cut`` records, a smaller featuremap."""
        parts = [p for p in parts if len(p[0])]
        pos0, lines = np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])
        order = np.argsort(pos0, kind="stable")
        paths = {name: os.path.join(d, f"{name}.vcf")}
        _write_lines(paths[name], header, pos0[order], lines[order])
        if cut:
            paths[f"{name}_cut"] = os.path.join(d, f"{name}_cut.vcf")
            _write_lines(paths[f"{name}_cut"], header, pos0[order][:cut], lines[order][:cut])
        return paths

    def reads_at_loci(rng, name: str, n: int, kind: str) -> dict:
        """A TP or FP featuremap: reads at loci, 1-8 reads a locus."""
        per = rng.integers(1, 9, n // 4 + 1)
        per = per[: int(np.searchsorted(np.cumsum(per), n)) + 1]
        per[-1] -= int(per.sum()) - n
        return featuremap(name, [part_lines(rng, np.repeat(_loci(rng, length, len(per)), per), kind)], cut=n // 20)

    def cfdna(rng) -> dict:
        """The tumor signature, and the cfDNA featuremap and its control (the same reads but the tumor's)."""
        sig = _loci(rng, length, n_signature)
        sig_ref, sig_alt = _snv_alleles(rng, genome, sig)
        paths = {"signature": os.path.join(d, "signature.vcf")}
        _write_lines(paths["signature"], sig_header, sig, _records(sig, sig_ref, sig_alt, np.full(len(sig), b"."),
                                                                     qual=b"50"))
        n_tumor = int(round(n_signature * depth * tumor_fraction / 2))
        n_artifact = n_signature // 4
        tumor_at = rng.choice(n_signature, n_tumor)
        artifact_at = rng.choice(n_signature, n_artifact)
        noise = [part_lines(rng, _loci(rng, length, max(n_cfdna - n_tumor - n_artifact, 0), taken=sig), "error"),
                 part_lines(rng, sig[artifact_at], "artifact", sig_ref[artifact_at], sig_alt[artifact_at])]
        tumor = part_lines(rng, sig[tumor_at], "tumor", sig_ref[tumor_at], sig_alt[tumor_at])
        return {**paths, **featuremap("cfdna", [*noise, tumor], cut=n_cfdna // 10), **featuremap("control", noise),
                "n_tumor_reads": n_tumor}

    def lpr(rng) -> dict:
        """LPR: germline-like loci (AF 1), noise loci (AF 1/30), loci between; a calls VCF around them."""
        n_mid = n_lpr_loci // 12
        n_tp_loci = (n_lpr_loci - n_mid) // 2
        n_fp_loci = n_lpr_loci - n_mid - n_tp_loci
        fp_reads, mid_reads = 5, 25
        tp_reads = max((lpr_reads - n_fp_loci * fp_reads - n_mid * mid_reads) // max(n_tp_loci, 1), 1)
        loci = _loci(rng, length, n_lpr_loci)
        kinds = rng.permutation(np.repeat([0, 1, 2], [n_tp_loci, n_fp_loci, n_mid]))
        ref, alt = _snv_alleles(rng, genome, loci)
        per = np.array([tp_reads, fp_reads, mid_reads])[kinds]
        count = np.array([tp_reads, fp_reads * 30, mid_reads * 2])[kinds]
        pos_r, lines = np.repeat(loci, per), []
        for k, kind in ((0, "true"), (1, "error"), (2, "error")):
            m = np.repeat(kinds == k, per)
            lines.append(_records(pos_r[m], np.repeat(ref, per)[m], np.repeat(alt, per)[m],
                                  _read_features(rng, int(m.sum()), kind, np.repeat(count, per)[m])))
        by_kind = np.concatenate([np.flatnonzero(np.repeat(kinds == k, per)) for k in range(3)])
        paths = {"lpr_featuremap": os.path.join(d, "lpr_featuremap.vcf"), "lpr_calls": os.path.join(d, "lpr_calls.vcf")}
        _write_lines(paths["lpr_featuremap"], header, pos_r[by_kind], np.concatenate(lines))
        others = _loci(rng, length, max(n_calls - n_lpr_loci, 0), taken=loci)
        o_ref, o_alt = _snv_alleles(rng, genome, others)
        indel = rng.random(len(others)) < 0.15
        o_alt = np.where(indel, _cat(o_ref, b"A"), o_alt)
        call_pos = np.concatenate([loci, others])
        call_ref, call_alt = np.concatenate([ref, o_ref]), np.concatenate([alt, o_alt])
        filt = np.where(rng.random(len(call_pos)) < 0.1, b"LowQual", b"PASS")
        _write_lines(paths["lpr_calls"], sig_header, call_pos,
                     _records(call_pos, call_ref, call_alt, _cat(b"DP=", _text(rng.poisson(30, len(call_pos)))),
                              qual=_text(rng.integers(5, 99, len(call_pos))), filt=filt))
        return {**paths, "lpr_reads": len(pos_r)}

    with ThreadPoolExecutor(4) as pool:  # numpy's string operations run outside the GIL
        jobs = [pool.submit(reads_at_loci, tp_rng, "tp", n_tp, "true"),
                pool.submit(reads_at_loci, fp_rng, "fp", n_fp, "error"), pool.submit(cfdna, sig_rng),
                pool.submit(lpr, lpr_rng)]
        for job in jobs:
            out.update(job.result())
    out.update(n_signature=n_signature, depth=depth, tumor_fraction=tumor_fraction, n_lpr_loci=n_lpr_loci)
    return out


def write_bridging_world(d: str, seed: int, length: int = 64_444_167, n_records: int = 104_000,
                         n_rescue: int = 1_000, n_tandem: int = 500, n_high_normal: int = 500) -> dict:
    """The bridging world (see the module's docstring); returns its paths and
    the 1-based positions of the records to rescue (``rescue``)."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    genome = _genome(rng, length)
    n_planted = n_rescue + n_tandem + n_high_normal
    slots = np.sort(rng.choice(np.arange(1_000, (length - 1_000) // 40), n_planted, replace=False)) * 40
    kind = rng.permutation(np.repeat([0, 1, 2], [n_rescue, n_tandem, n_high_normal]))
    x = rng.integers(0, 4, n_planted).astype(np.uint8)  # the homopolymer base = ALT
    refb = ((x + rng.integers(1, 4, n_planted)) % 4).astype(np.uint8)
    for i, (p, k) in enumerate(zip(slots.tolist(), kind.tolist())):
        b, r = x[i], refb[i]
        other = (b + 1) % 4 if (b + 1) % 4 != r else (b + 2) % 4
        if k == 1:  # tandem: r XX r XX r around the variant's r
            genome[p - 3: p + 4] = [r, b, b, r, b, b, r]
        else:  # bridging: other XXXX r XXXXX (a run of 10 once r is X)
            genome[p - 5: p + 6] = [other, b, b, b, b, r, b, b, b, b, b]
            genome[p + 6] = other
    planted_ref, planted_alt = _BASES[refb], _BASES[x]
    normal_alt = np.where(kind == 2, 5, 0)
    planted_sample = _cat(b"0/1:10,10:20:", _text(15 - normal_alt), b",", _text(normal_alt), b":15")
    n_bg = n_records - n_planted
    bg = _loci(rng, length, n_bg, taken=np.concatenate([slots + o for o in range(-8, 9)]))
    bg_ref, bg_alt = _snv_alleles(rng, genome, bg)
    indel = rng.random(n_bg) < 0.12
    bg_alt = np.where(indel, _cat(bg_ref, b"T"), bg_alt)
    is_pass = rng.random(n_bg) < 0.6
    depth = np.maximum(rng.poisson(40, n_bg), 12)
    # a filtered record's tumor VAF stays at most 0.1: none of them passes the rescue's VAF test
    alt_reads = np.where(is_pass, rng.binomial(depth, 0.35), np.minimum(rng.binomial(depth, 0.05), depth // 10))
    bg_sample = _cat(b"0/1:", _text(depth - alt_reads), b",", _text(alt_reads), b":", _text(depth), b":",
                     _text(np.full(n_bg, 30)), b",", _text(np.zeros(n_bg, np.int64)), b":30")
    fmt = b"GT:AD:DP:BG_AD:BG_DP"
    lines = np.concatenate([
        _records(slots, planted_ref, planted_alt, _cat(b".\t", fmt, b"\t", planted_sample), qual=b"10",
                 filt=b"LowQual"),
        _records(bg, bg_ref, bg_alt, _cat(b".\t", fmt, b"\t", bg_sample), qual=_text(rng.integers(2, 60, n_bg)),
                 filt=np.where(is_pass, b"PASS", b"LowQual"))])
    out = {"fasta": os.path.join(d, "ref.fa"), "vcf": os.path.join(d, "somatic.vcf")}
    _write_fasta(out["fasta"], [(CONTIG, genome)])
    header = ("\n".join([
        "##fileformat=VCFv4.2", '##FILTER=<ID=LowQual,Description="Low quality">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allele depths">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Depth">',
        '##FORMAT=<ID=BG_AD,Number=R,Type=Integer,Description="Normal allele depths">',
        '##FORMAT=<ID=BG_DP,Number=1,Type=Integer,Description="Normal depth">',
        f"##contig=<ID={CONTIG},length={length}>",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ttumor"]) + "\n").encode()
    _write_lines(out["vcf"], header, np.concatenate([slots, bg]), lines)
    out["rescue"] = slots[kind == 0] + 1
    out["n_pass"] = int(is_pass.sum())
    return out


def _bedgraph_lines(contig: bytes, start: np.ndarray, n_meth: np.ndarray, n_unmeth: np.ndarray) -> np.ndarray:
    cov = np.maximum(n_meth + n_unmeth, 1)
    pct = (100 * n_meth + cov // 2) // cov
    tab = b"\t"
    return _cat(contig, tab, _text(start), tab, _text(start + 1), tab, _text(pct), tab, _text(n_meth), tab,
                _text(n_unmeth))


def write_methyl_world(d: str, seed: int, length: int = 64_444_167, n_cpg_sites: int = 950_000, n_shards: int = 4,
                       n_chh: int = 1_000_000, n_reads: int = 1_000_000, n_alt_rows: int = 200) -> dict:
    """The methylation world (see the module's docstring); returns its paths
    and the planted M-bias (``bias_5p``, ``bias_3p``: positions trimmed)."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    genome = _genome(rng, length)
    cpg = np.flatnonzero((genome[:-1] == 1) & (genome[1:] == 2))[:n_cpg_sites]
    track = b'track type="bedGraph" description="CpG methylation levels"\n'

    def counts(n: int, level: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        cov = rng.poisson(15, n)
        cov[rng.random(n) < 0.01] = 0  # sites of zero coverage
        meth = rng.binomial(cov, level)
        return meth, cov - meth

    level = np.where(rng.random(len(cpg)) < 0.75, rng.beta(8, 1.5, len(cpg)), rng.beta(1, 10, len(cpg)))
    plus, minus = counts(len(cpg), level), counts(len(cpg), level)
    keep_minus = rng.random(len(cpg)) < 0.97  # a few sites with one strand only
    start = np.concatenate([cpg, cpg[keep_minus] + 1])
    n_meth = np.concatenate([plus[0], minus[0][keep_minus]])
    n_unmeth = np.concatenate([plus[1], minus[1][keep_minus]])
    order = np.argsort(start, kind="stable")
    start, n_meth, n_unmeth = start[order], n_meth[order], n_unmeth[order]
    lines = _bedgraph_lines(CONTIG.encode(), start, n_meth, n_unmeth)
    alt_start = np.sort(rng.choice(100_000, n_alt_rows, replace=False))
    alt_lines = _bedgraph_lines(ALT_CONTIG.encode(), alt_start, *counts(n_alt_rows, np.full(n_alt_rows, 0.7)))
    out = {"cpg": os.path.join(d, "cpg.bedGraph"), "shards": []}
    with open(out["cpg"], "wb") as fh:
        fh.write(track + b"\n".join(lines.tolist()) + b"\n" + b"\n".join(alt_lines.tolist()) + b"\n")
    bounds = np.linspace(0, len(lines), n_shards + 1).astype(np.int64)
    for s in range(n_shards):  # each shard overlaps the next by 50 rows: duplicate sites to sum
        lo, hi = bounds[s], min(bounds[s + 1] + 50, len(lines))
        path = os.path.join(d, f"cpg_shard{s}.bedGraph")
        body = b"\n".join(lines[lo:hi].tolist()) + b"\n"
        if s == n_shards - 1:
            body += b"\n".join(alt_lines.tolist()) + b"\n"
        with open(path, "wb") as fh:
            fh.write(track + body)
        out["shards"].append(path)
    chh = np.sort(rng.choice(length - 1, n_chh, replace=False))
    out["chh"] = os.path.join(d, "chh.bedGraph")
    with open(out["chh"], "wb") as fh:
        fh.write(track + b"\n".join(_bedgraph_lines(CONTIG.encode(), chh,
                                                    *counts(n_chh, np.full(n_chh, 0.02))).tolist()) + b"\n")
    # mbias: 4 strands x 2 reads x 150 positions; the first 8 and last 6 positions biased
    bias_5p, bias_3p = 8, 6
    pos = np.arange(1, 151)
    rows = ["Strand\tRead\tPosition\tnMethylated\tnUnmethylated"]
    for strand in ("OT", "OB", "CTOT", "CTOB"):
        for read in (1, 2):
            total = rng.integers(40_000, 60_000, len(pos))
            frac = np.full(len(pos), 0.75) + rng.normal(0, 0.004, len(pos))
            frac[:bias_5p] = np.linspace(0.3, 0.6, bias_5p)
            frac[-bias_3p:] = np.linspace(0.9, 0.98, bias_3p)
            meth = rng.binomial(total, np.clip(frac, 0, 1))
            rows += [f"{strand}\t{read}\t{p}\t{m}\t{t - m}" for p, m, t in zip(pos, meth, total)]
    out["mbias"] = os.path.join(d, "mbias.txt")
    with open(out["mbias"], "w") as fh:
        fh.write("\n".join(rows) + "\n")
    # perRead: read, chrom, pos, meth_fraction, n_sites
    n_sites = rng.integers(1, 30, n_reads)
    frac = rng.binomial(n_sites, np.where(rng.random(n_reads) < 0.8, 0.85, 0.1)) / n_sites
    names = _cat(b"read", _text(np.arange(n_reads)))
    tab = b"\t"
    per_read = _cat(names, tab, CONTIG.encode(), tab, _text(np.sort(rng.integers(0, length, n_reads))), tab,
                    _fixed(frac, 6), tab, _text(n_sites))
    out["per_read"] = os.path.join(d, "per_read.tsv")
    with open(out["per_read"], "wb") as fh:
        fh.write(b"#read\tchrom\tpos\tmeth_fraction\tn_sites\n" + b"\n".join(per_read.tolist()) + b"\n")
    out.update(bias_5p=bias_5p, bias_3p=bias_3p, n_cpg_rows=len(lines))
    return out
