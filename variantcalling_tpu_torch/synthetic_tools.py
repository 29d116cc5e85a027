"""Seeded worlds of the host-only tools (the SV pair, the uBAM tools and the small file tools).

Each writer makes its files from one ``numpy`` seed and returns their paths
and what it planted, so that a run's outputs can be held to the plant:

- :func:`write_sv_world`: an SV callset (DEL, INS, DUP, INV, CTX and BND
  records, SVLEN log-uniform from 50 bp to 2 Mbp, a share not PASS and a
  share without SVLEN) and a concordance h5 (``base`` and ``calls`` frames
  of ``svlen_int``, ``svtype``, ``label`` and ``qual``, a share of QUAL
  missing), written by the port's ``write_hdf``;
- :func:`write_read_world`: a uBAM of reads of one length with ``as``/``ae``
  strand tags drawn from the ppmSeq categories (a share missing), a 5'
  adapter and UMI planted in a share of them (some truncated at the read
  start) and a 3' adapter in another share, at error rates within the
  tools' budgets;
- :func:`write_ml_world`: a uBAM and a (reads, flows, classes) float32
  probability tensor (``.npy``, or raw ``.bin``) with its regressed key;
- :func:`write_hpol_bed`: a BED of intervals over a FASTA's contig;
- :func:`write_dup_vcf`: a VCF with planted duplicate records (same CHROM,
  POS, REF and ALT) placed right after their originals;
- :func:`write_empty_files`: files of which a share is empty;
- :func:`bgzip_indexed`: a VCF bgzipped with its ``.tbi``.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from variantcalling_tpu_torch.utils.h5_utils import Frame, write_frames

#: phase 19's SV world: a callset of 25,000 records, a concordance h5 of 20,000 base and 25,000 call rows
SV_WORLD = dict(seed=2047, n_records=25_000, n_base=20_000, n_calls=25_000)
#: the world of the committed JAX-written SV pickle (``tests/torch_data/sv_stats_reference.pkl``)
SV_REFERENCE_WORLD = dict(seed=2048, n_records=2_000, n_base=1_600, n_calls=2_000)
#: phase 19's read world: 500,000 reads of 200 bp
READ_WORLD = dict(seed=2049, n_reads=500_000, read_len=200)
#: phase 19's ML tag world: 20,000 reads, 380 flows, 21 classes (a 638 MB tensor)
ML_WORLD = dict(seed=2050, n_reads=20_000, n_flows=380, n_classes=21)

SV_TYPES = ("DEL", "INS", "DUP", "INV", "CTX", "BND")
SV_TYPE_SHARES = (0.45, 0.3, 0.1, 0.07, 0.04, 0.04)
PPMSEQ_CATEGORIES = ("MIXED", "MINUS", "PLUS", "UNDETERMINED", "END_UNREACHED")
#: the 5' and 3' adapters planted by :func:`write_read_world`
LEFT_ADAPTER = "CTACACGACGCTCTTCCGATCT"
RIGHT_ADAPTER = "AGATCGGAAGAGCACACGTCTG"
LEFT_UMI = 8
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_NIB = np.zeros(256, np.uint8)
for _c, _v in zip(b"=ACMGRSVTWYHKDBN", range(16)):
    _NIB[_c] = _v


# -- the SV pair -----------------------------------------------------------------------------------------------


def _svlens(rng: np.random.Generator, n: int) -> np.ndarray:
    """Lengths log-uniform from 50 bp to 2 Mbp (int64)."""
    return np.floor(np.exp(rng.uniform(np.log(50), np.log(2_000_000), n))).astype(np.int64)


def write_sv_world(d: str, seed: int, n_records: int = 25_000, n_base: int = 20_000, n_calls: int = 25_000,
                   contig: str = "chr1", length: int = 248_956_422) -> dict:
    """Write ``sv.vcf`` and ``concordance.h5`` under ``d``.

    The callset: types drawn by :data:`SV_TYPE_SHARES`, SVLEN log-uniform
    from 50 bp to 2 Mbp (negative for DEL), 10 % of the records LowQual and
    5 % without SVLEN, at distinct sorted positions. The concordance h5:
    ``base`` (TP or FN) and ``calls`` (TP or FP) frames of ``svlen_int``
    (int64), ``svtype``, ``label`` and ``qual`` (float64, 1 % NaN).
    Returns the paths and the planted columns (``svtype``, ``svlen``: NaN
    where absent, ``pass``)."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    types = np.array(SV_TYPES, dtype=object)[rng.choice(len(SV_TYPES), n_records, p=SV_TYPE_SHARES)]
    lens = _svlens(rng, n_records)
    signed = np.where(types == "DEL", -lens, lens)
    has_len = rng.random(n_records) >= 0.05
    passing = rng.random(n_records) >= 0.10
    pos = np.sort(rng.choice(length - 3_000_000, n_records, replace=False) + 1)
    qual = rng.integers(1, 1000, n_records)
    alt = np.array([f"<{t}>" if t != "BND" else f"N[{contig}:{p + 1000}[" for t, p in zip(types.tolist(),
                                                                                          pos.tolist())])
    lines = []
    for i in range(n_records):
        info = (f"SVLEN={signed[i]};" if has_len[i] else "") + f"SVTYPE={types[i]}"
        filt = "PASS" if passing[i] else "LowQual"
        lines.append(f"{contig}\t{pos[i]}\tsv{i}\tN\t{alt[i]}\t{qual[i]}\t{filt}\t{info}")
    header = [
        "##fileformat=VCFv4.2",
        '##FILTER=<ID=LowQual,Description="Low quality">',
        '##INFO=<ID=SVLEN,Number=.,Type=Integer,Description="Difference in length between REF and ALT alleles">',
        '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">',
        f"##contig=<ID={contig},length={length}>",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO",
    ]
    vcf = os.path.join(d, "sv.vcf")
    with open(vcf, "w") as fh:
        fh.write("\n".join(header + lines) + "\n")

    def frame(n: int, labels: tuple[str, str], share: float) -> Frame:
        t = np.array(SV_TYPES[:5], dtype=object)[rng.choice(5, n, p=(0.45, 0.3, 0.1, 0.1, 0.05))]
        q = rng.uniform(0, 100, n)
        q[rng.random(n) < 0.01] = np.nan
        lab = np.where(rng.random(n) < share, labels[0], labels[1]).astype(object)
        return Frame({"svlen_int": np.where(t == "DEL", -1, 1) * _svlens(rng, n), "svtype": t, "label": lab,
                      "qual": q})

    h5 = os.path.join(d, "concordance.h5")
    write_frames(h5, {"base": frame(n_base, ("TP", "FN"), 0.8), "calls": frame(n_calls, ("TP", "FP"), 0.75)})
    return {"vcf": vcf, "concordance_h5": h5, "svtype": types, "svlen": np.where(has_len, signed, np.nan),
            "pass": passing}


# -- uBAMs ---------------------------------------------------------------------------------------------------------


def _ubam_header(read_group: str = "rg1") -> bytes:
    text = f"@HD\tVN:1.6\tSO:unknown\n@RG\tID:{read_group}\tSM:sample\n".encode()
    return b"BAM\x01" + struct.pack("<i", len(text)) + text + struct.pack("<i", 0)


def ubam_records(seq: np.ndarray, prefix: str, aux: list[bytes]) -> np.ndarray:
    """Unmapped BAM records (flag 4, no CIGAR) of ``seq`` ((reads, length)
    ASCII letters) named ``prefix`` and the read's number (zero-padded to one
    width), with qualities of 30 and the auxiliary bytes ``aux``: the fixed
    part of every record built as one matrix, the fields appended by
    ``io/bam.append_to_records``."""
    n, lr = seq.shape
    width = len(str(max(n - 1, 0)))
    names = np.char.add(prefix, np.char.zfill(np.arange(n).astype(str), width)).astype("S")
    name_len = names.dtype.itemsize + 1
    nib = _NIB[seq]
    if lr % 2:
        nib = np.concatenate([nib, np.zeros((n, 1), np.uint8)], axis=1)
    packed = (nib[:, 0::2] << 4) | nib[:, 1::2]
    head = np.zeros(n, dtype=np.dtype([("block_size", "<i4"), ("ref", "<i4"), ("pos", "<i4"), ("l_name", "u1"),
                                       ("mapq", "u1"), ("bin", "<u2"), ("n_cigar", "<u2"), ("flag", "<u2"),
                                       ("l_seq", "<i4"), ("next_ref", "<i4"), ("next_pos", "<i4"),
                                       ("tlen", "<i4")]))
    fixed = 36 + name_len + packed.shape[1] + lr
    head["block_size"] = fixed - 4
    head["ref"] = head["pos"] = head["next_ref"] = head["next_pos"] = -1
    head["l_name"], head["bin"], head["flag"], head["l_seq"] = name_len, 4680, 4, lr
    rows = np.concatenate([head.view(np.uint8).reshape(n, 36), names.view(np.uint8).reshape(n, -1),
                           np.zeros((n, 1), np.uint8), packed, np.full((n, lr), 30, np.uint8)], axis=1)
    from variantcalling_tpu_torch.io.bam import append_to_records

    aux_len = np.fromiter(map(len, aux), dtype=np.int64, count=n)
    return append_to_records(rows.reshape(-1), 0, np.arange(n, dtype=np.int64) * fixed,
                             np.full(n, fixed - 4, dtype=np.int64), np.frombuffer(b"".join(aux), np.uint8), aux_len)


def _write_bgzf(path: str, *parts) -> None:
    from variantcalling_tpu_torch.io.bgzf import BgzfWriter

    with BgzfWriter(path, level=1) as out:
        for data in parts:
            out.write(data)


def _plant(rng: np.random.Generator, seq: np.ndarray, rows: np.ndarray, at: np.ndarray, adapter: bytes,
           skip: np.ndarray, rate: float) -> np.ndarray:
    """Write ``adapter[skip[i]:]`` into ``seq[rows[i]]`` from column ``at[i]``
    (cut at the read's end), with ``int(rate * len)`` of its letters replaced by
    another base at drawn places; returns each planted length."""
    lr = seq.shape[1]
    la = len(adapter)
    src = np.arange(la)[None, :] + skip[:, None]  # adapter index of each planted column
    length = np.minimum(la - skip, lr - at)
    valid = np.arange(la)[None, :] < length[:, None]
    letters = np.frombuffer(adapter, np.uint8)[np.minimum(src, la - 1)]
    keys = np.where(valid, rng.random(valid.shape), np.inf)
    rank = np.argsort(np.argsort(keys, axis=1), axis=1)
    flip = rank < (rate * length).astype(np.int64)[:, None]
    code = np.searchsorted(_BASES, letters)
    letters = np.where(flip, _BASES[(code + rng.integers(1, 4, letters.shape)) % 4], letters)
    cols = at[:, None] + np.arange(la)[None, :]
    r = np.broadcast_to(rows[:, None], cols.shape)
    seq[r[valid], cols[valid]] = letters[valid]
    return length


def write_read_world(d: str, seed: int, n_reads: int = 500_000, read_len: int = 200,
                     left_share: float = 0.7, right_share: float = 0.6, truncated_share: float = 0.1,
                     missing_tag_share: float = 0.01) -> dict:
    """Write ``reads.bam`` under ``d``: reads of ``read_len`` random bases
    named ``r<i>``, with ``as``/``ae`` Z tags drawn from the ppmSeq
    categories (about 40 % MIXED/MIXED, ``missing_tag_share`` of each tag
    absent), :data:`LEFT_ADAPTER` and an 8-base UMI planted at the start of
    ``left_share`` of them (``truncated_share`` of those losing 1-12 leading
    adapter bases), and :data:`RIGHT_ADAPTER` planted at a random point of
    the read's second half in ``right_share`` (running off the read's end
    where it does not fit). Each planted adapter has ``int(0.1 * len)``
    substitutions, within the tools' default budgets of 0.15 and 0.2.

    Returns the path and the plant: each read's start and end category
    (:data:`PPMSEQ_CATEGORIES` index, 5 = absent), the 5' adapter's end
    (the 0-based index after it, 0 where none) and whether it was
    truncated, the UMI's letters, and the 3' adapter's start (-1 where none)
    and planted length."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    seq = _BASES[rng.integers(0, 4, (n_reads, read_len), dtype=np.uint8)]
    has_left = rng.random(n_reads) < left_share
    cut = np.where(has_left & (rng.random(n_reads) < truncated_share), rng.integers(1, 13, n_reads), 0)
    has_right = rng.random(n_reads) < right_share
    right_at = np.where(has_right, rng.integers(read_len // 2, read_len - 5, n_reads), -1)
    rows = np.flatnonzero(has_left)
    left_end = np.zeros(n_reads, np.int64)
    left_end[rows] = _plant(rng, seq, rows, np.zeros(len(rows), np.int64), LEFT_ADAPTER.encode(), cut[rows], 0.1)
    umis = np.zeros((n_reads, LEFT_UMI), np.uint8)
    umis[rows] = seq[rows[:, None], left_end[rows][:, None] + np.arange(LEFT_UMI)]
    rows = np.flatnonzero(has_right)
    right_len = np.zeros(n_reads, np.int64)
    right_len[rows] = _plant(rng, seq, rows, right_at[rows], RIGHT_ADAPTER.encode(), np.zeros(len(rows), np.int64),
                             0.1)
    # categories: MIXED/MIXED about 40 %, the rest spread over the five
    mixed = rng.random(n_reads) < 0.4
    cat_s = np.where(mixed, 0, rng.integers(0, 5, n_reads))
    cat_e = np.where(mixed, 0, rng.integers(0, 5, n_reads))
    cat_s[rng.random(n_reads) < missing_tag_share] = 5
    cat_e[rng.random(n_reads) < missing_tag_share] = 5
    tag_s = [f"asZ{c}\x00".encode() for c in PPMSEQ_CATEGORIES] + [b""]
    tag_e = [f"aeZ{c}\x00".encode() for c in PPMSEQ_CATEGORIES] + [b""]
    combos = [tag_s[a] + tag_e[b] for a in range(6) for b in range(6)]
    aux = [combos[c] for c in (cat_s * 6 + cat_e).tolist()]
    path = os.path.join(d, "reads.bam")
    _write_bgzf(path, _ubam_header(), ubam_records(seq, "r", aux))
    return {"bam": path, "cat_start": cat_s, "cat_end": cat_e, "left_end": left_end, "truncated": cut > 0,
            "umi": umis, "right_start": right_at, "right_len": right_len}


def write_ml_world(d: str, seed: int, n_reads: int = 20_000, n_flows: int = 380, n_classes: int = 21,
                   bin_tensor: bool = False) -> dict:
    """Write ``reads.bam`` (``n_reads`` reads of 150 bases), the float32
    probability tensor (reads, flows, classes) as ``probs.npy`` (or raw
    ``probs.bin``) and a regressed key ``key.npy`` (``key.bin``). Each
    flow's probabilities peak at a drawn class (0.9), its two neighbours
    hold 0.01-0.05, and the rest small values of which a few pass the
    tools' 0.003 threshold; every 37th flow ties classes 0 and 1 exactly
    (argmax takes the lower), and a share of the cells are 0."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    seq = _BASES[rng.integers(0, 4, (n_reads, 150), dtype=np.uint8)]
    path = os.path.join(d, "reads.bam")
    _write_bgzf(path, _ubam_header(), ubam_records(seq, "m", [b"RGZrg1\x00"] * n_reads))
    ext = "bin" if bin_tensor else "npy"
    probs_path, key_path = os.path.join(d, f"probs.{ext}"), os.path.join(d, f"key.{ext}")
    key = np.zeros((n_reads, n_flows), np.float32)
    shape = (n_reads, n_flows, n_classes)
    mm = np.memmap(probs_path, dtype=np.float32, mode="w+", shape=shape) if bin_tensor else \
        np.lib.format.open_memmap(probs_path, mode="w+", dtype=np.float32, shape=shape)
    for lo in range(0, n_reads, 1_000):
        hi = min(lo + 1_000, n_reads)
        called = np.minimum(rng.geometric(0.5, (hi - lo, n_flows)) - 1, n_classes - 1)
        p = rng.random((hi - lo, n_flows, n_classes), dtype=np.float32)
        p *= p
        p *= p
        p *= np.float32(0.004)
        p[p < np.float32(0.0004)] = 0
        for side in (-1, 1):
            near = np.clip(called + side, 0, n_classes - 1)
            np.put_along_axis(p, near[..., None], rng.uniform(0.01, 0.05, near.shape + (1,)).astype(np.float32),
                              axis=2)
        np.put_along_axis(p, called[..., None], np.float32(0.9), axis=2)
        p[:, ::37, 1] = p[:, ::37, 0]  # exact ties: argmax takes the lower class
        mm[lo:hi] = p
        key[lo:hi] = called + rng.normal(0, 0.3, called.shape).astype(np.float32)
    mm.flush()
    del mm
    if bin_tensor:
        key.tofile(key_path)
    else:
        np.save(key_path, key)
    return {"bam": path, "probs": probs_path, "key": key_path, "shape": shape}


# -- the small file tools ------------------------------------------------------------------------------------------


def write_hpol_bed(path: str, seed: int, contig: str, length: int, n_intervals: int = 2_000,
                   total_bp: int = 20_000_000) -> str:
    """A BED of ``n_intervals`` distinct sorted intervals of about ``total_bp`` in all on ``contig``."""
    rng = np.random.default_rng(seed)
    size = max(total_bp // n_intervals, 1)
    slots = length // size
    starts = np.sort(rng.choice(slots, n_intervals, replace=False)) * size
    ends = starts + rng.integers(size // 2, size + 1, n_intervals)
    with open(path, "w") as fh:
        fh.write("".join(f"{contig}\t{s}\t{min(e, length)}\n" for s, e in zip(starts.tolist(), ends.tolist())))
    return path


def write_region_beds(d: str, seed: int, contig: str, length: int, n: int = 3, n_intervals: int = 5_000) -> list[str]:
    """``n`` BEDs of ``n_intervals`` random intervals (1-20 kbp, overlapping, unsorted) on ``contig``."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for k in range(n):
        starts = rng.integers(0, length - 20_000, n_intervals)
        ends = starts + rng.integers(1_000, 20_000, n_intervals)
        path = os.path.join(d, f"regions{k}.bed")
        with open(path, "w") as fh:
            fh.write("".join(f"{contig}\t{s}\t{e}\n" for s, e in zip(starts.tolist(), ends.tolist())))
        paths.append(path)
    return paths


def write_dup_vcf(path: str, vcf: str, seed: int, n_dups: int) -> dict:
    """``vcf``'s records with ``n_dups`` planted duplicates (same CHROM, POS,
    REF and ALT, another QUAL and ID) each written right after its original.
    Returns the path and the original record lines."""
    rng = np.random.default_rng(seed)
    with open(vcf, "rb") as fh:
        lines = fh.read().split(b"\n")
    head = [ln for ln in lines if ln.startswith(b"#")]
    body = [ln for ln in lines if ln and not ln.startswith(b"#")]
    picks = set(rng.choice(len(body), n_dups, replace=False).tolist())
    out = []
    for i, ln in enumerate(body):
        out.append(ln)
        if i in picks:
            f = ln.split(b"\t")
            f[2], f[5] = b"dup%d" % i, b"%d" % (i % 97)
            out.append(b"\t".join(f))
    with open(path, "wb") as fh:
        fh.write(b"\n".join(head + out) + b"\n")
    return {"vcf": path, "records": body, "n_dups": n_dups}


def bgzip_indexed(vcf: str, out: str) -> str:
    """``vcf`` BGZF-compressed to ``out`` with its ``.tbi``."""
    from variantcalling_tpu_torch.io.bgzf import BgzfWriter
    from variantcalling_tpu_torch.io.tabix import build_tabix_index

    with BgzfWriter(out) as dst:
        with open(vcf, "rb") as src:
            dst.write(src.read())
    build_tabix_index(out)
    return out


def write_empty_files(d: str, seed: int, n: int = 100, n_empty: int = 30) -> dict:
    """``n`` files under ``d``, ``n_empty`` of them empty (drawn), the rest of 1-100 bytes."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    empty = set(rng.choice(n, n_empty, replace=False).tolist())
    paths = []
    for i in range(n):
        p = os.path.join(d, f"f{i:03d}.txt")
        with open(p, "wb") as fh:
            fh.write(b"" if i in empty else b"x" * int(rng.integers(1, 101)))
        paths.append(p)
    return {"paths": paths, "empty": sorted(paths[i] for i in empty)}
