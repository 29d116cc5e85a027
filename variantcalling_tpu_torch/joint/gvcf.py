"""gVCF block algebra: PL band compression, record merging, overlap cleanup, GQ BEDs.

Counterpart of ``variantcalling_tpu/joint/gvcf.py``, with its outputs
byte for byte:
- :func:`compress_gvcf`: merge sequential reference-band records whose GQ
  stays within a band into one ``<*>`` block, PLs collapsed to 3 values;
- :func:`cleanup_gvcf`: drop uncalled (``./.``) records that overlap a
  called deletion (the GLNexus pre-pass);
- :func:`gvcf_to_bed`: the spans whose GQ passes a threshold, with the
  reference's overlap and extent rules.

Host-side over the table's columns. Sample 0's GT, GQ and DP, INFO END and
the allele counts come from the native scan where the table has it (the
plain parse gives the same values); the other FORMAT keys are read in one
pass over the records' text; only the merge decisions and the deletion
buffers walk records one by one, the latter only where a deletion starts.
"""

from __future__ import annotations

import numpy as np

from variantcalling_tpu_torch.io.vcf import (MISSING, VariantTable, format_qual, number_lists, read_vcf, sample_fields,
                                             write_vcf)
from variantcalling_tpu_torch.ops.genotypes import genotype_ordering
from variantcalling_tpu_torch.utils.stages import stage


_GQ_SENTINEL = np.iinfo(np.int32).min


def compress_pl_to_3(pl: np.ndarray, n_alts: np.ndarray) -> np.ndarray:
    """Collapse padded diploid PLs (n, G_max) to (n, 3) hom-ref band summaries:
    ``[PL(0,0), min over k >= 1 of PL(0,k), min of all other genotypes]``;
    records of one alt pass through unchanged. Bucketed by alt count, one
    masked min a bucket and slot."""
    n = pl.shape[0]
    out = np.zeros((n, 3), dtype=pl.dtype)
    big = np.iinfo(np.int64).max if np.issubdtype(pl.dtype, np.integer) else np.inf
    for a in np.unique(n_alts):
        rows = np.nonzero(n_alts == a)[0]
        order = genotype_ordering(int(a))
        j, k = order[:, 0], order[:, 1]
        slot = np.where((j == 0) & (k == 0), 0, np.where(j == 0, 1, 2))
        block = pl[rows][:, :order.shape[0]]
        for s in range(3):
            m = slot == s
            if m.any():
                out[rows, s] = np.min(np.where(m[None, :], block, big), axis=1)
    return out


def _int_values(raw: list) -> np.ndarray:
    """``int(float(v))`` of each raw FORMAT value; the sentinel where absent or not a number."""
    out = np.full(len(raw), _GQ_SENTINEL, dtype=np.int64)
    for i, r in enumerate(raw):
        if r not in (None, MISSING, ""):
            try:
                out[i] = int(float(r))
            except ValueError:
                pass
    return out


def int_format_field(table: VariantTable, name: str, raw: list | None = None) -> np.ndarray:
    """A scalar integer FORMAT key of sample 0 as int64, :data:`_GQ_SENTINEL`
    where absent: GQ and DP from the native scan where the table has it,
    else parsed from ``raw`` (or the table's text)."""
    if table.aux is not None and name in ("GQ", "DP"):
        vals = table.aux.gq if name == "GQ" else table.aux.dp_fmt
        out = np.full(len(table), _GQ_SENTINEL, dtype=np.int64)
        ok = ~np.isnan(vals)
        out[ok] = vals[ok].astype(np.int64)
        return out
    return _int_values(table.format_field(name) if raw is None else raw)


def _filter_flags(table: VariantTable, names: tuple[str, ...]) -> list[np.ndarray]:
    """For each of ``names``, whether it is among a record's FILTER values."""
    codes, uniques = table.factorize("filters")
    return [np.asarray([f not in (MISSING, "") and name in f.split(";") for f in uniques], dtype=bool)[codes]
            if uniques else np.zeros(len(table), dtype=bool) for name in names]


def _ref_len(table: VariantTable) -> np.ndarray:
    if table.aux is not None:
        return table.aux.alle["ref_len"].astype(np.int64)
    return np.fromiter((len(r) for r in table.ref), dtype=np.int64, count=len(table))


def compress_gvcf_table(table: VariantTable, refcall_gq_threshold: int = 22,
                        merge_gq_threshold: int = 10) -> tuple[list[str], int, int]:
    """Merge sequential gVCF records within a GQ band; (output lines, records
    in, records out).

    A record starts a new group (flushing the previous one) when it or the
    previous record is PASS or RefCall with GQ <= ``refcall_gq_threshold``
    (these are kept verbatim), the chromosome changes, or its GQ lies
    ``merge_gq_threshold`` or more from the group's running min or max.
    A group of one is written verbatim; a merged group as one ``<*>`` block:
    the first record's position and first reference base, the last one's
    END, GT 0/0, the group's min GQ, its MIN_DP (min of MIN_DP, else DP) and
    the elementwise min of the 3-value PLs."""
    n = len(table)
    if table.n_samples != 1:
        raise ValueError("gVCF compression expects a single-sample file")
    fmt, cols = table.format_columns()
    fmts, samples = fmt.tolist(), cols[:, 0].tolist()
    raw = sample_fields(fmts, samples, ("MIN_DP", "PL") if table.aux is not None else ("MIN_DP", "PL", "GQ", "DP"))
    gq = int_format_field(table, "GQ", raw.get("GQ"))
    min_dp = _int_values(raw["MIN_DP"])
    dp = int_format_field(table, "DP", raw.get("DP"))
    n_alts = np.maximum(table.n_alts(), 1)
    g_max = int(np.max((n_alts + 1) * (n_alts + 2) // 2)) if n else 3
    pl3 = compress_pl_to_3(number_lists(raw["PL"], g_max, np.inf), n_alts).astype(np.int64)

    is_pass, is_refcall = _filter_flags(table, ("PASS", "RefCall"))
    keep = is_pass | (is_refcall & (gq != _GQ_SENTINEL) & (gq <= refcall_gq_threshold))
    end = table.info_field("END", dtype=np.int64, missing=-1)
    end = np.where(end >= 0, end, table.pos + _ref_len(table) - 1)

    # the groups: a Python walk over plain lists (each record's running GQ band and MIN_DP)
    gq_l, min_dp_l, dp_l = gq.tolist(), min_dp.tolist(), dp.tolist()
    hard = np.ones(n, dtype=bool)
    hard[1:] = keep[1:] | keep[:-1] | (table.chrom[1:] != table.chrom[:-1])
    starts: list[int] = []
    grp_dps: list[int] = []
    grp_gqs: list[int] = []
    if n:
        starts.append(0)
        grp_min_gq = grp_max_gq = gq_l[0]
        grp_dp = min_dp_l[0] if min_dp_l[0] != _GQ_SENTINEL else dp_l[0]
    for i, new in enumerate(hard.tolist()):
        if i == 0:
            continue
        gqi = gq_l[i] if gq_l[i] != _GQ_SENTINEL else 0
        if new or gqi - grp_min_gq >= merge_gq_threshold or grp_max_gq - gqi >= merge_gq_threshold:
            grp_gqs.append(grp_min_gq)
            grp_dps.append(grp_dp)
            starts.append(i)
            grp_min_gq = grp_max_gq = gqi
            grp_dp = min_dp_l[i] if min_dp_l[i] != _GQ_SENTINEL else dp_l[i] if dp_l[i] != _GQ_SENTINEL else 0
        else:
            if gqi < grp_min_gq:
                grp_min_gq = gqi
            elif gqi > grp_max_gq:
                grp_max_gq = gqi
            cand = min_dp_l[i] if min_dp_l[i] != _GQ_SENTINEL else dp_l[i]
            if cand != _GQ_SENTINEL:
                grp_dp = min(grp_dp, cand) if grp_dp else cand
    if n:
        grp_gqs.append(grp_min_gq)
        grp_dps.append(grp_dp)

    lo = np.asarray(starts, dtype=np.int64)
    hi = np.append(lo[1:], n) - 1
    grp_pl = np.minimum.reduceat(pl3, lo, axis=0) if n else np.zeros((0, 3), dtype=np.int64)
    single = lo == hi
    out_lines = np.empty(len(lo), dtype=object)
    # a group of one: the record as read (QUAL as %g), FORMAT and sample 0 (its columns read for these rows only)
    one = lo[single]
    sub = table.subset(one)
    quals = _format_qual_rows(table.qual[one])
    out_lines[single] = [
        "\t".join((c, str(p), v, r, a, q, f, inf, fmts[i], samples[i]))
        for c, p, v, r, a, q, f, inf, i in zip(sub.chrom.tolist(), sub.pos.tolist(), sub.vid, sub.ref, sub.alt, quals,
                                                 sub.filters, sub.info, one.tolist())]
    merged = np.flatnonzero(~single)
    first = table.subset(lo[merged])
    end_hi = end[hi[merged]].tolist()
    out_lines[merged] = [
        f"{c}\t{p}\t.\t{r[0]}\t<*>\t0\t.\tEND={e}\tGT:GQ:MIN_DP:PL\t0/0:{g}:{d}:{pl[0]},{pl[1]},{pl[2]}"
        for c, p, r, e, g, d, pl in zip(first.chrom.tolist(), first.pos.tolist(), first.ref, end_hi,
                                        [grp_gqs[k] for k in merged.tolist()], [grp_dps[k] for k in merged.tolist()],
                                        grp_pl[merged].tolist())]
    return out_lines.tolist(), n, len(out_lines)


def _format_qual_rows(qual: np.ndarray) -> list[str]:
    return [format_qual(q) for q in np.asarray(qual, dtype=np.float64).tolist()]


def compress_gvcf(input_path: str, output_path: str, refcall_gq_threshold: int = 22,
                  merge_gq_threshold: int = 10) -> tuple[int, int]:
    with stage("ingest"):
        table = read_vcf(input_path)
    with stage("compress"):
        lines, n_in, n_out = compress_gvcf_table(table, refcall_gq_threshold, merge_gq_threshold)
    with stage("writeback"):
        write_lines(output_path, table, lines)
    return n_in, n_out


def write_lines(path: str, table: VariantTable, lines: list[str]) -> None:
    """The table's header and ``lines`` (``.gz``: BGZF, no index)."""
    if str(path).endswith(".gz"):
        from variantcalling_tpu_torch.io.bgzf import BgzfWriter

        out = BgzfWriter(path)
    else:
        out = open(path, "wb")
    with out:
        out.write(("\n".join([*table.header.lines, table.header.column_header(), *lines]) + "\n").encode())


def cleanup_gvcf_table(table: VariantTable) -> tuple[np.ndarray, int, int]:
    """(keep mask, records written, records removed): a buffer opens at each
    record with a deletion (REF longer than a non-symbolic ALT) and takes
    every following record on its chromosome that starts within the span
    of the deletions in it; where any record of a buffer has a called
    non-reference GT, its uncalled (``./.``) records are dropped."""
    n = len(table)
    gts = table.genotypes()
    uncalled = gts[:, 0] == -1
    called_alt = (gts[:, 0] > 0) | (gts[:, 1] > 0)
    ref_len = _ref_len(table)
    max_del = np.zeros(n, dtype=np.int64)
    long_ref = np.flatnonzero(ref_len > 1)  # only a REF of 2+ bases can be deleted from
    for i, a in zip(long_ref.tolist(), table.subset(long_ref).alt):
        if a in (MISSING, ""):
            continue
        best = max((int(ref_len[i]) - len(x) for x in a.split(",") if not x.startswith("<")), default=0)
        max_del[i] = max(best, 0)

    keep = np.ones(n, dtype=bool)
    chrom, pos, dels = table.chrom.tolist(), table.pos.tolist(), max_del.tolist()
    starts = np.nonzero(max_del > 0)[0].tolist()
    k, i = 0, 0
    while k < len(starts):
        s = starts[k]
        if s < i:
            k += 1
            continue
        span, j = pos[s] + dels[s], s + 1
        while j < n and chrom[j] == chrom[s] and pos[j] <= span:
            if dels[j] > 0:
                span = max(span, pos[j] + dels[j])
            j += 1
        if called_alt[s:j].any():
            keep[s:j] &= ~uncalled[s:j]
        i = j
        k += 1
    n_written = int(keep.sum())
    return keep, n_written, n - n_written


def cleanup_gvcf(input_path: str, output_path: str) -> tuple[int, int]:
    with stage("ingest"):
        table = read_vcf(input_path)
    with stage("cleanup"):
        keep, n_written, n_removed = cleanup_gvcf_table(table)
    with stage("writeback"):
        write_vcf(output_path, table.subset(keep), verbatim_core=True, qual_as_read=False)
    return n_written, n_removed


def gvcf_to_bed(gvcf_file: str, bed_file: str, gq_threshold: int = 20, gt: bool = True) -> int:
    """Write a BED of the gVCF's spans with GQ >= ``gq_threshold`` (below it,
    or without GQ, when ``gt`` is False); returns the records skipped.

    Reference-block deletions (REF of 2+ bases, hom-ref, uncalled or
    without GQ) cover only their first base; a record that starts before
    the extent of the records kept so far on its chromosome is skipped."""
    with stage("ingest"):
        table = read_vcf(gvcf_file)
    with stage("bed"):
        return _bed_of(table, bed_file, gq_threshold, gt)


def _bed_of(table: VariantTable, bed_file: str, gq_threshold: int, gt: bool) -> int:
    from variantcalling_tpu_torch.io.bed import BedWriter

    gq = int_format_field(table, "GQ")
    gts = table.genotypes()
    ref_len = _ref_len(table)
    end_info = table.info_field("END", dtype=np.int64, missing=-1)
    start = table.pos - 1
    stop = np.where(end_info >= 0, end_info, table.pos + ref_len - 1)
    hom_ref = (gts[:, 0] == 0) & (gts[:, 1] == 0)
    no_gq = gq == _GQ_SENTINEL
    refblock_del = (ref_len > 1) & (no_gq | hom_ref | (gts[:, 0] == -1))
    end = np.where(refblock_del, start + 1, stop)
    take = ~no_gq & (gq >= gq_threshold) if gt else no_gq | (gq < gq_threshold)

    skipped = 0
    extent = -1
    last_chrom = ""
    with BedWriter(bed_file) as bed:
        for chrom, s, e, w in zip(table.chrom.tolist(), start.tolist(), end.tolist(), take.tolist()):
            if chrom == last_chrom and s < extent:
                skipped += 1
                continue
            if chrom != last_chrom or extent < e:
                last_chrom = chrom
                extent = e
            if w:
                bed.write(chrom, s, e)
    return skipped
