"""In-process stage chain of ``correct_genotypes_by_imputation --input_vcf``.

Counterpart of ``variantcalling_tpu/pipelines/imputation_stages.py``, which
stands in for the reference's per-chromosome bcftools and beagle shell
stages: subset -> high-GQ filter -> beagle -> collapse -> annotate. Every
bcftools stage is a columnar operation on a
:class:`~variantcalling_tpu_torch.io.vcf.VariantTable`; beagle (a Java
imputer) stays the one external process, run with the reference's
arguments and bounded by ``VCTPU_SUBPROC_TIMEOUT_S``. Each stage file is
written as the reference writes it (QUAL as ``%g`` of its value).
"""

from __future__ import annotations

import gzip
import logging
import os
import shutil
import subprocess

import numpy as np

from variantcalling_tpu_torch.io.vcf import VariantTable, join_tails, read_vcf, write_vcf

log = logging.getLogger(__name__)


def subset_vcf(input_vcf: str | VariantTable, chrom: str, out_path: str) -> VariantTable:
    """``bcftools view <vcf> <chrom>``: the records of one chromosome (a
    parsed table is taken as it is, so a chain over several chromosomes
    parses its input once)."""
    table = input_vcf if isinstance(input_vcf, VariantTable) else read_vcf(input_vcf)
    sub = table.subset(np.asarray(table.chrom) == chrom)
    write_vcf(out_path, sub, verbatim_core=True, qual_as_read=False)
    return sub


def filter_high_gq(table: VariantTable, out_path: str, min_qual: float = 20.0, min_gq: float = 20.0) -> None:
    """``bcftools view -f PASS | filter -i 'QUAL>20 && FORMAT/GQ[0]>20'``."""
    is_pass = np.array([f in ("PASS", ".", "") for f in table.filters], dtype=bool)
    qual_ok = np.nan_to_num(table.qual, nan=-1.0) > min_qual
    gq = table.format_numeric("GQ", max_len=1, missing=np.nan)[:, 0]
    gq_ok = np.nan_to_num(gq, nan=-1.0) > min_gq
    write_vcf(out_path, table.subset(is_pass & qual_ok & gq_ok), verbatim_core=True, qual_as_read=False)


def run_beagle(high_gq_vcf: str, cohort_vcf: str, plink_map: str, out_vcf: str, nthreads: int = 1,
               beagle_cmd: str = "beagle") -> None:
    """``beagle gt=<vcf> ref=<cohort> map=<plink> out=<prefix>``, bounded by
    ``VCTPU_SUBPROC_TIMEOUT_S``; a missing executable, a failure or a
    timeout raises ``RuntimeError`` with beagle's last output."""
    if shutil.which(beagle_cmd.split()[0]) is None:
        raise RuntimeError(
            f"beagle executable {beagle_cmd!r} not found on PATH — the imputation "
            "stage chain requires beagle 5.x (reference setup/environment.yml); "
            "alternatively run this tool with --beagle_annotated_vcf on a "
            "pre-annotated VCF")
    prefix = out_vcf[:-7] if out_vcf.endswith(".vcf.gz") else out_vcf
    cmd = beagle_cmd.split() + [f"gt={high_gq_vcf}", f"ref={cohort_vcf}", f"map={plink_map}", f"out={prefix}",
                                f"nthreads={nthreads}", "window=100"]
    from variantcalling_tpu_torch import knobs

    timeout_s = knobs.get_int("VCTPU_SUBPROC_TIMEOUT_S")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        err = e.stderr or ""
        tail = (err.decode(errors="replace") if isinstance(err, (bytes, bytearray)) else err)[-800:]
        raise RuntimeError(f"beagle timed out after {timeout_s}s (VCTPU_SUBPROC_TIMEOUT_S): {tail}") from e
    if proc.returncode != 0 or not os.path.exists(prefix + ".vcf.gz"):
        raise RuntimeError(f"beagle failed rc={proc.returncode}: {proc.stderr[-800:]}")


def collapse_beagle(beagle_vcf: str, out_path: str) -> dict:
    """``bcftools view -i 'GT="alt"' | grep -v END | norm -m +``: alt-called
    records without END, the biallelic records of one (chrom, pos, ref)
    joined into one multiallelic record with per-allele FORMAT/DS; written
    to ``out_path`` (the reference's stage file) and returned as columns."""
    t = read_vcf(beagle_vcf)
    has_alt = (t.genotypes() > 0).any(axis=1)
    has_end = np.array(["END" in (s or "") for s in t.info], dtype=bool)
    t = t.subset(has_alt & ~has_end)

    key_order: list[tuple] = []
    groups: dict[tuple, list[int]] = {}
    for i, k in enumerate(zip(t.chrom.tolist(), t.pos.tolist(), list(t.ref))):
        if k not in groups:
            groups[k] = []
            key_order.append(k)
        groups[k].append(i)

    ds = t.format_numeric("DS", max_len=1, missing=np.nan)[:, 0]
    dr2 = t.info_field("DR2")
    rows: dict[str, list] = {"chrom": [], "pos": [], "ref": [], "alts": [], "ds": [], "dr2": [], "imp": []}
    for k in key_order:
        idxs = groups[k]
        alts, dvals = [], []
        for i in idxs:
            for a in t.alt[i].split(","):
                if a not in (".", ""):
                    alts.append(a)
                    dvals.append(float(ds[i]) if not np.isnan(ds[i]) else np.nan)
        if not alts:
            continue
        rows["chrom"].append(k[0])
        rows["pos"].append(k[1])
        rows["ref"].append(k[2])
        rows["alts"].append(alts)
        rows["ds"].append(dvals)
        rows["dr2"].append(float(np.nanmax([dr2[i] for i in idxs])) if len(idxs) else np.nan)
        rows["imp"].append(any("IMP" in (t.info[i] or "") for i in idxs))

    opener = (lambda p: gzip.open(p, "wt")) if out_path.endswith(".gz") else (lambda p: open(p, "w"))
    with opener(out_path) as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write('##INFO=<ID=DR2,Number=1,Type=Float,Description="Dosage R2">\n')
        fh.write('##INFO=<ID=IMP,Number=0,Type=Flag,Description="Imputed">\n')
        fh.write('##FORMAT=<ID=DS,Number=A,Type=Float,Description="Dosage">\n')
        for c in dict.fromkeys(rows["chrom"]):
            fh.write(f"##contig=<ID={c}>\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
        for i in range(len(rows["pos"])):
            info = []
            if rows["imp"][i]:
                info.append("IMP")
            if not np.isnan(rows["dr2"][i]):
                info.append(f"DR2={rows['dr2'][i]:g}")
            ds_s = ",".join("." if np.isnan(v) else f"{v:g}" for v in rows["ds"][i])
            fh.write(f"{rows['chrom'][i]}\t{rows['pos'][i]}\t.\t{rows['ref'][i]}\t{','.join(rows['alts'][i])}\t.\t.\t"
                     f"{';'.join(info) or '.'}\tDS\t{ds_s}\n")
    return rows


def annotate_with_beagle(subset_table: VariantTable, collapsed_rows: dict, out_path: str) -> None:
    """``bcftools annotate --columns INFO/IMP,INFO/DR2,FORMAT/DS``: per-allele
    DS moved by the exact (chrom, pos, ref, alt) key; records with no
    beagle counterpart pass through unannotated."""
    ds_by_key: dict[tuple, float] = {}
    meta_by_site: dict[tuple, tuple] = {}
    for i in range(len(collapsed_rows["pos"])):
        site = (collapsed_rows["chrom"][i], collapsed_rows["pos"][i], collapsed_rows["ref"][i])
        meta_by_site[site] = (collapsed_rows["imp"][i], collapsed_rows["dr2"][i])
        for alt, d in zip(collapsed_rows["alts"][i], collapsed_rows["ds"][i]):
            ds_by_key[site + (alt,)] = d

    n = len(subset_table)
    fmt, samples = subset_table.format_columns()
    imp_flag = np.full(n, None, dtype=object)
    dr2_col = np.full(n, np.nan)
    for i, site in enumerate(zip(subset_table.chrom.tolist(), subset_table.pos.tolist(), list(subset_table.ref))):
        if site not in meta_by_site:
            continue
        alts = [a for a in subset_table.alt[i].split(",") if a not in (".", "")]
        dvals = [ds_by_key.get(site + (a,), np.nan) for a in alts]
        if all(np.isnan(v) for v in dvals):
            continue
        ds_s = ",".join("." if np.isnan(v) else f"{v:g}" for v in dvals)
        fmt[i] = fmt[i] + ":DS" if fmt[i] else "DS"
        samples[i, 0] = samples[i, 0] + ":" + ds_s if samples[i, 0] else ds_s
        imp, dr2 = meta_by_site[site]
        imp_flag[i] = True if imp else None
        dr2_col[i] = dr2

    subset_table.header.ensure_format("DS", "A", "Float", "Genotype dosage from beagle")
    subset_table.header.ensure_info("IMP", "0", "Flag", "Imputed marker")
    subset_table.header.ensure_info("DR2", "1", "Float", "Dosage R2 from beagle")
    write_vcf(out_path, subset_table, extra_info={"IMP": imp_flag, "DR2": dr2_col}, qual_as_read=False,
              tails=join_tails(fmt, samples))


def concat_vcfs(paths: list[str], out_path: str) -> None:
    """The first part's header, then every part's records, in order."""
    from variantcalling_tpu_torch.io.bgzf import BgzfWriter
    from variantcalling_tpu_torch.io.vcf import parse_header_bytes

    opener = BgzfWriter if str(out_path).endswith(".gz") else (lambda p: open(p, "wb"))
    with opener(out_path) as out:
        for pi, p in enumerate(paths):
            if pi == 0:
                with (gzip.open if str(p).endswith(".gz") else open)(p, "rb") as fh:
                    header, _ = parse_header_bytes(_head_bytes(fh))
                out.write(("\n".join([*header.lines, header.column_header()]) + "\n").encode())
            _append_records(out, p)
    log.info("concatenated %d parts -> %s", len(paths), out_path)


def _head_bytes(fh) -> bytes:
    """The file's lines up to and including the ``#CHROM`` line."""
    lines = []
    for line in fh:
        lines.append(line)
        if not line.startswith(b"##"):
            break
    return b"".join(lines)


def _append_records(out, path: str) -> None:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as fh:
        for line in fh:
            if not line.startswith("#"):
                out.write(line.encode())
