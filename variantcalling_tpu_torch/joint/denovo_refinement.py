"""De novo quality refinement: DENOVO_QUAL from child-against-parent somatic quals.

Counterpart of ``variantcalling_tpu/joint/denovo_refinement.py``: for every
de novo call (the samples listed in INFO ``hiConfDeNovo``, else
``loConfDeNovo``), the recalibrated quality is the minimum of the
variant's QUAL in the child-against-mother and child-against-father
somatic VCFs (absent: 0); a record's ``DENOVO_QUAL`` is the minimum over
its de novo samples. Hash joins over the tables' columns.
"""

from __future__ import annotations

import numpy as np

from variantcalling_tpu_torch.io.vcf import MISSING, read_vcf, write_vcf
from variantcalling_tpu_torch.utils.stages import stage


def _qual_by_locus(vcf_path: str) -> dict[tuple[str, int], float]:
    t = read_vcf(vcf_path, drop_format=True)
    return {(str(c), int(p)): (0.0 if np.isnan(q) else float(q))
            for c, p, q in zip(t.chrom.tolist(), t.pos.tolist(), t.qual.tolist())}


def _info_list(table, name: str) -> list[list[str]]:
    """A comma-separated INFO list per record (the key matched without case)."""
    out: list[list[str]] = []
    lower = name.lower()
    for s in table.info:
        vals: list[str] = []
        if s not in (None, MISSING, ""):
            for part in s.split(";"):
                if "=" in part:
                    k, v = part.split("=", 1)
                    if k.lower() == lower:
                        vals = [x for x in v.split(",") if x not in ("", MISSING)]
                        break
        out.append(vals)
    return out


def add_parental_qualities(denovo_vcf: str, maternal_vcfs: dict[str, str],
                           paternal_vcfs: dict[str, str]) -> tuple[object, np.ndarray]:
    """(the de novo VCF's table, DENOVO_QUAL per record, NaN where it has none)."""
    if set(maternal_vcfs) != set(paternal_vcfs):
        raise ValueError("Mismatch between maternal and paternal samples")
    mother = {s: _qual_by_locus(p) for s, p in maternal_vcfs.items()}
    father = {s: _qual_by_locus(p) for s, p in paternal_vcfs.items()}

    table = read_vcf(denovo_vcf)
    hiconf = _info_list(table, "hiConfDeNovo")
    loconf = _info_list(table, "loConfDeNovo")
    qual = np.full(len(table), np.nan)
    chrom, pos = table.chrom.tolist(), table.pos.tolist()
    for i in range(len(table)):
        samples = [s for s in (hiconf[i] or loconf[i]) if s in mother]
        if samples:
            locus = (str(chrom[i]), int(pos[i]))
            qual[i] = min(min(mother[s].get(locus, 0.0), father[s].get(locus, 0.0)) for s in samples)
    if np.isnan(qual).all():
        raise ValueError("No denovo calls found in the VCF or no overlap between the de novo vcf and the somatic calls")
    return table, qual


def write_recalibrated_vcf(denovo_vcf: str, output_vcf: str, maternal_vcfs: dict, paternal_vcfs: dict) -> int:
    """The de novo VCF with ``DENOVO_QUAL`` added to INFO; returns the records annotated."""
    with stage("join"):
        table, qual = add_parental_qualities(denovo_vcf, maternal_vcfs, paternal_vcfs)
    table.header.ensure_info("DENOVO_QUAL", "1", "Float", "Pair quality (min of child/parent pair)")
    with stage("writeback"):
        write_vcf(output_vcf, table, extra_info={"DENOVO_QUAL": qual}, verbatim_core=True, qual_as_read=False)
    return int(np.sum(~np.isnan(qual)))
