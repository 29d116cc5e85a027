"""Mutational-signature fitting and extraction on the run's device, and the COSMIC channel classifiers.

Counterpart of ``variantcalling_tpu/reports/signatures.py``:

- :func:`fit_signatures`: known-signature assignment, Lee-Seung
  multiplicative updates of the KL objective, batched over samples, in
  float32 on the run's device;
- :func:`extract_signatures`: de-novo KL-NMF, its start drawn from a
  ``torch.Generator`` seeded by ``seed`` (the reference draws from
  ``jax.random``, which torch cannot replay: the start differs, the
  iteration is the same);
- :func:`cosine_similarity_matrix`, :func:`sparsify_exposures`,
  :func:`assignment_table`;
- the ID83 and DBS78 labels, classifiers and count vectors (host code, exact).

The float32 fit agrees with the reference's to a stated relative tolerance,
not bit for bit (the products accumulate in another order);
``tests/torch_report_compare.py`` counts what that can move.
"""

from __future__ import annotations

import csv
import json

import numpy as np
import torch

from variantcalling_tpu_torch.models.dan import full_float32
from variantcalling_tpu_torch.utils.h5_utils import Frame, object_column

_EPS = 1e-12


def load_signature_matrix(path: str) -> tuple[list[str], list[str], np.ndarray]:
    """COSMIC-style signature definitions (a ``.tsv``/``.txt`` or ``.csv`` whose
    first column holds the channel labels, like 'A[C>A]A'): (channel labels,
    signature names, (channels, signatures) float64 matrix)."""
    sep = "\t" if path.endswith((".tsv", ".txt")) else ","
    with open(path, newline="", encoding="utf-8") as fh:
        rows = list(csv.reader(fh, delimiter=sep))
    names = rows[0][1:]
    labels = [r[0] for r in rows[1:]]
    mat = np.array([[float(v) if v not in ("",) else np.nan for v in r[1:]] for r in rows[1:]], dtype=np.float64)
    return labels, names, mat.reshape(len(labels), len(names))


def align_catalog(labels: list[str], mat: np.ndarray, channels: list[str]) -> np.ndarray:
    """The catalog's rows in ``channels`` order, 0 for a channel it lacks and
    for a missing value (the reference's ``reindex(...).fillna(0.0)``)."""
    pos = {lab: i for i, lab in enumerate(labels)}
    out = np.zeros((len(channels), mat.shape[1]), dtype=np.float64)
    for j, ch in enumerate(channels):
        if ch in pos:
            out[j] = mat[pos[ch]]
    return np.nan_to_num(out, nan=0.0)


def load_signature_metadata(path: str) -> dict[str, dict]:
    """The reference's cosmic_signatures json: {SBS1: {description, link}}."""
    with open(path) as fh:
        return json.load(fh)


def fit_signatures(counts: np.ndarray, signatures: np.ndarray, n_iter: int = 500,
                   device: torch.device | str = "cpu") -> np.ndarray:
    """Exposures (S, K) explaining counts (S, C) with signatures (C, K):
    ``n_iter`` updates ``e <- e * (S^T (c / (S e + eps))) / (S^T 1 + eps)`` of
    every sample at once, from ``e0 = max(sum c, 1) / K``, in full float32
    whatever TF32 setting the caller left."""
    device = torch.device(device)
    c = torch.from_numpy(np.atleast_2d(np.asarray(counts, dtype=np.float32))).to(device)
    sigs = torch.from_numpy(np.asarray(signatures, dtype=np.float32)).to(device)
    sigs = sigs / torch.clamp(sigs.sum(dim=0, keepdim=True), min=_EPS)  # column-stochastic
    k = sigs.shape[1]
    e = (torch.clamp(c.sum(dim=1, keepdim=True), min=1.0) / k).expand(-1, k).contiguous()
    den = sigs.sum(dim=0) + _EPS
    with full_float32():
        for _ in range(n_iter):
            recon = e @ sigs.T + _EPS
            num = (c / recon) @ sigs
            e = e * num / den
    return e.cpu().numpy()


def sparsify_exposures(exposures: np.ndarray, min_fraction: float = 0.03) -> np.ndarray:
    """Zero signatures contributing < min_fraction of a sample's mutations
    (SigProfilerAssignment's sparsity heuristic)."""
    total = exposures.sum(axis=1, keepdims=True)
    frac = exposures / np.maximum(total, _EPS)
    return np.where(frac >= min_fraction, exposures, 0.0)


def extract_signatures(counts: np.ndarray, n_signatures: int, n_iter: int = 2000, seed: int = 0,
                       device: torch.device | str = "cpu") -> tuple[np.ndarray, np.ndarray]:
    """De-novo KL-NMF: counts (S, C) ~= exposures (S, K) @ sigs.T (K, C).

    Returns (signatures (C, K) column-normalized, exposures (S, K)); the
    start is uniform in [0.1, 1.0) from a ``torch.Generator`` seeded by ``seed``."""
    device = torch.device(device)
    c = torch.from_numpy(np.atleast_2d(np.asarray(counts, dtype=np.float32)).T.copy()).to(device)  # (C, S)
    gen = torch.Generator().manual_seed(seed)
    w = (0.1 + 0.9 * torch.rand((c.shape[0], n_signatures), generator=gen)).to(device)
    h = (0.1 + 0.9 * torch.rand((n_signatures, c.shape[1]), generator=gen)).to(device)
    with full_float32():
        for _ in range(n_iter):
            recon = w @ h + _EPS
            h = h * (w.T @ (c / recon)) / (w.sum(dim=0)[:, None] + _EPS)
            recon = w @ h + _EPS
            w = w * ((c / recon) @ h.T) / (h.sum(dim=1)[None, :] + _EPS)
    w, h = w.cpu().numpy(), h.cpu().numpy()
    scale = w.sum(axis=0)
    w = w / np.maximum(scale, _EPS)
    h = h * scale[:, None]
    return w, h.T


_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _rc(s: str) -> str:
    return "".join(_COMP[c] for c in reversed(s))


def id83_labels() -> list[str]:
    """The 83 COSMIC indel channels, SigProfiler label layout
    ``{len}:{Del|Ins}:{C|T|R|M}:{n}`` (len 5 means 5+, n 5 means 5+)."""
    labels = []
    for kind in ("Del", "Ins"):
        for base in ("C", "T"):
            labels += [f"1:{kind}:{base}:{n}" for n in range(6)]
    for kind in ("Del", "Ins"):
        for ln in (2, 3, 4, 5):
            labels += [f"{ln}:{kind}:R:{n}" for n in range(6)]
    for ln, max_mh in ((2, 1), (3, 2), (4, 3), (5, 5)):
        labels += [f"{ln}:Del:M:{m}" for m in range(1, max_mh + 1)]
    assert len(labels) == 83
    return labels


def _repeat_count(seq: str, unit: str) -> int:
    """Copies of ``unit`` at the start of ``seq``."""
    n = 0
    u = len(unit)
    while seq[n * u: (n + 1) * u] == unit:
        n += 1
    return n


def classify_indel_id83(ref: str, alt: str, right_ctx: str, left_ctx: str) -> str | None:
    """COSMIC ID83 channel for a left-anchored simple indel, or None.

    ``right_ctx`` is the reference sequence right after the record's REF
    span; ``left_ctx`` ends at (and includes) the anchor base at POS. 1-bp
    indels bucket by pyrimidine-folded base and adjacent homopolymer run;
    longer ones by repeat count of the unit; repeat-free deletions by
    microhomology with the flanks (the SigProfilerMatrixGenerator scheme)."""
    if len(ref) == len(alt) or not ref or not alt or ref[0] != alt[0]:
        return None
    if len(ref) > 1 and len(alt) > 1:
        return None  # complex substitution, not a simple indel
    kind = "Del" if len(ref) > len(alt) else "Ins"
    unit = (ref if kind == "Del" else alt)[1:]
    if not unit or any(c not in "ACGT" for c in unit):
        return None
    ln = len(unit)
    lb = min(ln, 5)
    following = right_ctx
    if ln == 1:
        base = unit if unit in ("C", "T") else _COMP[unit]
        n = min(_repeat_count(following, unit), 5)
        return f"1:{kind}:{base}:{n}"
    n = min(_repeat_count(following, unit), 5)
    if kind == "Del" and n == 0:
        mh_r = 0
        while mh_r < ln - 1 and mh_r < len(following) and unit[mh_r] == following[mh_r]:
            mh_r += 1
        mh_l = 0
        while (mh_l < ln - 1 and mh_l < len(left_ctx)
               and unit[ln - 1 - mh_l] == left_ctx[len(left_ctx) - 1 - mh_l]):
            mh_l += 1
        mh = max(mh_r, mh_l)
        if mh > 0:
            max_mh = {2: 1, 3: 2, 4: 3, 5: 5}[lb]
            return f"{lb}:Del:M:{min(mh, max_mh)}"
    return f"{lb}:{kind}:R:{n}"


def id83_matrix(records, fasta) -> np.ndarray:
    """(83,) int64 indel counts, in :func:`id83_labels` order, for an iterable
    of (chrom, pos 1-based, ref, alt); reference context from ``fasta``."""
    idx = {lab: i for i, lab in enumerate(id83_labels())}
    counts = np.zeros(83, dtype=np.int64)
    refs = set(fasta.references)
    for chrom, pos, ref, alt in records:
        if chrom not in refs:
            continue
        end = pos - 1 + len(ref)
        right = fasta.fetch(chrom, end, end + 6 * max(len(ref), len(alt)))
        left = fasta.fetch(chrom, max(0, pos - 1 - 6), pos)
        ch = classify_indel_id83(ref, alt, right.upper(), left.upper())
        if ch is not None:
            counts[idx[ch]] += 1
    return counts


_DBS_CANON_REFS = ("AC", "AT", "CC", "CG", "CT", "GC", "TA", "TC", "TG", "TT")


def dbs78_labels() -> list[str]:
    """The 78 COSMIC doublet channels ('AC>CA' style): canonical ref doublets
    with revcomp folding; palindromic refs fold the alt to min(alt, revcomp(alt))."""
    out = []
    for ref in _DBS_CANON_REFS:
        seen = set()
        for a0 in "ACGT":
            for a1 in "ACGT":
                if a0 == ref[0] or a1 == ref[1]:
                    continue
                alt = a0 + a1
                if _rc(ref) == ref:
                    alt = min(alt, _rc(alt))
                if alt not in seen:
                    seen.add(alt)
                    out.append(f"{ref}>{alt}")
    assert len(out) == 78
    return out


def classify_doublet_dbs78(ref: str, alt: str) -> str | None:
    """Canonical DBS78 channel for a 2-bp REF/ALT pair, or None."""
    if len(ref) != 2 or len(alt) != 2 or ref == alt:
        return None
    if any(c not in "ACGT" for c in ref + alt):
        return None
    if alt[0] == ref[0] or alt[1] == ref[1]:
        return None
    if ref not in _DBS_CANON_REFS:
        ref, alt = _rc(ref), _rc(alt)
        if ref not in _DBS_CANON_REFS:
            return None
    if _rc(ref) == ref:
        alt = min(alt, _rc(alt))
    return f"{ref}>{alt}"


def dbs78_matrix(table, return_paired: bool = False):
    """(78,) int64 doublet counts, in :func:`dbs78_labels` order: explicit 2-bp
    MNP records plus adjacent SNV pairs merged into doublets; runs of three
    or more adjacent SNVs enter neither catalog. ``return_paired=True`` also
    returns the mask of SNV records consumed as doublet halves or run members
    (excluded from SBS96 by the caller)."""
    idx = {lab: i for i, lab in enumerate(dbs78_labels())}
    counts = np.zeros(78, dtype=np.int64)
    chrom = np.asarray(table.chrom)
    pos = np.asarray(table.pos)
    refs = np.asarray(table.ref)
    alts = np.asarray(table.alt)
    n = len(pos)
    is_snv = np.zeros(n, dtype=bool)
    for i in range(n):
        r, a = refs[i], alts[i].split(",")[0]
        if len(r) == 2 and len(a) == 2:
            ch = classify_doublet_dbs78(r.upper(), a.upper())
            if ch is not None:
                counts[idx[ch]] += 1
        elif len(r) == 1 and len(a) == 1 and r in "ACGT" and a in "ACGT":
            is_snv[i] = True
    paired = np.zeros(n, dtype=bool)
    i = 0
    while i < n:
        if not is_snv[i]:
            i += 1
            continue
        j = i
        while (j + 1 < n and is_snv[j + 1] and chrom[j + 1] == chrom[j]
               and int(pos[j + 1]) == int(pos[j]) + 1):
            j += 1
        run = j - i + 1
        if run == 2:
            ch = classify_doublet_dbs78((refs[i] + refs[i + 1]).upper(),
                                        (alts[i].split(",")[0] + alts[i + 1].split(",")[0]).upper())
            if ch is not None:
                counts[idx[ch]] += 1
                paired[i] = paired[i + 1] = True
        elif run >= 3:
            paired[i: j + 1] = True
        i = j + 1
    return (counts, paired) if return_paired else counts


def cosine_similarity_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(Ka, Kb) cosine similarities between signature columns."""
    an = a / np.maximum(np.linalg.norm(a, axis=0, keepdims=True), _EPS)
    bn = b / np.maximum(np.linalg.norm(b, axis=0, keepdims=True), _EPS)
    return an.T @ bn


def assignment_table(exposures: np.ndarray, signature_names: list[str], metadata: dict[str, dict] | None = None,
                     sample_names: list[str] | None = None) -> Frame:
    """Long-form exposures (``sample``, ``signature``, ``mutations``,
    ``fraction``, and ``description`` where ``metadata`` names a signature;
    NaN where it does not), nonzero rows only, sorted by sample and then by
    mutations, largest first (ties in row order, as pandas' stable sort)."""
    exposures = np.atleast_2d(exposures)
    samples = sample_names or [f"sample{i}" for i in range(exposures.shape[0])]
    rows = []
    for si, sample in enumerate(samples):
        total = exposures[si].sum()
        for ki, name in enumerate(signature_names):
            if exposures[si, ki] <= 0:
                continue
            row = {"sample": sample, "signature": name, "mutations": float(exposures[si, ki]),
                   "fraction": float(exposures[si, ki] / max(total, _EPS))}
            if metadata and name in metadata:
                row["description"] = metadata[name].get("description", metadata[name].get("descprition", ""))
            rows.append(row)
    order = sorted(range(len(rows)), key=lambda i: (rows[i]["sample"], -rows[i]["mutations"]))
    rows = [rows[i] for i in order]
    names = list(dict.fromkeys(k for r in rows for k in r))
    cols = {}
    for name in names:
        if name in ("mutations", "fraction"):
            cols[name] = np.array([r[name] for r in rows], dtype=np.float64)
        else:
            cols[name] = object_column([r.get(name, np.nan) for r in rows])
    return Frame(cols)
