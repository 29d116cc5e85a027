"""Compare two outputs of the genotype tools to the stated bar of their float32 math.

``convert_haploid_regions`` truncates, and ``correct_genotypes_by_imputation``
rounds, float32 phred values to integer PLs, and a float32 PL of 70 lies
within a few ulps of its integer. The port computes ``exp`` and ``log`` as
XLA's CPU backend does (``variantcalling_tpu_torch/ops/math.py``) and holds
the JAX package's bytes on the CPU; this helper states what two engines may
still differ by, and counts what does. Every record whose bytes differ is
checked against these rules, and anything else fails:

- **haploid**: an output PL may differ by exactly 1, only where the float64
  recomputation of its value before ``trunc`` lies within :data:`TOL` of an
  integer; GT and GQ may differ only as those PLs imply (GT the last allele
  of PL 0, GQ the smallest nonzero PL, 10000 where there is none);
- **imputation**: a PL may differ by exactly 1, only where the float64 value
  before ``rint`` lies within :data:`TOL` of a half-integer; GT may differ
  only where the two smallest float64 phred values lie within :data:`TOL`
  of each other; GQ only as the PLs imply (second smallest less smallest);
- everything else is exact: the header, every other column and FORMAT value
  of a record, the record count, and the counters CSV.

The float64 recomputation takes the record's input PL (and, for the
imputation, its DS and GT) from the input VCF, read only where a record
differs.
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

TOL = 1e-3
_PL_CLAMP = 350.0


def _text(data: bytes | str | Path) -> list[str]:
    if isinstance(data, (str, Path)):
        data = Path(data).read_bytes()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return data.decode().splitlines()


def _split(got: bytes, want: bytes) -> list[tuple[str, str]]:
    g, w = _text(got), _text(want)
    assert [ln for ln in g if ln.startswith("#")] == [ln for ln in w if ln.startswith("#")], "headers differ"
    g = [ln for ln in g if not ln.startswith("#")]
    w = [ln for ln in w if not ln.startswith("#")]
    assert len(g) == len(w), f"{len(g)} records against {len(w)}"
    return [(a, b) for a, b in zip(g, w) if a != b]


def _inputs(paths) -> dict[tuple[str, str], dict]:
    """(chrom, pos) -> the input record's FORMAT values of sample 0."""
    out = {}
    for p in [paths] if isinstance(paths, (str, Path)) else paths:
        for ln in _text(p):
            if ln.startswith("#"):
                continue
            f = ln.split("\t")
            out[(f[0], f[1])] = dict(zip(f[8].split(":"), f[9].split(":")))
    return out


def _sample(rec: str) -> tuple[list[str], dict]:
    f = rec.split("\t")
    return f, dict(zip(f[8].split(":"), f[9].split(":")))


def _pls(s: str) -> np.ndarray:
    return np.asarray([int(x) for x in s.split(",")], dtype=np.int64)


def _check_rest(gf: list[str], wf: list[str], gs: dict, ws: dict, free: set[str]) -> None:
    assert gf[:9] == wf[:9] and gf[10:] == wf[10:], (gf, wf)
    assert gs.keys() == ws.keys(), (gf, wf)
    for k in gs:
        assert k in free or gs[k] == ws[k], (k, gf, wf)


def haploid_pre_trunc(pl: np.ndarray) -> np.ndarray:
    """float64 phred of each homozygous genotype's share, before ``trunc``."""
    a = int(round((np.sqrt(8 * len(pl) + 1) - 3) / 2))
    hom = pl[[i * (i + 3) // 2 for i in range(a + 1)]].astype(np.float64)
    hom = np.minimum(hom - hom.min(), _PL_CLAMP)
    lik = 10.0 ** (-hom / 10.0)
    return -10.0 * np.log10(lik / lik.sum())


def differing_haploid_records(got, want, input_vcf) -> int:
    """Count the records of two ``convert_haploid_regions`` outputs that
    differ, and assert that each differs only as the haploid rule allows."""
    diff = _split(got, want)
    src = _inputs(input_vcf) if diff else {}
    for g, w in diff:
        (gf, gs), (wf, ws) = _sample(g), _sample(w)
        _check_rest(gf, wf, gs, ws, {"GT", "GQ", "PL"})
        gp, wp = _pls(gs["PL"]), _pls(ws["PL"])
        assert len(gp) == len(wp), (g, w)
        pre = haploid_pre_trunc(_pls(src[(gf[0], gf[1])]["PL"]).astype(np.float64))
        for j in np.flatnonzero(gp != wp):
            assert abs(gp[j] - wp[j]) == 1 and abs(pre[j] - round(pre[j])) <= TOL, (g, w, pre)
        for s, p in ((gs, gp), (ws, wp)):
            zero = np.flatnonzero(p == 0)
            if s["GT"] != ".":
                assert zero.size and int(s["GT"]) == int(zero[-1]), (g, w)
            if "GQ" in s:
                nz = p[p != 0]
                assert int(s["GQ"]) == (int(nz.min()) if nz.size else 10000), (g, w)
    return len(diff)


def imputation_pre_rint(pl: np.ndarray, ds: np.ndarray, epsilon: float = 0.01) -> np.ndarray:
    """float64 phred of each genotype after the imputation prior, shifted
    to a minimum of 0: the values the rewrite rounds."""
    g = len(pl)
    a = int(round((np.sqrt(8 * g + 1) - 3) / 2))
    table = [(j, k) for k in range(a + 1) for j in range(k + 1)]
    f_het = np.clip(2.0 - ds, epsilon, 1 - epsilon)
    f_hom = np.clip(np.maximum(ds, 1.0) - 1.0, epsilon, 1 - epsilon)
    f_het, f_hom = np.nan_to_num(f_het, nan=epsilon), np.nan_to_num(f_hom, nan=epsilon)
    f = np.ones(g)
    for i, (j, k) in enumerate(table[1:], 1):
        f[i] = max([epsilon] + [(f_hom if j == k else f_het)[x - 1] for x in {j, k} if x > 0])
    pl = np.minimum(pl - pl.min(), _PL_CLAMP)
    lik = 10.0 ** (-pl / 10.0)
    weighted = lik * f
    scaled = np.concatenate([lik[:1], lik[1:].sum() / max(weighted[1:].sum(), 1e-37) * weighted[1:]])
    phred = -10.0 * np.log10(np.maximum(scaled, 1e-37))
    return phred - phred.min()


def differing_imputation_records(got, want, input_vcfs, epsilon: float = 0.01) -> int:
    """Count the records of two ``correct_genotypes_by_imputation`` outputs
    that differ, and assert that each differs only as the imputation rule
    allows (``input_vcfs``: the beagle-annotated VCF, or the annotated parts
    of a stage-chain run)."""
    diff = _split(got, want)
    src = _inputs(input_vcfs) if diff else {}
    for g, w in diff:
        (gf, gs), (wf, ws) = _sample(g), _sample(w)
        _check_rest(gf, wf, gs, ws, {"GT", "GQ", "PL"})
        gp, wp = _pls(gs["PL"]), _pls(ws["PL"])
        assert len(gp) == len(wp), (g, w)
        rec = src[(gf[0], gf[1])]
        ds = np.asarray([np.nan if x == "." else float(x) for x in rec["DS"].split(",")])
        a = int(round((np.sqrt(8 * len(gp) + 1) - 3) / 2))
        ds = np.concatenate([ds, np.full(max(0, a - len(ds)), np.nan)])[:a]
        pre = imputation_pre_rint(_pls(rec["PL"]).astype(np.float64), ds, epsilon)
        for j in np.flatnonzero(gp != wp):
            assert abs(gp[j] - wp[j]) == 1 and abs(pre[j] - np.floor(pre[j]) - 0.5) <= TOL, (g, w, pre)
        if gs["GT"] != ws["GT"]:
            two = np.sort(pre)[:2]
            assert two[1] - two[0] <= TOL, (g, w, pre)
        for s, p in ((gs, gp), (ws, wp)):
            srt = np.sort(p)
            assert int(s["GQ"]) == int(srt[1] - srt[0]), (g, w)
    return len(diff)


def same_counters(got, want) -> None:
    """The counters CSVs of two runs: equal, byte for byte."""
    assert _text(got) == _text(want)
