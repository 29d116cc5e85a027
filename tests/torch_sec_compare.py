"""Compare two SEC outputs to the stated tolerance of the likelihood ratio.

The ratio goes through ``lgamma`` in float32, which no two libraries (XLA,
torch on the CPU, CUDA's ``lgammaf``) compute to the same last bits. So two
runs of ``correct_systematic_errors`` on the same inputs are held to this:
outside the ``##vctpu_*`` lines the headers are equal, and a record whose
bytes differ differs only in ``SEC_RATIO``, within :data:`RTOL` of each
other (plus the ``%g`` rendering's six digits), or in FILTER (``SEC`` added
or not), where its ratio lies within :data:`RTOL` of the threshold. Two
``sec_validation`` sweeps are held alike: a row may differ only where a
ratio lies within :data:`RTOL` of that row's threshold, by at most the
number of such ratios.
"""

from __future__ import annotations

import csv
import io

from tests.fixtures import strip_vctpu_header

#: relative tolerance of the SEC likelihood ratio between two engines
RTOL = 5e-4
#: relative error of a ``%g`` rendering (six significant digits), each side
_RENDER = 5e-6


def _split_ratio(info: str) -> tuple[str, float | None]:
    """(INFO without SEC_RATIO, the ratio or None)."""
    parts = info.split(";")
    rest = [p for p in parts if not p.startswith("SEC_RATIO=")]
    ratio = [float(p.split("=", 1)[1]) for p in parts if p.startswith("SEC_RATIO=")]
    return ";".join(rest), (ratio[0] if ratio else None)


def _without_sec(filt: str) -> str:
    kept = [f for f in filt.split(";") if f != "SEC"]
    return ";".join(kept) if kept else "PASS"


def differing_records(got: bytes, want: bytes, threshold: float, rtol: float = RTOL) -> int:
    """Count the records of two corrected VCFs whose bytes differ, and assert
    that each differs only as the module docstring allows."""
    got_lines = strip_vctpu_header(got).decode().splitlines()
    want_lines = strip_vctpu_header(want).decode().splitlines()
    assert [ln for ln in got_lines if ln.startswith("#")] == [ln for ln in want_lines if ln.startswith("#")]
    got_recs = [ln for ln in got_lines if not ln.startswith("#")]
    want_recs = [ln for ln in want_lines if not ln.startswith("#")]
    assert len(got_recs) == len(want_recs)
    n_diff = 0
    for g, w in zip(got_recs, want_recs):
        if g == w:
            continue
        n_diff += 1
        gf, wf = g.split("\t"), w.split("\t")
        assert gf[:6] == wf[:6] and gf[8:] == wf[8:], (g, w)
        (g_info, gr), (w_info, wr) = _split_ratio(gf[7]), _split_ratio(wf[7])
        assert g_info == w_info, (g, w)
        if gf[6] == wf[6]:
            assert gr is not None and wr is not None, (g, w)
            assert abs(gr - wr) <= rtol * abs(wr) + _RENDER * (abs(gr) + abs(wr)), (g, w)
        else:
            assert _without_sec(gf[6]) == _without_sec(wf[6]), (g, w)
            r = gr if gr is not None else wr
            assert r is not None and abs(r - threshold) <= rtol * threshold + _RENDER * r, (g, w)
    return n_diff


def differing_sweep_rows(got: str, want: str, ratios, rtol: float = RTOL) -> int:
    """Count the rows of two ``sec_validation`` CSVs (text) that differ, and
    assert that each differs only where ``ratios`` (one run's, of every call
    at a DB locus) come within ``rtol`` of the row's threshold, its counts by
    at most the number of such ratios."""
    g_rows = list(csv.reader(io.StringIO(got)))
    w_rows = list(csv.reader(io.StringIO(want)))
    assert g_rows[:1] == w_rows[:1] and len(g_rows) == len(w_rows)
    names = w_rows[0]
    n_diff = 0
    for g, w in zip(g_rows[1:], w_rows[1:]):
        if g == w:
            continue
        n_diff += 1
        assert g[0] == w[0], (g, w)
        thr = float(w[0])
        near = sum(1 for r in ratios if abs(float(r) - thr) <= rtol * thr)
        for name, a, b in zip(names[1:-1], g[1:-1], w[1:-1]):
            assert abs(int(a) - int(b)) <= near, (name, g, w, near)
    return n_diff
