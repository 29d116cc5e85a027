"""Compare two filter outputs scored by a threshold model or a DAN, to a stated tolerance.

Neither family can match XLA bit for bit (sigmoids and GEMMs on another
library), so two outputs of the same run are held to this: outside the
``##vctpu_*`` lines, every record whose bytes differ differs only in
TREE_SCORE by one unit of its fourth decimal, or in FILTER (PASS against
LOW_SCORE) where the score lies within ``tol`` of the pass threshold.
"""

from __future__ import annotations

from tests.fixtures import strip_vctpu_header


def _tree_score(info: str) -> float:
    return float(info.split("TREE_SCORE=")[1].split(";")[0])


def _score_filter(filt: str) -> str:
    """PASS or LOW_SCORE, the part of FILTER the score decides (HPOL_RUN alone
    is a passing score near a homopolymer run)."""
    first = filt.split(";")[0]
    return "PASS" if first == "HPOL_RUN" else first


def differing_records(got: bytes, want: bytes, pass_threshold: float, tol: float) -> int:
    """Count the records of ``got`` and ``want`` whose bytes differ, and assert
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
        gs, ws = _tree_score(gf[7]), _tree_score(wf[7])
        assert abs(gs - ws) <= 1e-4 + 1e-9, (g, w)
        assert gf[7].split("TREE_SCORE=")[0] == wf[7].split("TREE_SCORE=")[0], (g, w)
        if gf[6] != wf[6]:
            # a rendered score is within 5e-5 of the score it rounds
            assert min(abs(gs - pass_threshold), abs(ws - pass_threshold)) <= tol + 5e-5, (g, w)
            assert {_score_filter(gf[6]), _score_filter(wf[6])} == {"PASS", "LOW_SCORE"}, (g, w)
    return n_diff
