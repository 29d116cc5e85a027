"""The bars two engines' report outputs are held to, and the counts of what they let differ.

Used by the CPU tests (the port against the JAX package) and by
``chip_smoke.py`` (the card against the CPU); it imports neither pandas nor
JAX, so it runs on the card's machine too.

- Frames and h5 files (:func:`frame_problems`, :func:`h5_problems`): equal
  keys, columns, dtypes, values (NaN equal to NaN) and index;
  :func:`store_problems` also each key's stored column kinds (``fstr``,
  ``str``, ``bool``, ``ragged``, a numpy kind) and array cells element by
  element.
- The signature exposures (:func:`compare_exposures`): the fit is 500
  float32 multiplicative updates, whose products accumulate in another
  order on another engine, so ``mutations`` may differ by a relative
  :data:`EXPOSURE_RTOL`. Measured by ``tests/test_torch_signatures.fit_error``
  (``python -m tests.test_torch_signatures``): at most 4.2e-5 between the
  JAX package and the port on the CPU, over 441 exposures of 18 seeded
  catalogs of COSMIC v3.3's shapes (SBS 96x79, ID 83x18, DBS 78x11), three
  planted mixtures each; the bar holds about ten times that. What the bar
  may move is counted, and nothing else may differ: a row on one side only
  must lie within the bar of
  the 3 % sparsity cut (``near_cut``: its share of the sample's mutations,
  the ``.all`` matrix's column sum, within ``2 * EXPOSURE_RTOL`` of 0.03
  relatively), the fractions of that sample's rows then move with it
  (``fraction_shifted``), and two rows of a sample may trade places only
  where their mutations lie within the bar of each other (``order_flips``).
  The case-vs-control table (:func:`compare_control`) is held the same way.
- The HTML (:func:`strip_images`): equal once every ``<img .../>`` element
  is removed (a PNG's bytes depend on the plotting library's version, and
  the card's machine has none, so its runs skip every figure).
"""

from __future__ import annotations

import re

import numpy as np

from variantcalling_tpu_torch.utils import h5_utils

#: relative bar of a fitted exposure (see the module docstring for the measurement)
EXPOSURE_RTOL = 5e-4
SPARSITY_CUT = 0.03
_IMG = re.compile(r"<img[^>]*/>")


def _index(frame: h5_utils.Frame) -> list | None:
    idx = frame.index
    if idx is None or (isinstance(idx, range) and idx == range(len(frame))):
        return None
    return list(idx)


def frame_problems(got: h5_utils.Frame, want: h5_utils.Frame, label: str = "") -> list[str]:
    """What differs between two frames (empty: equal)."""
    if got.columns != want.columns:
        return [f"{label}: columns {got.columns} != {want.columns}"]
    if len(got) != len(want):
        return [f"{label}: {len(got)} rows != {len(want)}"]
    out = []
    for c in got.columns:
        x, y = np.asarray(got[c]), np.asarray(want[c])
        if x.dtype != y.dtype:
            out.append(f"{label}.{c}: dtype {x.dtype} != {y.dtype}")
        elif not (list(x) == list(y) or np.array_equal(x, y, equal_nan=x.dtype.kind == "f")):
            bad = [i for i in range(len(x)) if not (x[i] == y[i] or (x[i] != x[i] and y[i] != y[i]))]
            out.append(f"{label}.{c}: {len(bad)} values differ, first at row {bad[0]}: {x[bad[0]]!r} != {y[bad[0]]!r}")
    if _index(got) != _index(want):
        out.append(f"{label}: index differs")
    return out


def h5_problems(got: str, want: str, skip: tuple[str, ...] = ()) -> list[str]:
    """What differs between two h5 files of frames, key by key, but the keys in ``skip``."""
    keys_got, keys_want = h5_utils.list_keys(got), h5_utils.list_keys(want)
    if keys_got != keys_want:
        return [f"keys {keys_got} != {keys_want}"]
    out = []
    for key in keys_got:
        if key not in skip:
            out += frame_problems(h5_utils.read_hdf(got, key), h5_utils.read_hdf(want, key), key)
    return out


def assert_same_h5(got: str, want: str, skip: tuple[str, ...] = ()) -> None:
    problems = h5_problems(got, want, skip)
    assert not problems, "\n".join(problems)


def _cells_equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and np.array_equal(a, b, equal_nan=True)
    return bool(a == b) or (a != a and b != b)


def _stored_layout(path: str) -> dict[str, tuple]:
    """Each key's ``columns`` and ``kinds`` attributes, as stored."""
    from variantcalling_tpu_torch.io import hdf5

    with hdf5.H5File(path) as f:
        return {k: (f.root[k].attrs.get("columns"), f.root[k].attrs.get("kinds")) for k in f.root.keys()}


def store_problems(got: str, want: str) -> list[str]:
    """What differs between two h5 files of frames: the keys, each key's
    stored columns and kinds, index, dtypes and values (NaN equal to NaN,
    array cells element by element)."""
    keys = h5_utils.list_keys(want)
    if h5_utils.list_keys(got) != keys:
        return [f"keys {h5_utils.list_keys(got)} != {keys}"]
    lg, lw = _stored_layout(got), _stored_layout(want)
    out = [f"{k}: stored layout {lg.get(k)} != {lw.get(k)}" for k in keys if lg.get(k) != lw.get(k)]
    for key in keys:
        g, w = h5_utils.read_hdf(got, key), h5_utils.read_hdf(want, key)
        if g.columns != w.columns or len(g) != len(w):
            out.append(f"{key}: columns {g.columns} != {w.columns} or {len(g)} != {len(w)} rows")
            continue
        if _index(g) != _index(w):
            out.append(f"{key}: index differs")
        for c in g.columns:
            x, y = np.asarray(g[c]), np.asarray(w[c])
            bad = [i for i in range(len(x)) if not _cells_equal(x[i], y[i])]
            if x.dtype != y.dtype or bad:
                out.append(f"{key}.{c}: dtype {x.dtype} / {y.dtype}, {len(bad)} values differ"
                           + (f", first {x[bad[0]]!r} != {y[bad[0]]!r}" if bad else ""))
    return out


def strip_images(html: str) -> tuple[str, int]:
    """(the document without its ``<img .../>`` elements, how many were removed)."""
    return _IMG.subn("", html)


def matrix_totals(prefix: str, catalogs=("SBS96", "ID83", "DBS78")) -> dict[tuple[str, str], float]:
    """(catalog, sample) -> the sample's mutations, the column sums of ``<prefix>.<catalog>.all``."""
    out = {}
    for cat in catalogs:
        with open(f"{prefix}.{cat}.all", encoding="utf-8") as fh:
            rows = [line.rstrip("\r\n").split("\t") for line in fh if line.strip()]
        for j, name in enumerate(rows[0][1:], start=1):
            out[(cat, name)] = float(sum(int(r[j]) for r in rows[1:]))
    return out


def _near(a: float, b: float, rtol: float) -> bool:
    return abs(a - b) <= rtol * max(abs(a), abs(b))


def compare_exposures(got: h5_utils.Frame, want: h5_utils.Frame, totals: dict[tuple[str, str], float],
                      rtol: float = EXPOSURE_RTOL) -> dict:
    """Hold two ``signature_exposures`` frames to the bar; raise AssertionError
    on a difference it does not admit; return the counts of what it admits."""
    assert got.columns == want.columns, (got.columns, want.columns)
    cols = got.columns

    def rows(f: h5_utils.Frame) -> list[dict]:
        return [dict(zip(cols, vals)) for vals in zip(*(f[c].tolist() for c in cols))]

    g_rows, w_rows = rows(got), rows(want)
    key = lambda r: (r["catalog"], r["sample"], r["signature"])  # noqa: E731
    g_by, w_by = {key(r): r for r in g_rows}, {key(r): r for r in w_rows}
    counts = {"rows": len(w_rows), "near_cut": 0, "fraction_shifted": 0, "order_flips": 0, "max_rel_err": 0.0}
    shifted_groups = set()
    for k in set(g_by) ^ set(w_by):
        r = g_by.get(k) or w_by[k]
        share = r["mutations"] / totals[(k[0], k[1])]
        assert abs(share / SPARSITY_CUT - 1) <= 2 * rtol + 1e-6, f"{k}: on one side only, share {share}"
        counts["near_cut"] += 1
        shifted_groups.add(k[:2])
    for k in set(g_by) & set(w_by):
        g, w = g_by[k], w_by[k]
        err = abs(g["mutations"] - w["mutations"]) / abs(w["mutations"])
        counts["max_rel_err"] = max(counts["max_rel_err"], err)
        assert err <= rtol, f"{k}: mutations {g['mutations']} against {w['mutations']}"
        if k[:2] in shifted_groups:
            counts["fraction_shifted"] += 1
        else:
            assert _near(g["fraction"], w["fraction"], 2 * rtol), f"{k}: fraction {g['fraction']} / {w['fraction']}"
        for c in cols:
            if c not in ("mutations", "fraction"):
                assert g[c] == w[c] or (g[c] != g[c] and w[c] != w[c]), f"{k}.{c}: {g[c]!r} != {w[c]!r}"
    # order: the shared rows in the same sequence, but for trades within runs of near-tied mutations
    shared = set(g_by) & set(w_by)
    w_seq = [key(r) for r in w_rows if key(r) in shared]
    g_seq = [key(r) for r in g_rows if key(r) in shared]
    cluster, cid = {}, -1
    for i, k in enumerate(w_seq):
        prev = w_seq[i - 1] if i else None
        if prev is None or prev[:2] != k[:2] or not _near(w_by[prev]["mutations"], w_by[k]["mutations"], 2 * rtol):
            cid += 1
        cluster[k] = cid
    assert [cluster[k] for k in g_seq] == [cluster[k] for k in w_seq], "rows out of order beyond near-ties"
    counts["order_flips"] = sum(a != b for a, b in zip(g_seq, w_seq))
    counts["near_cut_groups"] = sorted(shifted_groups)
    return counts


def compare_control(got: h5_utils.Frame, want: h5_utils.Frame, near_cut_groups, rtol: float = EXPOSURE_RTOL) -> int:
    """Hold two ``signature_control_comparison`` frames to the bar; the rows
    whose values the near-cut groups excuse, counted."""
    assert got.columns == want.columns, (got.columns, want.columns)
    g_by = {(c, s): i for i, (c, s) in enumerate(zip(got["catalog"].tolist(), got["signature"].tolist()))}
    w_by = {(c, s): i for i, (c, s) in enumerate(zip(want["catalog"].tolist(), want["signature"].tolist()))}
    excused_catalogs = {c for c, _ in near_cut_groups}
    assert [k for k in g_by if k in w_by] == [k for k in w_by if k in g_by], "rows out of order"
    excused = 0
    for k in set(g_by) | set(w_by):
        if k not in g_by or k not in w_by:
            assert k[0] in excused_catalogs, f"{k}: on one side only"
            excused += 1
            continue
        for c in ("case_fraction", "control_mean_fraction", "enrichment"):
            g, w = float(got[c][g_by[k]]), float(want[c][w_by[k]])
            if not _near(g, w, 4 * rtol) and not (g == w == 0.0):
                assert k[0] in excused_catalogs, f"{k}.{c}: {g} against {w}"
                excused += 1
                break
    return excused


def compare_somatic(got_prefix: str, want_prefix: str, rtol: float = EXPOSURE_RTOL) -> dict:
    """A ``somatic_analysis`` output against another: the ``.all`` TSVs byte
    for byte, the exposures and the control table under the bar, any other
    key of the h5 exactly. The counts of what the bar admitted. The case
    sample is named after the prefix's last part: the two prefixes must
    share it (two directories)."""
    assert got_prefix.split("/")[-1] == want_prefix.split("/")[-1], "the prefixes name the case sample"
    for cat in ("SBS96", "ID83", "DBS78"):
        with open(f"{got_prefix}.{cat}.all", "rb") as a, open(f"{want_prefix}.{cat}.all", "rb") as b:
            assert a.read() == b.read(), f"{cat}.all differs"
    got_h5, want_h5 = f"{got_prefix}.h5", f"{want_prefix}.h5"
    tol_keys = ("signature_exposures", "signature_control_comparison")
    assert_same_h5(got_h5, want_h5, skip=tol_keys)
    keys = h5_utils.list_keys(want_h5)
    counts = {}
    if "signature_exposures" in keys:
        counts = compare_exposures(h5_utils.read_hdf(got_h5, "signature_exposures"),
                                   h5_utils.read_hdf(want_h5, "signature_exposures"), matrix_totals(want_prefix),
                                   rtol)
        if "signature_control_comparison" in keys:
            counts["control_rows_excused"] = compare_control(
                h5_utils.read_hdf(got_h5, "signature_control_comparison"),
                h5_utils.read_hdf(want_h5, "signature_control_comparison"), counts["near_cut_groups"], rtol)
    return counts
