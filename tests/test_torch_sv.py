"""The SV pair of the port (``sv_stats_collect``, ``create_sv_report``) against the JAX package's, on the CPU.

Seeded worlds of ``synthetic_tools.write_sv_world`` (an SV callset with
every type, LowQual records and records without SVLEN, and a concordance h5
with missing QUAL):

- the port's pickle, loaded with pandas, equals the JAX tool's
  (``assert_series_equal`` / ``assert_frame_equal(check_exact=True)``),
  with and without the concordance h5 and with ``--ignore_filter``;
- the port's reader (``utils/pandas_pickle``) on the JAX tool's pickle
  gives the port's own frames, and so does it on the port's pickle;
- ``create_sv_report`` from either pickle: every h5 key with its stored
  kinds (``tests/torch_report_compare.store_problems``) and the HTML once
  images are removed equal the JAX tool's, with matplotlib and without;
- a pickle naming a global outside the reader's table exits 2 and names it;
- the committed JAX pickle ``tests/torch_data/sv_stats_reference.pkl``
  equals the JAX tool's pickle regenerated from its seed, so it cannot go
  stale unseen, and the port reads it to its own frames.
"""

import os
import pickle
import sys

import numpy as np
import pandas as pd
import pytest

from tests import torch_worlds
from tests.torch_report_compare import store_problems, strip_images
from variantcalling_tpu.pipelines import create_sv_report as jrep
from variantcalling_tpu.pipelines import sv_stats_collect as jsv
from variantcalling_tpu_torch import synthetic_tools
from variantcalling_tpu_torch.pipelines import create_sv_report as trep
from variantcalling_tpu_torch.pipelines import sv_stats_collect as tsv
from variantcalling_tpu_torch.utils import pandas_pickle as pp

WORLD_SEEDS = (11, 12)
ARGVS = {"plain": [], "concordance": ["--concordance_h5"], "ignore_filter": ["--ignore_filter", "--concordance_h5"]}


@pytest.fixture(scope="module", params=WORLD_SEEDS)
def world(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"sv{request.param}")
    return synthetic_tools.write_sv_world(str(d), seed=request.param, n_records=1_500, n_base=1_200, n_calls=1_500)


def _argv(world: dict, kind: str, out: str) -> list[str]:
    extra = [x for a in ARGVS[kind] for x in ([a, world["concordance_h5"]] if a == "--concordance_h5" else [a])]
    return [world["vcf"], out, *extra]


def _pandas_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for key in want:
        if isinstance(want[key], pd.Series):
            pd.testing.assert_series_equal(got[key], want[key], check_exact=True)
        else:
            pd.testing.assert_frame_equal(got[key], want[key], check_exact=True)


def _same(a, b) -> bool:
    """Two of the port's frames (or labels) hold the same values, dtypes and names."""
    if type(a) is not type(b):
        return False
    if isinstance(a, np.ndarray):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype == object:
            return all(_same(x, y) if isinstance(x, np.ndarray) else (x == y or (x != x and y != y))
                       for x, y in zip(a.tolist(), b.tolist()))
        return bool(np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (pp.Labels, pp.MultiLabels, pp.Series, pp.Table)):
        return all(_same(getattr(a, f), getattr(b, f)) for f in a.__dataclass_fields__)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("kind", list(ARGVS))
def test_pickle_loads_with_pandas_to_the_reference_objects(world, tmp_path, kind):
    assert jsv.run(_argv(world, kind, str(tmp_path / "j.pkl"))) == 0
    assert tsv.run(_argv(world, kind, str(tmp_path / "t.pkl"))) == 0
    with open(tmp_path / "j.pkl", "rb") as fh:
        want = pickle.load(fh)
    with open(tmp_path / "t.pkl", "rb") as fh:
        got = pickle.load(fh)
    _pandas_equal(got, want)
    assert set(want) == ({"type_counts", "length_counts", "length_by_type_counts"}
                         | ({"concordance", "fp_stats"} if kind != "plain" else set()))


@pytest.mark.parametrize("kind", list(ARGVS))
def test_reader_gives_the_port_frames_from_either_pickle(world, tmp_path, kind):
    assert jsv.run(_argv(world, kind, str(tmp_path / "j.pkl"))) == 0
    assert tsv.run(_argv(world, kind, str(tmp_path / "t.pkl"))) == 0
    from_jax = pp.loads((tmp_path / "j.pkl").read_bytes())
    own = pp.loads((tmp_path / "t.pkl").read_bytes())
    assert _same(from_jax, own)
    # the JAX pickle's globals are the pandas 3 table, the port's pickle names no block layout
    assert {k for k in pp.PANDAS3_GLOBALS if k[0].startswith("pyarrow")} <= _globals(tmp_path / "j.pkl")
    assert not {g for g in _globals(tmp_path / "t.pkl") if "internals" in g[0] or g[0] == "pyarrow.lib"}


def _globals(path) -> set[tuple[str, str]]:
    seen = set()

    class Spy(pickle.Unpickler):
        def find_class(self, module, name):
            seen.add((module, name))
            return super().find_class(module, name)

    with open(path, "rb") as fh:
        Spy(fh).load()
    return seen


def _reports(tmp_path, pkl: str, tag: str) -> dict:
    """Both packages' create_sv_report of ``pkl`` in directories of their own, relative outputs."""
    out = {}
    for pkg, run in (("jax", jrep.run), ("torch", trep.run)):
        d = tmp_path / f"{tag}_{pkg}"
        d.mkdir()
        cwd = os.getcwd()
        os.chdir(d)
        try:
            assert run(["--statistics_file", pkl, "--run_id", "r1", "--truth_sample_name", "HG002",
                        "--h5_output", "sv.h5", "--html_output", "sv.html"]) == 0
        finally:
            os.chdir(cwd)
        out[pkg] = d
    return out


@pytest.mark.parametrize("source", ["port", "jax"])
def test_create_sv_report_equals_the_reference(world, tmp_path, source):
    run = tsv.run if source == "port" else jsv.run
    assert run(_argv(world, "concordance", str(tmp_path / "s.pkl"))) == 0
    out = _reports(tmp_path, str(tmp_path / "s.pkl"), source)
    problems = store_problems(str(out["torch"] / "sv.h5"), str(out["jax"] / "sv.h5"))
    assert not problems, "\n".join(problems)
    got, n_got = strip_images((out["torch"] / "sv.html").read_text())
    want, n_want = strip_images((out["jax"] / "sv.html").read_text())
    assert got == want and n_got == n_want == 6
    assert sorted(os.listdir(out["torch"] / "sv_figs")) == sorted(os.listdir(out["jax"] / "sv_figs"))


def test_create_sv_report_without_concordance_equals_the_reference(world, tmp_path):
    assert tsv.run(_argv(world, "plain", str(tmp_path / "s.pkl"))) == 0
    out = _reports(tmp_path, str(tmp_path / "s.pkl"), "plain")
    assert not store_problems(str(out["torch"] / "sv.h5"), str(out["jax"] / "sv.h5"))
    got, want = ((out[pkg] / "sv.html").read_text() for pkg in ("torch", "jax"))
    assert strip_images(got)[0] == strip_images(want)[0]


def test_create_sv_report_skips_figures_without_matplotlib(world, tmp_path, monkeypatch):
    """Where matplotlib does not import (the card's machine) the six figures
    are skipped and counted, and the document is the reference's without its images."""
    assert tsv.run(_argv(world, "concordance", str(tmp_path / "s.pkl"))) == 0
    want = _reports(tmp_path, str(tmp_path / "s.pkl"), "with")["jax"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    d = tmp_path / "without"
    d.mkdir()
    monkeypatch.chdir(d)
    from variantcalling_tpu_torch.utils import degrade

    degrade.clear_for_tests()
    assert trep.run(["--statistics_file", str(tmp_path / "s.pkl"), "--run_id", "r1", "--truth_sample_name",
                     "HG002", "--h5_output", "sv.h5", "--html_output", "sv.html"]) == 0
    assert len(degrade.events_for("reports.figure")) == 6
    html, n_img = strip_images((d / "sv.html").read_text())
    assert n_img == 0 and html == strip_images((want / "sv.html").read_text())[0]
    assert not store_problems(str(d / "sv.h5"), str(want / "sv.h5"))


class _Foreign:
    pass


@pytest.mark.parametrize("payload", ["global", "object_column"])
def test_a_pickle_outside_the_table_exits_2_and_names_it(world, tmp_path, caplog, payload):
    if payload == "global":
        data = pickle.dumps({"type_counts": _Foreign()})
        name = f"{__name__}._Foreign"
    else:  # an object column of strings where the reader reads float arrays alone
        col = np.empty(2, dtype=object)
        col[:] = ["a", "b"]
        frame = pp.Table({"thresholds": col}, pp.str_labels(["x", "y"]))
        data = pp.dumps({"concordance": frame})
        name = "thresholds"
    (tmp_path / "bad.pkl").write_bytes(data)
    assert trep.run(["--statistics_file", str(tmp_path / "bad.pkl"), "--h5_output", str(tmp_path / "r.h5")]) == 2
    assert name in caplog.text
    with pytest.raises(pp.UnsupportedPickle, match=name.replace(".", r"\.")):
        pp.loads(data)


def test_committed_reference_pickle_is_current_and_read(tmp_path):
    """The committed pickle equals the JAX tool's regenerated from its seed
    (loaded with pandas), and the port reads it to the frames of its own
    ``sv_stats_collect`` on the same world."""
    w = torch_worlds.write_sv_reference_pickle(tmp_path / "fresh.pkl", world_dir=str(tmp_path / "w"))
    with open(torch_worlds.SV_REFERENCE_PICKLE, "rb") as fh:
        committed = pickle.load(fh)
    with open(tmp_path / "fresh.pkl", "rb") as fh:
        fresh = pickle.load(fh)
    _pandas_equal(committed, fresh)
    assert tsv.run([w["vcf"], str(tmp_path / "own.pkl"), "--concordance_h5", w["concordance_h5"]]) == 0
    assert _same(pp.loads(torch_worlds.SV_REFERENCE_PICKLE.read_bytes()), pp.loads((tmp_path / "own.pkl").read_bytes()))


def test_histograms_count_the_planted_records(world):
    """The port's histograms against a count of the plant."""
    h = tsv.collect_size_type_histograms(world["vcf"])
    keep = world["pass"]
    types, lens = world["svtype"][keep], np.nan_to_num(world["svlen"][keep], nan=0.0)
    assert dict(zip(h["type_counts"].index.values.tolist(), h["type_counts"].values.tolist())) == \
        {t: int((types == t).sum()) for t in set(types.tolist())}
    codes = np.searchsorted(np.asarray(tsv.SVBINS), np.abs(lens), side="right") - 1
    assert h["length_counts"].values.tolist() == np.bincount(codes, minlength=11).tolist()
    assert "CTX" not in h["length_by_type_counts"].index.values.tolist()
