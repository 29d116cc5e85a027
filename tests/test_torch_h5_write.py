"""The port's HDF5 writer (``io/hdf5.write_file``) and ``utils/h5_utils.write_hdf``
against h5py and the JAX package's ``write_hdf``/``read_hdf``.

The same frames go through both packages' ``write_hdf``; the files are read
by h5py (every dataset and attribute), by the JAX package's ``read_hdf``
(``pandas.testing.assert_frame_equal``, dtypes included) and by the port's
reader. Covered: every column kind (``fstr``, ``str``, ``bool``, each
integer and float width, ``ragged``), None, the ``__index__`` rule as pandas
3 applies it to row subsets and concatenations, ``mode="a"`` (a key added or
replaced, the others kept), empty frames, groups of more than 256 members
(B-trees of two levels), and a file the reader refuses, which ``"a"`` leaves
as it was.
"""

import os

import h5py
import numpy as np
import pandas as pd
import pytest

from variantcalling_tpu.utils import h5_utils as jh5
from variantcalling_tpu_torch.io import hdf5
from variantcalling_tpu_torch.utils import h5_utils as th5


def _columns(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    ragged = np.empty(n, dtype=object)
    ragged[:] = [rng.random(int(k)) for k in rng.integers(0, 5, n)]
    return {
        "fstr": rng.choice(["chr1", "chr20", "chrX"], n).astype(object),
        "with_none": np.asarray([None if i % 5 == 0 else f"v{i}" for i in range(n)], dtype=object),
        "long_str": np.asarray(["x" * 200 if i % 7 == 0 else f"s{i}" for i in range(n)], dtype=object),
        "unicode": np.asarray([f"é{i}ß" for i in range(n)], dtype=object),
        "flag": rng.random(n) < 0.5,
        "i8": rng.integers(-100, 100, n).astype(np.int8),
        "i32": rng.integers(-1000, 1000, n).astype(np.int32),
        "i64": rng.integers(-10**12, 10**12, n),
        "u16": rng.integers(0, 60000, n).astype(np.uint16),
        "u64": rng.integers(0, 2**62, n).astype(np.uint64),
        "f16": rng.random(n).astype(np.float16),
        "f32": rng.random(n).astype(np.float32),
        "f64": np.where(rng.random(n) < 0.1, np.nan, rng.random(n)),
        "ragged": ragged,
    }


def _df(cols: dict, index=None) -> pd.DataFrame:
    df = pd.DataFrame({k: (pd.Series(v, dtype=object) if k == "ragged" else v) for k, v in cols.items()})
    if index is not None:
        df.index = index
    return df


def _read_all_with_h5py(path) -> int:
    """Every dataset and attribute of the file through h5py; the count of objects."""
    seen = []
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            seen.append(name)
            for v in obj.attrs.values():
                assert v is not None
            if isinstance(obj, h5py.Dataset):
                obj[()]
        f.visititems(visit)
    return len(seen)


def _both(tmp_path, frame: th5.Frame, df: pd.DataFrame, key: str = "k", mode: str = "w"):
    port, ref = tmp_path / "port.h5", tmp_path / "ref.h5"
    th5.write_hdf(frame, str(port), key, mode=mode)
    jh5.write_hdf(df, str(ref), key, mode=mode)
    return port, ref


def _assert_same_file_frames(port, ref, keys) -> None:
    assert jh5.list_keys(str(port)) == jh5.list_keys(str(ref)) == th5.list_keys(str(port))
    for key in keys:
        pd.testing.assert_frame_equal(jh5.read_hdf(str(port), key), jh5.read_hdf(str(ref), key))
        with h5py.File(port) as fp, h5py.File(ref) as fr:
            assert json_attrs(fp[key]) == json_attrs(fr[key])


def json_attrs(g) -> dict:
    return {k: (v if isinstance(v, str) else int(v)) for k, v in g.attrs.items()}


@pytest.mark.parametrize("n_rows", [0, 1, 40])
def test_every_kind_reads_as_the_reference_writes_it(tmp_path, n_rows):
    cols = _columns(n_rows, n_rows)
    port, ref = _both(tmp_path, th5.Frame(cols), _df(cols))
    assert _read_all_with_h5py(port) == _read_all_with_h5py(ref)
    _assert_same_file_frames(port, ref, ["k"])
    got = th5.read_hdf(str(port), "k")
    assert got.columns == list(cols) and got.index is None
    want = jh5.read_hdf(str(ref), "k")
    for name in cols:  # the port's reader gives the JAX package's values (None for a missing string)
        a, b = got[name], want[name].to_numpy()
        if a.dtype == object:
            assert all((x is None and (y is None or y != y)) or np.array_equal(x, y) for x, y in zip(a, b)), name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    with h5py.File(port) as fp, h5py.File(ref) as fr:
        for name in cols:  # the same layout: datasets of the same types and shapes
            a, b = fp["k"][name], fr["k"][name]
            assert type(a) is type(b), name
            if isinstance(a, h5py.Dataset):
                assert a.dtype == b.dtype and a.shape == b.shape, name


@pytest.mark.parametrize("rows", [[0, 1, 2], [3, 4], [0, 2, 4], [5], [0], [], [1, 2, 5], [0, 3, 6, 9]])
def test_index_of_a_row_subset_follows_pandas(tmp_path, rows):
    """pandas 3 keeps a RangeIndex for equally spaced kept rows; only
    RangeIndex(0, n, 1) goes unwritten."""
    cols = _columns(10, 1)
    mask = np.zeros(10, dtype=bool)
    mask[rows] = True
    frame, df = th5.Frame(cols).take(mask), _df(cols)[mask]
    want = df.index
    if isinstance(want, pd.RangeIndex):
        assert frame.index == range(want.start, want.stop, want.step)
    else:
        assert list(frame.index) == list(want)
    port, ref = _both(tmp_path, frame, df)
    with h5py.File(port) as fp, h5py.File(ref) as fr:
        assert ("__index__" in fp["k"]) == ("__index__" in fr["k"])
    _assert_same_file_frames(port, ref, ["k"])
    # a subset of the subset, as training_prep takes one per contig
    sub = np.arange(len(df)) % 2 == 0
    port2, ref2 = _both(tmp_path, frame.take(sub), df[sub], key="again")
    _assert_same_file_frames(port2, ref2, ["again"])


@pytest.mark.parametrize("index", ["ints", "strings", "range_from_3", "range_step_2"])
def test_explicit_index_is_written(tmp_path, index):
    cols = _columns(6, 2)
    values = {"ints": np.asarray([10, 11, 15, 3, 2, 1]), "strings": np.asarray([f"r{i}" for i in range(6)]),
              "range_from_3": range(3, 9), "range_step_2": range(0, 12, 2)}[index]
    pidx = pd.RangeIndex(values.start, values.stop, values.step) if isinstance(values, range) else values
    port, ref = _both(tmp_path, th5.Frame(cols, values), _df(cols, pidx))
    _assert_same_file_frames(port, ref, ["k"])
    assert list(th5.read_hdf(str(port), "k").index) == list(jh5.read_hdf(str(ref), "k").index)


def test_concat_index_follows_pandas(tmp_path):
    """``read_hdf(key="all")`` over keys stacks their indexes as pd.concat does,
    and a frame written from it writes that index."""
    a, b, c = _columns(3, 3), _columns(2, 4), _columns(0, 5)
    port, ref = tmp_path / "p.h5", tmp_path / "r.h5"
    for path, write, make in ((port, th5.write_hdf, th5.Frame), (ref, jh5.write_hdf, _df)):
        write(make(a), str(path), "a", mode="w")
        write(make(b), str(path), "b", mode="a")
        write(make(c), str(path), "c", mode="a")
    got, want = th5.read_hdf(str(port)), jh5.read_hdf(str(ref))
    assert list(got.index) == list(want.index) and not isinstance(got.index, range)
    th5.write_hdf(got, str(port), "all_again", mode="a")
    jh5.write_hdf(want, str(ref), "all_again", mode="a")
    _assert_same_file_frames(port, ref, ["a", "b", "c", "all_again"])
    frames = [th5.Frame({"x": np.arange(k)}, idx) for k, idx in ((2, None), (0, None), (3, range(2, 5)))]
    dfs = [pd.DataFrame({"x": np.arange(k)}, index=pd.RangeIndex(i.start, i.stop) if i else None)
           for k, i in ((2, None), (0, None), (3, range(2, 5)))]
    got_idx, want_idx = th5._concat_index(frames), pd.concat(dfs).index
    assert isinstance(want_idx, pd.RangeIndex) and got_idx == range(want_idx.start, want_idx.stop, want_idx.step)


def test_mode_a_adds_and_replaces_keys(tmp_path):
    port, ref = tmp_path / "p.h5", tmp_path / "r.h5"
    for i, key in enumerate(["first", "second", "first", "third"]):
        cols = _columns(5 + i, 10 + i)
        mode = "w" if i == 0 else "a"
        th5.write_hdf(th5.Frame(cols), str(port), key, mode=mode)
        jh5.write_hdf(_df(cols), str(ref), key, mode=mode)
    _assert_same_file_frames(port, ref, ["first", "second", "third"])
    assert len(th5.read_hdf(str(port), "first")) == 7
    th5.write_hdf(th5.Frame({"x": np.arange(3)}), str(port), "only", mode="w")
    assert th5.list_keys(str(port)) == ["only"]


def test_mode_a_keeps_an_h5py_file_readable(tmp_path):
    """A file written by h5py (the JAX package's writer) gains a key."""
    ref = tmp_path / "r.h5"
    jh5.write_hdf(_df(_columns(8, 20)), str(ref), "theirs", mode="w")
    th5.write_hdf(th5.Frame(_columns(4, 21)), str(ref), "ours", mode="a")
    _read_all_with_h5py(ref)
    pd.testing.assert_frame_equal(jh5.read_hdf(str(ref), "theirs"), _df(_columns(8, 20)))
    pd.testing.assert_frame_equal(jh5.read_hdf(str(ref), "ours"), _df(_columns(4, 21)))


@pytest.mark.parametrize("n_members", [0, 9, 257, 300])
def test_groups_of_many_members(tmp_path, n_members):
    """Symbol nodes hold 8 links and a B-tree node 32 children: 257 and more
    members need a second B-tree level."""
    root = hdf5.WGroup(members={f"d{i:04d}": hdf5.WDataset(np.arange(i % 5)) for i in range(n_members)})
    root.members["sub"] = hdf5.WGroup({"a": 1}, {f"s{i}": hdf5.WDataset(np.full(2, i)) for i in range(n_members)})
    path = tmp_path / "many.h5"
    hdf5.write_file(str(path), root)
    with h5py.File(path) as f:
        assert sorted(f.keys()) == sorted(root.members)
        assert len(f["sub"]) == n_members
        for i in range(0, n_members, 37):
            assert np.array_equal(f[f"d{i:04d}"][()], np.arange(i % 5))
            assert np.array_equal(f["sub"][f"s{i}"][()], np.full(2, i))
    with hdf5.H5File(str(path)) as f:
        assert sorted(f.root.keys()) == sorted(root.members)


def test_attributes_and_strings_read_by_h5py(tmp_path):
    many = np.empty(70_000, dtype=object)  # past one global heap collection's 65,535 objects
    many[:] = [f"s{i}" * (1 + i % 3) for i in range(70_000)]
    root = hdf5.WGroup({"int": 7, "float": 2.5, "text": "héllo", "fixed": np.bytes_(b"abc"),
                        "arr": np.arange(4, dtype=np.int16)},
                       {"vlen": hdf5.WDataset(many, {"note": "x"}), "fixed": hdf5.WDataset(np.asarray([b"ab", b"c"])),
                        "empty_vlen": hdf5.WDataset(np.empty(0, dtype=object)),
                        "two_d": hdf5.WDataset(np.arange(12.0).reshape(3, 4))})
    path = tmp_path / "attrs.h5"
    hdf5.write_file(str(path), root)
    with h5py.File(path) as f:
        assert f.attrs["int"] == 7 and f.attrs["float"] == 2.5 and f.attrs["text"] == "héllo"
        assert f.attrs["fixed"] == b"abc" and np.array_equal(f.attrs["arr"], np.arange(4))
        got = f["vlen"].asstr()[()]
        assert list(got) == list(many) and f["vlen"].attrs["note"] == "x"
        assert list(f["fixed"][()]) == [b"ab", b"c"] and f["empty_vlen"].shape == (0,)
        assert np.array_equal(f["two_d"][()], np.arange(12.0).reshape(3, 4))
    with hdf5.H5File(str(path)) as f:
        assert [v.decode() for v in f.root["vlen"].read()] == list(many)


def test_unreadable_file_is_refused_by_name_and_left_as_it_was(tmp_path):
    path = tmp_path / "latest.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(3))
    before = path.read_bytes()
    with pytest.raises(hdf5.H5Unsupported, match="superblock version"):
        th5.write_hdf(th5.Frame({"x": np.arange(2)}), str(path), "k", mode="a")
    assert path.read_bytes() == before and not [p for p in os.listdir(tmp_path) if ".tmp." in p]


def test_nul_in_strings_refused_as_the_reference_refuses(tmp_path):
    cols = {"s": np.asarray(["a\x00b", "c"], dtype=object)}
    with pytest.raises(ValueError, match="NUL"):
        th5.write_hdf(th5.Frame(cols), str(tmp_path / "p.h5"), "k", mode="w")
    with pytest.raises(ValueError, match="NUL"):
        jh5.write_hdf(_df(cols), str(tmp_path / "r.h5"), "k", mode="w")


def test_write_frames_equals_keys_written_one_after_the_other(tmp_path):
    frames = {f"chr{i}": th5.Frame(_columns(3 + i, 30 + i)).take(np.arange(3 + i) % 2 == 1) for i in range(4)}
    th5.write_frames(str(tmp_path / "once.h5"), frames)
    for i, (key, frame) in enumerate(frames.items()):
        th5.write_hdf(frame, str(tmp_path / "each.h5"), key, mode="w" if i == 0 else "a")
    _assert_same_file_frames(tmp_path / "once.h5", tmp_path / "each.h5", list(frames))
