"""The port's HDF5 reader (``io/hdf5``) and frame reader (``utils/h5_utils``)
against h5py and the JAX package's ``read_hdf``.

Files are written here by the JAX package's ``write_hdf`` (every column
kind), by h5py directly (chunked datasets with and without gzip + shuffle,
attributes of each type), and by hand in the pytables ``format="fixed"``
layout (``tests/torch_worlds.write_pytables_frame``), empty frames
included. Values must be equal, element for element; files with features
the reader lacks raise :class:`H5Unsupported` naming them. The committed
blacklists under ``tests/torch_data/`` hold the loci their stated seed draws.
"""

import h5py
import numpy as np
import pandas as pd
import pytest

from tests import torch_worlds
from variantcalling_tpu.utils import h5_utils as jh5
from variantcalling_tpu_torch.io import hdf5
from variantcalling_tpu_torch.utils import h5_utils as th5


def _same(got: np.ndarray, want: np.ndarray) -> bool:
    """Element for element, NaN equal to NaN, arrays inside object columns compared whole."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return False
    if want.dtype == object or got.dtype == object:
        return all(np.array_equal(g, w) if isinstance(w, np.ndarray) else
                   (g is None and w is None) or g == w or (g != g and w != w) for g, w in zip(got, want))
    return np.array_equal(got, want, equal_nan=want.dtype.kind == "f")


def _assert_frame(frame: th5.Frame, df: pd.DataFrame) -> None:
    assert frame.columns == [str(c) for c in df.columns]
    for c in df.columns:
        want = df[c].to_numpy()
        if isinstance(df[c].dtype, pd.StringDtype):  # pandas' string columns: None for a missing value
            want = np.asarray([None if v is pd.NA or (isinstance(v, float) and v != v) else v for v in df[c]],
                              dtype=object)
        assert _same(frame[c], want), c
    if isinstance(df.index, pd.RangeIndex) and df.index.start == 0 and frame.index is None:
        return
    assert list(frame.index) == list(df.index)


def _frame_df(n: int, seed: int) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "fstr": rng.choice(["chr1", "chr20", "chrX"], n).astype(object),
        "long_str": np.asarray(["x" * 200 if i % 7 == 0 else f"s{i}" for i in range(n)], dtype=object),
        "flag": rng.random(n) < 0.5,
        "i64": rng.integers(-1000, 1000, n),
        "u16": rng.integers(0, 60000, n).astype(np.uint16),
        "f32": rng.random(n).astype(np.float32),
        "f64": np.where(rng.random(n) < 0.1, np.nan, rng.random(n)),
        "ragged": [rng.random(int(k)) for k in rng.integers(0, 5, n)],
    })


@pytest.fixture(scope="module")
def vctpu_store(tmp_path_factory):
    """A multi-key store written by the JAX package: every column kind, a
    string index with a missing-string sentinel, an integer index, a frame
    with other columns."""
    p = tmp_path_factory.mktemp("h5") / "store.h5"
    a = _frame_df(50, 1)
    a.loc[3, "long_str"] = None
    b = _frame_df(20, 2)
    b.index = [f"row{i}" for i in range(20)]
    c = pd.DataFrame({"i64": np.arange(5), "other": np.arange(5.0)}, index=np.arange(10, 15))
    for key, df in (("chr1", a), ("chr2", b), ("extra", c)):
        jh5.write_hdf(df, str(p), key)
    return p


@pytest.mark.parametrize("key", ["chr1", "chr2", "extra"])
def test_every_write_hdf_kind_reads_as_the_reference_reads_it(vctpu_store, key):
    _assert_frame(th5.read_hdf(str(vctpu_store), key=key), jh5.read_hdf(str(vctpu_store), key=key))


def test_list_keys_all_skip_keys_and_columns_subset(vctpu_store):
    p = str(vctpu_store)
    assert th5.list_keys(p) == jh5.list_keys(p) == ["chr1", "chr2", "extra"]
    got = th5.read_hdf(p, key="all", skip_keys=["extra"])
    want = jh5.read_hdf(p, key="all", skip_keys=["extra"])
    _assert_frame(got, want)
    sub = ["i64", "nope", "fstr"]
    _assert_frame(th5.read_hdf(p, key="chr2", columns_subset=sub), jh5.read_hdf(p, key="chr2", columns_subset=sub))
    with pytest.raises(KeyError):
        th5.read_hdf(p, key="chr3")


def test_all_fills_a_column_some_frames_lack(vctpu_store):
    got = th5.read_hdf(str(vctpu_store), key="all", skip_keys=["chr2"])
    want = jh5.read_hdf(str(vctpu_store), key="all", skip_keys=["chr2"])
    assert got.columns == list(want.columns) and len(got) == 55
    assert _same(got["other"], want["other"].to_numpy()) and _same(got["i64"], want["i64"].to_numpy())


@pytest.mark.parametrize("compression", [None, "gzip"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_h5py_chunked_datasets(tmp_path, compression, shuffle):
    p = tmp_path / "c.h5"
    rng = np.random.default_rng(3)
    data = {"i4": rng.integers(-9, 9, (300, 7)).astype(">i4"), "f8": rng.random(1001),
            "u1": rng.integers(0, 255, 999).astype(np.uint8), "s": np.asarray([b"ab", b"c", b"defgh"] * 50)}
    with h5py.File(p, "w") as f:
        for name, a in data.items():
            f.create_dataset(name, data=a, chunks=(16,) + a.shape[1:2] if a.ndim > 1 else (37,),
                             compression=compression, shuffle=shuffle)
        f.create_dataset("unwritten", shape=(50,), dtype="i2", chunks=(8,), fillvalue=-5)
        f.create_dataset("empty", shape=(0,), dtype="f4", chunks=(8,), maxshape=(None,))
        v = f.create_dataset("vlen", shape=(4,), dtype=h5py.vlen_dtype(np.uint8), chunks=(2,), maxshape=(None,),
                             compression=compression, shuffle=shuffle)
        v[0], v[3] = np.arange(9, dtype=np.uint8), np.arange(3000, dtype=np.uint8) % 11
    with hdf5.H5File(str(p)) as h, h5py.File(p) as f:
        assert sorted(h.root.keys()) == sorted(f.keys())
        for name in f:
            got, want = h.root[name][()], f[name][()]
            assert got.dtype == want.dtype and _same(got, want), name


def test_attributes_of_each_type(tmp_path):
    p = tmp_path / "a.h5"
    attrs = {"i8": np.int8(-3), "u32": np.uint32(7), "i64be": np.array(5, dtype=">i8"), "f32": np.float32(1.5),
             "f64be": np.array([1.25, -2.0], dtype=">f8"), "vstr": "héllo", "vstrs": ["a", "bb", ""],
             "fstr": np.bytes_(b"frame"), "fstrs": np.asarray([b"x", b"yz"]), "flag": True,
             "ints": np.arange(6, dtype=np.int32).reshape(2, 3)}
    with h5py.File(p, "w") as f:
        g = f.create_group("g")
        for k, v in attrs.items():
            g.attrs[k] = v
        for i in range(40):  # past one object header block: continuation messages
            g.attrs[f"pad{i:02d}"] = "v" * (i * 3)
    with hdf5.H5File(str(p)) as h, h5py.File(p) as f:
        got, want = h.root["g"].attrs, dict(f["g"].attrs)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            g = got[k]
            assert type(g) is type(w) and np.asarray(g).dtype == np.asarray(w).dtype, k
            assert _same(np.atleast_1d(g), np.atleast_1d(w)), k


@pytest.mark.parametrize("n_rows", [0, 4])
def test_hand_built_pytables_frames(tmp_path, n_rows):
    p = tmp_path / "pt.h5"
    rng = np.random.default_rng(n_rows)
    cols = {"chrom": np.asarray([f"chr{i % 3}" for i in range(n_rows)], dtype=object),
            "pos": rng.integers(1, 10**6, n_rows), "qual": rng.random(n_rows),
            "note": np.asarray([None if i == 1 else ("PASS", i) for i in range(n_rows)], dtype=object)}
    torch_worlds.write_pytables_frame(str(p), "concordance", cols)
    torch_worlds.write_pytables_frame(str(p), "second", {"pos": np.arange(3), "qual": np.ones(3)})
    assert th5.list_keys(str(p)) == jh5.list_keys(str(p)) == ["concordance", "second"]
    got, want = th5.read_hdf(str(p), key="concordance"), jh5.read_hdf(str(p), key="concordance")
    assert got.columns == list(want.columns) == list(cols) and len(got) == n_rows
    for c in cols:
        assert _same(got[c], want[c].to_numpy()), c
    assert list(got.index) == list(want.index)
    all_got, all_want = th5.read_hdf(str(p)), jh5.read_hdf(str(p))
    assert len(all_got) == len(all_want) == n_rows + 3
    assert _same(all_got["qual"], all_want["qual"].to_numpy())


@pytest.mark.parametrize("case,feature", [
    ("latest", "superblock version 3"), ("lzf", "filter 32000"), ("fletcher32", "filter 3"),
    ("compound", "compound datatypes"), ("track_order", "version 2 object headers"),
])
def test_unsupported_features_raise_naming_them(tmp_path, case, feature):
    p = tmp_path / f"{case}.h5"
    with h5py.File(p, "w", libver="latest" if case == "latest" else "earliest",
                   track_order=case == "track_order") as f:
        g = f.create_group("bl")
        g.attrs["vctpu_frame"] = 1
        g.attrs["columns"], g.attrs["kinds"] = '["pos"]', '{"pos": "i"}'
        kw = {"lzf": {"chunks": (4,), "compression": "lzf"}, "fletcher32": {"chunks": (4,), "fletcher32": True}}
        data = np.zeros(10, dtype=[("a", "i4"), ("b", "f8")]) if case == "compound" else np.arange(10)
        g.create_dataset("pos", data=data, **kw.get(case, {}))
    with pytest.raises(hdf5.H5Unsupported, match=feature):
        th5.read_hdf(str(p), key="bl")
    with h5py.File(p) as f:  # h5py reads it: the file is valid
        assert f["bl/pos"].shape == (10,)


def test_not_hdf5_and_truncated_files_raise(tmp_path):
    p = tmp_path / "x.h5"
    p.write_bytes(b"not an hdf5 file at all" * 10)
    with pytest.raises(hdf5.H5Unsupported, match="not an HDF5 file"):
        th5.list_keys(str(p))
    src = torch_worlds.BLACKLIST_FILES["vctpu"].read_bytes()
    p.write_bytes(src[: len(src) // 3])
    with pytest.raises(hdf5.H5Unsupported, match="truncated"):
        th5.read_hdf(str(p), key="blacklist")


@pytest.mark.parametrize("layout", ["vctpu", "pytables"])
def test_committed_blacklists_hold_the_seeded_loci(layout):
    """Each committed fixture, read by the port and by the JAX package, holds
    the loci ``synthetic.blacklist_loci`` draws with the stated seeds."""
    path = str(torch_worlds.BLACKLIST_FILES[layout])
    want = torch_worlds.blacklist_columns()
    assert th5.list_keys(path) == jh5.list_keys(path) == ["blacklist"]
    got, ref = th5.read_hdf(path, key="blacklist"), jh5.read_hdf(path, key="blacklist")
    assert got.columns == list(ref.columns) == ["chrom", "pos"]
    assert len(want["pos"]) == torch_worlds.BLACKLIST_LOCI == len(np.unique(got["pos"]))
    for frame_pos, frame_chrom in ((got["pos"], got["chrom"]), (ref["pos"].to_numpy(), ref["chrom"].to_numpy())):
        assert np.array_equal(frame_pos, want["pos"])
        assert list(frame_chrom) == list(want["chrom"])
