"""Frames stored in HDF5, read and written without h5py or pandas.

Counterpart of ``variantcalling_tpu/utils/h5_utils.py`` (its ``list_keys``,
``read_hdf`` and ``write_hdf``) over the port's own parser and writer
(:mod:`io.hdf5`). It reads the same two layouts:

- the JAX package's own: one group per key with a ``vctpu_frame``
  attribute, one dataset per column, the column order and each column's
  kind (``fstr``, ``str``, ``bool``, ``ragged``, a numpy kind letter) in the
  JSON attributes ``columns`` and ``kinds``, and a non-trivial index as the
  ``__index__`` pseudo-column;
- pandas ``to_hdf(format="fixed")`` frames written by pytables: ``axis0``
  (the columns), ``axis1`` (the index), and per dtype block
  ``blockN_items``/``blockN_values``, the values stored transposed, object
  blocks as one pickled ndarray in a VLArray (``PSEUDOATOM``), an empty
  frame as (1, 1) placeholders.

With no pandas, a frame is a :class:`Frame`: an ordered mapping of numpy
columns and an index. It writes the first layout (:func:`write_hdf`), the
column kinds chosen by the reference's rules, and its index where pandas
would hold one that is not ``RangeIndex(0, n, 1)``: :class:`Frame` follows
pandas' rules for the index of a row subset and of a concatenation.
"""

from __future__ import annotations

import csv
import json
import os
import pickle

import numpy as np

from variantcalling_tpu_torch.io import hdf5

_FORMAT_ATTR = "vctpu_frame"
#: keys of a ``run_comparison`` h5 that hold no callset rows: ``key="all"`` readers skip them
CONCORDANCE_SKIP_KEYS = ["concordance", "scored_concordance", "input_args", "comparison_result"]
# the JAX package's sentinel of a missing string (h5py strings reject NUL)
_NULL = "\x01null\x01"


class Frame:
    """Named numpy columns of equal length, in order, and an index: None
    (the rows numbered from 0), a ``range`` (a pandas ``RangeIndex``) or an
    array (any other pandas index)."""

    def __init__(self, columns: dict[str, np.ndarray], index: np.ndarray | range | None = None):
        self.data = dict(columns)
        self.index = index

    @property
    def columns(self) -> list[str]:
        return list(self.data)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.data[name]

    def __setitem__(self, name: str, values) -> None:
        """Set a column: an array of the frame's length, or a scalar broadcast
        to it (pandas' ``df[name] = 1`` gives an int64 column)."""
        values = np.asarray(values)
        self.data[name] = np.full(len(self), values) if values.ndim == 0 else values

    def __contains__(self, name: str) -> bool:
        return name in self.data

    def __len__(self) -> int:
        if self.data:
            return len(next(iter(self.data.values())))
        return 0 if self.index is None else len(self.index)

    def select(self, names) -> "Frame":
        """The columns of ``names`` that this frame has, in that order."""
        return Frame({n: self.data[n] for n in names if n in self.data}, self.index)

    def take(self, keep: np.ndarray) -> "Frame":
        """The rows of ``keep`` (a boolean mask or ascending positions), with
        the index pandas gives such a subset (:func:`_take_index`)."""
        keep = np.asarray(keep)
        pos = np.flatnonzero(keep) if keep.dtype == bool else keep.astype(np.int64)
        return Frame({n: c[pos] for n, c in self.data.items()}, _take_index(self.index, len(self), pos))

    def to_csv(self, path: str, sep: str = ",") -> None:
        """The file pandas' ``to_csv(path, sep=sep, index=False)`` writes: a
        header of the column names, then the rows through :mod:`csv` with
        pandas' dialect (minimal quoting, ``os.linesep``). Values as pandas
        renders them: floats (float64 and float32 alike) by numpy's
        ``astype(str)``, the shortest text that reads back to the same
        value; ints and ``True``/``False`` as Python prints them; an empty
        field for NaN and for a missing object."""

        def text(col: np.ndarray) -> list:
            if col.dtype.kind == "f":
                out = col.astype(str).astype(object)
                out[np.isnan(col)] = ""
                return out.tolist()
            if col.dtype.kind in "biu":
                return col.tolist()
            return ["" if _missing(v) else v for v in col]

        with open(path, "w", encoding="utf-8", newline="") as fh:
            writer = csv.writer(fh, delimiter=sep, lineterminator=os.linesep, quoting=csv.QUOTE_MINIMAL)
            writer.writerow(self.columns)
            writer.writerows(zip(*(text(np.asarray(self.data[n])) for n in self.columns)))


def _take_index(index, n: int, pos: np.ndarray):
    """The index of rows ``pos`` of a frame of ``n`` rows with ``index``, as
    pandas builds it: a range stays a range where the kept rows are equally
    spaced (one row: a range of one step; none: ``range(0, 0)``), an array
    index is subset."""
    if index is None:
        index = range(n)
    if not isinstance(index, range):
        return np.asarray(index)[pos]
    if len(pos) == 0:
        return range(0, 0)
    start = index[int(pos[0])]
    if len(pos) == 1:
        return range(start, start + index.step, index.step)
    gaps = np.diff(pos)
    if (gaps == gaps[0]).all():
        step = index.step * int(gaps[0])
        return range(start, index[int(pos[-1])] + step, step)
    return np.asarray(index)[pos]


def _index_values(index, n: int) -> np.ndarray:
    return np.arange(n) if index is None else np.asarray(index)


def _concat_index(frames: list["Frame"]):
    """The index ``pd.concat`` gives frames stacked: a range where every
    frame's index is a range and the non-empty ones continue each other
    with one step, else the values one after the other."""
    ranges = [range(len(f)) if f.index is None else f.index for f in frames]
    values = np.concatenate([_index_values(f.index, len(f)) for f in frames]) if frames else np.arange(0)
    if not all(isinstance(r, range) for r in ranges):
        return values
    start = step = nxt = None
    full = [r for r in ranges if len(r)]
    for r in full:
        if start is None:
            start = r.start
            if len(r) > 1:
                step = r.step
        elif step is None:
            if r.start == start:
                return values
            step = r.start - start
        if (step != r.step and len(r) > 1) or (nxt is not None and r.start != nxt):
            return values
        if step is not None:
            nxt = r[-1] + step
    if not full:
        return range(0, 0)
    stop = full[-1].stop if nxt is None else nxt
    if len(full) == 1:
        step = full[0].step
    return range(start, stop, step)


def object_column(values) -> np.ndarray:
    """``values`` as a 1-D object array (a string column of a :class:`Frame`)."""
    out = np.empty(len(values), dtype=object)
    out[:] = list(values)
    return out


def _decode_column(node, kind: str) -> np.ndarray:
    if kind == "ragged":
        flat, offsets = node["values"][()], node["offsets"][()]
        return object_column([flat[offsets[i]: offsets[i + 1]] for i in range(len(offsets) - 1)])
    data = node[()]
    if kind == "fstr":
        try:  # ASCII bytes (the common case) widen to str in one C cast
            text = data.astype(f"U{max(data.dtype.itemsize, 1)}")
        except UnicodeDecodeError:
            text = np.char.decode(data, "utf-8")
        out = text.astype(object)
        out[text == _NULL] = None
        return out
    if kind == "str":
        out = object_column([v.decode() if isinstance(v, bytes) else str(v) for v in data])
        return np.where(out == _NULL, None, out)
    if kind == "bool":
        return data.astype(bool)
    return data


def _text(v, encoding: str = "utf-8"):
    return v.decode(encoding, "replace") if isinstance(v, bytes) else v


def _is_pytables_frame(g) -> bool:
    return isinstance(g, hdf5.Group) and _text(g.attrs.get("pandas_type", b"")) == "frame"


def _is_frame_group(g) -> bool:
    """A group this reader can decode: the JAX package's layout or a pytables frame."""
    return isinstance(g, hdf5.Group) and (_FORMAT_ATTR in g.attrs or _is_pytables_frame(g))


def _read_pytables_frame(g: hdf5.Group) -> Frame:
    """A pandas ``to_hdf(format="fixed")`` frame (see the module docstring),
    decoded as the JAX package's ``_read_pytables_frame`` decodes it. Object
    blocks are unpickled: the same trust as the model pickles."""
    encoding = _text(g.attrs.get("encoding", b"utf-8"))

    def arr(ds) -> np.ndarray:
        a = ds[()]
        if a.dtype == object or ds.attrs.get("PSEUDOATOM") is not None:
            parts = [pickle.loads(bytes(bytearray(e))) for e in a]
            a = np.asarray(parts[0] if len(parts) == 1 else np.concatenate(parts))
        if ds.attrs.get("transposed", False):
            a = a.T
        return a

    def destring(col: np.ndarray) -> np.ndarray:
        if col.dtype.kind == "S" or (col.dtype == object and len(col) and isinstance(col[0], bytes)):
            return object_column([_text(v, encoding) for v in col])
        return col

    nblocks = int(g.attrs.get("nblocks", 0))
    order = [_text(x, encoding) for x in g["axis0"][()]]
    idx = arr(g["axis1"]) if "axis1" in g else np.empty(0)
    n_rows = len(idx)
    cols: dict[str, np.ndarray] = {}
    for b in range(nblocks):
        items = [_text(x, encoding) for x in g[f"block{b}_items"][()]]
        values = arr(g[f"block{b}_values"])  # (n_items, n_rows) after un-transposing
        if values.ndim != 2:
            values = values.reshape(len(items), -1)
        for j, name in enumerate(items):
            # an empty frame stores (1, 1) placeholder blocks: every column is empty
            col = values[j, :n_rows] if j < values.shape[0] and n_rows else np.empty(0, dtype=values.dtype)
            cols[name] = destring(np.asarray(col))
    frame = Frame({name: cols[name] for name in order if name in cols})
    if n_rows == len(frame):
        frame.index = np.asarray([_text(v, encoding) for v in idx])
    return frame


def _read_frame(g: hdf5.Group) -> Frame:
    if _FORMAT_ATTR not in g.attrs and _is_pytables_frame(g):
        return _read_pytables_frame(g)
    kinds = json.loads(g.attrs["kinds"])
    names = json.loads(g.attrs["columns"])
    frame = Frame({name: _decode_column(g[name], kinds.get(name, "f")) for name in names})
    if "__index__" in g:
        frame.index = _decode_column(g["__index__"], kinds.get("__index__", "f"))
    return frame


def concat_frames(frames: list[Frame]) -> Frame:
    """Frames one after the other, as ``pd.concat`` stacks them: the union of
    their columns in order of first appearance, a column that a frame lacks
    filled with NaN there (None in a column of strings or objects), and the
    index pandas builds (:func:`_concat_index`)."""
    names = list(dict.fromkeys(n for f in frames for n in f.columns))
    cols = {}
    for name in names:
        parts = []
        for f in frames:
            if name in f:
                parts.append(f[name])
            else:
                like = next(g[name] for g in frames if name in g)
                fill = np.full(len(f), np.nan) if like.dtype.kind in "biuf" else object_column([None] * len(f))
                parts.append(fill)
        cols[name] = np.concatenate(parts)
    return Frame(cols, _concat_index(frames))


def list_keys(path: str) -> list[str]:
    """The keys of ``path`` that hold frames, sorted."""
    with hdf5.H5File(path) as f:
        return sorted(k for k in f.root.keys() if _is_frame_group(f.root[k]))


def read_hdf(path: str, key: str = "all", skip_keys: list[str] | None = None, columns_subset=None) -> Frame:
    """Read one key, or, for ``key="all"`` where the file has no such key,
    every frame key but ``skip_keys`` stacked in sorted key order."""
    skip = set(skip_keys or [])
    with hdf5.H5File(path) as f:
        root = f.root
        if key in root:
            frame = _read_frame(root[key])
        elif key == "all":
            frames = [_read_frame(root[k]) for k in sorted(root.keys())
                      if k not in skip and _is_frame_group(root[k])]
            if not frames:
                raise KeyError(f"no frames in {path}")
            frame = concat_frames(frames)
        else:
            raise KeyError(f"key {key!r} not in {path}")
    if columns_subset is not None:
        frame = frame.select(columns_subset)
    return frame


# -- the write half -----------------------------------------------------------


def _missing(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and v != v)


def _encode_column(vals: np.ndarray):
    """(data, kind) of one column, by the reference's rules: array-valued
    objects -> ``ragged`` (float64 values, int64 offsets); strings -> the
    ``\x01null\x01`` sentinel for a missing value, then ``fstr``
    (fixed-width UTF-8) unless one outlier would blow up the width, else
    ``str`` (variable-length); booleans -> uint8 ``bool``; numbers as they
    are, under their numpy kind letter."""
    if vals.dtype == object and len(vals) and isinstance(vals[0], (np.ndarray, list)):
        arrays = [np.asarray(v, dtype=np.float64).ravel() for v in vals]
        offsets = np.zeros(len(arrays) + 1, dtype=np.int64)
        np.cumsum([len(a) for a in arrays], out=offsets[1:])
        flat = np.concatenate(arrays) if arrays else np.array([], dtype=np.float64)
        return (flat, offsets), "ragged"
    if vals.dtype == object or vals.dtype.kind in ("U", "S"):
        if not (vals.dtype == object and len(vals) and set(map(type, vals)) == {str}):
            vals = object_column([_NULL if _missing(v) else str(v) for v in vals])
        return _encode_strings(vals)
    if vals.dtype.kind == "b":
        return vals.astype(np.uint8), "bool"
    return vals, vals.dtype.kind


def _encode_strings(vals: np.ndarray):
    """(data, kind) of an object column of ``str`` alone: ``fstr`` unless the
    widest value is over 64 characters and over four times the mean length
    plus one, else ``str``; a NUL anywhere in a value is refused. The
    fixed-width copy is made only once the width is chosen."""
    n = len(vals)
    lens = np.fromiter(map(len, vals), np.int64, count=n)
    width = max(int(lens.max()) if n else 1, 1)
    if width > 64 and width * n > 4 * (int(lens.sum()) + n):
        return vals, "str"
    fixed = vals.astype(f"U{width}")
    codes = fixed.view(np.uint32).reshape(n, width)  # code points, 0-padded
    # a NUL inside a value, or at its end (which the fixed-width copy drops)
    if (codes[np.arange(width) < lens[:, None]] == 0).any():
        raise ValueError("NUL bytes in string column are not storable")
    if not n or int(codes.max()) < 128:  # ASCII: the UTF-8 bytes are the code points
        return codes.astype(np.uint8).view(f"S{width}").ravel(), "fstr"
    return np.char.encode(fixed, "utf-8"), "fstr"


def _frame_group(frame: Frame) -> hdf5.WGroup:
    """The reference's ``vctpu_frame`` group of a frame: one dataset a
    column (a ``ragged`` one a group of ``values`` and ``offsets``), the
    index as ``__index__`` unless it is ``RangeIndex(0, n, 1)``, the column
    order and kinds as JSON attributes."""
    names = [str(c) for c in frame.columns]
    kinds: dict[str, str] = {}
    members: dict = {}

    def put(name: str, data) -> None:
        if isinstance(data, tuple):
            members[name] = hdf5.WGroup(members={"values": hdf5.WDataset(data[0]),
                                                 "offsets": hdf5.WDataset(data[1])})
        else:
            members[name] = hdf5.WDataset(data)

    idx = frame.index
    if not (idx is None or (isinstance(idx, range) and idx.start == 0 and idx.step == 1)):
        raw = np.asarray(idx)
        if raw.dtype.kind not in "biufc":
            raw = raw.astype(object)
        data, kinds["__index__"] = _encode_column(raw)
        put("__index__", data)
    for col, name in zip(frame.columns, names):
        data, kinds[name] = _encode_column(np.asarray(frame[col]))
        put(name, data)
    return hdf5.WGroup({_FORMAT_ATTR: 1, "columns": json.dumps(names), "kinds": json.dumps(kinds)}, members)


def write_hdf(frame: Frame, path: str, key: str, mode: str = "a") -> None:
    """Write ``frame`` under ``key`` (``mode="w"``: a new file; ``"a"``: the
    file's other keys kept, ``key`` added or replaced). The file is written
    whole: ``"a"`` reads the existing file back first (:func:`hdf5.read_tree`),
    so a file the reader refuses raises :class:`hdf5.H5Unsupported` and is
    left as it was."""
    if mode not in ("w", "a"):
        raise ValueError(f"mode {mode!r} (expected 'w' or 'a')")
    root = hdf5.read_tree(path) if mode == "a" and os.path.exists(path) else hdf5.WGroup()
    root.members[key] = _frame_group(frame)
    hdf5.write_file(path, root)


def write_frames(path: str, frames: dict[str, Frame]) -> None:
    """A new file holding each frame under its key: the file ``write_hdf``
    gives for the keys one after the other (``"w"``, then ``"a"``), written
    once."""
    hdf5.write_file(path, hdf5.WGroup(members={key: _frame_group(f) for key, f in frames.items()}))
