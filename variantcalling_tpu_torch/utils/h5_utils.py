"""Frames stored in HDF5, read without h5py or pandas (the read half).

Counterpart of ``variantcalling_tpu/utils/h5_utils.py`` (its ``list_keys``
and ``read_hdf``) over the port's own parser (:mod:`io.hdf5`). It reads the
same two layouts:

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
columns and an optional index. The write half (``write_hdf``) is not
ported.
"""

from __future__ import annotations

import json
import pickle

import numpy as np

from variantcalling_tpu_torch.io import hdf5

_FORMAT_ATTR = "vctpu_frame"
# the JAX package's sentinel of a missing string (h5py strings reject NUL)
_NULL = "\x01null\x01"


class Frame:
    """Named numpy columns of equal length, in order, and an optional index
    (None: the rows are numbered from 0)."""

    def __init__(self, columns: dict[str, np.ndarray], index: np.ndarray | None = None):
        self.data = dict(columns)
        self.index = index

    @property
    def columns(self) -> list[str]:
        return list(self.data)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.data[name]

    def __contains__(self, name: str) -> bool:
        return name in self.data

    def __len__(self) -> int:
        if self.data:
            return len(next(iter(self.data.values())))
        return 0 if self.index is None else len(self.index)

    def select(self, names) -> "Frame":
        """The columns of ``names`` that this frame has, in that order."""
        return Frame({n: self.data[n] for n in names if n in self.data}, self.index)


def _obj(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = list(values)
    return out


def _decode_column(node, kind: str) -> np.ndarray:
    if kind == "ragged":
        flat, offsets = node["values"][()], node["offsets"][()]
        return _obj([flat[offsets[i]: offsets[i + 1]] for i in range(len(offsets) - 1)])
    data = node[()]
    if kind == "fstr":
        out = np.char.decode(data, "utf-8").astype(object)
        return np.where(out == _NULL, None, out)
    if kind == "str":
        out = _obj([v.decode() if isinstance(v, bytes) else str(v) for v in data])
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
            return _obj([_text(v, encoding) for v in col])
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


def _concat(frames: list[Frame]) -> Frame:
    """Frames one after the other, as ``pd.concat`` stacks them: the union of
    their columns in order of first appearance, a column that a frame lacks
    filled with NaN there (None in a column of strings or objects), and each
    frame's own index (its row numbers where it has none)."""
    names = list(dict.fromkeys(n for f in frames for n in f.columns))
    cols = {}
    for name in names:
        parts = []
        for f in frames:
            if name in f:
                parts.append(f[name])
            else:
                like = next(g[name] for g in frames if name in g)
                fill = np.full(len(f), np.nan) if like.dtype.kind in "biuf" else _obj([None] * len(f))
                parts.append(fill)
        cols[name] = np.concatenate(parts)
    index = None
    if any(f.index is not None for f in frames):
        index = np.concatenate([np.arange(len(f)) if f.index is None else f.index for f in frames])
    return Frame(cols, index)


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
            frame = _concat(frames)
        else:
            raise KeyError(f"key {key!r} not in {path}")
    if columns_subset is not None:
        frame = frame.select(columns_subset)
    return frame
