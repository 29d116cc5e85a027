"""pandas Series and DataFrames in a pickle, written and read without pandas.

The reference's ``sv_stats_collect`` pickles a dict of pandas objects and
its ``create_sv_report`` unpickles it. The card's machine has neither
pandas nor pyarrow, so the port holds those objects in its own small types
(:class:`Labels`, :class:`MultiLabels`, :class:`Series`, :class:`Table`)
and moves them through a pickle both ways:

- *Writer* (:func:`dumps`): a ``pickle._Pickler`` whose port objects are
  written as calls of pandas' own constructors, named by ``STACK_GLOBAL``
  without importing pandas: ``pandas.Series(values, index, None, name)``,
  ``pandas.DataFrame(columns, index, column_labels, None)``,
  ``pandas.Index(values, None, False, name)``,
  ``pandas.CategoricalIndex(values, categories, ordered, None, False, name)``,
  ``pandas.Categorical(values, categories, ordered)`` and
  ``pandas.MultiIndex.from_arrays(arrays, None, names)`` (positional
  arguments only), the arrays as numpy pickles them. Loaded where pandas is
  installed, any version, they are the reference's objects: the same
  dtypes, index types and names and categorical order. pandas' block
  layout, which changes from version to version, is not written.
- *Reader* (:func:`loads`): a restricted ``find_class`` maps two sets of
  globals onto stand-ins that rebuild the port's types: the constructors
  above, and :data:`PANDAS3_GLOBALS`, the globals of pandas 3's own pickle
  of such objects (its block managers, ``_new_Index``, ``Categorical``'s
  ``NDArrayBacked`` state, and the Arrow string arrays of every string
  index: ``pyarrow.lib._restore_array`` with its validity bitmap, int32 or
  int64 offsets and data buffers). Any other global raises
  :class:`UnsupportedPickle` naming it (a pandas 1.x or 2.x block layout,
  say), and so does an object column whose cells are not float arrays.
  Nothing in the pickle is run but these stand-ins and numpy's own array
  and dtype reconstruction.
"""

from __future__ import annotations

import io
import pickle
from dataclasses import dataclass, field

import numpy as np


class UnsupportedPickle(ValueError):
    """A pickle the reader does not read (a global outside its table, or a layout it does not know)."""


@dataclass
class Labels:
    """A pandas ``Index``: its values (an object array of ``str``, None
    where missing, or a numeric array) and name; a ``CategoricalIndex`` also
    has its categories, in order, and whether they are ordered."""

    values: np.ndarray
    name: object = None
    categories: list | None = None
    ordered: bool = False

    def __len__(self) -> int:
        return len(self.values)


@dataclass
class MultiLabels:
    """A pandas ``MultiIndex``: one :class:`Labels` a level, each with a value a row."""

    levels: list[Labels]

    def __len__(self) -> int:
        return len(self.levels[0]) if self.levels else 0

    @property
    def names(self) -> list:
        return [lv.name for lv in self.levels]

    def tuples(self) -> list[tuple]:
        return list(zip(*(lv.values.tolist() for lv in self.levels)))


@dataclass
class Series:
    """A pandas ``Series``: values, index and name."""

    values: np.ndarray
    index: Labels | MultiLabels
    name: object = None

    def __len__(self) -> int:
        return len(self.values)


@dataclass
class Table:
    """A pandas ``DataFrame``: columns in order, the row index, and the name of the column labels."""

    columns: dict = field(default_factory=dict)
    index: Labels | MultiLabels | None = None
    columns_name: object = None

    def __len__(self) -> int:
        return len(self.index) if self.index is not None else 0


def str_labels(values, name=None) -> Labels:
    """A string index of ``values`` (numpy strings as ``str``)."""
    return Labels(_objects(values), name)


def _objects(values) -> np.ndarray:
    """An object array of ``values``, numpy scalars as Python's (a pickle of them names no numpy scalar type)."""
    arr = np.empty(len(values), dtype=object)
    arr[:] = [v.item() if isinstance(v, np.generic) else v for v in values]
    return arr


# -- the writer --------------------------------------------------------------------------------------------------


class _Global:
    """A module-level name written by ``STACK_GLOBAL`` without importing its module."""

    def __init__(self, module: str, qualname: str):
        self.module, self.qualname = module, qualname

    def __call__(self, *args):  # the pickler asks that a reduce function be callable; this one is only named
        raise TypeError(f"{self.module}.{self.qualname} is written into a pickle, not called")


_SERIES = _Global("pandas", "Series")
_DATAFRAME = _Global("pandas", "DataFrame")
_INDEX = _Global("pandas", "Index")
_CATEGORICAL_INDEX = _Global("pandas", "CategoricalIndex")
_CATEGORICAL = _Global("pandas", "Categorical")
_FROM_ARRAYS = _Global("pandas", "MultiIndex.from_arrays")


class _PandasPickler(pickle._Pickler):
    """A plain pickle whose port frames are pandas constructor calls (see the module docstring)."""

    def reducer_override(self, obj):
        if isinstance(obj, _Global):
            return obj.qualname  # save_global(obj, qualname)
        if isinstance(obj, Labels):
            if obj.categories is not None:
                return _CATEGORICAL_INDEX, (obj.values, _objects(obj.categories), obj.ordered, None, False, obj.name)
            return _INDEX, (obj.values, None, False, obj.name)
        if isinstance(obj, MultiLabels):
            arrays = [_CategoricalCall(lv) if lv.categories is not None else lv.values for lv in obj.levels]
            return _FROM_ARRAYS, (arrays, None, obj.names)
        if isinstance(obj, _CategoricalCall):
            lv = obj.labels
            return _CATEGORICAL, (lv.values, _objects(lv.categories), lv.ordered)
        if isinstance(obj, Series):
            return _SERIES, (obj.values, obj.index, None, obj.name)
        if isinstance(obj, Table):
            labels = Labels(_objects(obj.columns), obj.columns_name)
            return _DATAFRAME, (dict(obj.columns), obj.index, labels, None)
        return NotImplemented

    def save_global(self, obj, name=None):
        if not isinstance(obj, _Global):
            return super().save_global(obj, name)
        self.save(obj.module)
        self.save(obj.qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _CategoricalCall:
    """A categorical level of a MultiIndex, written as ``pandas.Categorical(...)``."""

    def __init__(self, labels: Labels):
        self.labels = labels


def dumps(obj) -> bytes:
    """The pickle bytes of ``obj`` (any picklable structure holding the port's frames)."""
    buf = io.BytesIO()
    _PandasPickler(buf, protocol=4).dump(obj)
    return buf.getvalue()


# -- the reader --------------------------------------------------------------------------------------------------


class _Stub:
    """A pandas object rebuilt by the pickle: the arguments of a constructor
    call or of ``NEWOBJ``, and the state of ``BUILD``."""

    kind = ""

    def __new__(cls, *args):
        obj = object.__new__(cls)
        obj.args, obj.state = args, None
        return obj

    def __init__(self, *args):
        pass

    def __setstate__(self, state):
        self.state = state


def _stub(kind: str) -> type:
    return type(f"_{kind}Stub", (_Stub,), {"kind": kind})


_STUBS = {name: _stub(name) for name in (
    "Series", "DataFrame", "Index", "CategoricalIndex", "MultiIndex", "Categorical", "CategoricalDtype",
    "StringDtype", "ArrowStringArray", "BlockManager", "SingleBlockManager")}


class _Call:
    """The result of a function global (``_new_Index``, ``from_arrays``, ...) before conversion."""

    def __init__(self, kind: str, args: tuple):
        self.kind, self.args = kind, args


def _new_index(cls, d):
    obj = cls.__new__(cls)
    obj.state = d
    return obj


def _from_arrays(arrays, sortorder=None, names=None):
    return _Call("from_arrays", (arrays, names))


def _unpickle_block(values, placement, ndim=None):
    return {"values": values, "mgr_locs": placement}


def _unpickle_ndarray_backed(cls, checksum, state):
    obj = cls.__new__(cls)
    if state is not None:
        obj.state = state
    return obj


def _restore_array(data):
    """``pyarrow.lib._restore_array`` of a string array: (type, length,
    null_count, offset, buffers, children, dictionary) -> an object array
    of ``str``, None where the validity bitmap says missing."""
    typ, length, _null_count, offset, buffers, children, dictionary = data
    if typ not in ("string", "large_string", "utf8", "large_utf8") or children or dictionary is not None:
        raise UnsupportedPickle(f"an Arrow array of type {typ!r}: only string arrays are read")
    validity, offsets, payload = buffers
    offsets = np.frombuffer(offsets, dtype="<i8" if typ.startswith("large") else "<i4")[offset:offset + length + 1]
    payload = bytes(payload or b"")
    out = np.empty(length, dtype=object)
    out[:] = [payload[a:b].decode("utf-8") for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist())]
    if validity is not None:
        bits = np.unpackbits(np.frombuffer(validity, dtype=np.uint8), bitorder="little")[offset:offset + length]
        out[bits == 0] = None
    return out


#: the globals of pandas 3's own pickle of the SV statistics (pandas 3.0.3, pyarrow 25) and of the
#: writer's constructor calls -> their stand-ins
_GLOBALS = {
    ("pandas", "Series"): _STUBS["Series"],
    ("pandas", "DataFrame"): _STUBS["DataFrame"],
    ("pandas", "Index"): _STUBS["Index"],
    ("pandas", "MultiIndex"): _STUBS["MultiIndex"],
    ("pandas", "Categorical"): _STUBS["Categorical"],
    ("pandas", "CategoricalIndex"): _STUBS["CategoricalIndex"],
    ("pandas", "CategoricalDtype"): _STUBS["CategoricalDtype"],
    ("pandas", "StringDtype"): _STUBS["StringDtype"],
    ("pandas", "MultiIndex.from_arrays"): _from_arrays,
    ("pandas.core.internals.managers", "BlockManager"): _STUBS["BlockManager"],
    ("pandas.core.internals.managers", "SingleBlockManager"): _STUBS["SingleBlockManager"],
    ("pandas._libs.internals", "_unpickle_block"): _unpickle_block,
    ("pandas.core.indexes.base", "_new_Index"): _new_index,
    ("pandas._libs.arrays", "__pyx_unpickle_NDArrayBacked"): _unpickle_ndarray_backed,
    ("pandas.arrays", "ArrowStringArray"): _STUBS["ArrowStringArray"],
    ("pyarrow.lib", "_restore_array"): _restore_array,
    ("pyarrow.lib", "py_buffer"): bytes,
    ("pyarrow.lib", "type_for_alias"): str,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    ("numpy._core.multiarray", "_reconstruct"): np.ndarray.__reduce__(np.zeros(0))[0],
    ("numpy.core.multiarray", "_reconstruct"): np.ndarray.__reduce__(np.zeros(0))[0],
    ("builtins", "slice"): slice,
    ("builtins", "bytearray"): bytearray,
}
#: the 22 globals of pandas 3.0.3's own pickle (with pyarrow's string arrays) that the reader maps
PANDAS3_GLOBALS = frozenset(k for k in _GLOBALS if k[1] != "MultiIndex.from_arrays"
                            and k[0] != "numpy.core.multiarray")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        hit = _GLOBALS.get((module, name))
        if hit is None:
            raise UnsupportedPickle(f"the pickle names {module}.{name}, which the port does not read (it reads "
                                    "pandas 3's Series and DataFrames and the port's own pickles)")
        return hit


# -- stand-ins -> the port's types -------------------------------------------------------------------------------


def _text_values(data) -> np.ndarray:
    """Index or column data as an array: an Arrow string array as objects, an ndarray as it is."""
    if isinstance(data, _Stub) and data.kind == "ArrowStringArray":
        return data.state["_pa_array"]
    if isinstance(data, np.ndarray):
        return data
    if isinstance(data, list):
        return _objects(data)
    raise UnsupportedPickle(f"index or column data of type {type(data).__name__}")


def _categorical(obj) -> Labels:
    """A ``Categorical`` (constructor call or ``NDArrayBacked`` state) as :class:`Labels`."""
    if obj.args:
        values, categories, ordered = (list(obj.args) + [None, None])[:3]
        return Labels(_objects(list(values)), None, list(_text_values(categories)), bool(ordered))
    state = obj.state
    if isinstance(state, tuple) and len(state) >= 2:
        dtype = next(s for s in state if isinstance(s, _Stub) and s.kind == "CategoricalDtype")
        codes = next(s for s in state if isinstance(s, np.ndarray))
    else:
        raise UnsupportedPickle("a Categorical state the reader does not know")
    cats = _labels(dtype.state["categories"]).values
    values = np.empty(len(codes), dtype=object)
    values[codes >= 0] = cats[codes[codes >= 0]]
    values[codes < 0] = None
    return Labels(values, None, cats.tolist(), bool(dtype.state.get("ordered")))


def _labels(obj) -> Labels | MultiLabels:
    """An index stand-in (constructor call or ``_new_Index`` state) as the port's type."""
    if isinstance(obj, _Call) and obj.kind == "from_arrays":
        arrays, names = obj.args
        names = list(names) if names is not None else [None] * len(arrays)
        levels = []
        for arr, name in zip(arrays, names):
            lv = _categorical(arr) if isinstance(arr, _Stub) and arr.kind == "Categorical" else \
                Labels(_text_values(arr))
            lv.name = name
            levels.append(lv)
        return MultiLabels(levels)
    if not isinstance(obj, _Stub):
        raise UnsupportedPickle(f"an index of type {type(obj).__name__}")
    if obj.kind == "Index":
        if obj.args:
            data, _dtype, _copy, name = (list(obj.args) + [None] * 4)[:4]
            return Labels(_text_values(data), name)
        return Labels(_text_values(obj.state["data"]), obj.state.get("name"))
    if obj.kind == "CategoricalIndex":
        if obj.args:
            values, categories, ordered, _dtype, _copy, name = (list(obj.args) + [None] * 6)[:6]
            return Labels(_objects(list(values)), name, list(_text_values(categories)), bool(ordered))
        lv = _categorical(obj.state["data"])
        lv.name = obj.state.get("name")
        return lv
    if obj.kind == "MultiIndex":
        d = obj.state
        levels = []
        for level, codes, name in zip(d["levels"], d["codes"], d["names"]):
            lv = _labels(level)
            vals = np.empty(len(codes), dtype=object if lv.values.dtype == object else lv.values.dtype)
            vals[:] = lv.values[codes]
            if (codes < 0).any():
                vals = vals.astype(object)
                vals[codes < 0] = None
            levels.append(Labels(vals, name, lv.categories, lv.ordered))
        return MultiLabels(levels)
    raise UnsupportedPickle(f"an index of kind {obj.kind}")


def _blocks(mgr) -> tuple[list, list]:
    """(axes, [(values, column positions)]) of a block manager: the
    ``BlockManager(blocks, axes)`` call of a DataFrame, or the ``0.14.1``
    state of a Series' ``SingleBlockManager``."""
    state = mgr.state
    extra = state[3] if isinstance(state, tuple) and len(state) > 3 and isinstance(state[3], dict) else None
    if mgr.kind == "BlockManager" and len(mgr.args) == 2 and state is None:
        blocks, axes = mgr.args
    elif extra and "0.14.1" in extra:
        blocks, axes = extra["0.14.1"]["blocks"], extra["0.14.1"]["axes"]
    else:
        raise UnsupportedPickle(f"a {mgr.kind} state the reader does not know (a pandas 1.x or 2.x block layout)")
    out = []
    for b in blocks:
        if not isinstance(b, dict):
            raise UnsupportedPickle(f"a block of type {type(b).__name__}")
        locs = b["mgr_locs"]
        pos = list(range(*locs.indices(1 << 62))) if isinstance(locs, slice) else np.asarray(locs).tolist()
        out.append((b["values"], pos))
    return axes, out


def _check_object_column(name, values: np.ndarray) -> None:
    """An object column's cells must be float arrays (or NaN): the concordance's ROC columns."""
    if values.dtype != object:
        return
    for v in values.tolist():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            continue
        if isinstance(v, float) and v != v:
            continue
        raise UnsupportedPickle(f"column {name!r} holds a {type(v).__name__}: object columns are read only as "
                                "float arrays")


def _convert(obj):
    """A loaded structure with every pandas stand-in replaced by the port's type."""
    if isinstance(obj, dict):
        return {k: _convert(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_convert(v) for v in obj]
    if isinstance(obj, _Call):
        return _labels(obj)
    if not isinstance(obj, _Stub):
        return obj
    if obj.kind in ("Index", "CategoricalIndex", "MultiIndex"):
        return _labels(obj)
    if obj.kind == "Series":
        if obj.args:
            data, index, _dtype, name = (list(obj.args) + [None] * 4)[:4]
            return Series(np.asarray(data), _labels(index), name)
        axes, blocks = _blocks(obj.state["_mgr"])
        (values, _), = blocks
        return Series(_text_values(values), _labels(axes[0]), obj.state.get("_name", obj.state.get("name")))
    if obj.kind == "DataFrame":
        if obj.args:
            data, index, columns, _dtype = (list(obj.args) + [None] * 4)[:4]
            cols = _labels(columns)
            if isinstance(data, dict):
                out = {k: np.asarray(v) if not isinstance(v, np.ndarray) else v for k, v in data.items()}
            else:
                data = np.asarray(data)
                out = {k: data[:, j] for j, k in enumerate(cols.values.tolist())}
            for k, v in out.items():
                _check_object_column(k, v)
            return Table({k: out[k] for k in cols.values.tolist()}, _labels(index), cols.name)
        axes, blocks = _blocks(obj.state["_mgr"])
        cols, index = _labels(axes[0]), _labels(axes[1])
        names = cols.values.tolist()
        out = {}
        for values, pos in blocks:
            values = _text_values(values)
            for j, p in enumerate(pos):
                out[names[p]] = values[j] if values.ndim == 2 else values
        for k, v in out.items():
            _check_object_column(k, v)
        return Table({k: out[k] for k in names}, index, cols.name)
    raise UnsupportedPickle(f"a {obj.kind} outside a Series or DataFrame")


def loads(data: bytes):
    """The structure a pickle holds, its pandas objects as the port's types
    (:class:`UnsupportedPickle` for what the reader does not read)."""
    return _convert(_Unpickler(io.BytesIO(data)).load())
