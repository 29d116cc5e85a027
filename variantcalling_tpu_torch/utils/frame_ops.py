"""pandas' row orders and sums, replayed without pandas.

The reference's host code sorts, groups and sums with pandas; the port
computes the same rows in the same order with numpy alone (the card's
machine has no pandas). Each function names the pandas call it replays.
"""

from __future__ import annotations

import ast
import csv
import math

import numpy as np

from variantcalling_tpu_torch.utils.h5_utils import Frame


def value_counts(values: np.ndarray) -> tuple[list, np.ndarray]:
    """(values, counts) as ``pd.Series(values).value_counts()`` orders them:
    count descending, ties in order of first appearance."""
    values = np.asarray(values)
    uniq = list(dict.fromkeys(values.tolist()))
    counts = np.array([int(np.count_nonzero(values == u)) for u in uniq], dtype=np.int64)
    order = np.argsort(-counts, kind="stable")
    return [uniq[i] for i in order], counts[order]


def astype_str(column: np.ndarray) -> np.ndarray:
    """pandas 3's ``Series.astype(str)`` as an object column: each value's
    text (a float's shortest text at its own width, as numpy writes it;
    ``True``/``False``; ``str`` of any other object), a missing value (NaN,
    None) left missing, as None."""
    column = np.asarray(column)
    out = np.empty(len(column), dtype=object)
    if column.dtype.kind == "f":
        ok = ~np.isnan(column)
        out[ok] = column[ok].astype(str).astype(object)
        return out
    if column.dtype.kind in "biu":
        out[:] = [str(v) for v in column.tolist()]
        return out
    out[:] = [None if v is None or (isinstance(v, (float, np.floating)) and v != v) else str(v)
              for v in column.tolist()]
    return out


def nan_mean(column: np.ndarray) -> float:
    """``Series.mean()`` of a numeric column: NaN set to 0, numpy's sum (in
    the column's float dtype; ints in float64) over the count of the others."""
    column = np.asarray(column)
    if column.dtype.kind != "f":
        column = column.astype(np.float64)
    mask = np.isnan(column)
    count = column.dtype.type(len(column) - int(mask.sum()))
    return np.where(mask, column.dtype.type(0), column).sum(dtype=column.dtype) / count


def take_rows(df: Frame, keep) -> Frame:
    """The rows ``keep`` (a mask or positions) of every column, the index dropped."""
    return Frame({n: np.asarray(c)[keep] for n, c in df.data.items()})


def concat_rows(frames: list[Frame]) -> Frame:
    """``pd.concat(frames, ignore_index=True)`` of frames with the same columns
    (an int64 and a float64 column give float64; an object column object)."""
    out = {}
    for name in frames[0].columns:
        parts = [np.asarray(f[name]) for f in frames]
        out[name] = np.concatenate([p.astype(object) for p in parts]) if any(p.dtype == object for p in parts) \
            else np.concatenate(parts)
    return Frame(out)


def nargsort(values: np.ndarray, ascending: bool = True) -> np.ndarray:
    """The row order of pandas' one-key ``sort_values`` (``nargsort`` with
    numpy's quicksort, NaN last)."""
    values = np.asarray(values)
    mask = np.isnan(values) if values.dtype.kind == "f" else np.zeros(len(values), dtype=bool)
    idx = np.arange(len(values))
    non_nans, non_nan_idx = values[~mask], idx[~mask]
    if not ascending:
        non_nans, non_nan_idx = non_nans[::-1], non_nan_idx[::-1]
    indexer = non_nan_idx[non_nans.argsort(kind="quicksort")]
    if not ascending:
        indexer = indexer[::-1]
    return np.concatenate([indexer, np.flatnonzero(mask)])


def kahan_sum(values: np.ndarray) -> float:
    """pandas' groupby sum of one group: NaN skipped, compensated addition in row order."""
    total = comp = 0.0
    for v in values.tolist():
        if v != v:
            continue
        y = v - comp
        t = total + y
        comp = t - total - y
        if comp != comp:
            comp = 0.0
        total = t
    return total


def sorted_codes(column: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(the sorted distinct values, each row's position among them): the
    groups of ``groupby(key)``. A column of ``str`` objects is sorted as a
    numpy string array (code-point order, as Python orders ``str``), much
    faster than as objects."""
    column = np.asarray(column)
    if column.dtype == object and len(column) and isinstance(column[0], str):
        try:
            column = column.astype("U")
        except (TypeError, ValueError):
            pass
    uniq, inv = np.unique(column, return_inverse=True)
    return uniq, inv.reshape(-1).astype(np.int64)


def _joint_codes(*columns: np.ndarray) -> np.ndarray:
    """One int64 code a row for the tuple of its keys, ordered as the tuples sort."""
    key = np.zeros(len(columns[0]), dtype=np.int64)
    span = 1
    for c in columns:
        uniq, codes = sorted_codes(c)
        if span * max(len(uniq), 1) >= 1 << 62:  # too many combinations for one int64: renumber first
            key = np.unique(key, return_inverse=True)[1].reshape(-1).astype(np.int64)
            span = int(key.max(initial=0)) + 1
        key = key * max(len(uniq), 1) + codes
        span *= max(len(uniq), 1)
    return key


def first_seen_codes(*columns: np.ndarray) -> tuple[np.ndarray, int]:
    """Each row's group number over the key ``columns``, the groups numbered
    in order of first appearance (``groupby(keys, sort=False)``'s order), and
    the number of groups."""
    n = len(columns[0]) if columns else 0
    if n == 0:
        return np.zeros(0, dtype=np.int64), 0
    _, first, inv = np.unique(_joint_codes(*columns), return_index=True, return_inverse=True)
    rank = np.empty(len(first), dtype=np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    return rank[inv.reshape(-1)], len(first)


def run_codes(*columns: np.ndarray) -> tuple[np.ndarray, int]:
    """Group numbers of rows already sorted by the key ``columns``: a new
    group wherever a key differs from the row before (no sort)."""
    n = len(columns[0]) if columns else 0
    if n == 0:
        return np.zeros(0, dtype=np.int64), 0
    change = np.zeros(n, dtype=bool)
    change[0] = True
    for c in columns:
        c = np.asarray(c)
        change[1:] |= c[1:] != c[:-1]
    codes = np.cumsum(change) - 1
    return codes, int(codes[-1]) + 1


def group_mean_f32(values: np.ndarray, codes: np.ndarray, n_groups: int) -> np.ndarray:
    """pandas' groupby ``mean`` of a float32 column: per group, compensated
    (Kahan) float32 addition in row order, then the float32 sum over the
    count; NaN skipped (a group of NaN alone gives NaN)."""
    values = np.asarray(values, dtype=np.float32)
    order = np.argsort(codes, kind="stable")
    sv, sc = values[order], codes[order]
    starts = np.searchsorted(sc, np.arange(n_groups))
    rank = np.arange(len(sc)) - starts[sc]
    total = np.zeros(n_groups, dtype=np.float32)
    comp = np.zeros(n_groups, dtype=np.float32)
    count = np.zeros(n_groups, dtype=np.int64)
    with np.errstate(invalid="ignore"):
        for r in range(int(rank.max(initial=-1)) + 1):
            at = rank == r
            g, v = sc[at], sv[at]
            ok = ~np.isnan(v)
            g, v = g[ok], v[ok]
            y = v - comp[g]
            t = total[g] + y
            c = (t - total[g]) - y
            comp[g] = np.where(np.isnan(c), np.float32(0), c)
            total[g] = t
            count[g] += 1
        mean = total / count.astype(np.float32)
    return np.where(count > 0, mean, np.float32(np.nan)).astype(np.float32)


def sample_positions(n_rows: int, size: int, seed: int) -> np.ndarray:
    """The rows ``DataFrame.sample(n=size, random_state=seed)`` takes, in its
    order: ``numpy.random.RandomState(seed).choice(n_rows, size, replace=False)``."""
    return np.random.RandomState(seed).choice(n_rows, size=size, replace=False).astype(np.intp)


def group_sum(values: np.ndarray, codes: np.ndarray, n_groups: int) -> np.ndarray:
    """pandas' groupby ``sum`` of one column: integers exactly (their dtype
    kept), floats by compensated addition in row order, NaN skipped
    (:func:`kahan_sum`, vectorised over the groups)."""
    values = np.asarray(values)
    if values.dtype == object:  # Python objects (an empty column read as text): added in row order
        out = np.zeros(n_groups, dtype=object)
        for g, v in zip(codes.tolist(), values.tolist()):
            out[g] = out[g] + v
        return out
    if values.dtype.kind in "biu":
        out = np.zeros(n_groups, dtype=np.int64)
        np.add.at(out, codes, values.astype(np.int64))
        return out
    values = values.astype(np.float64)
    order = np.argsort(codes, kind="stable")
    sv, sc = values[order], codes[order]
    rank = np.arange(len(sc)) - np.searchsorted(sc, sc)
    total = np.zeros(n_groups)
    comp = np.zeros(n_groups)
    with np.errstate(invalid="ignore"):
        for r in range(int(rank.max(initial=-1)) + 1):
            at = (rank == r) & ~np.isnan(sv)
            g, v = sc[at], sv[at]
            y = v - comp[g]
            t = total[g] + y
            c = (t - total[g]) - y
            comp[g] = np.where(np.isnan(c), 0.0, c)
            total[g] = t
    return total


def lexsort_rows(*keys: np.ndarray) -> np.ndarray:
    """The row order of a multi-column ``sort_values(keys)``: stable, the
    first key major (strings in code-point order)."""
    if not keys:
        return np.zeros(0, dtype=np.intp)
    return np.argsort(_joint_codes(*keys), kind="stable")


# -- read_csv ---------------------------------------------------------------------------------------------------------

#: the texts ``read_csv`` reads as NaN by default
NA_TEXTS = frozenset(b"" if s == "" else s.encode() for s in (
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
    "NULL", "NaN", "None", "n/a", "nan", "null"))


def _digits(raw: np.ndarray) -> np.ndarray | None:
    """int64 values of a bytes array whose every value is 1 to 18 decimal
    digits (no sign), by array arithmetic; None for any other column."""
    width = raw.dtype.itemsize
    if not len(raw) or width > 18:
        return None
    mat = np.ascontiguousarray(raw).view(np.uint8).reshape(len(raw), width)
    digit = (mat >= 48) & (mat <= 57)
    lens = digit.sum(axis=1)
    # digits first, then only the padding
    if not (lens > 0).all() or (digit != (np.arange(width) < lens[:, None])).any() \
            or (mat[~digit] != 0).any():
        return None
    vals = np.where(digit, mat.astype(np.int64) - 48, 0)
    scale = 10 ** np.clip(lens[:, None] - 1 - np.arange(width), 0, None)
    return (vals * np.where(digit, scale, 0)).sum(axis=1)


def infer_column(raw: np.ndarray, none: np.ndarray | None = None) -> np.ndarray:
    """A column of field texts (a bytes array; ``none``: the rows that had no
    such field) as ``read_csv`` types it: int64 where every field is an
    integer, float64 where every field is a number or missing (NaN), else an
    object column of ``str`` with NaN where missing."""
    raw = np.asarray(raw, dtype=bytes)
    if not len(raw):
        return np.zeros(0, dtype=object)
    missing = np.isin(raw, np.array(sorted(NA_TEXTS), dtype=bytes))
    if none is not None:
        missing |= none
    if not missing.any():
        fast = _digits(raw)
        if fast is not None:
            return fast
        try:
            return raw.astype(np.int64)
        except ValueError:
            pass
    try:
        return np.where(missing, b"nan", raw).astype(np.float64)
    except ValueError:
        pass
    try:
        out = raw.astype("U").astype(object)
    except UnicodeDecodeError:
        out = np.array([v.decode() for v in raw.tolist()], dtype=object)
    out[missing] = np.nan
    return out


def to_numeric(column: np.ndarray, coerce: bool = False) -> np.ndarray:
    """``pd.to_numeric``: numbers as they are; an object column of texts as
    int64 where each is an integer, else float64; a text that is no number
    raises, or with ``coerce`` becomes NaN."""
    column = np.asarray(column)
    if column.dtype != object:
        return column
    texts = [None if isinstance(v, float) and v != v else str(v).encode() for v in column.tolist()]
    if not coerce:
        none = np.array([t is None for t in texts], dtype=bool)
        out = infer_column(np.array([b"" if t is None else t for t in texts], dtype=bytes), none)
        if out.dtype == object and len(out):
            raise ValueError(f"Unable to parse string {next(v for v in out if isinstance(v, str))!r}")
        return out.astype(np.int64) if out.dtype == object else out
    num = []
    for t in texts:
        try:
            num.append(np.nan if t is None or t in NA_TEXTS else float(t))
        except ValueError:
            num.append(np.nan)
    return np.array(num, dtype=np.float64)


def _span_texts(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """The bytes of each ``[start, end)`` span of ``buf`` as one fixed-width bytes array."""
    lens = ends - starts
    width = max(int(lens.max(initial=0)), 1)
    cols = np.arange(width)
    idx = np.minimum(starts[:, None] + cols, max(len(buf) - 1, 0))
    mat = np.where(cols < lens[:, None], buf[idx] if len(buf) else 0, 0).astype(np.uint8)
    return np.ascontiguousarray(mat).view(f"S{width}").ravel()


def read_tsv(path: str, names: list[str] | None = None, comment: bytes | None = None) -> dict[str, np.ndarray]:
    """``pd.read_csv(path, sep="\\t", header=None, names=names, comment=comment)``
    (``names=None``: the first line is the header), its columns typed by
    :func:`infer_column`: each line cut at its first ``comment`` byte, lines
    left empty skipped, a row of fewer fields padded with missing ones; a row
    of more fields than the names raises ``ValueError``. The fields of the
    full rows are cut out of the file's bytes by array operations; the few
    other rows (cut short by a comment) one by one."""
    with open(path, "rb") as fh:
        data = fh.read()
    if b"\r" in data:
        data = data.replace(b"\r\n", b"\n")
    if data and not data.endswith(b"\n"):
        data += b"\n"
    buf = np.frombuffer(data, dtype=np.uint8)
    ends = np.flatnonzero(buf == 10)
    starts = np.concatenate([[0], ends[:-1] + 1]).astype(np.int64)
    tab_pos = np.flatnonzero(buf == 9)
    tab_line = np.searchsorted(ends, tab_pos)
    tabs = np.bincount(tab_line, minlength=len(ends))
    cut = ends.copy()  # each line's end once its comment is cut off
    if comment is not None:
        hits = np.flatnonzero(buf == comment[0])
        hit_line = np.searchsorted(ends, hits)
        first = np.unique(hit_line, return_index=True)
        cut[first[0]] = hits[first[1]]
        tabs = np.bincount(tab_line[tab_pos < cut[tab_line]], minlength=len(ends))
    keep = np.flatnonzero(cut > starts)
    if names is None:
        if not len(keep):
            raise ValueError("No columns to parse from file")
        names = [h.decode() for h in data[starts[keep[0]]: cut[keep[0]]].split(b"\t")]
        keep = keep[1:]
    width = len(names)
    n = len(keep)
    if (tabs[keep] >= width).any():
        raise ValueError(f"Expected {width} fields in line {int(keep[np.argmax(tabs[keep] >= width)]) + 1}")
    full = keep[tabs[keep] == width - 1]
    row_of_full = np.flatnonzero(tabs[keep] == width - 1)
    in_full = np.zeros(len(ends), dtype=bool)
    in_full[full] = True
    seps = tab_pos[in_full[tab_line]].reshape(len(full), width - 1) if width > 1 else np.zeros((len(full), 0), int)
    f_start = np.concatenate([starts[full][:, None], seps + 1], axis=1)
    f_end = np.concatenate([seps, cut[full][:, None]], axis=1)
    out = {}
    short = [(r, data[starts[i]: cut[i]].split(b"\t")) for r, i in enumerate(keep.tolist()) if not in_full[i]]
    for j, name in enumerate(names):
        texts = _span_texts(buf, f_start[:, j], f_end[:, j])
        none = np.zeros(n, dtype=bool)
        if short:
            width_j = max([texts.itemsize] + [len(f[j]) for _, f in short if j < len(f)])
            col = np.zeros(n, dtype=f"S{width_j}")
            col[row_of_full] = texts
            for r, f in short:
                if j < len(f):
                    col[r] = f[j]
                else:
                    none[r] = True
            texts = col
        out[name] = infer_column(texts, none)
    return out


_POW10 = [float(f"1e{k}") for k in range(309)]


def precise_xstrtod(text: str) -> float | None:
    """A decimal text as ``read_csv``'s default float converter reads it
    (pandas' ``precise_xstrtod``, not always the nearest double): leading and
    trailing blanks skipped, up to 17 significant digits accumulated into a
    double, the rest counted into the exponent, then one multiplication or
    division by a power of ten. None where the text is no such number."""
    p, n = 0, len(text)
    while p < n and text[p] in " \t\n\v\f\r":
        p += 1
    negative = p < n and text[p] == "-"
    if p < n and text[p] in "+-":
        p += 1
    number, exponent, num_digits = 0.0, 0, 0
    while p < n and "0" <= text[p] <= "9":
        if num_digits < 17:
            number = number * 10.0 + (ord(text[p]) - 48)
            num_digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and text[p] == ".":
        p += 1
        num_decimals = 0
        while num_digits < 17 and p < n and "0" <= text[p] <= "9":
            number = number * 10.0 + (ord(text[p]) - 48)
            p += 1
            num_digits += 1
            num_decimals += 1
        while p < n and "0" <= text[p] <= "9":
            p += 1
        exponent -= num_decimals
    if num_digits == 0:
        return None
    if negative:
        number = -number
    if p < n and text[p] in "eE":
        q = p + 1
        neg_exp = q < n and text[q] == "-"
        if q < n and text[q] in "+-":
            q += 1
        digits, e = 0, 0
        while digits < 17 and q < n and "0" <= text[q] <= "9":
            e = e * 10 + (ord(text[q]) - 48)
            digits += 1
            q += 1
        if digits:
            exponent += -e if neg_exp else e
            p = q
    while p < n and text[p] in " \t\n\v\f\r":
        p += 1
    if p != n or exponent > 308:
        return None
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _csv_bools(texts: list[str]) -> np.ndarray | None:
    """A bool column where every field is one of ``read_csv``'s default true or false texts."""
    truth = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False, "false": False}
    if not texts or any(t not in truth for t in texts):
        return None
    return np.array([truth[t] for t in texts], dtype=bool)


def read_csv(path: str) -> dict[str, np.ndarray]:
    """``pd.read_csv(path)``: the first line is the header (a repeated name
    made ``name.1``, ``name.2``), fields split at commas with ``"`` quoting
    (a doubled quote inside a quoted field is one quote), blank lines skipped,
    a short row padded with missing fields, a row of more fields than the
    header refused (``ValueError``). Each column typed by :func:`infer_column`
    (int64, float64, or ``str`` objects with NaN for the missing texts),
    or bool where every field is ``True``/``False`` in one of their three
    spellings."""
    with open(path, newline="", encoding="utf-8") as fh:
        rows = [r for r in csv.reader(fh) if r]
    if not rows:
        raise ValueError("No columns to parse from file")
    names: list[str] = []
    for name in rows[0]:
        base, k = name, 0
        while name in names:
            k += 1
            name = f"{base}.{k}"
        names.append(name)
    width = len(names)
    body = rows[1:]
    for i, r in enumerate(body):
        if len(r) > width:
            raise ValueError(f"Expected {width} fields in line {i + 2}, saw {len(r)}")
    out = {}
    for j, name in enumerate(names):
        texts = [r[j] if j < len(r) else "" for r in body]
        none = np.array([j >= len(r) for r in body], dtype=bool)
        bools = _csv_bools(texts)
        if bools is not None:
            out[name] = bools
            continue
        raw = np.array([t.encode() for t in texts], dtype=bytes) if texts else np.zeros(0, dtype="S1")
        col = infer_column(raw, none)
        if col.dtype.kind == "f":  # the numbers as pandas' converter reads them
            for i in np.flatnonzero(~np.isnan(col)).tolist():
                v = precise_xstrtod(texts[i])
                if v is not None:
                    col[i] = v
                elif texts[i].strip().lower().lstrip("+-") not in ("inf", "infinity") \
                        and not np.isinf(col[i]):  # a text numpy reads and pandas does not ("1_0")
                    col = np.array(texts, dtype=object)
                    col[none | np.isin(raw, np.array(sorted(NA_TEXTS), dtype=bytes))] = np.nan
                    break
        out[name] = col
    return out


# -- DataFrame.eval over a whitelist ----------------------------------------------------------------------------------

_COMPARE = {ast.Eq: np.equal, ast.NotEq: np.not_equal, ast.Lt: np.less, ast.LtE: np.less_equal,
            ast.Gt: np.greater, ast.GtE: np.greater_equal}
_ARITH = {ast.Add: np.add, ast.Sub: np.subtract, ast.Mult: np.multiply, ast.Div: np.true_divide,
          ast.FloorDiv: np.floor_divide, ast.Mod: np.mod, ast.Pow: np.power,
          ast.BitAnd: np.bitwise_and, ast.BitOr: np.bitwise_or}


def _eval_node(node: ast.AST, columns: dict[str, np.ndarray]):
    if isinstance(node, ast.Expression):
        return _eval_node(node.body, columns)
    if isinstance(node, ast.Name):
        if node.id not in columns:
            raise NameError(f"name '{node.id}' is not defined")
        return np.asarray(columns[node.id])
    if isinstance(node, ast.Constant) and isinstance(node.value, (bool, int, float, str)):
        return node.value
    if isinstance(node, ast.BoolOp):  # ``and``/``or`` are element-wise, as pandas' eval reads them
        fn = np.bitwise_and if isinstance(node.op, ast.And) else np.bitwise_or
        out = _eval_node(node.values[0], columns)
        for v in node.values[1:]:
            out = fn(out, _eval_node(v, columns))
        return out
    if isinstance(node, ast.UnaryOp):
        v = _eval_node(node.operand, columns)
        if isinstance(node.op, (ast.Not, ast.Invert)):
            return np.invert(v)
        if isinstance(node.op, ast.USub):
            return np.negative(v)
        if isinstance(node.op, ast.UAdd):
            return np.positive(v)
    if isinstance(node, ast.BinOp) and type(node.op) in _ARITH:
        return _ARITH[type(node.op)](_eval_node(node.left, columns), _eval_node(node.right, columns))
    if isinstance(node, ast.Compare):
        out = None
        left = _eval_node(node.left, columns)
        for op, comp in zip(node.ops, node.comparators):
            if isinstance(op, (ast.In, ast.NotIn)):
                if not isinstance(comp, (ast.List, ast.Tuple)):
                    raise TypeError("'in' takes a list of constants")
                right = [_eval_node(e, columns) for e in comp.elts]
                if any(isinstance(v, np.ndarray) for v in right):
                    raise TypeError("'in' takes a list of constants")
                hit = np.isin(left, np.array(right, dtype=object if np.asarray(left).dtype == object else None))
                step = hit if isinstance(op, ast.In) else ~hit
            elif type(op) in _COMPARE:
                right = _eval_node(comp, columns)
                step = _COMPARE[type(op)](left, right)
            else:
                break
            out = step if out is None else out & step
            left = right
        else:
            return out
    raise TypeError(f"unsupported expression: {ast.dump(node)[:60]}")


def eval_query(columns: dict[str, np.ndarray], query: str, n_rows: int) -> np.ndarray:
    """``DataFrame.eval(query).fillna(False).astype(bool)`` over ``columns``
    (``n_rows`` long), without ``eval``: the query is parsed with :mod:`ast`
    and only names, constants, comparisons (chained ones too), ``and``,
    ``or``, ``not``, ``&``, ``|``, ``~``, arithmetic and ``in``/``not in``
    over a list of constants are evaluated, element-wise over the columns,
    NaN giving False. Any other expression, or a failure, raises
    ``ValueError(f"filter query {query!r} failed: ...")``, the reference's
    text."""
    try:
        out = _eval_node(ast.parse(query.strip(), mode="eval"), columns)
        out = np.asarray(out)
        if out.shape != (n_rows,):
            raise TypeError(f"the query gives no column of {n_rows} rows")
        if out.dtype == bool:
            return out
        if out.dtype.kind == "f":
            return np.where(np.isnan(out), False, out != 0)
        return np.array([not (isinstance(v, float) and v != v) and bool(v) for v in out.tolist()], dtype=bool)
    except Exception as e:  # noqa: BLE001 - every failure is the one refusal
        raise ValueError(f"filter query {query!r} failed: {e}") from e


# -- DataFrame.to_json(orient="records") ------------------------------------------------------------------------------

#: pandas' ``to_json`` writes floats with this many decimals at most
JSON_DOUBLE_PRECISION = 10


def json_double_text(value: float, precision: int = JSON_DOUBLE_PRECISION) -> str:
    """A finite float as pandas' ``to_json`` writes it (its vendored ujson's
    ``Buffer_AppendDoubleUnchecked``): past 1e16, or nonzero below 1e-15 in
    magnitude, ``%.{precision}g``; else the whole part, a point and the
    fraction rounded to ``precision`` decimals (half to odd, or up from a
    zero last digit), trailing zeros cut, ``.0`` for none."""
    neg = value < 0
    if neg:
        value = -value
    if value > 1e16 - 1 or (value != 0.0 and value < 1e-15):
        return "%.*g" % (precision, -value if neg else value)
    pow10 = float(10 ** precision)
    whole = int(value)
    tmp = (value - float(whole)) * pow10
    frac = int(tmp)
    diff = tmp - float(frac)
    if diff > 0.5 or (diff == 0.5 and (frac == 0 or frac & 1)):
        frac += 1
    if frac >= pow10:
        frac = 0
        whole += 1
    text = f"{whole}." + (f"{frac:0{precision}d}".rstrip("0") if frac else "0")
    return ("-" if neg else "") + text


def _json_value(v):
    if v is None:
        return None
    if isinstance(v, (np.ndarray, list, tuple)):
        return [_json_value(x) for x in (v.tolist() if isinstance(v, np.ndarray) else v)]
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        v = float(v)
        return None if math.isnan(v) or math.isinf(v) else float(json_double_text(v))
    return str(v)


def records_json(frame: Frame) -> list[dict]:
    """``json.loads(df.to_json(orient="records"))``: a dict a row, column
    name to value; floats rounded as pandas writes them
    (:func:`json_double_text`), NaN, infinities and missing values ``None``,
    ints and bools as they are, strings as they are, an array cell a list."""
    names = frame.columns
    cols = [[_json_value(v) for v in np.asarray(frame[n]).tolist()] for n in names]
    return [dict(zip(names, row)) for row in zip(*cols)] if names else [{} for _ in range(len(frame))]
