"""Experiment results store: argument-hash memoization + CSV + manifest.

Port of ``bayesian_coresets_tpu/experiments/results.py`` (reference
``examples/common/results.py:8-59``) with no pandas: runs are keyed by the
md5 of their sorted-JSON argparse namespace, results land in one CSV per
key plus an append-only ``manifest.csv``, and :func:`load_matching` scans
all result CSVs row-filtering on the intersection of columns.

The files are the JAX package's, written with ``csv`` as pandas writes
them (``to_csv(index=False)``: floats in their shortest form, missing
values empty, lists as their ``str``), and read with pandas' rule for a
column's type (int, float, bool, else string; an int column with a missing
value is float), so each package reads the other's files and a manifest
appended by either stays column-aligned.  :func:`load_matching` returns a
:class:`Table`, a dict of column name -> numpy array.
"""

from __future__ import annotations

import csv
import hashlib
import json
import math
import os

import numpy as np

_EXCLUDED = {"func", "verbosity", "plot_x", "plot_y", "plot_title", "plot_x_label",
             "plot_y_label", "plot_x_type", "plot_y_type", "plot_legend",
             "plot_height", "plot_width", "plot_type", "plot_fontsize",
             "plot_toolbar", "summarize", "groupby", "plot_out",
             "device"}     # this package's only: where a run computes, not what

# the strings pandas.read_csv reads as missing by default
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}


class Table(dict):
    """Result rows as columns: name -> numpy array (int64, float64, bool,
    or object holding strings, NaN where a value is missing)."""

    @property
    def columns(self) -> list[str]:
        return list(self)

    @property
    def nrows(self) -> int:
        return len(next(iter(self.values()))) if self else 0

    def take(self, rows) -> "Table":
        """The rows that ``rows`` (a boolean mask or indices) selects."""
        return Table({k: v[rows] for k, v in self.items()})


def _namespace_dict(arguments) -> dict:
    d = {k: v for k, v in vars(arguments).items() if k not in _EXCLUDED}
    return d


def hash_namespace(arguments) -> str:
    """md5 of the sorted-JSON namespace (reference results.py:8-11)."""
    s = json.dumps(_namespace_dict(arguments), sort_keys=True, default=str)
    return hashlib.md5(s.encode()).hexdigest()


def _folder(arguments) -> str:
    return getattr(arguments, "results_folder", "results/")


def check_exists(arguments) -> bool:
    """Skip duplicate runs (reference results.py:13-17)."""
    return os.path.exists(os.path.join(_folder(arguments), hash_namespace(arguments) + ".csv"))


# ---------------------------------------------------------------- cells

def _missing(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and math.isnan(v))


def _format(v) -> str:
    """One cell as pandas writes it."""
    if _missing(v):
        return ""
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, np.floating):
        return str(v)                      # shortest form of its own width
    if isinstance(v, float):
        return repr(v)
    return str(v)


def _parse(s: str):
    """One cell as read before its column's type is known: None (missing),
    bool, int, float or the string itself."""
    if s in _NA:
        return None
    if s in _BOOLS:
        return _BOOLS[s]
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s


def _kind(values) -> str:
    """pandas' type for a column holding these cells (None = missing)."""
    present = [v for v in values if v is not None]
    missing = len(present) < len(values)
    if not present:
        return "float"
    if all(isinstance(v, bool) for v in present):
        return "object" if missing else "bool"
    if all(isinstance(v, int) and not isinstance(v, bool) for v in present):
        return "float" if missing else "int"
    if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in present):
        return "float"
    return "object"


def _column(values) -> np.ndarray:
    kind = _kind(values)
    if kind == "int":
        return np.array(values, dtype=np.int64)
    if kind == "bool":
        return np.array(values, dtype=bool)
    if kind == "float":
        return np.array([np.nan if v is None else float(v) for v in values], dtype=np.float64)
    out = np.empty(len(values), dtype=object)
    out[:] = [np.nan if v is None else v for v in values]
    return out


def _cells(col: np.ndarray) -> list:
    """A table column back to cells (None = missing), keeping its type."""
    if col.dtype == object:
        return [None if _missing(v) else v for v in col]
    if col.dtype.kind == "f":
        return [None if math.isnan(v) else float(v) for v in col]
    return col.tolist()


def _read_cells(path: str) -> dict[str, list]:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        return {}
    header, body = rows[0], rows[1:]
    return {name: [_parse(r[j]) if j < len(r) else None for r in body]
            for j, name in enumerate(header)}


def _concat(parts: list[dict[str, list]]) -> dict[str, list]:
    """Column-aligned concatenation (columns in order of first appearance;
    cells a part lacks are missing)."""
    names: list[str] = []
    for p in parts:
        names += [k for k in p if k not in names]
    lengths = [len(next(iter(p.values()))) if p else 0 for p in parts]
    return {k: [c for p, n in zip(parts, lengths) for c in p.get(k, [None] * n)]
            for k in names}


def _write(path: str, columns: dict[str, list]) -> None:
    """Write cells column by column as pandas writes a frame of them: a
    column whose type is float writes its ints as floats."""
    names = list(columns)
    out = []
    for k in names:
        vals = columns[k]
        if _kind(vals) == "float":
            vals = [None if v is None else
                    (v if isinstance(v, (float, np.floating)) else float(v)) for v in vals]
        out.append([_format(v) for v in vals])
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        w.writerows(zip(*out))


def read_csv(path: str) -> Table:
    """One results CSV (or the manifest) as a :class:`Table`."""
    return Table({k: _column(v) for k, v in _read_cells(path).items()})


# ---------------------------------------------------------------- store

def save(arguments, **kwargs) -> str:
    """One CSV per arg-hash (columns = namespace values + result arrays) and
    an appended manifest row (reference results.py:38-59)."""
    folder = _folder(arguments)
    os.makedirs(folder, exist_ok=True)
    h = hash_namespace(arguments)
    ns = _namespace_dict(arguments)

    arrays = {k: np.atleast_1d(np.asarray(v)) for k, v in kwargs.items()}
    lengths = {a.shape[0] for a in arrays.values()}
    if len(lengths) > 1:
        raise ValueError(f"result arrays have mismatched lengths: "
                         f"{ {k: v.shape for k, v in arrays.items()} }")
    n = lengths.pop() if lengths else 1

    cols = {k: [v] * n for k, v in ns.items()}
    for k, v in arrays.items():
        # a row of a 2-D result is written as its list (the JAX package's
        # .tolist()); 1-D results keep their numpy scalars
        cols[k] = v.reshape(n, -1).tolist() if v.ndim > 1 else list(v)
    path = os.path.join(folder, h + ".csv")
    _write(path, cols)

    manifest = os.path.join(folder, "manifest.csv")
    row = {k: [v] for k, v in {**ns, "hash": h}.items()}
    if os.path.exists(manifest):
        # column-aligned append (namespaces can differ across experiments)
        row = _concat([_read_cells(manifest), row])
    _write(manifest, row)
    return path


def load_matching(to_match, folder: str | None = None) -> Table | None:
    """Scan result CSVs; keep rows whose shared columns match ``to_match``
    (reference results.py:19-36).  A cell matches when its text, as
    pandas' ``astype(str)`` gives it for the column's type, equals
    ``str(value)``; missing cells never match."""
    if not isinstance(to_match, dict):
        to_match = _namespace_dict(to_match)
    folder = folder or to_match.get("results_folder", "results/")
    if not os.path.isdir(folder):
        return None
    parts = []
    for fn in sorted(os.listdir(folder)):
        if not fn.endswith(".csv") or fn == "manifest.csv":
            continue
        t = read_csv(os.path.join(folder, fn))
        keep = np.ones(t.nrows, dtype=bool)
        for k, v in to_match.items():
            if k in t and v is not None:
                keep &= np.array([not _missing(c) and _format(c) == str(v)
                                  for c in _cells(t[k])], dtype=bool)
        if keep.any():
            parts.append({k: _cells(col[keep]) for k, col in t.items()})
    if not parts:
        return None
    return Table({k: _column(v) for k, v in _concat(parts).items()})
