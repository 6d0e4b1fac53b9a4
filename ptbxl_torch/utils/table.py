"""A small column table read from and written to CSV with the stdlib ``csv`` module.

The JAX package reads PTB-XL's CSVs with ``pd.read_csv`` and writes the
prediction CSVs with ``DataFrame.to_csv``; the port has no pandas (the GPU
machine does not list it), so this module reproduces what the data layer
relies on:

* reading: quoted fields with commas and newlines (PTB-XL's ``report``
  column); empty cells and pandas' default NA strings become NaN; a column
  whose other cells are all integers becomes ints (floats when it also has
  NaN, as pandas makes it float64), all numbers floats, all ``True`` /
  ``False`` bools; any other column keeps its strings, with NaN for NA
  (``scp_codes``, ``filename_hr``, ``pacemaker``);
* writing: ``to_csv(index=False)``'s text: ints as ints, Python floats by
  ``repr``, numpy floats by ``str`` (float32 in its shortest form), NaN as an
  empty cell, ``\\n`` line ends, minimal quoting.

``Table`` keeps the columns in file order; ``t[name]`` is a column (a list),
``t.row(i)`` a dict, ``t.take(idx)`` / ``t.where(mask)`` a new table.
"""

from __future__ import annotations

import csv
import math
import re
from typing import Any, Dict, Iterable, List, Mapping, Sequence

import numpy as np

# pandas' default NA strings (pandas.io.parsers: STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT = re.compile(r"^[+-]?\d+$")
_BOOL = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False,
         "false": False}
NAN = float("nan")


def is_na(v: Any) -> bool:
    """pandas' ``isna`` for one cell: None or a float NaN."""
    return v is None or (isinstance(v, (float, np.floating)) and math.isnan(v))


def _is_float(s: str) -> bool:
    try:
        float(s)
    except ValueError:
        return False
    return "_" not in s  # Python's float() takes 1_000, pandas does not


def _column(cells: List[str]) -> list:
    """Type one column's cells as ``pd.read_csv`` would."""
    vals = [c for c in cells if c not in NA_STRINGS]
    has_na = len(vals) < len(cells)
    if not vals:
        return [NAN] * len(cells)
    if all(_INT.match(v) for v in vals):
        conv = float if has_na else int
        return [NAN if c in NA_STRINGS else conv(int(c)) for c in cells]
    if all(_is_float(v) for v in vals):
        return [NAN if c in NA_STRINGS else float(c) for c in cells]
    if not has_na and all(v in _BOOL for v in vals):
        return [_BOOL[c] for c in cells]
    return [NAN if c in NA_STRINGS else c for c in cells]


class Table:
    """Columns of equal length, in order."""

    def __init__(self, columns: Sequence[str], data: Mapping[str, Sequence]):
        self.columns = list(columns)
        self._data: Dict[str, list] = {c: list(data[c]) for c in self.columns}
        lengths = {len(v) for v in self._data.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal length: {sorted(lengths)}")
        self._n = lengths.pop() if lengths else 0

    def __len__(self) -> int:
        return self._n

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __getitem__(self, name: str) -> list:
        return self._data[name]

    def row(self, i: int) -> Dict[str, Any]:
        return {c: self._data[c][i] for c in self.columns}

    def rows(self) -> Iterable[Dict[str, Any]]:
        return (self.row(i) for i in range(self._n))

    def take(self, idx: Sequence[int]) -> "Table":
        return Table(self.columns, {c: [v[i] for i in idx] for c, v in self._data.items()})

    def where(self, mask: Sequence[bool]) -> "Table":
        return self.take([i for i, keep in enumerate(mask) if keep])

    def rename(self, old: str, new: str) -> "Table":
        cols = [new if c == old else c for c in self.columns]
        return Table(cols, {new if c == old else c: v for c, v in self._data.items()})


def read_csv(path: str) -> Table:
    """A CSV with a header row -> ``Table`` (a blank header becomes
    ``Unnamed: i``, as in pandas)."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"empty CSV: {path}")
    header = [h if h != "" else f"Unnamed: {i}" for i, h in enumerate(rows[0])]
    body = [r for r in rows[1:] if r]
    for r in body:
        if len(r) != len(header):
            raise ValueError(f"{path}: a row has {len(r)} fields, the header {len(header)}")
    return Table(header, {h: _column([r[i] for r in body]) for i, h in enumerate(header)})


def _cell(v: Any) -> str:
    if is_na(v):
        return ""
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, np.floating):
        return str(v)
    if isinstance(v, float):
        return repr(v)
    return str(v)


def write_csv(path: str, columns: Mapping[str, Sequence]) -> None:
    """Write ``{name: values}`` (equal lengths, in order) as ``to_csv(index=False)`` does."""
    names = list(columns)
    n = {len(v) for v in columns.values()}
    if len(n) > 1:
        raise ValueError(f"columns of unequal length: {sorted(n)}")
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        for i in range(n.pop() if n else 0):
            w.writerow([_cell(columns[c][i]) for c in names])
