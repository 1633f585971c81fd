"""Minimal columnar table (the pandas stand-in of the prototype)."""
from __future__ import annotations

from itertools import compress
from typing import Any, Callable, Dict, List, Optional, Sequence


class Table:
    def __init__(self, columns: Dict[str, List[Any]]):
        columns = dict(columns)
        lens = {k: len(v) for k, v in columns.items()}
        if len(set(lens.values())) > 1:
            raise ValueError(
                "ragged columns: every column must have the same length, "
                f"got {lens}")
        self.columns = columns

    @classmethod
    def from_rows(cls, rows: Sequence[Dict[str, Any]]) -> "Table":
        rows = list(rows)
        if not rows:
            return cls({})
        keys = list(rows[0])
        cols: Dict[str, List[Any]] = {k: [] for k in keys}
        for i, r in enumerate(rows):
            if set(r) != set(keys):
                missing = sorted(set(keys) - set(r))
                extra = sorted(set(r) - set(keys))
                raise ValueError(
                    f"from_rows: row {i} does not match row 0's schema "
                    f"(missing {missing}, unexpected {extra}) — a silent "
                    f"mismatch would build ragged columns")
            for k in keys:
                cols[k].append(r[k])
        return cls(cols)

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()), []))

    def __getitem__(self, col: str) -> List[Any]:
        try:
            return self.columns[col]
        except KeyError:
            raise KeyError(f"no column {col!r}; available: "
                           f"{sorted(self.columns)}") from None

    def with_column(self, name: str, values: List[Any]) -> "Table":
        values = list(values)
        if len(values) != len(self):
            raise ValueError(
                f"with_column({name!r}): {len(values)} values for "
                f"{len(self)} rows")
        out = dict(self.columns)
        out[name] = values
        return Table(out)

    def select(self, cols: Sequence[str]) -> "Table":
        cols = list(cols)
        if not cols:
            raise ValueError(
                "select() needs at least one column — a zero-column "
                "table cannot represent its row count")
        missing = [c for c in cols if c not in self.columns]
        if missing:
            raise KeyError(f"select: no column(s) {missing}; available: "
                           f"{sorted(self.columns)}")
        return Table({c: self.columns[c] for c in cols})

    def take(self, idxs: Sequence[int]) -> "Table":
        """Row subset by index, in the given order."""
        return Table({k: [v[i] for i in idxs]
                      for k, v in self.columns.items()})

    def filter(self, pred: Callable[[Dict[str, Any]], bool]) -> "Table":
        """Keep rows where ``pred(row_dict)`` is truthy.

        Columnar fast path: rows are assembled via one ``zip`` sweep
        over the column lists (C-speed) instead of per-index random
        access into every column, and surviving columns are rebuilt
        with ``itertools.compress`` — same observable semantics (the
        pred still receives a real per-row dict), several times fewer
        Python-level operations per row.
        """
        if not self.columns:
            return Table({})
        names = tuple(self.columns)
        cols = tuple(self.columns.values())
        keep = [bool(pred(dict(zip(names, vals))))
                for vals in zip(*cols)]
        return Table({k: list(compress(c, keep))
                      for k, c in zip(names, cols)})

    def row(self, i: int) -> Dict[str, Any]:
        return {k: v[i] for k, v in self.columns.items()}

    def rows(self) -> List[Dict[str, Any]]:
        return [self.row(i) for i in range(len(self))]

    def head(self, n: int = 5) -> "Table":
        return Table({k: v[:n] for k, v in self.columns.items()})

    def __repr__(self) -> str:
        cols = list(self.columns)
        lines = [" | ".join(cols)]
        for i in range(min(len(self), 8)):
            lines.append(" | ".join(str(self.columns[c][i])[:32]
                                    for c in cols))
        if len(self) > 8:
            lines.append(f"... ({len(self)} rows)")
        return "\n".join(lines)
