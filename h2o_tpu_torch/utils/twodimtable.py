"""TwoDimTable — the tabular-results container (``h2o_tpu/utils/
twodimtable.py``, `water/util/TwoDimTable.java`): a named table with typed
columns, row headers and console rendering, the form the metrics publish
their max-criteria, gains/lift and multinomial AUC tables in."""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np


class TwoDimTable:
    def __init__(self, table_header: str = "", description: str = "",
                 col_header: Sequence[str] = (),
                 col_types: Sequence[str] | None = None,
                 row_headers: Sequence[str] | None = None,
                 cell_values: Sequence[Sequence[Any]] | None = None):
        self.table_header = table_header
        self.description = description
        self.col_header = list(col_header)
        self.col_types = list(col_types) if col_types else \
            ["string"] * len(self.col_header)
        self.row_headers = list(row_headers) if row_headers else None
        self.cell_values = [list(r) for r in (cell_values or [])]

    def _fmt(self, v) -> str:
        if v is None:
            return ""
        if isinstance(v, (float, np.floating)):
            return f"{v:.5f}" if abs(v) < 1e6 else f"{v:.3e}"
        return str(v)

    def __repr__(self) -> str:
        headers = ([""] if self.row_headers else []) + self.col_header
        rows = []
        for i, r in enumerate(self.cell_values):
            lead = [self.row_headers[i]] if self.row_headers else []
            rows.append(lead + [self._fmt(v) for v in r])
        widths = [max(len(h), *(len(row[j]) for row in rows)) if rows
                  else len(h) for j, h in enumerate(headers)]
        out = [self.table_header] if self.table_header else []
        if self.description:
            out.append(self.description)
        out.append("  ".join(h.ljust(w) for h, w in zip(headers, widths)))
        out.append("  ".join("-" * w for w in widths))
        for row in rows:
            out.append("  ".join(v.ljust(w) for v, w in zip(row, widths)))
        return "\n".join(out)
