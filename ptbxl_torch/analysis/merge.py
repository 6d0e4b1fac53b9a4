"""Prediction-CSV merging (port of ``ptbxl_tpu/analysis/merge.py``; CLI 09).

Column-concatenates the three per-task prediction tables by position; the
ground-truth columns are kept from the baseline table only, and the row
counts must agree.  Tables are ``utils/table.py`` ``Table``s (the port has
no pandas); written with ``write_csv`` the merged CSV has the JAX script's
bytes.
"""

from __future__ import annotations

from ptbxl_torch.utils.table import Table


def merge_prediction_frames(base: Table, mm: Table, af: Table) -> Table:
    n = len(base)
    if len(mm) != n or len(af) != n:
        raise ValueError(
            f"Row count mismatch: baseline={len(base)}, multimodal={len(mm)}, AF={len(af)}"
        )
    parts = [(base, base.columns), (mm, [c for c in mm.columns if not c.startswith("y_true_")]),
             (af, af.columns)]
    columns = [c for _, cols in parts for c in cols]
    if len(set(columns)) != len(columns):
        raise ValueError(f"the merged tables repeat a column: {columns}")
    return Table(columns, {c: t[c] for t, cols in parts for c in cols})
