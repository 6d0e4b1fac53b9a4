"""PTB-XL metadata and labels (port of ``ptbxl_tpu/utils/label_maps.py:28-121``).

The port's copy reads the CSVs with ``utils/table.py`` (no pandas) and keeps
the reference's semantics (src/utils/label_maps.py):

* ``load_metadata``: ``ptbxl_database.csv`` and ``scp_statements.csv``, the
  scp table's first column renamed ``scp_code``;
* ``build_label_matrix``: each ``scp_codes`` dict-string through
  ``ast.literal_eval``, each code through ``diagnostic_class``, multi-hot
  ``[N, C]`` f32; unparseable or non-dict rows stay all zero;
* ``find_af_codes`` / ``build_af_binary_labels``: AF = any code whose
  description holds "atrial fibrillation", case-insensitive, as a literal
  substring -> ``[N, 1]`` f32.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ptbxl_torch.utils.table import Table, is_na, read_csv


def load_metadata(base_dir: str) -> Tuple[Table, Table]:
    """Load ptbxl_database.csv and scp_statements.csv; ensure a 'scp_code' column."""
    db_path = os.path.join(base_dir, "ptbxl_database.csv")
    scp_path = os.path.join(base_dir, "scp_statements.csv")
    if not os.path.exists(db_path):
        raise FileNotFoundError(f"ptbxl_database.csv not found at: {db_path}")
    if not os.path.exists(scp_path):
        raise FileNotFoundError(f"scp_statements.csv not found at: {scp_path}")
    df = read_csv(db_path)
    scp = read_csv(scp_path)
    first_col = scp.columns[0]
    if first_col != "scp_code":
        scp = scp.rename(first_col, "scp_code")
    return df, scp


def _parse_scp_codes(raw) -> Optional[Dict]:
    """``ast.literal_eval`` of a scp_codes cell; None on any failure or a non-dict."""
    try:
        codes = ast.literal_eval(raw)
    except Exception:
        return None
    if not isinstance(codes, dict):
        return None
    return codes


def build_label_matrix(df: Table, scp: Table, classes: List[str]) -> np.ndarray:
    """Multi-hot [N, C] float32 over the high-level diagnostic classes."""
    if "diagnostic_class" not in scp:
        raise KeyError("Column 'diagnostic_class' missing in scp_statements.csv.")
    # set_index("scp_code")[...].to_dict(): a repeated code keeps its last row
    code_to_class = dict(zip(scp["scp_code"], scp["diagnostic_class"]))
    class_index = {cls: i for i, cls in enumerate(classes)}
    labels = np.zeros((len(df), len(classes)), dtype=np.float32)
    for i, raw in enumerate(df["scp_codes"]):
        codes = _parse_scp_codes(raw)
        if codes is None:
            continue
        for code in codes.keys():
            diag = code_to_class.get(code)
            if not is_na(diag) and diag in class_index:
                labels[i, class_index[diag]] = 1.0
    return labels


def find_af_codes(scp: Table, keywords: Optional[List[str]] = None) -> List[str]:
    """SCP codes whose description contains any keyword, case-insensitive
    (``astype(str).str.lower()``: a missing description reads as "nan")."""
    if keywords is None:
        keywords = ["atrial fibrillation"]
    if "description" not in scp:
        raise KeyError("Column 'description' missing in scp_statements.csv.")
    desc = [str(d).lower() for d in scp["description"]]
    return [code for code, d in zip(scp["scp_code"], desc) if any(kw in d for kw in keywords)]


def build_af_binary_labels(df: Table, scp: Table,
                           keywords: Optional[List[str]] = None) -> np.ndarray:
    """Binary AF labels [N, 1] float32."""
    af_codes = set(find_af_codes(scp, keywords))
    labels = np.zeros((len(df), 1), dtype=np.float32)
    for i, raw in enumerate(df["scp_codes"]):
        codes = _parse_scp_codes(raw)
        if codes is None:
            continue
        if any(code in af_codes for code in codes.keys()):
            labels[i, 0] = 1.0
    return labels
