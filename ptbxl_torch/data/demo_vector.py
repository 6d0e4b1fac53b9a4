"""Demographic feature vector for the multimodal model (numpy only).

The port's copy of ``ptbxl_tpu/data/demo_vector.py``: how a serving caller
turns a metadata row into the ``[5]`` vector
``[age_norm, sex_id, height_norm, weight_norm, pacemaker]``, with the
reference's clamp and fallback rules:

* age: a value that ``float()`` refuses, or a non-finite one -> 0; negative
  -> 0; >= 300 -> 90; then /100
* sex: ``"M"`` -> 0, ``"F"`` -> 1, anything else -> 0.5 (PTB-XL's sex column
  is numeric, so real rows give 0.5, as every record of the demo pack has)
* height: refused, non-finite or <= 0 -> 0; /250
* weight: the same, /200
* pacemaker: PTB-XL stores strings (``"ja, pacemaker"``) that ``float()``
  refuses -> 0, so the feature is 0 in practice (kept as the reference has it)
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np


def _safe_float(value: Any, default: float = 0.0) -> float:
    try:
        v = float(value)
    except Exception:
        return default
    if not math.isfinite(v):
        return default
    return v


def build_demo_vector(row: Mapping[str, Any]) -> np.ndarray:
    """row: mapping with age/sex/height/weight/pacemaker -> float32 [5]."""
    age = _safe_float(row.get("age", float("nan")))
    if age < 0:
        age = 0.0
    if age >= 300:
        age = 90.0

    sex = row.get("sex", "UNKNOWN")
    sex_id = 0.0 if sex == "M" else 1.0 if sex == "F" else 0.5

    height = _safe_float(row.get("height", float("nan")))
    if height <= 0:
        height = 0.0
    weight = _safe_float(row.get("weight", float("nan")))
    if weight <= 0:
        weight = 0.0
    pacemaker = _safe_float(row.get("pacemaker", 0))

    return np.array([age / 100.0, sex_id, height / 250.0, weight / 200.0, pacemaker],
                    dtype=np.float32)
