"""Per-epoch metrics CSV (port of ``ptbxl_tpu/utils/csv_log.py``).

The reference's 10 columns, append mode, header written when the file is
created (reference: scripts/03_train_ecg_baseline.py:26-58); byte for byte
the JAX package's rows.
"""

from __future__ import annotations

import csv
import os
from datetime import datetime
from typing import Dict

EPOCH_CSV_HEADER = [
    "datetime",
    "run_name",
    "epoch",
    "train_bce",
    "val_auroc_macro",
    "val_auprc_macro",
    "val_f1_macro",
    "val_bce_loss",
    "ckpt_path",
    "config_path",
]


def log_epoch_to_csv(
    csv_path: str,
    run_name: str,
    epoch: int,
    train_loss: float,
    val_metrics: Dict[str, float],
    ckpt_path: str,
    config_path: str,
) -> None:
    """Append one epoch row; create the file with the header if needed."""
    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    file_exists = os.path.exists(csv_path)
    with open(csv_path, "a", newline="") as f:
        writer = csv.writer(f)
        if not file_exists:
            writer.writerow(EPOCH_CSV_HEADER)
        writer.writerow([
            datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
            run_name,
            epoch,
            float(train_loss),
            float(val_metrics.get("auroc_macro", -1)),
            float(val_metrics.get("auprc_macro", -1)),
            float(val_metrics.get("f1_macro", -1)),
            float(val_metrics.get("bce_loss", -1)),
            ckpt_path,
            config_path,
        ])
