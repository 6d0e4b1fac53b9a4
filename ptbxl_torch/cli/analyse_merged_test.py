"""Recompute the metrics from the merged CSV (port of ``scripts/10_analyse_merged_test.py``).

    python -m ptbxl_torch.cli.analyse_merged_test [--merged_csv CSV] [--threshold 0.5]

The reference quirk is kept: this CLI alone takes the labels in
**alphabetical** order (CD, HYP, MI, NORM, STTC).  Truth and probabilities
are cast to float32 before ``compute_metrics``, as the JAX script casts
them.  Host only: no tensor work, no device flag.  Returns the printed
metrics by header.
"""

from __future__ import annotations

import argparse

import numpy as np

from ptbxl_torch.training.metrics import compute_metrics
from ptbxl_torch.utils.table import read_csv

ECG_LABELS = ["CD", "HYP", "MI", "NORM", "STTC"]  # alphabetical (quirk)


def _values(t, names) -> np.ndarray:
    return np.array([t[n] for n in names], dtype=np.float64).T.astype(np.float32)


def _report(header, y_true, y_prob, threshold):
    print(f"\n{header}")
    metrics = compute_metrics(y_true, y_prob, threshold=threshold)
    for k, v in metrics.items():
        print(f"  {k}: {v}")
    return metrics


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--merged_csv", type=str,
        default="outputs/merged/test_03_04_05_merged.csv",
        help="Merged prediction file from baseline, multimodal and AF models.",
    )
    parser.add_argument(
        "--threshold", type=float, default=0.5,
        help="Threshold used for computing F1 and other metrics.",
    )
    args = parser.parse_args(argv)

    print("[INFO] Loading merged CSV:", args.merged_csv)
    t = read_csv(args.merged_csv)
    print("[INFO] merged shape:", (len(t), len(t.columns)))
    print("[INFO] ECG labels:", ECG_LABELS)

    truth = _values(t, [f"y_true_{lbl}" for lbl in ECG_LABELS])
    out = {}
    header = "[Baseline ECG][TEST] metrics:"
    out[header] = _report(header, truth, _values(t, [f"y_prob_{lbl}" for lbl in ECG_LABELS]),
                          args.threshold)

    mm_cols = [f"y_prob_{lbl}_mm" for lbl in ECG_LABELS]
    if all(c in t for c in mm_cols):
        header = "[ECG + demographics][TEST] metrics:"
        out[header] = _report(header, truth, _values(t, mm_cols), args.threshold)
    else:
        print("\n[WARN] Multimodal columns not found; skip ECG+demographics metrics.")

    if "y_true_AF" in t and "y_prob_AF" in t:
        header = "[AF binary][TEST] metrics:"
        out[header] = _report(header, _values(t, ["y_true_AF"]), _values(t, ["y_prob_AF"]),
                              args.threshold)
    else:
        print("\n[WARN] AF columns not found in merged CSV.")
    return out


if __name__ == "__main__":
    main()
