"""Merge the three per-task prediction CSVs (port of ``scripts/09_merge_all_test.py``).

    python -m ptbxl_torch.cli.merge_all_test [--baseline_csv CSV] [--multimodal_csv CSV]
        [--af_csv CSV] [--out_csv CSV]

Baseline columns, then multimodal without its ``y_true_*``, then AF, by row
position (``analysis/merge.py``).  Host only: no tensor work, no device flag.
"""

from __future__ import annotations

import argparse
import os

from ptbxl_torch.analysis.merge import merge_prediction_frames
from ptbxl_torch.utils.table import read_csv, write_csv

DEFAULTS = {
    "baseline_csv": "outputs/ecg_baseline/preds/ecg_baseline_test_preds.csv",
    "multimodal_csv": "outputs/ecg_multimodal/preds/ecg_multimodal_test_preds.csv",
    "af_csv": "outputs/af_binary/preds/af_binary_test_preds.csv",
    "out_csv": "outputs/merged/test_03_04_05_merged.csv",
}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for flag, default in DEFAULTS.items():
        parser.add_argument(f"--{flag}", type=str, default=default)
    args = parser.parse_args(argv)

    frames = {}
    for name, path in (("baseline", args.baseline_csv),
                       ("multimodal", args.multimodal_csv),
                       ("AF", args.af_csv)):
        print(f"[INFO] Loading {name}:", path)
        frames[name] = read_csv(path)

    merged = merge_prediction_frames(frames["baseline"], frames["multimodal"], frames["AF"])

    os.makedirs(os.path.dirname(args.out_csv) or ".", exist_ok=True)
    write_csv(args.out_csv, {c: merged[c] for c in merged.columns})
    print("[INFO] Saved merged CSV to:", args.out_csv)
    print("[INFO] merged shape:", (len(merged), len(merged.columns)))
    return merged


if __name__ == "__main__":
    main()
