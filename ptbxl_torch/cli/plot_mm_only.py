"""Multimodal-only per-class ROC/PR and MI distribution (port of ``scripts/17_plot_mm_only.py``).

    python -m ptbxl_torch.cli.plot_mm_only
        [--merged_csv outputs/merged/test_03_04_05_merged.csv] [--out_dir outputs/figures]

Writes the multimodal model's per-class ROC and PR curves and its MI density
under ``--out_dir`` (``analysis/figures.py``); a figure is skipped, with a
line that says so, where matplotlib or seaborn is missing.  The JAX script
hard-codes both paths; here they are flags with its paths as defaults.  Host
only: no tensor work, no device flag.  Returns the ``{png name: written}``
map.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ptbxl_torch.analysis.figures import ORANGE, render_single_model_figures
from ptbxl_torch.utils.table import read_csv


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--merged_csv", type=str, default="outputs/merged/test_03_04_05_merged.csv")
    parser.add_argument("--out_dir", type=str, default="outputs/figures")
    args = parser.parse_args(argv)
    merged_path = Path(args.merged_csv)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    t = read_csv(str(merged_path))
    print("[INFO] Loaded merged CSV:", (len(t), len(t.columns)))

    drawn = render_single_model_figures(
        t, out_dir,
        suffix="_mm",
        color=ORANGE,
        file_names={
            "roc": "mm_m1_per_class_roc.png",
            "pr": "mm_m2_per_class_pr.png",
            "mi": "mm_m3_mi_distribution.png",
        },
        titles={
            "roc": "Multimodal per-class ROC curves",
            "pr": "Multimodal per-class Precision-Recall curves",
            "mi": "Multimodal MI prediction distribution",
        },
        mi_labels=("MI = 1", "MI = 0"),
    )

    print("[INFO] Multimodal figures saved to:", out_dir.resolve())
    return drawn


if __name__ == "__main__":
    main()
