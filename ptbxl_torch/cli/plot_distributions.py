"""KDE probability-density figures (port of ``scripts/15_plot_distributions.py``).

    python -m ptbxl_torch.cli.plot_distributions
        [--merged_csv outputs/merged/test_03_04_05_merged.csv] [--out_dir outputs/figures]

Writes the MI, pooled and AF density figures under ``--out_dir``
(``analysis/figures.py``); a figure is skipped, with a line that says so,
where matplotlib or seaborn is missing.  The JAX script hard-codes both
paths; here they are flags with its paths as defaults.  Host only: no tensor
work, no device flag.  Returns the ``{png name: written}`` map.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ptbxl_torch.analysis.figures import render_distribution_figures
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

    drawn = render_distribution_figures(t, out_dir)

    print("[INFO] Distribution figures saved.")
    return drawn


if __name__ == "__main__":
    main()
