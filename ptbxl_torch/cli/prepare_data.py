"""PTB-XL metadata sanity report (port of ``scripts/02_prepare_data.py``).

    python -m ptbxl_torch.cli.prepare_data --base_dir DIR

Row counts, the ``strat_fold`` distribution and the diagnostic-class counts
of ``ptbxl_database.csv`` and ``scp_statements.csv``: the JAX script's
numbers, one ``value: count`` line each where it prints a pandas Series
(folds ascending, classes by count, ties in order of first appearance, NaN
left out).  Host only: no tensor work, no device flag.  Returns the counts.
"""

from __future__ import annotations

import argparse
from collections import Counter
from typing import Dict

from ptbxl_torch.utils.label_maps import load_metadata
from ptbxl_torch.utils.table import is_na


def _value_counts(values) -> Dict:
    """``Series.value_counts()``: count descending, ties in first-seen order."""
    return dict(Counter(v for v in values if not is_na(v)).most_common())


def _print_counts(counts: Dict) -> None:
    for value, n in counts.items():
        print(f"  {value}: {n}")


def report(base_dir: str) -> Dict:
    print(f"Base dir: {base_dir}")

    # load_metadata performs the existence checks + scp_code rename
    df, scp = load_metadata(base_dir)

    print(f"\nLoaded ptbxl_database.csv: {len(df)} rows")
    print("Columns:", list(df.columns))

    out = {"rows": len(df), "strat_fold": dict(sorted(_value_counts(df["strat_fold"]).items())),
           "scp_rows": len(scp)}
    print("\nstrat_fold distribution:")
    _print_counts(out["strat_fold"])

    print(f"\nLoaded scp_statements.csv: {len(scp)} rows")
    print("Columns:", list(scp.columns))

    if "diagnostic_class" in scp:
        out["diagnostic_class"] = _value_counts(scp["diagnostic_class"])
        print("\nDiagnostic classes:")
        _print_counts(out["diagnostic_class"])
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base_dir", type=str, required=True,
                        help="Path to PTB-XL 1.0.3 directory (contains ptbxl_database.csv)")
    return report(parser.parse_args(argv).base_dir)


if __name__ == "__main__":
    main()
