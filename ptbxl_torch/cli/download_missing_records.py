"""Complete a partial local PTB-XL mirror (port of
``scripts/01_download_missing_records.py``).

    python -m ptbxl_torch.cli.download_missing_records --base_dir DIR
        [--base_url URL] [--max_missing N]

Diffs ``ptbxl_database.csv`` against the waveform files on disk and fetches
the absent ``.hea``/``.dat`` files from ``--base_url`` (``data/fetch.py``).
Exits 1 when a record stays incomplete.  Host only: no device flag.
"""

from __future__ import annotations

import argparse
import sys

from ptbxl_torch.data.fetch import DEFAULT_BASE_URL, FetchReport, fetch_missing


def main(argv=None) -> FetchReport:
    parser = argparse.ArgumentParser(
        description="Download missing PTB-XL waveform records from PhysioNet.")
    parser.add_argument("--base_dir", type=str, required=True,
                        help="Local PTB-XL directory containing ptbxl_database.csv.")
    parser.add_argument("--base_url", type=str, default=DEFAULT_BASE_URL,
                        help="Remote base URL of PTB-XL dataset.")
    parser.add_argument("--max_missing", type=int, default=None,
                        help="Limit number of records to download.")
    args = parser.parse_args(argv)

    report = fetch_missing(args.base_dir, args.base_url, args.max_missing)
    if report.failed_records:
        sys.exit(1)
    return report


if __name__ == "__main__":
    main()
