"""PTB-XL record fetcher: completes a partial local mirror (port of
``ptbxl_tpu/data/fetch.py``).

Reads ``ptbxl_database.csv`` (through ``utils/table.py``: the GPU machine has
no pandas), finds the ``filename_hr`` rows whose ``.hea``/``.dat`` pair is
incomplete on disk and fetches the absent files from a base URL with bounded
retries: stdlib ``urllib``, atomic ``.part``-then-rename writes (an
interrupted run never leaves a truncated record for the WFDB reader), and an
injectable ``opener`` and ``log`` for hermetic tests.  Host only.
"""

from __future__ import annotations

import os
import shutil
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ptbxl_torch.utils.table import read_csv

DEFAULT_BASE_URL = "https://physionet.org/files/ptb-xl/1.0.3/"
WAVEFORM_SUFFIXES = (".hea", ".dat")


@dataclass
class FetchReport:
    """Outcome of one fetch run."""

    missing: int = 0
    attempted: int = 0
    completed: int = 0
    failed_records: List[str] = field(default_factory=list)


def scan_missing(base_dir: str) -> List[str]:
    """Relative record paths (``filename_hr``) with an incomplete file pair.

    Raises ``FileNotFoundError`` without the metadata CSV and ``KeyError``
    without its ``filename_hr`` column: nothing can be diffed without them.
    """
    csv_path = os.path.join(base_dir, "ptbxl_database.csv")
    if not os.path.exists(csv_path):
        raise FileNotFoundError(f"ptbxl_database.csv not found at {csv_path}")
    table = read_csv(csv_path)
    if "filename_hr" not in table:
        raise KeyError("Column 'filename_hr' missing in ptbxl_database.csv")

    incomplete = []
    for rel in map(str, table["filename_hr"]):
        stem = os.path.join(base_dir, rel)
        if any(not os.path.exists(stem + sfx) for sfx in WAVEFORM_SUFFIXES):
            incomplete.append(rel)
    return incomplete


def _default_opener(url: str):
    return urllib.request.urlopen(url, timeout=30)


def fetch_one(
    url: str,
    dest: str,
    retries: int = 3,
    retry_wait: float = 1.0,
    opener: Callable = _default_opener,
    log: Callable[[str], None] = print,
) -> bool:
    """Fetch ``url`` into ``dest`` atomically; True on success.

    The payload streams into ``dest + '.part'`` and is renamed only once the
    transfer finishes, so a partial download is never taken for a record.
    """
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    part = dest + ".part"
    for attempt in range(1, retries + 1):
        try:
            log(f"    GET {url} [try {attempt}/{retries}]")
            with opener(url) as resp, open(part, "wb") as sink:
                shutil.copyfileobj(resp, sink)
            os.replace(part, dest)
            return True
        except urllib.error.HTTPError as err:
            log(f"    server returned {err.code} for {url}")
        except Exception as err:  # noqa: BLE001 -- a transfer error is retried, then reported
            log(f"    transfer error: {err}")
        if attempt < retries:
            time.sleep(retry_wait)
    if os.path.exists(part):
        os.remove(part)
    log(f"    giving up on {url}")
    return False


def fetch_missing(
    base_dir: str,
    base_url: str = DEFAULT_BASE_URL,
    max_missing: Optional[int] = None,
    retries: int = 3,
    retry_wait: float = 1.0,
    opener: Callable = _default_opener,
    log: Callable[[str], None] = print,
) -> FetchReport:
    """Diff the local mirror against the metadata CSV and fill the gaps."""
    log(f"Scanning {base_dir} against ptbxl_database.csv ...")
    gaps = scan_missing(base_dir)
    report = FetchReport(missing=len(gaps))
    log(f"{len(gaps)} record(s) have missing waveform files.")
    if not gaps:
        log("Mirror is complete; nothing to fetch.")
        return report

    if max_missing is not None:
        gaps = gaps[:max_missing]
        log(f"Capping this run at {len(gaps)} record(s) (--max_missing).")

    for n, rel in enumerate(gaps, start=1):
        report.attempted += 1
        log(f"[{n}/{len(gaps)}] {rel}")
        record_ok = True
        for sfx in WAVEFORM_SUFFIXES:
            local = os.path.join(base_dir, rel) + sfx
            if os.path.exists(local):
                continue
            url = urllib.parse.urljoin(base_url, rel + sfx)
            if not fetch_one(url, local, retries=retries, retry_wait=retry_wait,
                             opener=opener, log=log):
                record_ok = False
        if record_ok:
            report.completed += 1
        else:
            report.failed_records.append(rel)
            log("    record still incomplete.")

    log(f"Done: {report.completed}/{report.attempted} record(s) completed.")
    if report.failed_records:
        log(f"Failed: {', '.join(report.failed_records)}")
    return report
