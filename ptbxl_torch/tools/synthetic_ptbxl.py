"""A synthetic PTB-XL tree (the port's copy of ``tests/fixtures/synthetic_ptbxl.py``).

    python -m ptbxl_torch.tools.synthetic_ptbxl OUT_DIR [--n_records 40] [--n_samples 512] [--seed 0]

The port's bench and ``chip_smoke.py`` need a PTB-XL tree and may not import
the test fixture (it imports the JAX package), so this module writes the same
tree: ``ptbxl_database.csv`` (scp_codes dict-strings, strat_fold,
filename_hr, demographics with a numeric sex and a string pacemaker),
``scp_statements.csv`` (diagnostic_class, description; the first column
unnamed) and format-16 WFDB records under ``records500/``, through the port's
``write_record_fmt16`` and the stdlib ``csv`` module.  It draws from
``default_rng(seed)`` in the fixture's order, so one seed gives the same
records, byte for byte, and CSVs that pandas reads as the same frames.

The fixture's edge cases come with it: record 6 (index 5) has no ``.dat``
(the validity filter drops it), index 7 a malformed scp_codes string and
index 8 one that parses to a list (all-zero labels), index 3 a missing age
and index 4 an age of 300 (the demo vector's rules).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ptbxl_torch.io.wfdb_io import write_record_fmt16
from ptbxl_torch.utils.table import write_csv

SCP_STATEMENTS = [
    # scp_code, description, diagnostic_class, diagnostic
    ("IMI", "inferior myocardial infarction", "MI", 1),
    ("AMI", "anterior myocardial infarction", "MI", 1),
    ("NDT", "non-diagnostic T abnormalities", "STTC", 1),
    ("ISC_", "non-specific ischemic", "STTC", 1),
    ("LVH", "left ventricular hypertrophy", "HYP", 1),
    ("RVH", "right ventricular hypertrophy", "HYP", 1),
    ("CLBBB", "complete left bundle branch block", "CD", 1),
    ("IRBBB", "incomplete right bundle branch block", "CD", 1),
    ("NORM", "normal ECG", "NORM", 1),
    ("AFIB", "atrial fibrillation", "", 0),
    ("AFLT", "atrial flutter", "", 0),
    ("SR", "sinus rhythm", "", 0),
]

_CODE_POOL = ["IMI", "AMI", "NDT", "ISC_", "LVH", "RVH", "CLBBB", "IRBBB", "NORM", "AFIB", "SR"]
COLUMNS = ["ecg_id", "patient_id", "age", "sex", "height", "weight", "pacemaker", "scp_codes",
           "strat_fold", "filename_lr", "filename_hr"]


def _ecg_waveform(rng: np.random.Generator, n_samples: int, fs: float = 500.0) -> np.ndarray:
    """A crude 12-lead ECG-ish signal: beat impulses + baseline wander + noise, [T, 12]."""
    t = np.arange(n_samples) / fs
    hr = rng.uniform(50, 100)  # bpm
    beat = np.sin(2 * np.pi * hr / 60.0 * t) ** 63  # spiky R-ish peaks
    leads = []
    for _ in range(12):
        amp = rng.uniform(0.5, 2.0)
        baseline_wander = 0.1 * np.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 6))
        noise = 0.02 * rng.standard_normal(n_samples)
        leads.append(amp * beat + baseline_wander + noise)
    return np.stack(leads, axis=1)


def make_synthetic_ptbxl(base_dir: str, n_records: int = 40, n_samples: int = 512,
                         seed: int = 0) -> dict:
    """Write the CSVs and WFDB records into ``base_dir``; return the database
    columns ``{name: list}``."""
    rng = np.random.default_rng(seed)
    os.makedirs(base_dir, exist_ok=True)
    # PTB-XL's first scp column is the unnamed index of scp codes
    write_csv(os.path.join(base_dir, "scp_statements.csv"), {
        "": [s[0] for s in SCP_STATEMENTS],
        "description": [s[1] for s in SCP_STATEMENTS],
        "diagnostic_class": [s[2] for s in SCP_STATEMENTS],
        "diagnostic": [s[3] for s in SCP_STATEMENTS],
    })

    cols = {c: [] for c in COLUMNS}
    for i in range(n_records):
        ecg_id = i + 1
        n_codes = rng.integers(1, 4)
        codes = list(rng.choice(_CODE_POOL, size=n_codes, replace=False))
        scp_codes = "{" + ", ".join(f"'{c}': {float(rng.choice([0, 50, 100]))}"
                                    for c in codes) + "}"
        age = float(rng.integers(20, 90))
        if i == 3:
            age = np.nan  # the multimodal dataset drops this row
        if i == 4:
            age = 300.0  # clamps to 90
        sex = int(rng.integers(0, 2))  # numeric, like real PTB-XL
        height = float(rng.integers(150, 200)) if rng.random() > 0.3 else np.nan
        weight = float(rng.integers(45, 120)) if rng.random() > 0.3 else np.nan
        pacemaker = "ja, pacemaker" if rng.random() < 0.1 else ""
        strat_fold = (i % 10) + 1  # folds 1..10 round-robin: every split is populated
        if i == 7:
            scp_codes = "{'IMI': broken"  # malformed -> all-zero labels
        if i == 8:
            scp_codes = "['IMI']"  # parses to a list -> all-zero labels
        row = dict(ecg_id=ecg_id, patient_id=1000 + i, age=age, sex=sex, height=height,
                   weight=weight, pacemaker=pacemaker, scp_codes=scp_codes,
                   strat_fold=strat_fold, filename_lr=f"records100/00000/{ecg_id:05d}_lr",
                   filename_hr=f"records500/00000/{ecg_id:05d}_hr")
        for c in COLUMNS:
            cols[c].append(row[c])
    write_csv(os.path.join(base_dir, "ptbxl_database.csv"), cols)

    for i, rel in enumerate(cols["filename_hr"]):
        rec_path = os.path.join(base_dir, rel)
        write_record_fmt16(rec_path, _ecg_waveform(rng, n_samples), fs=500.0, gain=1000.0)
        if i == 5:
            os.remove(rec_path + ".dat")  # unreadable record -> dropped by the validity scan
    return cols


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--n_records", type=int, default=40)
    ap.add_argument("--n_samples", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    make_synthetic_ptbxl(args.out_dir, args.n_records, args.n_samples, args.seed)
    print(f"wrote {args.n_records} records of {args.n_samples} samples to {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
