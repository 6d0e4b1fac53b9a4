"""Split sizes of the baseline and multimodal datasets (port of ``scripts/printsize.py``).

    python -m ptbxl_torch.cli.printsize [--base_dir DIR]

``--base_dir`` defaults to ``$PTBXL_BASE_DIR`` or ``data/ptb-xl/1.0.3``.
Host only: no tensor work, no device flag.  Returns the sizes by dataset
and split.
"""

from __future__ import annotations

import argparse
import os

from ptbxl_torch.data import PTBXLDataset, PTBXLECGMultimodalDataset

CLASSES = ["MI", "STTC", "HYP", "CD", "NORM"]
SPLITS = ("train", "val", "test")


def report(base_dir: str) -> dict:
    print("=== Baseline datasets ===")
    sizes = {split: len(PTBXLDataset(base_dir=base_dir, split=split, classes=CLASSES))
             for split in SPLITS}
    print("Baseline train size:", sizes["train"])
    print("Baseline val size:  ", sizes["val"])
    print("Baseline test size: ", sizes["test"])

    print("\n=== ECG + Demographics datasets ===")
    mm_sizes = {split: len(PTBXLECGMultimodalDataset(base_dir=base_dir, split=split,
                                                     classes=CLASSES))
                for split in SPLITS}
    print("ECG+Demo train size:", mm_sizes["train"])
    print("ECG+Demo val size:  ", mm_sizes["val"])
    print("ECG+Demo test size: ", mm_sizes["test"])
    return {"baseline": sizes, "multimodal": mm_sizes}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base_dir", type=str,
                        default=os.environ.get("PTBXL_BASE_DIR", "data/ptb-xl/1.0.3"))
    return report(parser.parse_args(argv).base_dir)


if __name__ == "__main__":
    main()
