"""Export a few test-split ECGs as ``.npy`` files (port of ``scripts/00_save_demo_ecg.py``).

    python -m ptbxl_torch.cli.save_demo_ecg --base_dir DIR [--out_dir data/demo]
        [--num_samples 3] [--classes MI,STTC,HYP,CD,NORM]

Writes ``demo_ecg_{i}.npy`` (z-scored ``[12, T]``) under ``--out_dir``.
Host only: no tensor work, no device flag.
"""

from __future__ import annotations

import argparse

from ptbxl_torch.data import PTBXLDataset
from ptbxl_torch.data.demo_export import CLASSES, export_npy_samples
from ptbxl_torch.utils.rng import set_seed


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base_dir", type=str, required=True, help="PTB-XL base directory.")
    parser.add_argument("--out_dir", type=str, default="data/demo",
                        help="Directory to save demo npy files.")
    parser.add_argument("--num_samples", type=int, default=3,
                        help="Number of ECG files to export.")
    parser.add_argument("--classes", type=str, default="MI,STTC,HYP,CD,NORM",
                        help="Class list (comma-separated).")
    args = parser.parse_args(argv)
    set_seed(42)
    classes = [c.strip() for c in args.classes.split(",") if c.strip()] or CLASSES

    ds = PTBXLDataset(args.base_dir, split="test", classes=classes, normalize="per_lead")
    print(f"[INFO] PTBXLDataset(test) size = {len(ds)}")

    export_npy_samples(ds, args.out_dir, args.num_samples, multimodal=False)
    print("[DONE] All demo ECG saved.")


if __name__ == "__main__":
    main()
