"""Build the shareable demo pack from PTB-XL (port of ``scripts/00_make_demo_pack.py``).

    python -m ptbxl_torch.cli.make_demo_pack --base_dir DIR [--out_root data/demo]
        [--normalize per_lead] [--seed 42] [--per_class 1] [--extra_all_zero 2]

One positive test record per class plus all-zero extras, chosen
deterministically (``data/demo_export.py``), for the single and the
multimodal dataset: ``single/single_sample_NN.npz``,
``multimodal/mm_sample_NN.npz`` and ``meta.csv`` under ``--out_root``.
Host only: no tensor work, no device flag.  Returns (single indices,
multimodal indices, meta.csv path).
"""

from __future__ import annotations

import argparse
import os

from ptbxl_torch.data import PTBXLDataset, PTBXLECGMultimodalDataset
from ptbxl_torch.data.demo_export import (
    CLASSES,
    export_npz_samples,
    pick_demo_indices,
    write_meta,
)
from ptbxl_torch.utils.rng import set_seed


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base_dir", type=str, required=True, help="PTB-XL base directory.")
    parser.add_argument("--out_root", type=str, default="data/demo", help="Output root directory.")
    parser.add_argument("--normalize", type=str, default="per_lead", help="Normalization mode.")
    parser.add_argument("--seed", type=int, default=42, help="Random seed.")
    parser.add_argument("--per_class", type=int, default=1,
                        help="How many positive samples per class.")
    parser.add_argument("--extra_all_zero", type=int, default=2,
                        help="Extra all-zero (normal-ish) samples.")
    args = parser.parse_args(argv)
    set_seed(args.seed)

    single_dir = os.path.join(args.out_root, "single")
    mm_dir = os.path.join(args.out_root, "multimodal")
    os.makedirs(single_dir, exist_ok=True)
    os.makedirs(mm_dir, exist_ok=True)

    ds_single = PTBXLDataset(args.base_dir, split="test", classes=CLASSES,
                             normalize=args.normalize)
    ds_mm = PTBXLECGMultimodalDataset(args.base_dir, split="test", classes=CLASSES,
                                      normalize=args.normalize)
    print(f"[INFO] PTBXLDataset(test) size = {len(ds_single)}")
    print(f"[INFO] PTBXLECGMultimodalDataset(test) size = {len(ds_mm)}")

    idx_single, why_single = pick_demo_indices(ds_single.y, args.per_class,
                                               args.extra_all_zero, args.seed)
    idx_mm, why_mm = pick_demo_indices(ds_mm.y, args.per_class, args.extra_all_zero, args.seed)
    print(f"[INFO] Chosen single indices: {idx_single}")
    print(f"[INFO] Chosen multimodal indices: {idx_mm}")

    meta_rows = []
    export_npz_samples(ds_single, single_dir, idx_single, why_single, meta_rows,
                       prefix="single", multimodal=False)
    export_npz_samples(ds_mm, mm_dir, idx_mm, why_mm, meta_rows,
                       prefix="mm", multimodal=True)

    meta_path = write_meta(meta_rows, args.out_root)
    print(f"[SAVE] meta.csv -> {meta_path}")
    print("[DONE] Demo pack created.")
    return idx_single, idx_mm, meta_path


if __name__ == "__main__":
    main()
