"""Evaluate the AF binary classifier on the PTB-XL test split (port of
``scripts/08_af_binary_test.py``).

    python -m ptbxl_torch.cli.af_binary_test --config CFG --ckpt CKPT --out_csv CSV
        [--threshold 0.5] [--thresholds search_per_class] [--device cpu]

The prediction CSV has the columns ``y_true_AF``, ``y_prob_AF``, ``y_pred_AF``.
"""

from __future__ import annotations

import argparse
import os

from ptbxl_torch import config as C
from ptbxl_torch.cli._common import predict_split
from ptbxl_torch.data import PTBXLAFDataset
from ptbxl_torch.models.factory import load_ecgcnn
from ptbxl_torch.training.metrics import compute_metrics
from ptbxl_torch.training.thresholds import fit_on_val_report
from ptbxl_torch.utils.device import resolve_device
from ptbxl_torch.utils.rng import set_seed
from ptbxl_torch.utils.table import write_csv


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--out_csv", type=str, required=True)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument(
        "--thresholds", type=str, default=None, choices=["search_per_class"],
        help="opt-in: additionally fit the AF F1 threshold on the VALIDATION split "
             "and print the fitted test metrics beside the fixed --threshold ones; "
             "the CSV y_pred_AF column stays at --threshold.")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' runs on the host).")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    print("[INFO] Running AF test script...")

    cfg = C.load_config(args.config)
    set_seed(C.get_seed(cfg))

    data_cfg = cfg["data"]
    train_cfg = cfg["train"]
    model_cfg = C.model_cfg_ecg(cfg)

    base_dir = C.get_base_dir(cfg)

    print(f"[INFO] Device: {device.type}")

    normalize = data_cfg.get("normalize", "per_lead")
    test_ds = PTBXLAFDataset(base_dir, split="test", normalize=normalize)
    print("[AF] Test size:", len(test_ds))

    assert os.path.exists(args.ckpt), f"Checkpoint not found: {args.ckpt}"
    model, _ = load_ecgcnn(
        args.ckpt,
        num_labels=1,  # binary output
        feat_dim=model_cfg.get("feat_dim", 256),
        in_leads=model_cfg.get("in_leads", 12),
        strict=True,
        device=device,
    )
    print(f"[INFO] Loaded checkpoint: {args.ckpt}")

    batch_size = int(train_cfg["batch_size"])
    y_true, y_prob, bce = predict_split(model, test_ds, batch_size, False, normalize)

    metrics = compute_metrics(y_true, y_prob, threshold=args.threshold)
    metrics["bce_loss"] = bce

    print("[AF][TEST] metrics:")
    for k, v in metrics.items():
        print(f"  {k}: {v}")

    if args.thresholds == "search_per_class":
        val_ds = PTBXLAFDataset(base_dir, split="val", normalize=normalize)
        yt_v, yp_v, _ = predict_split(model, val_ds, batch_size, False, normalize)
        thr, fitted = fit_on_val_report(yt_v, yp_v, y_true, y_prob)
        print("[AF][TEST] val-fitted threshold:", round(float(thr[0]), 4))
        print("[AF][TEST] metrics @ val-fitted threshold:")
        for k, v in fitted.items():
            print(f"  {k}: {v}")

    os.makedirs(os.path.dirname(args.out_csv) or ".", exist_ok=True)
    y_true_flat = y_true.reshape(-1)
    y_prob_flat = y_prob.reshape(-1)
    write_csv(args.out_csv, {
        "y_true_AF": y_true_flat.astype(int),
        "y_prob_AF": y_prob_flat,
        "y_pred_AF": (y_prob_flat >= args.threshold).astype(int),
    })

    print(f"[INFO] Saved AF test predictions to: {args.out_csv}")
    print("[INFO] Done.")
    return metrics


if __name__ == "__main__":
    main()
