"""Evaluate the multimodal model on the PTB-XL test split (port of
``scripts/07_ecg_multimodal_test.py``).

    python -m ptbxl_torch.cli.ecg_multimodal_test --config CFG --ckpt CKPT --out_csv CSV
        [--threshold 0.5] [--thresholds search_per_class] [--device cpu]

The prediction CSV has the reference's ``_mm``-suffixed columns
``y_true_{c}``, ``y_prob_{c}_mm``, ``y_pred_{c}_mm``; the eval loss is the
per-batch mean (the reference's loop_demo).
"""

from __future__ import annotations

import argparse
import os

from ptbxl_torch import config as C
from ptbxl_torch.cli._common import predict_split
from ptbxl_torch.data import PTBXLECGMultimodalDataset
from ptbxl_torch.models.factory import load_multimodal
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
        help="opt-in: additionally fit per-class F1 thresholds on the VALIDATION "
             "split and print the fitted test metrics beside the fixed --threshold "
             "ones; the CSV y_pred_ columns stay at --threshold.")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' runs on the host).")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = C.load_config(args.config)
    set_seed(C.get_seed(cfg))

    data_cfg = cfg["data"]
    train_cfg = cfg["train"]
    model_cfg = C.model_cfg_multimodal(cfg)

    classes = C.get_classes(cfg)
    base_dir = C.get_base_dir(cfg)

    print(f"[INFO] Device: {device.type}")

    normalize = data_cfg.get("normalize", "per_lead")
    test_ds = PTBXLECGMultimodalDataset(base_dir, split="test", classes=classes,
                                        normalize=normalize)
    print("[ECG-MM] test size =", len(test_ds))

    assert os.path.exists(args.ckpt), f"Checkpoint not found: {args.ckpt}"
    model, _ = load_multimodal(
        args.ckpt,
        num_labels=len(classes),
        ecg_feat_dim=model_cfg.get("ecg_feat_dim", 256),
        demo_hidden_dim=C.multimodal_hidden_dim(model_cfg),
        in_leads=model_cfg.get("in_leads", 12),
        strict=True,
        device=device,
    )
    print(f"[INFO] Loaded ECG-MM checkpoint: {args.ckpt}")

    batch_size = int(train_cfg.get("batch_size", 64))
    y_true, y_prob, avg_loss = predict_split(model, test_ds, batch_size, True, normalize,
                                             loss_mode="per_batch")

    metrics = compute_metrics(y_true, y_prob, threshold=args.threshold)
    metrics["bce_loss"] = avg_loss

    print("[ECG-MM][TEST] metrics:")
    for k, v in metrics.items():
        print(f"  {k}: {v}")

    if args.thresholds == "search_per_class":
        val_ds = PTBXLECGMultimodalDataset(base_dir, split="val", classes=classes,
                                           normalize=normalize)
        yt_v, yp_v, _ = predict_split(model, val_ds, batch_size, True, normalize,
                                      loss_mode="per_batch")
        thr, fitted = fit_on_val_report(yt_v, yp_v, y_true, y_prob)
        print("[ECG-MM][TEST] val-fitted per-class thresholds:",
              {c: round(float(t), 4) for c, t in zip(classes, thr)})
        print("[ECG-MM][TEST] metrics @ val-fitted thresholds:")
        for k, v in fitted.items():
            print(f"  {k}: {v}")

    os.makedirs(os.path.dirname(args.out_csv) or ".", exist_ok=True)
    cols = {}
    for i, cls in enumerate(classes):
        cols[f"y_true_{cls}"] = y_true[:, i].astype(int)
        cols[f"y_prob_{cls}_mm"] = y_prob[:, i]
        cols[f"y_pred_{cls}_mm"] = (y_prob[:, i] >= args.threshold).astype(int)
    write_csv(args.out_csv, cols)

    print(f"[INFO] Saved ECG-MM test predictions to: {args.out_csv}")
    print("[INFO] Done.")
    return metrics


if __name__ == "__main__":
    main()
