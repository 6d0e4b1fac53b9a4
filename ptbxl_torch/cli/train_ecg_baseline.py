"""Train the single-modal ECG baseline on PTB-XL (port of ``scripts/03_train_ecg_baseline.py``).

    python -m ptbxl_torch.cli.train_ecg_baseline [--config configs/ecg_baseline.yaml]
        [--resume] [--device cpu]

The config schema, the metrics CSV (``<out_dir>/<run_name>/logs/
metrics_ecg_baseline.csv``), the best checkpoint by val AUPRC
(``ckpts/ecg_baseline_best.npz`` + ``.pth``) and the prints are the JAX
script's; training runs through ``ptbxl_torch.training.trainer.train``.
"""

from __future__ import annotations

import argparse
import os

from ptbxl_torch import config as C
from ptbxl_torch.data import PTBXLDataset
from ptbxl_torch.models.factory import build_ecgcnn, dtype_from_config
from ptbxl_torch.training.trainer import TrainRun, train
from ptbxl_torch.utils.device import resolve_device
from ptbxl_torch.utils.rng import set_seed


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, default="configs/ecg_baseline.yaml")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the per-epoch resume point (extension).")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' runs on the host).")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    print("[INFO] Device (script import):", device.type)

    cfg = C.load_config(args.config)
    set_seed(C.get_seed(cfg))

    data_cfg = cfg["data"]
    train_cfg = cfg["train"]
    model_cfg = C.model_cfg_ecg(cfg)
    log_cfg = C.log_cfg(cfg)

    classes = C.get_classes(cfg)
    base_dir = C.get_base_dir(cfg)

    root_out = log_cfg.get("out_dir", "outputs")
    run_name = log_cfg.get("run_name", "ecg_baseline")
    out_dir = os.path.join(root_out, run_name)
    log_dir = os.path.join(out_dir, "logs")
    os.makedirs(log_dir, exist_ok=True)
    metrics_csv = os.path.join(log_dir, "metrics_ecg_baseline.csv")

    print("[INFO] Using config:", args.config)
    print("[INFO] Output dir:", out_dir)
    print("[INFO] Metrics CSV:", metrics_csv)

    normalize = data_cfg.get("normalize", "per_lead")
    train_ds = PTBXLDataset(base_dir, split="train", classes=classes, normalize=normalize)
    val_ds = PTBXLDataset(base_dir, split="val", classes=classes, normalize=normalize)

    print("[Baseline] train size =", len(train_ds))
    print("[Baseline] val size   =", len(val_ds))

    print("[INFO] Device (training):", device.type)

    model = build_ecgcnn(
        in_leads=model_cfg.get("in_leads", 12),
        feat_dim=model_cfg.get("feat_dim", 256),
        num_labels=len(classes),
        seed=C.get_seed(cfg),
        precision=train_cfg.get("precision", "highest"),
        dtype=dtype_from_config(train_cfg.get("dtype", "float32")),
        torch_init=bool(model_cfg.get("torch_init", False)),
        device=device,
    )

    ckpt_dir = os.path.join(out_dir, "ckpts")
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt_path = os.path.join(ckpt_dir, "ecg_baseline_best.npz")
    print("[INFO] Checkpoints ->", ckpt_path)

    run = TrainRun(
        model=model,
        train_ds=train_ds,
        val_ds=val_ds,
        batch_size=int(train_cfg["batch_size"]),
        epochs=int(train_cfg["epochs"]),
        lr=C.get_float(train_cfg, "lr", 1e-3),
        weight_decay=C.get_float(train_cfg, "weight_decay", 0.0),
        seed=C.get_seed(cfg),
        run_name=run_name,
        metrics_csv=metrics_csv,
        ckpt_path=ckpt_path,
        config_path=args.config,
        classes=classes,
        multimodal=False,
        loss_mode="per_sample",
        normalize=normalize,
        early_stop_patience=None,  # reference 03 ignores early_stop_patience
        arch="ecgcnn",
        train_print="Train BCE",
        val_print="Val metrics",
        best_print=lambda best, path: f"★ New best AUPRC: {best:.4f}",
        resume=args.resume,
        # large-batch recipe knobs (extension; dormant at defaults)
        warmup_steps=int(train_cfg.get("warmup_steps", 0)),
        lr_scaling=str(train_cfg.get("lr_scaling", "none")),
        ref_batch_size=int(train_cfg.get("ref_batch_size", 64)),
    )
    return train(run)


if __name__ == "__main__":
    main()
