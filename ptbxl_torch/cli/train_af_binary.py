"""Train the binary AF classifier on PTB-XL (port of ``scripts/05_train_af_binary.py``).

    python -m ptbxl_torch.cli.train_af_binary [--config configs/af_binary.yaml]
        [--resume] [--device cpu]

The JAX script's config, CSV (``<out_dir>/logs/metrics_af_binary.csv``) and
checkpoint (``<out_dir>/ckpts/af_binary_best.npz``, which carries no
classes, as the reference's).
"""

from __future__ import annotations

import argparse
import os

from ptbxl_torch import config as C
from ptbxl_torch.data import PTBXLAFDataset
from ptbxl_torch.models.factory import build_ecgcnn, dtype_from_config
from ptbxl_torch.training.trainer import TrainRun, train
from ptbxl_torch.utils.device import resolve_device
from ptbxl_torch.utils.rng import set_seed


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, default="configs/af_binary.yaml",
                        help="Path to YAML config file.")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the per-epoch resume point (extension).")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' runs on the host).")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    print("[INFO] Device:", device.type)

    cfg = C.load_config(args.config)
    set_seed(C.get_seed(cfg))

    data_cfg = cfg["data"]
    train_cfg = cfg["train"]
    model_cfg = C.model_cfg_ecg(cfg)
    log_cfg = C.log_cfg(cfg)

    base_dir = C.get_base_dir(cfg)

    out_dir = log_cfg["out_dir"]
    log_dir = os.path.join(out_dir, "logs")
    ckpt_dir = os.path.join(out_dir, "ckpts")
    os.makedirs(log_dir, exist_ok=True)
    os.makedirs(ckpt_dir, exist_ok=True)

    metrics_csv = os.path.join(log_dir, "metrics_af_binary.csv")
    ckpt_path = os.path.join(ckpt_dir, "af_binary_best.npz")
    run_name = log_cfg.get("run_name", "af_binary")

    print(f"[INFO] Metrics CSV: {metrics_csv}")
    print(f"[INFO] Best checkpoint: {ckpt_path}")

    normalize = data_cfg.get("normalize", "per_lead")
    train_ds = PTBXLAFDataset(base_dir, split="train", normalize=normalize)
    val_ds = PTBXLAFDataset(base_dir, split="val", normalize=normalize)

    print("[AF] Train size:", len(train_ds))
    print("[AF] Val size:", len(val_ds))

    model = build_ecgcnn(
        in_leads=model_cfg.get("in_leads", 12),
        feat_dim=model_cfg.get("feat_dim", 256),
        num_labels=1,  # AF vs non-AF
        seed=C.get_seed(cfg),
        precision=train_cfg.get("precision", "highest"),
        dtype=dtype_from_config(train_cfg.get("dtype", "float32")),
        torch_init=bool(model_cfg.get("torch_init", False)),
        device=device,
    )

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
        classes=None,  # the reference AF checkpoint has no classes (scripts/05:158)
        multimodal=False,
        loss_mode="per_sample",
        normalize=normalize,
        early_stop_patience=None,  # reference 05 ignores early stopping
        arch="ecgcnn",
        train_print="Train-AF BCE",
        val_print="Val-AF metrics",
        best_print=lambda best, path: f"⭐ New best AF AUPRC: {best:.4f}, saved to {path}",
        resume=args.resume,
        # large-batch recipe knobs (extension; dormant at defaults)
        warmup_steps=int(train_cfg.get("warmup_steps", 0)),
        lr_scaling=str(train_cfg.get("lr_scaling", "none")),
        ref_batch_size=int(train_cfg.get("ref_batch_size", 64)),
    )
    return train(run)


if __name__ == "__main__":
    main()
