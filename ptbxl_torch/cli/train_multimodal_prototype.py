"""Train the ECG + demographics FiLM model on PTB-XL (port of
``scripts/04_train_multimodal_prototype.py``).

    python -m ptbxl_torch.cli.train_multimodal_prototype [--config configs/ecg_multimodal.yaml]
        [--resume] [--device cpu]

The JAX script's config, CSV (``<out_dir>/logs/metrics_<run_name>.csv``),
checkpoint (``<out_dir>/ckpts/<run_name>_best.npz``), early stopping
(``train.early_stop_patience``), per-batch loss aggregation and the optional
warm start of the ECG encoder from ``model.ecg_multimodal.pretrained_ecg_ckpt``
(``load_checkpoint(arch="backbone")`` + ``merge_backbone``).

Under ``torchrun --nproc_per_node=N -m ptbxl_torch.cli.train_multimodal_prototype ...`` each
process joins the launcher's group (``parallel/multihost.py``) and the
trainer splits every batch over the ranks; it prints that data width.
"""

from __future__ import annotations

import argparse
import os

from ptbxl_torch import config as C
from ptbxl_torch.data import PTBXLECGMultimodalDataset
from ptbxl_torch.models.factory import build_multimodal, dtype_from_config, merge_backbone
from ptbxl_torch.models.params_io import load_checkpoint
from ptbxl_torch.parallel.multihost import maybe_initialize_distributed
from ptbxl_torch.training.trainer import TrainRun, report_data_width, train
from ptbxl_torch.utils.device import resolve_device
from ptbxl_torch.utils.rng import set_seed


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, default="configs/ecg_multimodal.yaml",
                        help="Path to YAML config file.")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the per-epoch resume point (extension).")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' runs on the host).")
    args = parser.parse_args(argv)
    maybe_initialize_distributed(device=args.device)  # torchrun's group, if any
    device = resolve_device(args.device)

    cfg = C.load_config(args.config)
    set_seed(C.get_seed(cfg))

    data_cfg = cfg["data"]
    train_cfg = cfg["train"]
    model_cfg = C.model_cfg_multimodal(cfg)
    log_cfg = C.log_cfg(cfg)

    classes = C.get_classes(cfg)
    base_dir = C.get_base_dir(cfg)

    out_dir = log_cfg["out_dir"]
    os.makedirs(out_dir, exist_ok=True)
    run_name = log_cfg.get("run_name", "ecg_multimodal")  # stable, no timestamp
    log_dir = os.path.join(out_dir, "logs")
    os.makedirs(log_dir, exist_ok=True)
    metrics_csv = os.path.join(log_dir, f"metrics_{run_name}.csv")

    print("[INFO] Using config:", args.config)
    print("[INFO] Classes:", classes)
    print("[INFO] Base dir:", base_dir)
    print("[INFO] Run name:", run_name)

    batch_size = int(train_cfg.get("batch_size", 64))
    epochs = int(train_cfg.get("epochs", 30))
    lr = C.get_float(train_cfg, "lr", 1.0e-4)
    weight_decay = C.get_float(train_cfg, "weight_decay", 1e-4)
    early_stop_patience = int(train_cfg.get("early_stop_patience", 1000))

    normalize = data_cfg.get("normalize", "per_lead")
    train_ds = PTBXLECGMultimodalDataset(base_dir, split="train", classes=classes,
                                         normalize=normalize)
    val_ds = PTBXLECGMultimodalDataset(base_dir, split="val", classes=classes,
                                       normalize=normalize)

    print("[ECG-MM] train size =", len(train_ds))
    print("[ECG-MM] val size   =", len(val_ds))
    print(f"[INFO] Device: {device.type}")

    model = build_multimodal(
        in_leads=model_cfg.get("in_leads", 12),
        ecg_feat_dim=model_cfg.get("ecg_feat_dim", 256),
        demo_hidden_dim=C.multimodal_hidden_dim(model_cfg),
        num_labels=len(classes),
        seed=C.get_seed(cfg),
        precision=train_cfg.get("precision", "highest"),
        dtype=dtype_from_config(train_cfg.get("dtype", "float32")),
        torch_init=bool(model_cfg.get("torch_init", False)),
        device=device,
    )

    # optional warm start of the ECG encoder (reference: scripts/04:149-156)
    pretrained_ecg_ckpt = model_cfg.get("pretrained_ecg_ckpt", None)
    if pretrained_ecg_ckpt is not None and os.path.exists(pretrained_ecg_ckpt):
        print(f"[INFO] Loading pretrained ECG encoder from: {pretrained_ecg_ckpt}")
        bb_state, _ = load_checkpoint(pretrained_ecg_ckpt, arch="backbone")
        merge_backbone(model, bb_state)
        print("[INFO] ECG encoder loaded.")

    ckpt_dir = os.path.join(out_dir, "ckpts")
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt_path = os.path.join(ckpt_dir, f"{run_name}_best.npz")
    print(f"[INFO] Best checkpoint will be saved to: {ckpt_path}")

    report_data_width(batch_size)
    run = TrainRun(
        model=model,
        train_ds=train_ds,
        val_ds=val_ds,
        batch_size=batch_size,
        epochs=epochs,
        lr=lr,
        weight_decay=weight_decay,
        seed=C.get_seed(cfg),
        run_name=run_name,
        metrics_csv=metrics_csv,
        ckpt_path=ckpt_path,
        config_path=args.config,
        classes=classes,
        multimodal=True,
        loss_mode="per_batch",  # reference quirk: loop_demo averages per batch
        normalize=normalize,
        early_stop_patience=early_stop_patience,
        arch="multimodal",
        train_print="Train-ECG-MM BCE",
        val_print="Val-ECG-MM metrics",
        best_print=lambda best, path: f"[INFO] New best AUPRC {best:.4f}, saved to {path}",
        resume=args.resume,
        # large-batch recipe knobs (extension; dormant at defaults)
        warmup_steps=int(train_cfg.get("warmup_steps", 0)),
        lr_scaling=str(train_cfg.get("lr_scaling", "none")),
        ref_batch_size=int(train_cfg.get("ref_batch_size", 64)),
        train_desc="Train-ECG+Demo",
        eval_desc="Val-ECG+Demo",
    )
    return train(run)


if __name__ == "__main__":
    main()
