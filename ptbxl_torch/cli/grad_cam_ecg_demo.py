"""Grad-CAM and demographic importance for the multimodal model (port of
``scripts/12_grad_cam_ecg_demo.py``).

    python -m ptbxl_torch.cli.grad_cam_ecg_demo [--config configs/ecg_multimodal.yaml]
        [--ckpt outputs/ecg_multimodal/ckpts/ecg_multimodal_best.npz] [--index 10]
        [--lead 0] [--class_idx 0] [--class_name MI] [--device cpu]

One test-split record (z-scored as the dataset's ``__getitem__`` gives it):
``GradCAM(norm_first=False, eps=1e-8, multimodal=True)`` and
``demo_importance``.  The CAM goes to
``outputs/gradcam_multimodal/sample_{i}_{class}_cam.npy`` (the reference's
code path; its README says gradcam_demo).  The two-panel PNG is drawn only
where matplotlib imports (the GPU machine has none).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ptbxl_torch import config as C
from ptbxl_torch.data import PTBXLECGMultimodalDataset
from ptbxl_torch.interpret.grad_cam import GradCAM, demo_importance
from ptbxl_torch.interpret.plotting import draw_if_available, plot_ecg_and_demo_importance
from ptbxl_torch.models.factory import load_multimodal
from ptbxl_torch.utils.device import resolve_device
from ptbxl_torch.utils.rng import set_seed

OUT_DIR = "outputs/gradcam_multimodal"
DEMO_FEATURES = ["age", "sex", "height", "weight", "pacemaker"]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, default="configs/ecg_multimodal.yaml",
                        help="Path to YAML config file.")
    parser.add_argument("--ckpt", type=str,
                        default="outputs/ecg_multimodal/ckpts/ecg_multimodal_best.npz")
    parser.add_argument("--index", type=int, default=10)
    parser.add_argument("--lead", type=int, default=0)
    parser.add_argument("--class_idx", type=int, default=0)
    parser.add_argument("--class_name", type=str, default="MI")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' runs on the host).")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = C.load_config(args.config)
    set_seed(C.get_seed(cfg))

    print("[INFO] Device:", device.type)

    data_cfg = cfg["data"]
    model_cfg = C.model_cfg_multimodal(cfg)
    base_dir = C.get_base_dir(cfg)
    classes = C.get_classes(cfg)

    test_ds = PTBXLECGMultimodalDataset(base_dir, split="test", classes=classes,
                                        normalize=data_cfg.get("normalize", "per_lead"))
    print("[INFO] ECG-MM test size:", len(test_ds))
    print("[INFO] Classes:", classes)

    model, _ = load_multimodal(
        args.ckpt,
        num_labels=len(classes),
        ecg_feat_dim=model_cfg.get("ecg_feat_dim", 256),
        demo_hidden_dim=C.multimodal_hidden_dim(model_cfg),
        in_leads=data_cfg.get("leads", 12),
        strict=False,
        device=device,
    )
    print("[INFO] Model loaded.")

    idx = args.index
    x_ecg, x_demo, _ = test_ds[idx]
    signal_length = x_ecg.shape[-1]
    x = torch.as_tensor(np.ascontiguousarray(x_ecg.T[None]), dtype=torch.float32, device=device)
    d = torch.as_tensor(x_demo[None], dtype=torch.float32, device=device)

    if args.class_name:
        class_name = args.class_name
        class_idx = classes.index(class_name)
    else:
        class_idx = args.class_idx
        class_name = classes[class_idx]

    print(f"[INFO] Grad-CAM on sample {idx}, class {class_name}")

    # script 12's variant: interpolate, then normalize with eps 1e-8 (12:66-73)
    grad_cam = GradCAM(model, signal_length=signal_length, norm_first=False, eps=1e-8,
                       multimodal=True)
    _, cam = grad_cam(x, class_idx=class_idx, x_demo=d)
    cam = cam[0].detach().cpu().numpy()
    importance = demo_importance(model, x, d, class_idx).detach().cpu().numpy()

    os.makedirs(OUT_DIR, exist_ok=True)
    cam_path = os.path.join(OUT_DIR, f"sample_{idx}_{class_name}_cam.npy")
    np.save(cam_path, cam)
    print("[INFO] Saved CAM to:", cam_path)

    fig_path = draw_if_available(
        plot_ecg_and_demo_importance,
        ecg=x_ecg, cam=cam, demo_importance=importance, demo_feature_names=DEMO_FEATURES,
        lead_idx=args.lead,
        title=f"ECG multimodal Grad-CAM | sample {idx} | class {class_name}",
        save_path=os.path.join(OUT_DIR, f"sample_{idx}_{class_name}_ecg_mm.png"),
    )
    if fig_path is not None:
        print(f"[INFO] Saved Grad-CAM figure to: {fig_path}")
    return cam_path, importance


if __name__ == "__main__":
    main()
