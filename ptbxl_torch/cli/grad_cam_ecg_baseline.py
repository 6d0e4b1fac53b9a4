"""Grad-CAM of the ECG baseline on one test record (port of
``scripts/11_grad_cam_ecg_baseline.py``).

    python -m ptbxl_torch.cli.grad_cam_ecg_baseline [--config configs/ecg_baseline.yaml]
        [--ckpt outputs/ecg_baseline/ckpts/ecg_baseline_best.npz] [--index 0] [--lead 0]
        [--class_idx 0] [--class_name NORM] [--device cpu]

One test-split record (z-scored as the dataset's ``__getitem__`` gives it),
the checkpoint loaded leniently, ``GradCAM(norm_first=True)`` (the library
variant: normalize, then interpolate); its backward through the last
ReLU -> MaxPool is K6 on the card.  Writes
``outputs/gradcam/sample_{i}_{class}_cam.npy`` and ``..._info.txt`` under the
working directory, and the overlay PNG (guarded norm, 0.2 display threshold)
only where matplotlib imports.  Returns (cam path, info path, PNG path or
None).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ptbxl_torch import config as C
from ptbxl_torch.data import PTBXLDataset
from ptbxl_torch.interpret.grad_cam import GradCAM
from ptbxl_torch.interpret.plotting import draw_if_available, plot_ecg_with_cam
from ptbxl_torch.models.factory import load_ecgcnn
from ptbxl_torch.utils.device import resolve_device
from ptbxl_torch.utils.rng import set_seed

OUT_DIR = "outputs/gradcam"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, default="configs/ecg_baseline.yaml")
    parser.add_argument("--ckpt", type=str,
                        default="outputs/ecg_baseline/ckpts/ecg_baseline_best.npz")
    parser.add_argument("--index", type=int, default=0)
    parser.add_argument("--lead", type=int, default=0)
    parser.add_argument("--class_idx", type=int, default=0)
    parser.add_argument("--class_name", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' runs on the host).")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = C.load_config(args.config)
    set_seed(C.get_seed(cfg))

    print("[INFO] Device:", device.type)
    os.makedirs(OUT_DIR, exist_ok=True)

    data_cfg = cfg["data"]
    classes = C.get_classes(cfg)
    base_dir = C.get_base_dir(cfg)

    test_ds = PTBXLDataset(base_dir, split="test", classes=classes,
                           normalize=data_cfg.get("normalize", "per_lead"))
    print("[INFO] Test size:", len(test_ds))
    print("[INFO] Classes:", classes)

    # lenient load (reference: scripts/11:75, strict=False)
    model, _ = load_ecgcnn(args.ckpt, num_labels=len(classes),
                           in_leads=data_cfg.get("leads", 12), strict=False, device=device)
    print("[INFO] Model loaded.")

    idx = args.index
    x, _ = test_ds[idx]
    signal_length = x.shape[-1]

    if args.class_name:
        class_name = args.class_name
        class_idx = classes.index(class_name)
    else:
        class_idx = args.class_idx
        class_name = classes[class_idx]

    print(f"[INFO] Running Grad-CAM on sample {idx}, class {class_name}")

    grad_cam = GradCAM(model, signal_length=signal_length, norm_first=True)
    xt = torch.as_tensor(np.ascontiguousarray(x.T[None]), dtype=torch.float32, device=device)
    _, cam = grad_cam(xt, class_idx=class_idx)
    cam = cam[0].cpu().numpy()

    cam_save_path = os.path.join(OUT_DIR, f"sample_{idx}_{class_name}_cam.npy")
    np.save(cam_save_path, cam)
    print(f"[SAVE] CAM saved to: {cam_save_path}")

    info_path = os.path.join(OUT_DIR, f"sample_{idx}_{class_name}_info.txt")
    with open(info_path, "w") as f:
        f.write(f"Sample index: {idx}\n")
        f.write(f"Class: {class_name}\n")
        f.write(f"Class idx: {class_idx}\n")
        f.write(f"ECG shape: {tuple(x.shape)}\n")
        f.write(f"CAM shape: {cam.shape}\n")
    print(f"[SAVE] Info saved to: {info_path}")

    plot_path = draw_if_available(
        plot_ecg_with_cam, ecg=x, cam=cam, lead_idx=args.lead,
        title=f"Grad-CAM | sample {idx} | class {class_name}",
        save_path=os.path.join(OUT_DIR, f"sample_{idx}_{class_name}_plot.png"),
        guard_norm=True, threshold=0.2,
    )
    if plot_path is not None:
        print(f"[SAVE] Heatmap saved to: {plot_path}")
    return cam_save_path, info_path, plot_path


if __name__ == "__main__":
    main()
