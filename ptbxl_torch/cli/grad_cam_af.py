"""Grad-CAM of the AF binary classifier on one test record (port of
``scripts/13_grad_cam_af.py``).

    python -m ptbxl_torch.cli.grad_cam_af [--base_dir data/ptb-xl/1.0.3]
        [--ckpt outputs/af_binary/ckpts/af_binary_best.npz] [--index 10] [--lead 0]
        [--device cpu]

The single logit (class 0), the checkpoint loaded strictly, ``GradCAM(
norm_first=False, eps=1e-9)``; its backward through the last ReLU -> MaxPool
is K6 on the card.  Writes ``outputs/gradcam_af/sample_{i}_AF_cam.npy`` under
the working directory, and the overlay PNG only where matplotlib imports.
Returns (cam path, PNG path or None).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ptbxl_torch.data import PTBXLAFDataset
from ptbxl_torch.interpret.grad_cam import GradCAM
from ptbxl_torch.interpret.plotting import draw_if_available, plot_ecg_with_cam
from ptbxl_torch.models.factory import load_ecgcnn
from ptbxl_torch.utils.device import resolve_device
from ptbxl_torch.utils.rng import set_seed

OUT_DIR = "outputs/gradcam_af"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base_dir", type=str, default="data/ptb-xl/1.0.3")
    parser.add_argument("--ckpt", type=str, default="outputs/af_binary/ckpts/af_binary_best.npz")
    parser.add_argument("--index", type=int, default=10)
    parser.add_argument("--lead", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' runs on the host).")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    set_seed(42)
    print("[INFO] Device:", device.type)

    test_ds = PTBXLAFDataset(base_dir=args.base_dir, split="test", normalize="per_lead")
    print("[INFO] AF test size:", len(test_ds))

    # AF loads are strict (reference: scripts/13:141)
    model, _ = load_ecgcnn(args.ckpt, num_labels=1, strict=True, device=device)

    x, y = test_ds[args.index]
    T = x.shape[-1]

    print(f"[INFO] Running AF Grad-CAM on sample {args.index} (y={float(y[0])})")

    gradcam = GradCAM(model, signal_length=T, norm_first=False, eps=1e-9)
    xt = torch.as_tensor(np.ascontiguousarray(x.T[None]), dtype=torch.float32, device=device)
    _, cam = gradcam(xt, class_idx=0)
    cam = cam[0].cpu().numpy()

    os.makedirs(OUT_DIR, exist_ok=True)
    npy_path = os.path.join(OUT_DIR, f"sample_{args.index}_AF_cam.npy")
    np.save(npy_path, cam)
    print("[SAVE] CAM saved to:", npy_path)

    fig_path = draw_if_available(
        plot_ecg_with_cam, ecg=x, cam=cam, lead_idx=args.lead,
        title=f"AF Grad-CAM | sample {args.index} | AF label = {float(y[0])}",
        save_path=os.path.join(OUT_DIR, f"sample_{args.index}_AF_plot.png"), figsize=(16, 4),
        xlabel="Time", ylabel=f"ECG Lead {args.lead}",
    )
    if fig_path is not None:
        print(f"[SAVE] AF Grad-CAM saved to: {fig_path}")
    return npy_path, fig_path


if __name__ == "__main__":
    main()
