"""Single-sample Grad-CAM demo on a bundled ECG (port of scripts/00_demo_inference.py).

    python -m ptbxl_torch.demo_inference                 # on the GPU
    python -m ptbxl_torch.demo_inference --device cpu    # on the host, explicitly

Prints the per-class probabilities of the demo record and writes the CAM
overlay PNG under ``--out_dir``.  Accepts ``.npy`` ([12, T]) and ``.npz``
(``ecg``, ``y``, ``classes``) files like the reference.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ptbxl_torch.interpret.grad_cam import GradCAM
from ptbxl_torch.models.factory import load_ecgcnn
from ptbxl_torch.utils.device import resolve_device

CLASSES = ["MI", "STTC", "HYP", "CD", "NORM"]


def load_demo_file(path: str):
    """Returns (ecg_np [12, T], y_true [5] or None, classes list)."""
    if path.endswith(".npy"):
        return np.load(path), None, CLASSES
    if path.endswith(".npz"):
        z = np.load(path, allow_pickle=True)
        ecg_np = z["ecg"]
        y_true = z["y"] if "y" in z.files else None
        classes = [str(c) for c in z["classes"]] if "classes" in z.files else CLASSES
        return ecg_np, y_true, classes
    raise ValueError(f"Unsupported demo file: {path}. Use .npy or .npz")


def main(args) -> str:
    device = resolve_device(args.device)
    print("[INFO] Device:", device)

    ecg_np, y_true, _ = load_demo_file(args.demo_path)
    print("[INFO] Loaded demo ECG:", ecg_np.shape)
    T = ecg_np.shape[-1]
    x = torch.as_tensor(ecg_np.T[None], dtype=torch.float32, device=device)  # [1, T, 12]

    # lenient load like the reference demo path (strict=False)
    model, _ = load_ecgcnn(args.ckpt, num_labels=len(CLASSES), strict=False, device=device)
    print("[INFO] Loaded baseline model.")

    class_idx = args.class_idx
    class_name = CLASSES[class_idx]
    gradcam = GradCAM(model, signal_length=T, norm_first=False, eps=1e-9)
    probs, cam = gradcam(x, class_idx=class_idx)
    probs = probs[0].cpu().numpy()
    cam = cam[0].cpu().numpy()

    print("[INFO] Predicted probabilities:")
    for i, p in enumerate(probs):
        name = CLASSES[i] if i < len(CLASSES) else f"cls_{i}"
        print(f"  {name}: {p:.3f}")

    if y_true is not None:
        y_true = np.asarray(y_true).astype(np.float32)
        print("[INFO] Ground-truth labels:")
        for i in range(min(len(CLASSES), len(y_true))):
            print(f"  {CLASSES[i]}: {int(y_true[i])}")

    print(f"[INFO] Running Grad-CAM for class: {class_name} (index {class_idx})")
    base_name = os.path.splitext(os.path.basename(args.demo_path))[0]
    fig_path = os.path.join(args.out_dir, f"{base_name}_gradcam_{class_name}.png")
    title = f"Demo Grad-CAM | {base_name} | class {class_name}"
    if y_true is not None and class_idx < len(y_true):
        title += f" | GT={int(y_true[class_idx])}"

    from ptbxl_torch.interpret.plotting import plot_ecg_with_cam

    plot_ecg_with_cam(ecg=ecg_np, cam=cam, lead_idx=args.lead, title=title, save_path=fig_path)
    print(f"[SAVE] Demo Grad-CAM figure saved to: {fig_path}")
    return fig_path


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--demo_path", type=str, default="data/demo/single/single_sample_00.npz",
                        help="Path to demo ECG file (.npy or .npz).")
    parser.add_argument("--ckpt", type=str,
                        default="outputs/ecg_baseline/ckpts/ecg_baseline_best.npz",
                        help="Path to baseline ECG checkpoint (.npz or reference .pth).")
    parser.add_argument("--class_idx", type=int, default=0, help="Class index (0..4).")
    parser.add_argument("--lead", type=int, default=0, help="Lead index to plot (0..11).")
    parser.add_argument("--out_dir", type=str, default="outputs/demo",
                        help="Directory of the CAM figure.")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' runs on the host).")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
