"""Grad-CAM overlay figures (the port's copies of ``plot_ecg_with_cam`` and
``plot_ecg_and_demo_importance``).

Render conventions of the reference: a 1-row Reds heatmap behind the lead
trace via imshow (alpha 0.7, bilinear, extent spanning the signal range),
black 0.8-linewidth trace, dpi 300.  matplotlib is imported when a figure is
drawn, so the port imports without it.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def _norm_for_plot(cam: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    cam = cam - cam.min()
    return cam / (cam.max() + eps)


def plot_ecg_with_cam(
    ecg: np.ndarray,
    cam: np.ndarray,
    lead_idx: int,
    title: str,
    save_path: str,
    figsize=(15, 4),
    xlabel: str = "Time (samples)",
    ylabel: str | None = None,
    threshold: float | None = None,
    guard_norm: bool = False,
) -> None:
    """ecg: [12, T]; cam: [T]. Writes a dpi-300 PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ecg = np.asarray(ecg)
    cam = np.asarray(cam, dtype=np.float64).copy()

    if guard_norm:  # guarded norm + optional floor threshold
        cam = cam - cam.min()
        if cam.max() > 0:
            cam = cam / cam.max()
        if threshold is not None:
            cam[cam < threshold] = 0.0
    else:
        cam = _norm_for_plot(cam)

    sig = ecg[lead_idx]
    T = sig.shape[-1]
    t = np.arange(T)

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(111)
    ax.imshow(
        np.expand_dims(cam, axis=0),
        aspect="auto",
        cmap="Reds",
        alpha=0.7,
        extent=[0, T, sig.min(), sig.max()],
        origin="lower",
        interpolation="bilinear",
    )
    ax.plot(t, sig, color="black", linewidth=0.8)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel if ylabel is not None else f"ECG (lead {lead_idx})")

    plt.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=300)
    plt.close(fig)


def plot_ecg_and_demo_importance(
    ecg: np.ndarray,
    cam: np.ndarray,
    demo_importance: np.ndarray,
    demo_feature_names: Sequence[str],
    lead_idx: int,
    title: str,
    save_path: str,
) -> None:
    """Two panels: the CAM overlay on one lead, and the demographic importances as bars."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.gridspec import GridSpec

    ecg = np.asarray(ecg)
    cam = np.asarray(cam, dtype=np.float64).copy()
    cam = cam - cam.min()
    if cam.max() > 0:
        cam = cam / cam.max()

    sig = ecg[lead_idx]
    T = sig.shape[-1]
    t = np.arange(T)

    fig = plt.figure(figsize=(15, 6))
    gs = GridSpec(2, 1, height_ratios=[3, 1], hspace=0.3)

    ax1 = fig.add_subplot(gs[0, 0])
    ax1.imshow(
        np.expand_dims(cam, axis=0),
        aspect="auto",
        cmap="Reds",
        alpha=0.7,
        extent=[0, T, sig.min(), sig.max()],
        origin="lower",
        interpolation="bilinear",
    )
    ax1.plot(t, sig, color="black", linewidth=0.8)
    ax1.set_title(title)
    ax1.set_ylabel(f"ECG (lead {lead_idx})")

    ax2 = fig.add_subplot(gs[1, 0])
    y_pos = np.arange(len(demo_importance))
    ax2.barh(y_pos, demo_importance, color="salmon")
    ax2.set_yticks(y_pos)
    ax2.set_yticklabels(list(demo_feature_names))
    ax2.invert_yaxis()
    ax2.set_xlabel("Relative importance")
    ax2.set_xlim(0, 1.05)

    plt.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=300)
    plt.close(fig)
