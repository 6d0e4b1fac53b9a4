"""Demo-pack and raw-sample export (port of ``ptbxl_tpu/data/demo_export.py``).

The library behind the three ``00_*`` scripts: the shareable ``.npz`` demo
pack with deterministic class coverage (``cli/make_demo_pack.py``) and the
raw ``.npy`` exports of the single-modal (``cli/save_demo_ecg.py``) and
multimodal (``cli/save_demo_multimodal.py``) quick demos.  ``meta.csv`` is
written with ``utils/table.py`` and has the JAX package's bytes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ptbxl_torch.utils.table import NAN, write_csv

CLASSES = ["MI", "STTC", "HYP", "CD", "NORM"]


def pick_demo_indices(
    label_matrix: np.ndarray,
    max_per_class: int = 1,
    extra_all_zero: int = 1,
    seed: int = 42,
) -> Tuple[List[int], Dict[int, str]]:
    """Deterministically select one positive per class + all-zero extras.

    The per-class index pools and the all-zero pool are each shuffled with one
    ``np.random.default_rng(seed)``, in class order, then the first
    ``max_per_class`` / ``extra_all_zero`` unseen indices are taken.
    """
    rng = np.random.default_rng(seed)
    n_classes = label_matrix.shape[1]

    pools = {c: list(np.nonzero(label_matrix[:, c] == 1)[0]) for c in range(n_classes)}
    all_zero = list(np.nonzero(label_matrix.sum(axis=1) == 0)[0])

    chosen: List[int] = []
    chosen_for: Dict[int, str] = {}
    for c in range(n_classes):
        pool = [int(i) for i in pools[c]]
        if not pool:
            continue
        rng.shuffle(pool)
        for idx in pool[:max_per_class]:
            if idx not in chosen:
                chosen.append(idx)
                chosen_for[idx] = f"pos_{CLASSES[c]}"

    if all_zero and extra_all_zero > 0:
        pool = [int(i) for i in all_zero]
        rng.shuffle(pool)
        for idx in pool[:extra_all_zero]:
            if idx not in chosen:
                chosen.append(idx)
                chosen_for[idx] = "all_zero"

    return chosen, chosen_for


def _label_string(y: np.ndarray) -> str:
    return ";".join(f"{CLASSES[i]}={int(y[i])}" for i in range(len(CLASSES)))


def export_npz_samples(
    dataset,
    out_dir: str,
    indices: Sequence[int],
    chosen_for: Dict[int, str],
    meta_rows: List[dict],
    prefix: str,
    multimodal: bool,
) -> None:
    """Write {prefix}_sample_NN.npz files + meta rows (reference schemas)."""
    os.makedirs(out_dir, exist_ok=True)
    subdir = "multimodal" if multimodal else "single"
    for k, idx in enumerate(indices):
        item = dataset[idx]
        fname = f"{prefix}_sample_{k:02d}.npz"
        row = {
            "file": f"{subdir}/{fname}",
            "modality": subdir,
            "index_in_split": int(idx),
            "chosen_for": chosen_for.get(idx, "unknown"),
        }
        if multimodal:
            x_ecg, x_demo, y = item
            np.savez_compressed(
                os.path.join(out_dir, fname),
                ecg=x_ecg.astype(np.float32), demo=x_demo.astype(np.float32),
                y=y.astype(np.float32), classes=np.array(CLASSES),
            )
        else:
            x_ecg, y = item
            np.savez_compressed(
                os.path.join(out_dir, fname),
                ecg=x_ecg.astype(np.float32), y=y.astype(np.float32),
                classes=np.array(CLASSES),
            )
        row.update(
            y_true=_label_string(y), y_sum=int(np.sum(y)), ecg_shape=str(tuple(x_ecg.shape))
        )
        if multimodal:  # the reference's column order: demo_shape last
            row["demo_shape"] = str(tuple(x_demo.shape))
        meta_rows.append(row)


def write_meta(meta_rows: List[dict], out_root: str) -> str:
    """meta.csv: the rows' keys in first-seen order, a key a row lacks as an
    empty cell (``pd.DataFrame(rows).to_csv(index=False)``)."""
    meta_path = os.path.join(out_root, "meta.csv")
    columns = list(dict.fromkeys(k for row in meta_rows for k in row))
    write_csv(meta_path, {c: [row.get(c, NAN) for row in meta_rows] for c in columns})
    return meta_path


def export_npy_samples(dataset, out_dir: str, count: int, multimodal: bool) -> None:
    """Raw .npy exports (demo_ecg_{i}.npy / demo_mm_{ecg,demo}_{i}.npy)."""
    os.makedirs(out_dir, exist_ok=True)
    n = min(count, len(dataset))
    for i in range(n):
        item = dataset[i]
        if multimodal:
            x_ecg, x_demo, y = item
            ecg_path = os.path.join(out_dir, f"demo_mm_ecg_{i}.npy")
            demo_path = os.path.join(out_dir, f"demo_mm_demo_{i}.npy")
            np.save(ecg_path, x_ecg)
            np.save(demo_path, x_demo)
            print(f"[SAVE] multimodal sample #{i}:")
            print(f"       ECG  -> {ecg_path}  shape={x_ecg.shape}")
            print(f"       DEMO -> {demo_path} shape={x_demo.shape}  y={y}")
        else:
            x, y = item
            path = os.path.join(out_dir, f"demo_ecg_{i}.npy")
            np.save(path, x)
            print(f"[SAVE] demo ECG #{i} -> {path} | y = {y}")
