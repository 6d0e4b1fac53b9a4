"""PTB-XL datasets, host side, numpy-returning (port of ``ptbxl_tpu/data/datasets.py``).

The reference's three torch Datasets (src/datasets/ptbxl.py:74-142,
ptbxl_ecg_multimodal.py:40-191, ptbxl_af.py:30-101), as the JAX package
redesigned them:

* the split filter on ``strat_fold`` (test = 10, val = 9, train <= 8) and the
  validity filter with the reference's drop semantics (through the cached
  manifest, ``data/manifest.py``), the same label builders and log lines;
* ``__getitem__`` returns numpy, z-scored per lead when
  ``normalize='per_lead'`` (the CLIs that export samples use it);
* ``get_raw`` returns the un-normalized ``[12, T]`` f32 signal: training
  feeds raw batches and z-scores on the device;
* the multimodal dataset also drops rows with a missing age or sex and
  precomputes ``demo`` [N, 5] with ``build_demo_vector``.

``df`` is a ``utils/table.py`` ``Table`` (the port has no pandas) holding the
split's rows in file order.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from ptbxl_torch.data.demo_vector import build_demo_vector
from ptbxl_torch.data.manifest import ValidityManifest
from ptbxl_torch.io.wfdb_io import rdsamp
from ptbxl_torch.utils.label_maps import build_af_binary_labels, build_label_matrix, load_metadata
from ptbxl_torch.utils.table import Table, is_na

EPS = 1e-6  # z-score epsilon (reference: ptbxl.py:125)


def load_ecg(record_path: str) -> np.ndarray:
    """Read one record -> float32 [12, T] (reference: ptbxl.py:14-42)."""
    try:
        sig, _header = rdsamp(record_path)
    except Exception as e:  # noqa: BLE001 - mirror the reference's wrap
        raise RuntimeError(f"Failed to read record {record_path}: {e}")
    sig = np.asarray(sig, dtype=np.float32)
    if sig.ndim != 2:
        raise RuntimeError(f"Unexpected shape for {record_path}: ndim={sig.ndim}, expected 2.")
    _, n_leads = sig.shape
    if n_leads != 12:
        raise RuntimeError(f"Invalid lead count for {record_path}: {n_leads}, expected 12.")
    return sig.T


def zscore_per_lead(x: np.ndarray) -> np.ndarray:
    """(x - mean_t) / (std_t + 1e-6) per lead (reference: ptbxl.py:122-127)."""
    mean = x.mean(axis=1, keepdims=True)
    std = x.std(axis=1, keepdims=True) + EPS
    return (x - mean) / std


def _split_frame(df: Table, split: str) -> Table:
    fold = df["strat_fold"]
    if split == "test":
        keep = [f == 10 for f in fold]
    elif split == "val":
        keep = [f == 9 for f in fold]
    else:  # train
        keep = [f <= 8 for f in fold]
    return df.where(keep)


class _PTBXLBase:
    """Shared split / validity / metadata logic."""

    log_name = "PTBXLDataset"

    def __init__(self, base_dir: str, split: str, normalize: str = "per_lead",
                 use_cache: bool = True):
        self.base_dir = base_dir
        self.split = split
        self.normalize = normalize
        df, scp = load_metadata(base_dir)
        self._scp = scp
        df_split = _split_frame(df, split)
        self._num_total = len(df_split)
        manifest = ValidityManifest(base_dir, use_cache=use_cache)
        mask = manifest.filter_valid(df_split["filename_hr"])
        df_split = df_split.where(mask)
        self._num_valid = len(df_split)
        self.df = df_split

    def _log_filter(self):
        print(f"[{self.log_name}] split={self.split} | total={self._num_total} | "
              f"valid={self._num_valid} | dropped={self._num_total - self._num_valid}")

    def __len__(self) -> int:
        return len(self.df)

    def record_path(self, idx: int) -> str:
        return os.path.join(self.base_dir, self.df["filename_hr"][idx])

    def get_raw(self, idx: int) -> np.ndarray:
        """Un-normalized [12, T] float32 (for the on-device preprocessing path)."""
        return load_ecg(self.record_path(idx))

    def _maybe_normalize(self, x: np.ndarray) -> np.ndarray:
        if self.normalize == "per_lead":
            return zscore_per_lead(x)
        return x


class PTBXLDataset(_PTBXLBase):
    """Multi-label baseline dataset -> (x [12,T], y [C]) float32."""

    log_name = "PTBXLDataset"

    def __init__(self, base_dir: str, split: str, classes: List[str],
                 normalize: str = "per_lead", use_cache: bool = True):
        super().__init__(base_dir, split, normalize, use_cache)
        self.classes = classes
        self._log_filter()
        self.y = build_label_matrix(self.df, self._scp, classes)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        x = self._maybe_normalize(self.get_raw(idx))
        return x, self.y[idx]


class PTBXLECGMultimodalDataset(_PTBXLBase):
    """ECG + demographics dataset -> (x_ecg [12,T], x_demo [5], y [C])."""

    log_name = "PTBXLECGMultimodalDataset"

    def __init__(self, base_dir: str, split: str, classes: List[str],
                 normalize: str = "per_lead", use_cache: bool = True):
        super().__init__(base_dir, split, normalize, use_cache)
        self.classes = classes

        # drop rows with a missing age or sex (reference: ptbxl_ecg_multimodal.py:79-82)
        num_after_valid = len(self.df)
        self.df = self.df.where([not is_na(a) and not is_na(s)
                                 for a, s in zip(self.df["age"], self.df["sex"])])
        num_after_demo = len(self.df)
        print(f"[PTBXLECGMultimodalDataset] split={split} | "
              f"total={self._num_total} | valid_ecg={num_after_valid} | "
              f"after_drop_missing_age_sex={num_after_demo} | "
              f"dropped={self._num_total - num_after_demo}")

        self.y = build_label_matrix(self.df, self._scp, classes)
        self.demo = np.stack(
            [build_demo_vector(row) for row in self.df.rows()], axis=0
        ) if len(self.df) else np.zeros((0, 5), np.float32)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        x = self._maybe_normalize(self.get_raw(idx))
        return x, self.demo[idx], self.y[idx]


class PTBXLAFDataset(_PTBXLBase):
    """Binary AF dataset -> (x [12,T], y [1])."""

    log_name = "PTBXLAFDataset"

    def __init__(self, base_dir: str, split: str, normalize: str = "per_lead",
                 use_cache: bool = True):
        super().__init__(base_dir, split, normalize, use_cache)
        print(f"[PTBXLAFDataset] split={split} | "
              f"total={self._num_total} | valid_ecg={self._num_valid} | "
              f"dropped={self._num_total - self._num_valid}")
        self.y = build_af_binary_labels(self.df, self._scp)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        x = self._maybe_normalize(self.get_raw(idx))
        return x, self.y[idx]
