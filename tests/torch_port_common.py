"""Paths and data shared by the PyTorch-port tests (tests/test_torch_*.py)."""

import glob
import os

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(HERE, "outputs/ecg_baseline/ckpts/ecg_baseline_best.npz")
CKPT_AF = os.path.join(HERE, "outputs/af_binary/ckpts/af_binary_best.npz")
CKPT_MM = os.path.join(HERE, "outputs/ecg_multimodal/ckpts/ecg_multimodal_best.npz")
GOLD = os.path.join(HERE, "tests", "golden")


def demo_signals() -> np.ndarray:
    """The 7 bundled demo records, reference layout [7, 12, 5000] (already z-scored)."""
    files = sorted(glob.glob(os.path.join(HERE, "data/demo/single/*.npz")))
    assert len(files) == 7
    return np.stack([np.load(f, allow_pickle=True)["ecg"] for f in files])


def mm_demo_pack():
    """The 7 bundled multimodal records: signals [7, 12, 5000] (z-scored) and demo [7, 5]."""
    files = sorted(glob.glob(os.path.join(HERE, "data/demo/multimodal/*.npz")))
    assert len(files) == 7
    packs = [np.load(f, allow_pickle=True) for f in files]
    return (np.stack([z["ecg"] for z in packs]),
            np.stack([z["demo"] for z in packs]).astype(np.float32))


def golden(name: str):
    return np.load(os.path.join(GOLD, f"golden_{name}.npz"))


class InMemoryECG:
    """A dataset held in memory, read the way both packages' BatchSource read a
    dataset without an ADC cache: ``y`` [N, L], ``__len__`` and
    ``get_raw(idx)`` -> raw-like [12, T] f32 (per-lead scale and offset)."""

    def __init__(self, n: int, t: int, labels: int = 5, seed: int = 0):
        rng = np.random.default_rng(seed)
        scale = rng.uniform(0.5, 2.5, (n, 12, 1))
        self.x = (rng.standard_normal((n, 12, t)) * scale
                  + rng.standard_normal((n, 12, 1))).astype(np.float32)
        self.y = (rng.uniform(size=(n, labels)) > 0.7).astype(np.int64)

    def __len__(self) -> int:
        return len(self.y)

    def get_raw(self, idx: int) -> np.ndarray:
        return self.x[idx]


class InMemoryECGDemo(InMemoryECG):
    """``InMemoryECG`` with demographic vectors ``demo`` [N, 5]."""

    def __init__(self, n: int, t: int, labels: int = 5, seed: int = 0):
        super().__init__(n, t, labels, seed)
        self.demo = np.random.default_rng(seed + 1).uniform(size=(n, 5)).astype(np.float32)


CLASSES = ["MI", "STTC", "HYP", "CD", "NORM"]


def write_pred_csvs(root: str, n: int = 12, seed: int = 0) -> list:
    """Three prediction CSVs with the eval CLIs' columns (06, 07, 08), float32
    probabilities written as they write them: [baseline, multimodal, AF] paths."""
    from ptbxl_torch.utils.table import write_csv

    rng = np.random.default_rng(seed)
    y = (rng.uniform(size=(n, 6)) < 0.4).astype(int)
    paths = []
    for name, labels, suffix in (("base", CLASSES, ""), ("mm", CLASSES, "_mm"),
                                 ("af", ["AF"], "")):
        cols = {}
        for j, c in enumerate(labels):
            prob = rng.uniform(size=n).astype(np.float32)
            cols[f"y_true_{c}"] = y[:, 5 if c == "AF" else j]
            cols[f"y_prob_{c}{suffix}"] = prob
            cols[f"y_pred_{c}{suffix}"] = (prob >= 0.5).astype(int)
        path = os.path.join(root, f"{name}.csv")
        write_csv(path, cols)
        paths.append(path)
    return paths


def block_module(monkeypatch, name: str) -> None:
    """Make ``import name`` (and its submodules) raise ImportError for the
    test, as on a machine where it is not installed."""
    import sys

    for mod in [m for m in list(sys.modules) if m == name or m.startswith(name + ".")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, name, None)
