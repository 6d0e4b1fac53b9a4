"""Test-split loader factories (port of ``ptbxl_tpu/data/ptb_test.py``).

The reference defines these but its scripts build their loaders inline; they
are kept because they are part of the public API.  Each returns a
``(dataset, BatchSource)`` pair with ``shuffle=False``.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ptbxl_torch.data.datasets import PTBXLAFDataset, PTBXLDataset, PTBXLECGMultimodalDataset
from ptbxl_torch.data.pipeline import BatchSource


def _mk(config: Dict, ds) -> Tuple[object, BatchSource]:
    train_cfg = config["train"]
    return ds, BatchSource(ds, int(train_cfg["batch_size"]), shuffle=False)


def make_baseline_test_loader(config: Dict) -> Tuple[object, BatchSource]:
    data_cfg = config["data"]
    ds = PTBXLDataset(
        base_dir=data_cfg["base_dir"],
        split="test",
        classes=data_cfg["labels"],
        normalize=data_cfg.get("normalize", "per_lead"),
    )
    return _mk(config, ds)


def make_multimodal_test_loader(config: Dict) -> Tuple[object, BatchSource]:
    data_cfg = config["data"]
    ds = PTBXLECGMultimodalDataset(
        base_dir=data_cfg["base_dir"],
        split="test",
        classes=data_cfg["labels"],
        normalize=data_cfg.get("normalize", "per_lead"),
    )
    return _mk(config, ds)


def make_af_test_loader(config: Dict) -> Tuple[object, BatchSource]:
    data_cfg = config["data"]
    ds = PTBXLAFDataset(
        base_dir=data_cfg["base_dir"],
        split="test",
        normalize=data_cfg.get("normalize", "per_lead"),
    )
    return _mk(config, ds)
