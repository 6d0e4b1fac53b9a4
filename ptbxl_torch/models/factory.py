"""Model construction and checkpoint loading (port of ``models/factory.py``)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ptbxl_torch.models.ecg_cnn import ECGCNN
from ptbxl_torch.models.ecg_multimodal import ECGMultimodal
from ptbxl_torch.models.params_io import StateDict, load_checkpoint
from ptbxl_torch.utils.device import DeviceLike, resolve_device


def build_ecgcnn(
    in_leads: int = 12,
    feat_dim: int = 256,
    num_labels: int = 5,
    seed: int = 42,
    precision: Optional[str] = "highest",
    dtype: torch.dtype = torch.float32,
    torch_init: bool = False,
    device: DeviceLike = None,
) -> ECGCNN:
    """A freshly initialised ECGCNN in eval mode, weights drawn from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = ECGCNN(feat_dim=feat_dim, num_labels=num_labels, in_leads=in_leads,
                   precision=precision, dtype=dtype, torch_init=torch_init,
                   generator=gen)
    return model.to(dev).eval()


def build_multimodal(
    in_leads: int = 12,
    ecg_feat_dim: int = 256,
    demo_hidden_dim: int = 64,
    num_labels: int = 5,
    seed: int = 42,
    precision: Optional[str] = "highest",
    dtype: torch.dtype = torch.float32,
    torch_init: bool = False,
    device: DeviceLike = None,
) -> ECGMultimodal:
    """A freshly initialised FiLM multimodal model in eval mode, weights drawn from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = ECGMultimodal(feat_dim=ecg_feat_dim, num_labels=num_labels,
                          demo_hidden_dim=demo_hidden_dim, in_leads=in_leads,
                          precision=precision, dtype=dtype, torch_init=torch_init,
                          generator=gen)
    return model.to(dev).eval()


def merge_state(model: torch.nn.Module, loaded: StateDict, strict: bool) -> None:
    """Load ``loaded`` into ``model``.

    strict: every model entry must be present with its shape (extra entries
    are ignored, as in the JAX loader).  Lenient: take the entries whose name
    and shape match and keep the init values for the rest (the reference's
    ``strict=False`` demo loads, factory.py:110-146).
    """
    own = model.state_dict()
    if strict:
        for key, leaf in own.items():
            if key.endswith("num_batches_tracked"):
                continue
            if key not in loaded:
                raise KeyError(f"Checkpoint missing entry {key}")
            if tuple(loaded[key].shape) != tuple(leaf.shape):
                raise ValueError(
                    f"Shape mismatch at {key}: ckpt {tuple(loaded[key].shape)} "
                    f"vs model {tuple(leaf.shape)}"
                )
    take = {k: v for k, v in loaded.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)}
    model.load_state_dict(take, strict=False)


def merge_backbone(model: ECGMultimodal, backbone: StateDict) -> ECGMultimodal:
    """Warm-start the multimodal ECG encoder from a baseline checkpoint
    (``load_checkpoint(path, arch="backbone")``), as the reference's
    ``strict=False`` load into ``model.ecg_backbone`` (scripts/04:149-156).

    Entries that the encoder has (conv blocks, ``proj``) replace its values;
    the demo encoder, FiLM and head keep theirs.  A shape mismatch raises, as
    torch's lenient load and the JAX ``_check_shapes`` (factory.py:170) do.
    """
    own = model.ecg_backbone.state_dict()
    take = {}
    for key, v in backbone.items():
        if key not in own:
            continue
        if tuple(v.shape) != tuple(own[key].shape):
            raise ValueError(
                f"warm-start shape mismatch at ecg_backbone.{key}: model "
                f"{tuple(own[key].shape)} vs checkpoint {tuple(v.shape)}")
        take[key] = v
    model.ecg_backbone.load_state_dict(take, strict=False)
    return model


def load_ecgcnn(
    ckpt_path: str,
    num_labels: int = 5,
    feat_dim: int = 256,
    in_leads: int = 12,
    strict: bool = True,
    device: DeviceLike = None,
    **model_kwargs,
) -> Tuple[ECGCNN, Optional[List[str]]]:
    """Build an ECGCNN and load a checkpoint (``.npz`` native or reference ``.pth``).

    Returns ``(model, classes)``; the model holds its weights, so there is no
    separate variables tree as in JAX.
    """
    model = build_ecgcnn(in_leads, feat_dim, num_labels, device=device, **model_kwargs)
    loaded, classes = load_checkpoint(ckpt_path, arch="ecgcnn")
    merge_state(model, loaded, strict=strict)
    return model, classes


def load_multimodal(
    ckpt_path: str,
    num_labels: int = 5,
    ecg_feat_dim: int = 256,
    demo_hidden_dim: int = 64,
    in_leads: int = 12,
    strict: bool = True,
    device: DeviceLike = None,
    **model_kwargs,
) -> Tuple[ECGMultimodal, Optional[List[str]]]:
    """Build the multimodal model and load a checkpoint; returns ``(model, classes)``."""
    model = build_multimodal(in_leads, ecg_feat_dim, demo_hidden_dim, num_labels,
                             device=device, **model_kwargs)
    loaded, classes = load_checkpoint(ckpt_path, arch="multimodal")
    merge_state(model, loaded, strict=strict)
    return model, classes
