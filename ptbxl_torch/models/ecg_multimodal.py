"""FiLM multimodal ECG + demographics model (port of ``ptbxl_tpu/models/ecg_multimodal.py``).

``ECGBackbone`` (ECGCNN minus head, 718,112 parameters), ``DemoEncoder``
(Linear(5, 64) ReLU Linear(64, hidden) ReLU, 4,544 parameters) and
``ECGMultimodal``: ``film = Linear(hidden, 2F)(demo_encoder(d))``, ``gamma,
beta = film.chunk(2)``, ``gamma = 1 + tanh(gamma)``, ``z = gamma * z_ecg +
beta``, ``logits = head(z)``; 757,221 parameters for 5 labels.

Submodule names follow the reference state dict (``ecg_backbone.backbone.
{i}.net.{0,1}.*``, ``ecg_backbone.proj.*``, ``demo_encoder.mlp.{0,2}.*``,
``film_gen.*``, ``head.*``), so a reference ``.pth`` loads with plain
``load_state_dict``.  Layout, ``precision``, ``dtype`` (the whole fusion
tail follows it, ecg_multimodal.py:114-116), ``torch_init`` and the
``features``/``tail`` split at the last conv's pre-activation and
``phase_train`` (passed to the backbone's blocks) are those of ``ecg_cnn.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ptbxl_torch.models.ecg_cnn import (
    PARITY_PRECISION,
    ConvBlock,
    dense,
    precision_scope,
    reset_layers,
)


class ECGBackbone(nn.Module):
    """1D-CNN encoder: ``[B, T, in_leads]`` -> z ``[B, feat_dim]``."""

    def __init__(self, feat_dim: int = 256, channels: Sequence[int] = (32, 64, 128, 256),
                 in_leads: int = 12, dtype: torch.dtype = torch.float32,
                 phase_train: bool = False):
        super().__init__()
        cins = [in_leads] + list(channels[:-1])
        self.backbone = nn.Sequential(
            *[ConvBlock(cin, c, dtype=dtype, phase_train=phase_train)
              for cin, c in zip(cins, channels)]
        )
        self.proj = nn.Linear(channels[-1], feat_dim)
        self.dtype = dtype

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Grad-CAM tap: the last conv's pre-activation ``[B, T', C_last]``."""
        h = x.transpose(1, 2)
        for blk in self.backbone[:-1]:
            h = blk(h)
        return self.backbone[-1].conv_only(h).transpose(1, 2)

    def tail_z(self, a: torch.Tensor) -> torch.Tensor:
        h = self.backbone[-1].post(a.transpose(1, 2))
        return dense(self.proj, h.mean(dim=2), self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail_z(self.features(x))


class DemoEncoder(nn.Module):
    """MLP for ``[age_norm, sex_id, height_norm, weight_norm, pacemaker]``."""

    def __init__(self, hidden_dim: int = 64, in_dim: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(in_dim, 64), nn.ReLU(),
                                 nn.Linear(64, hidden_dim), nn.ReLU())
        self.dtype = dtype

    def forward(self, x_demo: torch.Tensor) -> torch.Tensor:
        h = torch.relu(dense(self.mlp[0], x_demo, self.dtype))
        return torch.relu(dense(self.mlp[2], h, self.dtype))


class ECGMultimodal(nn.Module):
    """FiLM fusion of ECG and demographic features; ``feat_dim`` is the
    reference's ``ecg_feat_dim``."""

    def __init__(
        self,
        feat_dim: int = 256,
        demo_dim: int = 5,
        num_labels: int = 5,
        demo_hidden_dim: int = 64,
        in_leads: int = 12,
        channels: Sequence[int] = (32, 64, 128, 256),
        precision: Optional[str] = PARITY_PRECISION,
        dtype: torch.dtype = torch.float32,
        torch_init: bool = False,
        generator: Optional[torch.Generator] = None,
        phase_train: bool = False,
    ):
        super().__init__()
        self.ecg_backbone = ECGBackbone(feat_dim, channels, in_leads, dtype, phase_train)
        self.demo_encoder = DemoEncoder(demo_hidden_dim, demo_dim, dtype)
        self.film_gen = nn.Linear(demo_hidden_dim, 2 * feat_dim)
        self.head = nn.Linear(feat_dim, num_labels)
        self.precision = precision
        self.dtype = dtype
        self.reset_parameters(torch_init, generator)

    def reset_parameters(self, torch_init: bool = False,
                         generator: Optional[torch.Generator] = None) -> None:
        mlp = self.demo_encoder.mlp
        reset_layers(self.ecg_backbone.backbone,
                     (self.ecg_backbone.proj, mlp[0], mlp[2], self.film_gen, self.head),
                     torch_init, generator)

    def features(self, x_ecg: torch.Tensor) -> torch.Tensor:
        """Grad-CAM tap on the ECG branch (``ecg_backbone.backbone[-1].net[0]``)."""
        with precision_scope(self.precision):
            return self.ecg_backbone.features(x_ecg)

    def tail(self, a: torch.Tensor, x_demo: torch.Tensor) -> torch.Tensor:
        """Last block's BN/ReLU/pool, mean, proj, then the FiLM fusion and head."""
        with precision_scope(self.precision):
            z_ecg = self.ecg_backbone.tail_z(a)
            film = dense(self.film_gen, self.demo_encoder(x_demo), self.dtype)
            gamma, beta = film.chunk(2, dim=-1)
            z_cond = (1.0 + torch.tanh(gamma)) * z_ecg + beta
            return dense(self.head, z_cond, self.dtype)

    def forward(self, x_ecg: torch.Tensor, x_demo: torch.Tensor) -> torch.Tensor:
        """x_ecg: [B, T, in_leads]; x_demo: [B, 5] -> logits [B, num_labels]."""
        return self.tail(self.features(x_ecg), x_demo)
