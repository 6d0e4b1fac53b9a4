"""Batched ECG classifier inference (port of ``ptbxl_tpu/inference.py``).

    predictor = Predictor.from_checkpoint("outputs/ecg_baseline/ckpts/ecg_baseline_best.npz")
    probs = predictor(signals)                  # [N, 12, T] raw -> [N, L]

    mm = Predictor.from_checkpoint("outputs/ecg_multimodal/ckpts/ecg_multimodal_best.npz",
                                   arch="multimodal")
    probs = mm(signals, demo=demo_vectors)      # + [N, 5] demographics

* accepts reference-layout ``[N, 12, T]`` or channels-last ``[N, T, 12]`` raw
  signals; the per-lead z-score runs on the device
* ``engine='kernel'`` runs the hand-written fused forward (K2, or K3 for
  ``arch='multimodal'``; f32 compute, its conv blocks in 3xTF32 on the tensor
  cores), ``engine='framework'`` the ``nn.Module`` on cuDNN (the JAX
  Predictor's names ``'pallas'`` and ``'xla'`` are taken for them), and
  ``engine='auto'`` takes the kernel for chunks of at most
  ``PTBXL_TORCH_KERNEL_MAX_BATCH`` records: by default 1024, the largest chunk
  at which the kernel engine was no slower than cuDNN f32 at ``'highest'`` on
  the H100 (chip_smoke.py's ``crossover`` phase, PERF.md)
* ``precision='highest'`` is f32 with TF32 off and the two-pass z-score;
  ``'default'`` runs the framework engine in bf16 with the one-pass z-score
  (inference.py:198-202).  The kernel engine computes in f32 either way, as
  the JAX kernel engine does.
* chunking, and power-of-two buckets for small N with the last row (signal
  and demo vector) repeated as padding (inference.py:289-319)
"""

from __future__ import annotations

import os
from typing import List, Mapping, Optional

import numpy as np
import torch

from ptbxl_torch.models.ecg_cnn import ECGCNN
from ptbxl_torch.models.ecg_multimodal import ECGMultimodal
from ptbxl_torch.models.factory import merge_state
from ptbxl_torch.models.params_io import load_checkpoint
from ptbxl_torch.ops.kernels.fused_ecgcnn import (
    fold_bn_into_conv,
    fold_multimodal,
    fused_ecgcnn_probs,
    fused_multimodal_probs,
    prepare_weights,
)
from ptbxl_torch.ops.preprocess import zscore_per_lead_batch, zscore_per_lead_batch_onepass
from ptbxl_torch.utils.device import DeviceLike, resolve_device

KERNEL_MAX_BATCH = int(os.environ.get("PTBXL_TORCH_KERNEL_MAX_BATCH", "1024"))

_ARCHS = ("ecgcnn", "multimodal")
_ENGINES = ("auto", "framework", "kernel")
ENGINE_ALIASES = {"xla": "framework", "pallas": "kernel"}  # the JAX Predictor's names
_PRECISIONS = ("highest", "default")


class Predictor:
    """Batched baseline / AF ECGCNN or FiLM multimodal inference on one device."""

    def __init__(
        self,
        state_dict: Mapping[str, torch.Tensor],
        classes: Optional[List[str]] = None,
        num_labels: int = 5,
        feat_dim: int = 256,
        arch: str = "ecgcnn",
        demo_hidden_dim: int = 64,
        engine: str = "auto",
        chunk_size: int = 512,
        normalize: bool = True,
        data_parallel: bool = False,
        precision: str = "highest",
        device: DeviceLike = None,
    ):
        """``state_dict`` is reference-layout (``params_io.load_checkpoint``)."""
        if arch not in _ARCHS:
            raise ValueError(f"arch must be one of {_ARCHS}, got {arch!r}")
        if data_parallel:
            raise NotImplementedError(
                "data_parallel=True comes with multi-GPU support, ROADMAP queue 1 item 8")
        if precision == "int8":
            raise NotImplementedError("precision='int8' comes with ROADMAP queue 1 item 9")
        if precision not in _PRECISIONS:
            raise ValueError(f"precision must be one of {_PRECISIONS + ('int8',)}, got {precision!r}")
        engine = ENGINE_ALIASES.get(engine, engine)
        if engine not in _ENGINES:
            raise ValueError(
                f"engine must be one of {_ENGINES + tuple(ENGINE_ALIASES)}, got {engine!r}")
        self.device = resolve_device(device)
        self.classes = classes
        self.chunk_size = chunk_size
        self.normalize = normalize
        self.arch = arch
        self.engine = engine
        self.precision = precision
        self._num_labels = num_labels

        dtype = torch.float32 if precision == "highest" else torch.bfloat16
        if arch == "multimodal":
            self.model = ECGMultimodal(feat_dim=feat_dim, num_labels=num_labels,
                                       demo_hidden_dim=demo_hidden_dim,
                                       precision=precision, dtype=dtype)
        else:
            self.model = ECGCNN(feat_dim=feat_dim, num_labels=num_labels,
                                precision=precision, dtype=dtype)
        merge_state(self.model, state_dict, strict=True)
        self.model.to(self.device).eval()
        self._folded = self._weights = None
        if engine != "framework":
            fold = fold_multimodal if arch == "multimodal" else fold_bn_into_conv
            self._folded = fold({k: v.to(self.device) for k, v in self.model.state_dict().items()})
            self._weights = prepare_weights(self._folded)  # the kernel's split f32 weights, once
        self._zscore = (zscore_per_lead_batch if precision == "highest"
                        else zscore_per_lead_batch_onepass)

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, num_labels: int = 5, arch: str = "ecgcnn",
                        **kwargs) -> "Predictor":
        state, classes = load_checkpoint(ckpt_path, arch=arch)
        return cls(state, classes=classes, num_labels=num_labels, arch=arch, **kwargs)

    def _use_kernel(self, batch: int) -> bool:
        if self.engine == "auto":
            return batch <= KERNEL_MAX_BATCH
        return self.engine == "kernel"

    @torch.no_grad()
    def _forward(self, x: torch.Tensor, d: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One chunk on the device: x [B, T, 12] (+ d [B, 5] for multimodal) -> probs."""
        if self._use_kernel(x.shape[0]):
            if self.arch == "multimodal":
                return fused_multimodal_probs(x, d, self._folded, normalize=self.normalize,
                                              weights=self._weights)
            return fused_ecgcnn_probs(x, self._folded, normalize=self.normalize,
                                      weights=self._weights)
        h = self._zscore(x) if self.normalize else x
        logits = self.model(h, d) if self.arch == "multimodal" else self.model(h)
        return torch.sigmoid(logits.float())

    def __call__(self, signals, demo=None) -> np.ndarray:
        """signals: [N, 12, T] or [N, T, 12] raw (+ demo [N, 5] for multimodal)
        -> probs [N, num_labels] (numpy f32)."""
        x = np.asarray(signals, dtype=np.float32)
        if x.ndim == 2:
            x = x[None]
        if x.shape[1] == 12 and x.shape[2] != 12:
            x = x.transpose(0, 2, 1)  # -> channels-last
        n = x.shape[0]
        if self.arch == "multimodal":
            if demo is None:
                raise ValueError("multimodal Predictor requires demo vectors")
            demo = np.asarray(demo, dtype=np.float32)
            if demo.ndim == 1:
                demo = demo[None]
            if demo.shape != (n, 5):
                raise ValueError(f"demo must be [N, 5] matching signals N={n}; got {demo.shape}")
        if n == 0:
            return np.empty((0, self._num_labels), np.float32)

        outs = []
        cs = self.chunk_size
        for i0 in range(0, n, cs):
            chunk = x[i0:i0 + cs]
            real = chunk.shape[0]
            if real < cs and n > cs:
                target = cs
            elif real < cs:
                # bucket small one-shot batches to the next power of two, as
                # the JAX Predictor does (pad rows are dropped below)
                target = 1 << (real - 1).bit_length() if real > 1 else 1
            else:
                target = real
            args = [chunk, demo[i0:i0 + cs]] if self.arch == "multimodal" else [chunk]
            if real < target:
                args = [np.concatenate([a, np.repeat(a[-1:], target - real, axis=0)])
                        for a in args]
            args = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in args]
            outs.append(self._forward(*args)[:real].cpu().numpy())
        return np.concatenate(outs, axis=0)
