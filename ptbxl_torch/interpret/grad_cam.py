"""Grad-CAM for the 1D ECG model (port of ``ptbxl_tpu/interpret/grad_cam.py``).

The model exposes a ``features``/``tail`` split at the last conv's
pre-activation; the JAX package pulls a one-hot cotangent back through
``tail`` with ``jax.vjp``, the port with ``torch.autograd.grad``:

  A    = last-conv pre-activation [B, T', C]
  dYdA = d(sum_b logits[b, class_idx]) / dA
  w    = mean_t(dYdA)                 # [B, 1, C]
  cam  = relu(sum_c w * A)            # [B, T']
  -> normalize / linearly interpolate to T

``norm_first=True`` is the reference library's order (guarded min-max, then
interpolate); ``False`` the demo scripts' (interpolate, then
``(cam - min) / (max + eps)`` with eps 1e-9, or 1e-8 for script 12).  It runs
on the framework modules (autograd), like the JAX version.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ptbxl_torch.models.ecg_cnn import ECGCNN


def linear_interpolate_1d(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Resize the last axis to ``out_len`` like ``F.interpolate(mode='linear')``.

    Half-pixel centres, ``src = (i + 0.5) * L_in / L_out - 0.5`` clamped to
    ``[0, L_in - 1]``; positions are computed in float64 on the host so the
    floors match the JAX version exactly.
    """
    in_len = x.shape[-1]
    if in_len == out_len:
        return x
    pos = (np.arange(out_len, dtype=np.float64) + 0.5) * (in_len / out_len) - 0.5
    pos = np.clip(pos, 0.0, in_len - 1.0)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_len - 1)
    w = torch.as_tensor(pos - i0, dtype=x.dtype, device=x.device)
    i0 = torch.as_tensor(i0, device=x.device)
    i1 = torch.as_tensor(i1, device=x.device)
    return x[..., i0] * (1.0 - w) + x[..., i1] * w


def _minmax_guarded(cam: torch.Tensor) -> torch.Tensor:
    """cam -= min; divide by max only where max > 0."""
    cam = cam - cam.amin(dim=-1, keepdim=True)
    mx = cam.amax(dim=-1, keepdim=True)
    return torch.where(mx > 0, cam / torch.where(mx > 0, mx, torch.ones_like(mx)), cam)


def _minmax_eps(cam: torch.Tensor, eps: float) -> torch.Tensor:
    cam = cam - cam.amin(dim=-1, keepdim=True)
    return cam / (cam.amax(dim=-1, keepdim=True) + eps)


class GradCAM:
    """(probs, cam) for an ECGCNN with ``features``/``tail``.

    Args:
        model: the ``ECGCNN`` (it holds its weights); it is put in eval mode.
        signal_length: output CAM length (None keeps T').
        norm_first: normalize-then-interpolate (library variant) vs
            interpolate-then-normalize (demo variants).
        eps: epsilon of the non-guarded normalization (ignored if norm_first).
        multimodal: the multimodal model is not ported yet.

    Input is channels-last ``[B, T, C]`` (a tensor or array; it is moved to
    the model's device).
    """

    def __init__(self, model: ECGCNN, signal_length: Optional[int] = None,
                 norm_first: bool = False, eps: float = 1e-9, multimodal: bool = False):
        if multimodal:
            raise NotImplementedError(
                "multimodal Grad-CAM comes with the multimodal model, ROADMAP queue 1 item 4")
        self.model = model.eval()
        self.signal_length = signal_length
        self.norm_first = norm_first
        self.eps = eps

    def _finish(self, cam: torch.Tensor) -> torch.Tensor:
        if self.norm_first:
            cam = _minmax_guarded(cam)
            if self.signal_length is not None:
                cam = linear_interpolate_1d(cam, self.signal_length)
            return cam
        if self.signal_length is not None:
            cam = linear_interpolate_1d(cam, self.signal_length)
        return _minmax_eps(cam, self.eps)

    def multi(self, x: torch.Tensor, class_indices: Sequence[int]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, T, C], class_indices: [n] -> (probs [B, L], cams [n, B, T]).

        One forward of ``features`` and ``tail``; each class then costs one
        backward of its one-hot cotangent through ``tail``.
        """
        idx = [int(c) for c in class_indices]
        if not idx:
            raise ValueError("class_indices is empty")
        x = torch.as_tensor(x, dtype=torch.float32, device=self.model.head.weight.device)
        with torch.no_grad():
            a = self.model.features(x)
        a = a.detach().requires_grad_(True)
        with torch.enable_grad():
            logits = self.model.tail(a)
            cams = []
            for n, ci in enumerate(idx):
                ct = torch.zeros_like(logits)
                ct[:, ci] = 1.0
                (dyda,) = torch.autograd.grad(logits, a, ct, retain_graph=n + 1 < len(idx))
                w = dyda.mean(dim=1, keepdim=True)           # [B, 1, C]
                cams.append(torch.relu((w * a.detach()).sum(dim=-1)))  # [B, T']
        return torch.sigmoid(logits.detach()), self._finish(torch.stack(cams))

    def __call__(self, x: torch.Tensor, class_idx: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, T, C] -> (probs [B, L], cam [B, signal_length])."""
        probs, cams = self.multi(x, [class_idx])
        return probs, cams[0]


def batch_grad_cam(cam_fn: GradCAM, x: torch.Tensor, class_indices: Sequence[int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CAMs for a batch across several classes in one pass: (probs, cams [n, B, T])."""
    return cam_fn.multi(x, class_indices)
