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
on the framework modules (autograd), like the JAX version.  For the FiLM
multimodal model (``multimodal=True``) the tail also takes the demo vectors;
``demo_importance`` is the |grad x input| saliency on them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ptbxl_torch.models.ecg_cnn import ECGCNN, dense, precision_scope
from ptbxl_torch.models.ecg_multimodal import ECGMultimodal


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


def _as_tensor(v, model: torch.nn.Module) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=model.head.weight.device)


class GradCAM:
    """(probs, cam) for a model with ``features``/``tail``.

    Args:
        model: the ``ECGCNN`` or ``ECGMultimodal`` (it holds its weights); it
            is put in eval mode.
        signal_length: output CAM length (None keeps T').
        norm_first: normalize-then-interpolate (library variant) vs
            interpolate-then-normalize (demo variants).
        eps: epsilon of the non-guarded normalization (ignored if norm_first).
        multimodal: ``tail`` takes the demo vectors ``x_demo`` [B, 5].

    Inputs are channels-last ``[B, T, C]`` and ``[B, 5]`` (tensors or
    arrays; they are moved to the model's device).
    """

    def __init__(self, model: Union[ECGCNN, ECGMultimodal], signal_length: Optional[int] = None,
                 norm_first: bool = False, eps: float = 1e-9, multimodal: bool = False):
        if multimodal != isinstance(model, ECGMultimodal):
            raise TypeError(f"multimodal={multimodal} does not fit a {type(model).__name__}")
        self.model = model.eval()
        self.signal_length = signal_length
        self.norm_first = norm_first
        self.eps = eps
        self.multimodal = multimodal

    def _finish(self, cam: torch.Tensor) -> torch.Tensor:
        if self.norm_first:
            cam = _minmax_guarded(cam)
            if self.signal_length is not None:
                cam = linear_interpolate_1d(cam, self.signal_length)
            return cam
        if self.signal_length is not None:
            cam = linear_interpolate_1d(cam, self.signal_length)
        return _minmax_eps(cam, self.eps)

    def multi(self, x: torch.Tensor, class_indices: Sequence[int], x_demo=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, T, C], class_indices: [n] (+ x_demo [B, 5]) -> (probs [B, L], cams [n, B, T]).

        One forward of ``features`` and ``tail``; each class then costs one
        backward of its one-hot cotangent through ``tail``.
        """
        idx = [int(c) for c in class_indices]
        if not idx:
            raise ValueError("class_indices is empty")
        if self.multimodal and x_demo is None:
            raise ValueError("multimodal Grad-CAM requires x_demo")
        extra = (_as_tensor(x_demo, self.model),) if self.multimodal else ()
        with torch.no_grad():
            a = self.model.features(_as_tensor(x, self.model))
        a = a.detach().requires_grad_(True)
        with torch.enable_grad():
            logits = self.model.tail(a, *extra)
            cams = []
            for n, ci in enumerate(idx):
                ct = torch.zeros_like(logits)
                ct[:, ci] = 1.0
                (dyda,) = torch.autograd.grad(logits, a, ct, retain_graph=n + 1 < len(idx))
                w = dyda.mean(dim=1, keepdim=True)           # [B, 1, C]
                cams.append(torch.relu((w * a.detach()).sum(dim=-1)))  # [B, T']
        return torch.sigmoid(logits.detach()), self._finish(torch.stack(cams))

    def all_classes(self, x: torch.Tensor, x_demo=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``multi`` for every class, its backward through ``tail`` written out
        as tensor ops (no autograd), so that ``torch.export`` can trace it:
        x [B, T, C] (+ x_demo [B, 5]) -> (probs [B, L], cams [L, B, T]).
        (``multi``'s ``torch.autograd.grad`` exports to no working program:
        ``ptbxl_torch/tools/probe_cam_export.py``.)

        From the last block's pooled output ``p`` [B, C, T''] the tail is
        linear: d logits[:, l] / d p[b, c, t] = u[b, l, c] / T'', with
        ``u = head_w @ proj_w`` (times FiLM's ``gamma[b]`` over the features
        for the multimodal model).  The pool and ReLU send each window's
        cotangent to its max where that max is positive (torch's pool
        backward routes a tie to its first element, K6 splits it: the sum over
        the window is the same), and BatchNorm scales it by ``weight /
        sqrt(var + eps)``; so mean_t(dY/dA) = scale * u / T'' * n_pos / T',
        n_pos the count of positive pooled values.  Computed in f32.
        """
        m = self.model
        bb = m.ecg_backbone if self.multimodal else m
        extra = (_as_tensor(x_demo, m),) if self.multimodal else ()
        if self.multimodal and x_demo is None:
            raise ValueError("multimodal Grad-CAM requires x_demo")
        with torch.no_grad():
            a = m.features(_as_tensor(x, m))                   # [B, T', C]
            logits = m.tail(a, *extra)
            blk = bb.backbone[-1]
            pooled = blk.post(a.transpose(1, 2))               # [B, C, T'']
            bn = blk.net[1]
            with precision_scope(m.precision):
                wh, wp = m.head.weight.float(), bb.proj.weight.float()  # [L, F], [F, C]
                if self.multimodal:
                    film = dense(m.film_gen, m.demo_encoder(extra[0]), m.dtype).float()
                    gamma = 1.0 + torch.tanh(film[:, :wp.shape[0]])   # [B, F]
                    u = torch.matmul(wh[None] * gamma[:, None, :], wp)  # [B, L, C]
                else:
                    u = torch.matmul(wh, wp)[None]                      # [1, L, C]
                scale = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
                n_pos = (pooled > 0).sum(dim=2).float()[:, None, :]    # [B, 1, C]
                w = (u / pooled.shape[2]) * scale * n_pos / a.shape[1]  # [B, L, C]
                cams = torch.relu(torch.einsum("blc,btc->lbt", w, a.float()))
        return torch.sigmoid(logits.float()), self._finish(cams)

    def __call__(self, x: torch.Tensor, class_idx: int = 0, x_demo=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, T, C] (+ x_demo [B, 5]) -> (probs [B, L], cam [B, signal_length])."""
        probs, cams = self.multi(x, [class_idx], x_demo)
        return probs, cams[0]


def batch_grad_cam(cam_fn: GradCAM, x: torch.Tensor, class_indices: Sequence[int], x_demo=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CAMs for a batch across several classes in one pass: (probs, cams [n, B, T])."""
    return cam_fn.multi(x, class_indices, x_demo)


def demo_importance(model: ECGMultimodal, x_ecg, x_demo, class_idx: int) -> torch.Tensor:
    """|grad x input| saliency on the demographic vector, max-normalized: [5].

    ``|d(sum_b logits[b, class_idx]) / d demo[0] * demo[0]|``, divided by its
    max only when the max is > 0.  Record 0 alone, even when B > 1, as the
    reference (scripts/12_grad_cam_ecg_demo.py:78-97) and the JAX version do.
    """
    model.eval()
    d = _as_tensor(x_demo, model).detach().requires_grad_(True)
    with torch.no_grad():
        a = model.features(_as_tensor(x_ecg, model))
    with torch.enable_grad():
        score = model.tail(a, d)[:, class_idx].sum()
        (grad,) = torch.autograd.grad(score, d)
    imp = (grad[0] * d.detach()[0]).abs()
    mx = imp.max()
    return torch.where(mx > 0, imp / torch.where(mx > 0, mx, torch.ones_like(mx)), imp)
