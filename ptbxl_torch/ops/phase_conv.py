"""Phase-domain Conv1d: a stride-2 conv emitting both pool phases as channels
(port of ``ptbxl_tpu/ops/phase_conv.py``).

``conv(k, SAME, stride 1) -> BN -> relu -> maxpool(2)`` on an even length T
is the same function as

    phase conv: conv(k+1, stride 2, 2*Cout channels) -> both phases of each
                pool window side by side
    BN over (B, phase, U) per channel (the same elements as BN over (B, T))
    relu -> max over the phase axis

whose kernel is the original ``w`` with a zero tap appended for phase 0 and
prepended for phase 1 (``out[u, 0] = h[2u]``, ``out[u, 1] = h[2u+1]``: the
extra tap multiplies by zero).  The pool's backward becomes the max's
elementwise one.  The JAX package measured this form slower than the
standard one on its TPU and keeps it off (``ptbxl_tpu/models/ecg_cnn.py:
189-196``); ``ECGCNN(phase_train=True)`` runs it here, and PERF.md holds its
step time on the H100 beside the standard step's.

* ``build_phase_kernel`` / ``phase_conv``: JAX's layouts (``x [B, T, Cin]``,
  ``w [k, Cin, Cout]`` -> ``[B, T//2, 2, Cout]``), for the tests and tools.
* ``phase_conv_cf``: the channels-first form ``ConvBlock`` runs: ``x [B,
  Cin, T]``, ``w [Cout, Cin, k]`` -> ``[B, 2*Cout, T//2]``, channels in
  JAX's order ``[phase 0 C, phase 1 C]``; one stride-2 ``F.conv1d`` padded
  ``k//2`` on both sides (JAX's ``pl``/``pr``, equal for odd k and even T).
  On the card it is cuDNN's conv in the input's dtype.  On the CPU a bf16
  input runs as an f32 conv of the bf16 values rounded once to bf16, the
  same arithmetic: torch's CPU (oneDNN) bf16 conv gets this even-length
  kernel wrong at some channel counts (a max error of 70 on outputs of
  magnitude 55 at 12 input channels, torch 2.13).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def build_phase_kernel(w: torch.Tensor) -> torch.Tensor:
    """[k, Cin, Cout] -> [k+1, Cin, 2*Cout]: zero tap appended (phase 0) /
    prepended (phase 1)."""
    z = torch.zeros_like(w[:1])
    return torch.cat([torch.cat([w, z], dim=0), torch.cat([z, w], dim=0)], dim=2)


def _check(t: int, k: int) -> None:
    if t % 2:
        raise ValueError(f"phase_conv needs even T, got {t}")
    if k % 2 == 0:
        raise ValueError(f"phase_conv needs odd k (SAME padding), got {k}")


def phase_conv_cf(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME stride-1 conv1d with both pool phases as channels, channels first:
    ``x [B, Cin, T]`` (T even), ``w [Cout, Cin, k]`` (k odd) -> ``[B, 2*Cout,
    T//2]`` with ``out[:, j*Cout + c, u] == conv_same(x, w)[:, c, 2u+j]``.
    ``b`` is added after the product (once a phase)."""
    k = w.shape[2]
    _check(x.shape[2], k)
    wp = build_phase_kernel(w.permute(2, 1, 0)).permute(2, 1, 0)  # [2*Cout, Cin, k+1]
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        out = F.conv1d(x.float(), wp.float(), stride=2, padding=k // 2).to(x.dtype)
    else:
        out = F.conv1d(x, wp, stride=2, padding=k // 2)
    if b is not None:
        out = out + torch.cat([b, b])[:, None]
    return out


def phase_conv(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX's ``phase_conv``: ``x [B, T, Cin]`` (T even), ``w [k, Cin, Cout]``
    (k odd) -> ``[B, T//2, 2, Cout]`` with ``out[:, u, j] == conv_same(x, w)[:,
    2u+j]``.  Under ``highest_precision()`` on the card for full f32."""
    bsz, t, _ = x.shape
    k, _, co = w.shape
    _check(t, k)
    out = phase_conv_cf(x.transpose(1, 2), w.permute(2, 1, 0), b)  # [B, 2*Co, U]
    return out.view(bsz, 2, co, t // 2).permute(0, 3, 1, 2)
