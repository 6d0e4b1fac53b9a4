"""Phase-packed front: blocks 0 and 1 of the BN-folded ECGCNN with their output
positions packed into channels (port of ``ptbxl_tpu/ops/phase_pack.py``).

conv1 (Cout 32) becomes a stride-4 conv emitting 4 consecutive output
positions as channels,

    out[4*t2 + q, co] = (conv_{stride 4, k=18}(x_pad, W4))[t2, q*32 + co]
    W4[u, c, q*32 + co] = W[u - q, c, co]  (0 <= u - q < 15, else 0)

so MaxPool(2) pairs phases (2q', 2q'+1) of one t2 and is a channel-block
max whose result is the 2-phase packing conv2 takes: conv2 is a stride-1,
k=9, 64 -> 128 conv over t2 (phases in channels), and its pool unpacks to
the plain ``[B, T/4, 64]`` the third block reads.  Exact up to the order of
f32 sums.  The JAX package measured it neutral on its TPU (XLA packs output
positions itself) and keeps it unwired; the port keeps it unwired too, and
PERF.md holds the packed and plain fronts' times on the H100.

Works on the port's ``Folded`` weights (``ops/kernels/fused_ecgcnn.py::
fold_bn_into_conv``: ``w{i}`` [K, Cin, Cout], ``b{i}`` [Cout]) and JAX's
layouts (``x [B, T, 12]`` z-scored, T % 4 == 0).  The convs take their
operands rounded to ``compute_dtype`` and sum and return f32, as JAX's
``preferred_element_type=float32``: an f32 conv of the rounded operands,
whose products are exact in f32 (and in TF32 on the tensor cores, so with
TF32 allowed a bf16 front runs on them); f32 needs ``highest_precision()``
on the card.  The biases, ReLU and pools are f32.  This is the arithmetic of
``hybrid_ecgcnn._front_plain`` (JAX's ``_xla_front``), which it is held
against.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ptbxl_torch.ops.kernels.fused_ecgcnn import _round

K = 15
PAD = K // 2


def _np(w: torch.Tensor) -> np.ndarray:
    return w.detach().float().cpu().numpy()


def pack_conv1_weights(w: torch.Tensor, b: torch.Tensor,
                       phases: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [15, Cin, Cout], b [Cout] -> stride-``phases`` packed (w4, b4):
    w4 [15 + phases - 1, Cin, phases*Cout] with w4[u, c, q*Cout + co] =
    w[u - q, c, co] where valid, zero elsewhere; on ``w``'s device."""
    k, cin, cout = w.shape
    w4 = np.zeros((k + phases - 1, cin, phases * cout), dtype=np.float32)
    wn = _np(w)
    for q in range(phases):
        w4[q:q + k, :, q * cout:(q + 1) * cout] = wn
    return torch.from_numpy(w4).to(w.device), b.float().repeat(phases)


def pack_conv2_weights(w: torch.Tensor, b: torch.Tensor, phases_in: int = 2,
                       phases_out: int = 2) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """w [15, Cin, Cout] -> the conv over packed t2: (w9, b9, left pad, taps).

    Input channels are phase-packed p*Cin + c (p < phases_in), output channels
    q*Cout + co (q < phases_out); tap d reads input position phases_in*(t2+d) + p
    for output position phases_out*t2 + q.
    """
    if phases_in != phases_out:
        raise ValueError("mixed phase factors are not supported")
    k, cin, cout = w.shape
    wn = _np(w)
    p_ = phases_in
    d_lo = -((PAD + p_ - 1) // p_)
    d_hi = (k - PAD - 1 + (p_ - 1)) // p_
    taps = d_hi - d_lo + 1
    w9 = np.zeros((taps, p_ * cin, p_ * cout), dtype=np.float32)
    for q in range(p_):
        for d in range(d_lo, d_hi + 1):
            for p in range(p_):
                k_orig = p_ * d + p - q + PAD
                if 0 <= k_orig < k:
                    w9[d - d_lo, p * cin:(p + 1) * cin, q * cout:(q + 1) * cout] = wn[k_orig]
    return torch.from_numpy(w9).to(w.device), b.float().repeat(p_), -d_lo, taps


def _pool_packed_channels(h: torch.Tensor, phases: int, cout: int) -> torch.Tensor:
    """MaxPool(2) of a phase-packed ``[B, t2, phases*cout]``: the max over phase pairs."""
    bsz, t2, _ = h.shape
    return h.view(bsz, t2, phases // 2, 2, cout).amax(dim=3).reshape(bsz, t2, -1)


def prepack_front(folded: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """The BN-folded conv1/conv2 weights packed once."""
    w4, b4 = pack_conv1_weights(folded["w0"], folded["b0"], phases=4)
    w9, b9, _, _ = pack_conv2_weights(folded["w1"], folded["b1"], 2, 2)
    return {"pp_w4": w4, "pp_b4": b4, "pp_w9": w9, "pp_b9": b9}


def _conv(xp: torch.Tensor, w: torch.Tensor, stride: int,
          compute_dtype: torch.dtype) -> torch.Tensor:
    """VALID conv of channels-last ``xp`` with ``w [taps, Cin, Cout]``, operands
    rounded to ``compute_dtype``, f32 sums -> f32 ``[B, T', Cout]``."""
    y = F.conv1d(_round(xp.transpose(1, 2), compute_dtype),
                 _round(w.permute(2, 1, 0), compute_dtype), stride=stride)
    return y.transpose(1, 2)


def phase_packed_front(x: torch.Tensor, folded: Optional[Mapping[str, object]],
                       compute_dtype: torch.dtype = torch.bfloat16,
                       packed: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
    """z-scored ``x [B, T, 12]`` -> block 1's pooled output ``[B, T/4, C2]``: conv1 +
    ReLU + pool then conv2 + ReLU + pool with the BN-folded weights (``packed``
    from ``prepack_front``, else built from ``folded``)."""
    if packed is None:
        packed = prepack_front(folded)
    w4, b4, w9, b9 = packed["pp_w4"], packed["pp_b4"], packed["pp_w9"], packed["pp_b9"]
    cout1, cout2 = w4.shape[2] // 4, w9.shape[2] // 2
    # conv1: stride 4, 4 phases into channels (positions 4*t2 + q read 4*t2 + u - PAD)
    xp = F.pad(x, (0, 0, PAD, w4.shape[0] - 1 - PAD))
    h = torch.relu(_conv(xp, w4, 4, compute_dtype) + b4)
    h = _pool_packed_channels(h, 4, cout1)                   # [B, T/4, 2*cout1], 2 phases
    # conv2: stride 1 over t2, 2 phases in and out; the left pad is the packer's
    # -d_lo = ceil(PAD / 2)
    pad_left = (PAD + 1) // 2
    hp = F.pad(h, (0, 0, pad_left, w9.shape[0] - 1 - pad_left))
    h = torch.relu(_conv(hp, w9, 1, compute_dtype) + b9)
    return _pool_packed_channels(h, 2, cout2)                 # [B, T/4, cout2]
