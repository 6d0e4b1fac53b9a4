"""The f32 weight gradient of the train step's conv, CUDA kernel + plain PyTorch version.

Replaces no TPU kernel: the JAX package leaves this product to XLA
(``ptbxl_tpu/ops/fast_wgrad.py``, a plain ``lax.dot_general``).  It takes the
place of cuDNN's deterministic weight gradient in the f32 train step
(``ops/conv_wgrad.py``).  Kernel: ``ptbxl_torch/csrc/conv_wgrad.cu``.

``conv_wgrad(x, dy)``: ``x [B, Cin, T]`` the conv's input, ``dy [B, Cout, T]``
the cotangent of its output (stride 1, k=15, SAME padding 7), both f32 ->
``dW [Cout, Cin, 15]`` f32, ``dW[co, ci, tap] = sum_{b,t} dy[b, co, t] *
x[b, ci, t + tap - 7]`` with ``x`` zero outside ``[0, T)``.  The card's
kernel computes it as 3xTF32 on ``wgmma`` (each product ``small*big +
big*small + big*big`` of the split operands, in sums restarted every stage
of ``8 * STAGE_STEPS`` reduction columns and added in f32;
``conv_wgrad_tf32x3_plain`` repeats that arithmetic on the host), cut into
``plan``'s slices of the reduction, fixed by the shape alone, whose partial
sums a second kernel adds in a fixed order: deterministic, and capturable in
a CUDA graph (no allocation or synchronisation inside).

What bounds it on the H100: operations (2 Cin Cout 15 T a record: 72.5
GFLOP for the ECGCNN's four blocks at B=64, T=5000: 0.44 ms as 3xTF32, 1.08
ms at FP32 FMA).

A CPU tensor takes the plain version (``conv_wgrad_plain``); a CUDA tensor
launches the kernel or raises.  ``launches`` counts the kernel's weight
gradients (each is two launches: the product and the slices' sum).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ptbxl_torch.ops.kernels import _build
from ptbxl_torch.ops.kernels.probes import tf32_round

launches = 0

LIB = _build.Library("conv_wgrad", {
    # x, dy, ws, dw, B, T, Cin, Cout, slices
    "ptbxl_conv_wgrad": [_build.VOIDP] * 4 + [_build.INT] * 5,
})
K, PAD = 15, 7
BK = 64  # reduction columns (t') a K-tile
HALO = 12  # the reduction runs over t' in [0, T + 12): dy shifted by 4j - 12, j < 4
CI_TILE, CO_TILE = 16, 32  # a CTA's input and output channels
TILE_SUMS = 4 * CI_TILE * 4 * CO_TILE  # its m64 x n128 sums
SLOTS = 264  # CTAs of one wave on the H100: two on each of its 132 SMs
STAGE_STEPS = 8  # the kernel's k8 steps a stage: its tensor-core sums restart every 64 columns


def plan(b: int, t: int, cin: int, cout: int) -> Tuple[int, int]:
    """(slices of the reduction, workspace floats) for one weight gradient:
    about ``SLOTS`` CTAs, each an m64 x n128 tile over ``B * ceil((T + 12) /
    64) / slices`` K-tiles.  A function of the shape alone, so every card
    cuts the sums the same way."""
    tiles = -(-cin // CI_TILE) * (cout // CO_TILE)
    slices = max(1, min(SLOTS // tiles, b * -(-(t + HALO) // BK)))
    return slices, slices * tiles * TILE_SUMS


def conv_wgrad_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW in f32: every shifted window of the zero-padded ``x`` against ``dy``."""
    cols = F.pad(x.float(), (PAD, PAD)).unfold(2, K, 1)  # [B, Cin, T, 15]
    return torch.einsum("bot,bitk->oik", dy.float(), cols)


def conv_wgrad_tf32x3_plain(x: torch.Tensor, dy: torch.Tensor,
                            stage_cols: int = 8 * STAGE_STEPS) -> torch.Tensor:
    """dW as the kernel sums it, for one record's reduction at a time: both
    operands split (``big = tf32(a)``, ``small = tf32(a - big)``), each
    product ``small*big + big*small + big*big`` (each term exact in f32),
    summed over stages of ``stage_cols`` reduction columns (t' in [0, T + 12),
    dy at t' - 12 + 4j), the stage sums added up in f32."""
    bsz, cin, t = x.shape
    cout = dy.shape[1]
    kt = -(-(t + HALO) // BK) * BK

    def split(v):
        big = tf32_round(v)
        return big, tf32_round(v - big)

    acc = torch.zeros(4 * cin, 4 * cout)
    for rec in range(bsz):  # one record's operands at a time
        # rows (ci, r): x[t' + r - 7]; columns (j, co): dy[t' - 12 + 4j]; tap = 12 - 4j + r
        xp = F.pad(x[rec].float(), (PAD, kt - t))
        dp = F.pad(dy[rec].float(), (HALO, kt - t))
        ab, as_ = split(torch.stack([xp[:, r:r + kt] for r in range(4)], dim=1)
                        .reshape(4 * cin, kt))
        bb, bs = split(torch.stack([dp[:, 4 * j:4 * j + kt] for j in range(4)])
                       .reshape(4 * cout, kt))
        for c0 in range(0, kt, stage_cols):
            sl = slice(c0, c0 + stage_cols)
            acc = acc + (as_[:, sl] @ bb[:, sl].T + ab[:, sl] @ bs[:, sl].T
                         + ab[:, sl] @ bb[:, sl].T)
    d = acc.view(cin, 4, 4, cout)  # [ci, r, j, co]
    taps = torch.stack([d[:, tap % 4, 3 - tap // 4] for tap in range(K)], dim=-1)
    return taps.permute(1, 0, 2).contiguous()  # [Cout, Cin, 15]


def _check(x: torch.Tensor, dy: torch.Tensor) -> None:
    if x.dim() != 3 or dy.dim() != 3 or x.shape[0] != dy.shape[0] or x.shape[2] != dy.shape[2]:
        raise ValueError(f"expected x [B, Cin, T] and dy [B, Cout, T], got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}")
    if x.dtype != torch.float32 or dy.dtype != torch.float32:
        raise TypeError(f"conv_wgrad takes f32 x and dy, got {x.dtype}, {dy.dtype}")
    if x.device != dy.device:
        raise RuntimeError(f"conv_wgrad needs x and dy on one device, got {x.device}, {dy.device}")
    if x.device.type == "cuda" and (dy.shape[1] % CO_TILE or not x.numel()):
        raise ValueError(f"conv_wgrad kernel needs Cout % {CO_TILE} == 0 and a non-empty x, "
                         f"got x {tuple(x.shape)}, dy {tuple(dy.shape)}")


def conv_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW [Cout, Cin, 15] of the stride-1 SAME k=15 conv (see the module docstring)."""
    global launches
    _check(x, dy)
    if x.device.type == "cpu":
        return conv_wgrad_plain(x, dy)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv_wgrad kernel needs CUDA tensors, got {x.device}")
    x, dy = x.contiguous(), dy.contiguous()
    bsz, cin, t = x.shape
    cout = dy.shape[1]
    slices, ws_len = plan(bsz, t, cin, cout)
    ws = torch.empty(ws_len, dtype=torch.float32, device=x.device)
    dw = torch.empty((cout, cin, K), dtype=torch.float32, device=x.device)
    LIB.launch("ptbxl_conv_wgrad", x, dy, ws, dw, bsz, t, cin, cout, slices)
    launches += 1
    return dw
