"""The plain reference of the ``ecgfounder`` configuration, in float32 PyTorch.

ECGFounder's Net1D (Li et al., NEJM AI 2025, arXiv:2410.04133;
https://github.com/PKUDigitalHealth/ECGFounder, ``net1d.py``) at the kwargs
its fine-tuning builds, written from the configuration file
(``benchmark/configs/ecgfounder.json``) on ``[B, C, T]``:

1. front end: raw ``x [B, T, 12]``, the per-lead z-score
   ``(c - mean) / (std + zscore_eps)`` with the population std over T;
2. SAME conv (kernel ``k``, stride ``s``, length ``T``): ``T_out = ceil(T / s)``,
   ``p = max(0, (T_out - 1) s + k - T)``, zeros ``F.pad``-ed ``p // 2`` on the
   left and ``p - p // 2`` on the right, then ``F.conv1d`` with its groups;
3. stem: SAME conv ``leads -> base_filters`` (k, stride 2), Swish
   ``x sigmoid(x)``;
4. each stage ``i``: ``m_blocks_list[i]`` blocks of ``filter_list[i]``
   channels, the first at ``stride``.  A block on ``x``: ``out = x``, Swish
   unless it is the model's first block; the 1x1 SAME conv ``conv1``; Swish;
   the SAME k conv ``conv2`` at the block's stride in ``C / groups_width``
   groups; Swish; the 1x1 SAME conv ``conv3``; the gate
   ``g = sigmoid(W_2 swish(W_1 mean_T(out) + b_1) + b_2)`` and ``out * g``;
   the shortcut: ``x``, in a strided block zero-padded 0 | 1 (``stride - 1``
   zeros, ``(stride - 1) // 2`` on the left) and max-pooled by ``stride``
   (floor), and where ``C_in != C`` given ``(C - C_in) // 2`` zero channels
   before and the rest after; ``out + shortcut``;
5. head: the mean over T, the Linear ``filter_list[-1] -> num_labels``;
   probabilities by the sigmoid.

Departures from Net1D, and what could not be checked here: the front end is a
deployment's z-score (``Predictor``'s, as for the CNNs), not ECGFounder's own
filtering and scaling; Net1D as recalled and not checked against the
published file: the pre-activation order, the gate's reduction of 2 with
biases and Swish, the max-pool's zero padding, the channel split of the
shortcut; ``use_bn=False`` and ``use_do=False`` as the fine-tuning kwargs
were recalled, so no BatchNorm and no dropout.  The key names are the port's
(the released checkpoint is not in the repository; the benchmark draws the
weights from ``--seed``).

It takes a state dict of plain tensors and nothing that the program made.
``precision`` is as in ``reference/ecg.py``: ``"f32"`` (TF32 off, the
reference itself), or a control: ``"tf32"`` (TF32 allowed) or ``"fp8"``
(every conv's and Linear's operands rounded to float8 e4m3 with a per-tensor
scale, products summed in f32; below the bfloat16 that the cell runs).
"""

from __future__ import annotations

from typing import List, Mapping, Tuple

import torch
import torch.nn.functional as F

from .ecg import arithmetic, fp8, zscore

STEM_STRIDE = 2
SE_REDUCTION = 2


def param_shapes(cfg: Mapping) -> List[Tuple[str, List[int]]]:
    """Every leaf's key and shape, in the configuration's order."""
    k, gw = cfg["kernel_size"], cfg["groups_width"]
    out = [("stem.weight", [cfg["base_filters"], cfg["leads"], k]),
           ("stem.bias", [cfg["base_filters"]])]
    cin = cfg["base_filters"]
    for i, (c, m) in enumerate(zip(cfg["filter_list"], cfg["m_blocks_list"])):
        for j in range(m):
            b = f"stages.{i}.blocks.{j}."
            out += [(b + "conv1.weight", [c, cin if j == 0 else c, 1]), (b + "conv1.bias", [c]),
                    (b + "conv2.weight", [c, gw, k]), (b + "conv2.bias", [c]),
                    (b + "conv3.weight", [c, c, 1]), (b + "conv3.bias", [c]),
                    (b + "se_fc1.weight", [c // SE_REDUCTION, c]),
                    (b + "se_fc1.bias", [c // SE_REDUCTION]),
                    (b + "se_fc2.weight", [c, c // SE_REDUCTION]), (b + "se_fc2.bias", [c])]
        cin = c
    return out + [("head.weight", [cfg["num_labels"], cin]), ("head.bias", [cfg["num_labels"]])]


def _ops(precision: str, *ts):
    return [fp8(t) for t in ts] if precision == "fp8" else list(ts)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def pads(length: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(left, right) zeros of a SAME conv."""
    out = (length + stride - 1) // stride
    p = max(0, (out - 1) * stride + kernel - length)
    return p // 2, p - p // 2


def conv(p, name: str, x: torch.Tensor, stride: int, groups: int, precision: str
         ) -> torch.Tensor:
    """SAME conv of ``x [B, C_in, T]``."""
    w = p[name + ".weight"]
    x = F.pad(x, pads(x.shape[2], w.shape[2], stride))
    x, w = _ops(precision, x, w)
    return F.conv1d(x, w, p[name + ".bias"], stride=stride, groups=groups)


def linear(p, name: str, x: torch.Tensor, precision: str) -> torch.Tensor:
    return F.linear(*_ops(precision, x, p[name + ".weight"]), p[name + ".bias"])


def block(p, name: str, x: torch.Tensor, cfg: Mapping, stride: int, first: bool,
          precision: str) -> torch.Tensor:
    c = p[name + ".conv3.weight"].shape[0]
    out = x if first else swish(x)
    out = conv(p, name + ".conv1", out, 1, 1, precision)
    out = conv(p, name + ".conv2", swish(out), stride, c // cfg["groups_width"], precision)
    out = conv(p, name + ".conv3", swish(out), 1, 1, precision)
    se = linear(p, name + ".se_fc1", out.mean(dim=2), precision)
    g = torch.sigmoid(linear(p, name + ".se_fc2", swish(se), precision))
    out = out * g[:, :, None]
    short = x
    if stride > 1:
        short = F.max_pool1d(F.pad(short, ((stride - 1) // 2, stride // 2)), stride)
    extra = c - x.shape[1]
    if extra:
        short = F.pad(short.transpose(1, 2), (extra // 2, extra - extra // 2)).transpose(1, 2)
    return out + short


def logits(p: Mapping[str, torch.Tensor], cfg: Mapping, x: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """Raw ``[B, T, 12]`` -> logits ``[B, num_labels]``."""
    h = zscore(x.float(), cfg["zscore_eps"]).transpose(1, 2)
    h = swish(conv(p, "stem", h, STEM_STRIDE, 1, precision))
    for i, m in enumerate(cfg["m_blocks_list"]):
        for j in range(m):
            h = block(p, f"stages.{i}.blocks.{j}", h, cfg, cfg["stride"] if j == 0 else 1,
                      i == 0 and j == 0, precision)
    return linear(p, "head", h.mean(dim=2), precision)


@torch.no_grad()
def probs(p: Mapping[str, torch.Tensor], cfg: Mapping, x, block_rows: int = 256,
          precision: str = "f32", device=None) -> torch.Tensor:
    """Probabilities of host or device rows, in blocks of ``block_rows``."""
    device = device or next(iter(p.values())).device
    out = []
    with arithmetic(precision):
        for i in range(0, len(x), block_rows):
            xb = torch.as_tensor(x[i:i + block_rows], device=device)
            out.append(torch.sigmoid(logits(p, cfg, xb, precision)).cpu())
    return torch.cat(out)
