"""The yardstick: the H100's peaks and the operations and bytes of a call.

Every roofline share and every MFU is counted against the chip's own peaks,
whatever arithmetic form a kernel uses (3xTF32, f32 FMA, bf16): dense bf16
and HBM bandwidth of NVIDIA's H100 SXM data sheet, at the 700 W limit.  A
call's bound is the larger of its operations over ``PEAK_FLOPS`` and its
bytes over ``PEAK_BYTES``; so no share can pass 100% unless the operations or
bytes are counted too high or the time leaves out part of the work.

Operations come from the shapes: a conv block is ``2 Cin Cout K T_out``
(57.6 / 153.6 / 307.2 / 614.4 MFLOP a record at T=5000), a dense layer
``2 in out``.  Bytes count each input read once and each output written
once: the raw records, the parameters, the probabilities.
"""

from __future__ import annotations

from typing import Mapping, Sequence

PEAK_FLOPS = 989e12  # dense bf16, the H100's highest non-sparse rate below fp8
PEAK_BYTES = 3.35e12  # HBM3


def conv_flops(cfg: Mapping) -> list:
    """Operations of each conv block for one record (SAME conv, floor pool)."""
    t, cin, out = cfg["input_length"], cfg["leads"], []
    for c in cfg["channels"]:
        out.append(2.0 * cin * c * cfg["kernel_size"] * t)
        cin, t = c, t // cfg["pool"]
    return out


def dense_flops(cfg: Mapping) -> float:
    """Operations of the dense layers after the mean over time, one record."""
    c, f, n = cfg["channels"][-1], cfg["feat_dim"], cfg["num_labels"]
    total = 2.0 * c * f + 2.0 * f * n
    if cfg["arch"] == "multimodal":
        d, h = cfg["demo_dim"], cfg["demo_hidden_dim"]
        total += 2.0 * d * 64 + 2.0 * 64 * h + 2.0 * h * 2 * f
    return total


def forward_flops(cfg: Mapping, rows: float) -> float:
    return rows * (sum(conv_flops(cfg)) + dense_flops(cfg))


def train_flops(cfg: Mapping, rows: float) -> float:
    """Forward, input gradient and weight gradient of every layer; block 0
    needs no input gradient."""
    conv = conv_flops(cfg)
    return rows * (3 * sum(conv) - conv[0] + 3 * dense_flops(cfg))


def param_count(cfg: Mapping) -> int:
    total = 0
    for _, shape in cfg["params"]:
        n = 1
        for s in shape:
            n *= s
        total += n
    return total


def forward_bytes(cfg: Mapping, rows: float, in_bytes: int = 4) -> float:
    """Raw records (and demographics) read, parameters read once, f32
    probabilities written."""
    per_row = cfg["input_length"] * cfg["leads"] * in_bytes + 4 * cfg["num_labels"]
    if cfg["arch"] == "multimodal":
        per_row += 4 * cfg["demo_dim"]
    return rows * per_row + 4.0 * param_count(cfg)


def forward_bound_s(cfg: Mapping, rows: float) -> float:
    """The least time the chip could take for one forward call of ``rows``."""
    return max(forward_flops(cfg, rows) / PEAK_FLOPS, forward_bytes(cfg, rows) / PEAK_BYTES)


def bound_s(cfg: Mapping, launched_rows: Sequence[float]) -> float:
    """Summed bound of a list of forward calls, one entry a call."""
    return sum(forward_bound_s(cfg, r) for r in launched_rows)
