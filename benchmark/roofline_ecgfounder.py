"""The yardstick of the ``ecgfounder`` configuration: operations and bytes of
ECGFounder's Net1D, against ``roofline.PEAK_FLOPS`` / ``PEAK_BYTES``.

Operations come from the shapes: a conv ``2 C_out (C_in / groups) k T_out``
(the stem, each block's two 1x1 convs and its grouped k conv), a Linear
``2 in out`` (each gate's two, the head).  At the published widths that is
2,337,282,560 a record: 1,750,187,520 (74.9%) in the 1x1 convs,
506,429,440 (21.7%) in the grouped convs, 61,440,000 in the stem, 18,918,400
in the gates and 307,200 in the head.  Swish, the gates' means and scales, the shortcuts and the
residual adds are not counted: a few operations an element.

Bytes count what a chunk must move at least: the stem's input and output and
each block's input and output once, ``itemsize`` bytes an element (2 in
bf16), and the f32 parameters once.  At bf16 that is 4,675,520 bytes a record
beside 123 MB a chunk, so a chunk of 512 is bound by its operations (1.210 ms
against 0.751 ms).
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

from benchmark.roofline import PEAK_BYTES, PEAK_FLOPS, param_count

STEM_STRIDE = 2


def convs(cfg: Mapping) -> Iterator[Tuple[str, int, int, int, int, int]]:
    """Each conv of one record: (kind, C_in, C_out, groups, k, T_out)."""
    k, t = cfg["kernel_size"], cfg["input_length"]
    t_out = -(-t // STEM_STRIDE)
    yield "stem", cfg["leads"], cfg["base_filters"], 1, k, t_out
    cin, t = cfg["base_filters"], t_out
    for c, m in zip(cfg["filter_list"], cfg["m_blocks_list"]):
        for j in range(m):
            t_out = -(-t // cfg["stride"]) if j == 0 else t
            yield "conv1x1", cin if j == 0 else c, c, 1, 1, t
            yield "grouped", c, c, c // cfg["groups_width"], k, t_out
            yield "conv1x1", c, c, 1, 1, t_out
            t = t_out
        cin = c


def flops_by_kind(cfg: Mapping) -> Dict[str, float]:
    """Operations of one record by kind of layer."""
    out = {"stem": 0.0, "conv1x1": 0.0, "grouped": 0.0, "gate": 0.0, "head": 0.0}
    for kind, cin, cout, groups, k, t_out in convs(cfg):
        out[kind] += 2.0 * cout * (cin // groups) * k * t_out
    r = cfg["se_reduction"]
    for c, m in zip(cfg["filter_list"], cfg["m_blocks_list"]):
        out["gate"] += m * 2.0 * (2 * c * (c // r))
    out["head"] = 2.0 * cfg["filter_list"][-1] * cfg["num_labels"]
    return out


def forward_flops(cfg: Mapping, rows: float) -> float:
    """Model operations of ``rows`` records."""
    return rows * sum(flops_by_kind(cfg).values())


def activation_elements(cfg: Mapping) -> int:
    """Elements of one record read or written once: the stem's input and
    output, each block's input and output."""
    t = cfg["input_length"]
    t_stem = -(-t // STEM_STRIDE)
    total = cfg["leads"] * t + cfg["base_filters"] * t_stem
    cin, t = cfg["base_filters"], t_stem
    for c, m in zip(cfg["filter_list"], cfg["m_blocks_list"]):
        for j in range(m):
            t_out = -(-t // cfg["stride"]) if j == 0 else t
            total += (cin if j == 0 else c) * t + c * t_out
            t = t_out
        cin = c
    return total


def forward_bytes(cfg: Mapping, rows: float, itemsize: int) -> float:
    """Bytes of one forward of ``rows`` records: activations once at
    ``itemsize``, the f32 parameters once."""
    return rows * activation_elements(cfg) * itemsize + 4.0 * param_count(cfg)


def bound_s(cfg: Mapping, rows: float, itemsize: int) -> float:
    """The least time the chip could take for one forward of ``rows`` records."""
    return max(forward_flops(cfg, rows) / PEAK_FLOPS,
               forward_bytes(cfg, rows, itemsize) / PEAK_BYTES)
