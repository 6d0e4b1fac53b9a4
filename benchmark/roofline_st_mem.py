"""The yardstick of the ``st_mem`` configuration: operations and bytes of
ST-MEM's ViT encoder, against ``roofline.PEAK_FLOPS`` / ``PEAK_BYTES``.

Operations come from the shapes, ``2 in out`` a Linear a token: the patch
embedding ``2 leads n patch width`` (n patches a lead), each block
``2 N (3 d^2 + d^2 + 2 d m) + 4 N^2 d`` over its ``N`` tokens (qkv, the
output projection, the MLP, then ``q k^T`` and ``s v``), and the head.  At
the published widths that is 70,707,113,472 a record.  The front end's
resampling and z-score, the LayerNorms, GELU, softmax and residual adds are
not counted: they are a few operations an element.
"""

from __future__ import annotations

from typing import Mapping

from benchmark.roofline import PEAK_BYTES, PEAK_FLOPS


def tokens(cfg: Mapping) -> int:
    """Tokens a record: each lead's patches between two SEP tokens."""
    return cfg["leads"] * (cfg["model_samples"] // cfg["patch"] + 2)


def block_flops(cfg: Mapping) -> float:
    """Operations of one block for one record."""
    n, d, m = tokens(cfg), cfg["width"], cfg["mlp"]
    return 2.0 * n * (3 * d * d + d * d + 2 * d * m) + 4.0 * n * n * d


def forward_flops(cfg: Mapping, rows: float) -> float:
    """Model operations of ``rows`` records."""
    embed = 2.0 * cfg["leads"] * cfg["model_samples"] * cfg["width"]
    head = 2.0 * cfg["width"] * cfg["num_labels"]
    return rows * (embed + cfg["depth"] * block_flops(cfg) + head)


def attention_flops(cfg: Mapping, rows: float) -> float:
    """One block's attention for ``rows`` records: ``q k^T`` and ``s v``."""
    return rows * 4.0 * tokens(cfg) ** 2 * cfg["width"]


def attention_bytes(cfg: Mapping, rows: float, itemsize: int) -> float:
    """One block's attention for ``rows`` records: q, k and v read and the
    output written once, ``itemsize`` bytes an element."""
    return rows * 4.0 * tokens(cfg) * cfg["width"] * itemsize


def attention_bound_s(cfg: Mapping, rows: float, itemsize: int) -> float:
    """The least time the chip could take for one block's attention."""
    return max(attention_flops(cfg, rows) / PEAK_FLOPS,
               attention_bytes(cfg, rows, itemsize) / PEAK_BYTES)
