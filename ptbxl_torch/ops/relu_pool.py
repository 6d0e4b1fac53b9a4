"""ReLU -> MaxPool1d(2) whose backward is K6 (port of ``ptbxl_tpu/ops/relu_pool.py``).

``relu_max_pool2(h)`` on ``[B, C, T]`` is ``relu(max_pool1d(h, 2))`` with
the floor (relu is monotone, so pooling first is the same function and
skips a full-size relu temp).  Its backward:

* by default, a ``torch.autograd.Function`` that saves only ``h`` (no argmax
  indices) and differentiates with ``ops.kernels.relu_pool.relu_pool_bwd``:
  K6 on the card, its plain version on the CPU.  Ties at a positive value
  split the cotangent evenly.
* inside ``force_framework_pool_bwd()``: autograd through ``F.max_pool1d``,
  which routes a tie to its first element, the semantics of the JAX
  package's default.  It is the reference the kernel path is held against.

The JAX package keeps its Pallas backward off by default because of a TPU
layout cost (lane-padded activations relaid for ``pallas_call``); the
port's activations are already compact, so K6 is on here, and PERF.md
holds both backwards' step times on the H100.  ``force_framework_pool_bwd``
is the counterpart of ``force_xla_pool_bwd``.  As in JAX it governs every
backward through the pool, Grad-CAM's included.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ptbxl_torch.ops.kernels.relu_pool import relu_pool_bwd

_force_framework_depth = 0


class force_framework_pool_bwd:
    """Context manager pinning ``relu_max_pool2`` to the framework backward."""

    def __enter__(self):
        global _force_framework_depth
        _force_framework_depth += 1

    def __exit__(self, *exc):
        global _force_framework_depth
        _force_framework_depth -= 1
        return False


def framework_pool_bwd_forced() -> bool:
    """Whether a ``force_framework_pool_bwd`` scope is open (a captured train
    step holds the backward it was captured with, so it keys on this)."""
    return _force_framework_depth > 0


def _forward(h: torch.Tensor) -> torch.Tensor:
    return F.relu(F.max_pool1d(h, 2))


class _ReluPoolK6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h):
        ctx.save_for_backward(h)
        return _forward(h)

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors
        return relu_pool_bwd(h, g)


def relu_max_pool2(h: torch.Tensor) -> torch.Tensor:
    """relu -> MaxPool1d(2, floor) on ``[B, C, T]`` -> ``[B, C, T // 2]``."""
    if _force_framework_depth:
        return _forward(h)
    return _ReluPoolK6.apply(h)
