"""Train state and optimizer (port of ``ptbxl_tpu/training/train_state.py``).

The JAX package threads one explicit pytree (params, BatchNorm stats,
optimizer state) through a jitted step; in the port the model holds its
parameters and BatchNorm buffers, and ``TrainState`` bundles it with the
optimizer, the warmup schedule and the step count.  The optimizer is the
reference's AdamW (torch defaults: betas (0.9, 0.999), eps 1e-8, decoupled
weight decay on *all* parameters, BatchNorm affine included; scripts/03:133).
optax's ``p - lr (m^ / (sqrt(v^) + eps) + wd p)`` and torch's
``p (1 - lr wd) - lr m^ / (sqrt(v^) + eps)`` are the same algebra, rounded
differently.  Where every parameter is on a CUDA device the optimizer is
``capturable``: the same algorithm with its step count and bias corrections
in device tensors, so ``training/loop.py`` can capture its step in a CUDA
graph; elsewhere it is torch's default.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optional[torch.optim.Optimizer] = None
    scheduler: Optional[LambdaLR] = None
    step: int = 0


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float, weight_decay: float,
                   warmup_steps: int = 0) -> Tuple[torch.optim.AdamW, Optional[LambdaLR]]:
    """AdamW with torch's defaults, plus an optional linear warmup.

    ``warmup_steps > 0`` gives a ``LambdaLR`` equal to
    ``optax.linear_schedule(0, lr, warmup_steps)``: update ``k`` (from 0) runs
    at ``lr * min(k, warmup_steps) / warmup_steps``, so the first update has
    lr 0; step it once after every optimizer step.  0 keeps the reference's
    constant lr.
    """
    params = list(params)
    capturable = bool(params) and all(p.device.type == "cuda" for p in params)
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay, capturable=capturable)
    if warmup_steps <= 0:
        return opt, None
    return opt, LambdaLR(opt, lambda k: min(k, warmup_steps) / warmup_steps)


def large_batch_lr(base_lr: float, batch_size: int, ref_batch_size: int = 64) -> float:
    """Linear lr scaling for large batches (Goyal et al., 2017):
    ``base_lr * batch_size / ref_batch_size``; the reference trains at batch 64
    with lr 1.5e-3 (configs/ecg_baseline.yaml).  Pair it with a warmup."""
    return base_lr * (batch_size / float(ref_batch_size))


def create_train_state(model: torch.nn.Module, lr: float, weight_decay: float,
                       warmup_steps: int = 0) -> TrainState:
    opt, sched = make_optimizer(model.parameters(), lr, weight_decay, warmup_steps)
    return TrainState(model=model, optimizer=opt, scheduler=sched)
