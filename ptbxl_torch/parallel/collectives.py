"""Differentiable collectives and the column-parallel Linear layer.

* ``all_reduce_sum(x, group)``: the sum over the group's ranks, whose
  backward sums the incoming gradients over the group as well (the global
  BatchNorm statistics: every rank's loss depends on every rank's partial
  sums).  It is ``torch.distributed.nn.functional.all_reduce``, which torch
  2.13 deprecates; the port keeps its own six lines.
* ``copy_in(x, group)`` and ``gather_columns(y, group)``: the two ends of a
  column-parallel layer (Megatron's copy / gather pair).  The input is the
  same on every rank of the model group; each rank's shard sees only part of
  the input's gradient, so ``copy_in`` is the identity whose backward sums
  the group's parts.  ``gather_columns`` concatenates the group's column
  shards on the last dim; what follows it runs replicated on every rank of
  the model group (the same rows, the same parameters), so every rank
  receives the same gradient of the whole output and keeps its own columns.
  The backward of ``torch.distributed.nn.functional.all_gather`` sums the
  group's gradients instead, which would count them ``n_model`` times here.
* ``ColumnParallelLinear``: an ``nn.Linear`` holding rows ``[i·out/n,
  (i+1)·out/n)`` of the weight (and bias) on model index ``i``; it loads the
  full weight and saves the full weight (every rank of the model group calls
  ``state_dict`` together), so checkpoints stay unsharded.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y: torch.Tensor, group) -> torch.Tensor:
        ctx.width = y.shape[-1]
        ctx.index = dist.get_rank(group)
        parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        lo = ctx.index * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyIn.apply(x, group)


def gather_columns(y: torch.Tensor, group) -> torch.Tensor:
    return _GatherColumns.apply(y, group)


class ColumnParallelLinear(nn.Linear):
    """The local output-column shard of ``full`` on model index ``index`` of ``n_model``."""

    def __init__(self, full: nn.Linear, group, n_model: int, index: int):
        if full.out_features % n_model:
            raise ValueError(f"{full.out_features} output features do not split {n_model} ways")
        width = full.out_features // n_model
        super().__init__(full.in_features, width, bias=full.bias is not None,
                         device=full.weight.device, dtype=full.weight.dtype)
        self.group, self.n_model, self.index = group, n_model, index
        self.full_out = full.out_features
        with torch.no_grad():
            self.weight.copy_(self._shard(full.weight))
            if full.bias is not None:
                self.bias.copy_(self._shard(full.bias))

    def _shard(self, t: torch.Tensor) -> torch.Tensor:
        w = self.out_features
        return t[self.index * w:(self.index + 1) * w]

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return copy_in(x, self.group)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        return gather_columns(y, self.group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gather(super().forward(self.copy_in(x)))

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for name, p in self._parameters.items():
            if p is None:
                continue
            parts = [torch.empty_like(p.detach()) for _ in range(self.n_model)]
            dist.all_gather(parts, p.detach().contiguous(), group=self.group)
            destination[prefix + name] = torch.cat(parts)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name in ("weight", "bias"):
            key = prefix + name
            if key in state_dict and state_dict[key].shape[0] == self.full_out:
                state_dict[key] = self._shard(state_dict[key])
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
