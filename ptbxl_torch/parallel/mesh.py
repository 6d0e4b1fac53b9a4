"""The ('data', 'model') mesh over the ranks of the default process group
(port of ``ptbxl_tpu/parallel/mesh.py``).

The JAX package lays one process's chips out as a ``('data', 'model')`` mesh;
GSPMD then turns the gradient reduction into a ``psum`` and BatchNorm's
statistics into global-batch means.  The port runs one process a device, so
the mesh is a layout of ranks: rank ``r`` is data index ``r // n_model`` and
model index ``r % n_model``.  Its data group (the ranks of its model index)
sums gradients and BatchNorm's partial sums; its model group (the ranks of
its data index) gathers the column shards of the wide Linear layers.

* ``Mesh.rows(B)`` is ``batch_sharding``: rows ``[i·B/n_data,
  (i+1)·B/n_data)`` of a global batch on data index ``i``.
* ``param_spec`` keeps ``_param_spec``'s rule (mesh.py:49-59): a 2-D Linear
  weight whose output dim divides by ``n_model`` and is at least 64 is split
  on its output dim.
* ``shard_model`` is ``shard_variables``: it copies rank 0's parameters and
  buffers to every rank, turns each such Linear into a
  ``ColumnParallelLinear`` and hands each ``ConvBlock`` the data group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ptbxl_torch.models.ecg_cnn import ConvBlock
from ptbxl_torch.parallel.collectives import ColumnParallelLinear


@dataclass
class Mesh:
    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: Any  # torch.distributed ProcessGroup
    model_group: Any

    def rows(self, batch_size: int) -> slice:
        if batch_size % self.n_data:
            raise ValueError(f"batch of {batch_size} does not split over {self.n_data} data ranks")
        per = batch_size // self.n_data
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def local(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of every array of a global batch."""
        sl = self.rows(len(batch["mask"]))
        return {k: v[sl] for k, v in batch.items()}

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The data group's row blocks of ``t`` in data order.  Gloo gathers no
        CUDA tensors, so on a gloo group the blocks meet on the host."""
        if self.n_data == 1:
            return t
        src = t.detach()
        if dist.get_backend(self.data_group) == "gloo":
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.n_data)]
        dist.all_gather(parts, src.contiguous(), group=self.data_group)
        return torch.cat(parts)

    def all_reduce_grads(self, model: nn.Module, loss: torch.Tensor) -> torch.Tensor:
        """Sum every gradient over the data group in one flat all-reduce, with
        the loss beside them; returns the summed loss (f32)."""
        params = [p for p in model.parameters() if p.grad is not None]
        flat = torch.cat([p.grad.reshape(-1) for p in params]
                         + [loss.detach().float().reshape(1)])
        dist.all_reduce(flat, group=self.data_group)
        i = 0
        for p in params:
            n = p.grad.numel()
            p.grad.copy_(flat[i:i + n].view_as(p.grad))
            i += n
        return flat[-1]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """A ('data', 'model') mesh over all ranks of the default group.  Every
    rank must call it, in the same order as any other ``new_group``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group "
                           "(parallel/multihost.py::maybe_initialize_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks; "
                         f"the group has {world}, and launched processes cannot be left out")
    grid = np.arange(world).reshape(n_data, n_model)
    data_group = model_group = None
    for j in range(n_model):  # every rank creates every group, in one order
        g = dist.new_group(grid[:, j].tolist())
        if rank % n_model == j:
            data_group = g
    for i in range(n_data):
        g = dist.new_group(grid[i].tolist())
        if rank // n_model == i:
            model_group = g
    return Mesh(n_data, n_model, rank // n_model, rank % n_model, data_group, model_group)


def param_spec(shape, n_model: int) -> Optional[str]:
    """``'model'`` for a weight split on its output dim, else None (replicated)."""
    if n_model <= 1:
        return None
    if len(shape) == 2 and shape[0] % n_model == 0 and shape[0] >= 64:
        return "model"
    return None


@torch.no_grad()
def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Lay ``model`` out on ``mesh`` in place: rank 0's state on every rank,
    the wide Linear layers column-parallel over the model group, train-mode
    BatchNorm synced over the data group.  Build the optimizer after it."""
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t, src=0)
    for parent in list(model.modules()):
        if isinstance(parent, ConvBlock):
            parent.sync_group = mesh.data_group if mesh.n_data > 1 else None
        for name, child in list(parent.named_children()):
            if (type(child) is nn.Linear
                    and param_spec(child.weight.shape, mesh.n_model) == "model"):
                setattr(parent, name, ColumnParallelLinear(
                    child, mesh.model_group, mesh.n_model, mesh.model_index))
    return model
