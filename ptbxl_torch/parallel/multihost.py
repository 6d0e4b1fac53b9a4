"""Process-group bootstrap (port of ``ptbxl_tpu/parallel/multihost.py``).

The JAX package runs one process over all local chips and needs
``jax.distributed.initialize`` only across hosts.  PyTorch on GPUs runs one
process a device, so the port needs a process group whenever it trains on
more than one GPU; this module forms it from the launcher's environment and
is a no-op without one:

    from ptbxl_torch.parallel.multihost import maybe_initialize_distributed
    maybe_initialize_distributed()   # before building the trainer

    torchrun --nproc_per_node=N -m ptbxl_torch.cli.train_ecg_baseline --config ...

After it, ``trainer.mesh_for_batch`` builds the data mesh over the group's
ranks.  Every rank builds the same model from the same seed and reads the
same global batches; the mesh gives each rank its rows.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ptbxl_torch.utils.device import DeviceLike, resolve_device

_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def maybe_initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device: DeviceLike = None,
) -> bool:
    """Initialize ``torch.distributed`` when a cluster is described; else no-op.

    Recognizes explicit arguments (``init_method`` such as
    ``tcp://localhost:29500``, ``world_size``, ``rank``), torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``, or, with
    ``PTBXL_TORCH_DISTRIBUTED=1`` (``true`` / ``yes``; nothing else), an
    ``env://`` group whose variables the launcher sets.  Absent all of
    these it returns False and the job stays one process.

    The backend is ``nccl`` for ``device`` ``cuda`` (the default; without a
    GPU that raises) and ``gloo`` for ``device="cpu"``, unless ``backend``
    names one.  On ``cuda`` each rank takes GPU ``LOCAL_RANK`` (else its rank
    modulo the GPU count) as its current device.  Returns True once
    initialized.
    """
    explicit = init_method is not None or world_size is not None
    from_env = all(os.environ.get(v) for v in _TORCHRUN_VARS)
    opted_in = os.environ.get("PTBXL_TORCH_DISTRIBUTED", "").strip().lower() in (
        "1", "true", "yes")
    if not (explicit or from_env or opted_in):
        return False  # one process; nothing to do
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local else (rank or 0) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank)
    return True
