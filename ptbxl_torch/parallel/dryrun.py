"""Sharded training step against the unsharded one (counterpart of
``__graft_entry__.py::dryrun_multichip``).

    python -m ptbxl_torch.parallel.dryrun 4 [--t 5000] [--device cpu] [--backend gloo|nccl]

``dryrun_multichip(n)`` spawns ``n`` ranks (``run_ranks``) on a
``(n_data, n_model)`` mesh, ``n_model = 2`` when ``n >= 4`` and even, and
runs one full training step of the FiLM multimodal model on a seeded
``[4 n_data, T, 12]`` batch with one masked row: the per-lead z-score, the
train-mode forward with global-batch BatchNorm, the masked BCE, the
backward through K6 and the optimizer.  The same step runs unsharded in the
calling process on the same weights and batch, and the two must agree as
JAX gates them: the loss to 1e-5 relative, the BatchNorm running stats to
1e-5 and the parameters after one SGD step (lr 1e-3, linear in the
gradient) to 1e-5.

``run_ranks(fn, n, args)`` is the launcher the tests and ``chip_smoke.py``
share: ``n`` processes by ``torch.multiprocessing.spawn``, a process group on
``tcp://127.0.0.1:<free port>``, ``fn(*args)`` on every rank, rank 0's
result returned; a rank's exception is raised here, and past ``timeout``
seconds every rank is killed.
"""

from __future__ import annotations

import argparse
import os
import socket
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ptbxl_torch.models.factory import build_multimodal
from ptbxl_torch.ops.kernels import relu_pool as k6
from ptbxl_torch.parallel.mesh import make_mesh, shard_model
from ptbxl_torch.parallel.multihost import maybe_initialize_distributed
from ptbxl_torch.training.loop import make_train_step
from ptbxl_torch.training.train_state import TrainState, create_train_state
from ptbxl_torch.utils.device import DeviceLike, resolve_device

LR, WD = 1e-3, 1e-4
GATE = 1e-5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int, backend: Optional[str], device,
               threads: Optional[int],
               fn: Callable, args: Sequence, out: str) -> None:
    if threads:
        torch.set_num_threads(threads)
    maybe_initialize_distributed(f"tcp://127.0.0.1:{port}", n, rank, backend, device)
    try:
        result = fn(*args)
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, n: int, args: Sequence = (), backend: Optional[str] = None,
              device: DeviceLike = None, timeout: float = 600.0,
              threads: Optional[int] = None) -> Any:
    """``fn(*args)`` on ``n`` spawned ranks of one process group; rank 0's result.
    ``fn`` must be importable by name (the ranks are fresh interpreters).  The
    ranks run on ``device`` (``cuda`` by default, ``"cpu"`` on the host) over
    ``backend`` (default: ``nccl`` on ``cuda``, ``gloo`` on the CPU)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        ctx = mp.spawn(_rank_main, args=(n, free_port(), backend, device, threads, fn,
                                         tuple(args), out), nprocs=n, join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{n} ranks of {fn.__name__} ran past {timeout} s")
        return torch.load(out, weights_only=False)


def make_batch(bs: int, t: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """The dry run's batch: seeded signals, demographics and labels, the last row masked."""
    rng = np.random.default_rng(seed)
    mask = np.ones((bs,), np.float32)
    mask[-1] = 0.0
    return {
        "ecg": rng.standard_normal((bs, t, 12)).astype(np.float32),
        "demo": rng.uniform(size=(bs, 5)).astype(np.float32),
        "y": (rng.uniform(size=(bs, 5)) > 0.7).astype(np.float32),
        "mask": mask,
    }


def bn_stats(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in state.items() if "running_" in k}


def params(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in state.items() if "running_" not in k and "num_batches" not in k}


def max_diff(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def one_step(state_dict: Dict[str, torch.Tensor], batch: Dict[str, np.ndarray],
             optimizer: str, n_model: Optional[int], device: DeviceLike = None
             ) -> Dict[str, Any]:
    """One multimodal train step from ``state_dict`` on the global ``batch``:
    sharded over a mesh of every rank with ``n_model`` model ranks, or unsharded
    for ``n_model`` None.  ``optimizer`` is ``"adamw"`` (lr 1e-3, wd 1e-4) or
    ``"sgd"`` (lr 1e-3).  Returns the loss, the full state after the step (on
    the host) and this process's K6 launches."""
    dev = resolve_device(device)
    model = build_multimodal(num_labels=5, seed=0, device=dev)
    model.load_state_dict(state_dict)
    mesh = None
    if n_model is not None:
        mesh = make_mesh(n_model=n_model)
        shard_model(model, mesh)
    if optimizer == "sgd":
        state = TrainState(model, torch.optim.SGD(model.parameters(), lr=LR))
    else:
        state = create_train_state(model, LR, WD)
    k6.launches = 0
    _, loss = make_train_step(multimodal=True, mesh=mesh)(state, batch)
    loss = float(loss)
    return {"loss": loss, "launches": k6.launches,
            "state": {k: v.detach().cpu() for k, v in model.state_dict().items()}}


def _dryrun_rank(state_dict, batch, n_model, device) -> Dict[str, Any]:
    adamw = one_step(state_dict, batch, "adamw", n_model, device)
    sgd = one_step(state_dict, batch, "sgd", n_model, device)
    return {"loss": adamw["loss"], "bn": bn_stats(adamw["state"]),
            "params": params(sgd["state"]), "launches": adamw["launches"] + sgd["launches"]}


def dryrun_multichip(n: int, t: int = 5000, backend: Optional[str] = None,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """One DP(+model-axis) training step on ``n`` ranks against the unsharded step;
    raises if a gate fails, prints the JAX dry run's line and returns its numbers.
    The ranks run on ``device`` (``cuda`` by default) over ``backend`` (default
    as ``run_ranks``; ``"gloo"`` puts several ranks on one GPU, which NCCL refuses)."""
    dev = resolve_device(device)
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    n_data = n // n_model
    bs = 4 * n_data
    state_dict = {k: v.cpu() for k, v in build_multimodal(num_labels=5, seed=0,
                                                          device="cpu").state_dict().items()}
    batch = make_batch(bs, t)
    got = run_ranks(_dryrun_rank, n, (state_dict, batch, n_model, dev.type), backend,
                    dev.type, timeout=900.0)
    ref = _dryrun_rank(state_dict, batch, None, dev)
    if not np.isfinite(got["loss"]):
        raise AssertionError(f"non-finite loss {got['loss']}")
    dloss = abs(got["loss"] - ref["loss"]) / max(abs(ref["loss"]), 1e-12)
    if not dloss < GATE:
        raise AssertionError(f"sharded loss {got['loss']} != unsharded {ref['loss']} "
                             f"(rel {dloss:.2e})")
    db = max_diff(got["bn"], ref["bn"])
    if not db < GATE:
        raise AssertionError(f"sharded BN stats diverge from unsharded: max|d|={db:.2e}")
    dp = max_diff(got["params"], ref["params"])
    if not dp < GATE:
        raise AssertionError(
            f"sharded gradients diverge from unsharded (via SGD params): max|d|={dp:.2e}")
    print(f"[dryrun_multichip] mesh=(data={n_data}, model={n_model}) "
          f"batch={bs} T={t} loss={got['loss']:.4f} "
          f"equality-vs-unsharded: dloss={dloss:.2e} dparams={dp:.2e} dbn={db:.2e} OK",
          flush=True)
    return {"n_data": n_data, "n_model": n_model, "batch": bs, "t": t, "loss": got["loss"],
            "dloss": dloss, "dparams": dp, "dbn": db, "rank0_relu_pool_bwd": got["launches"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("--t", type=int, default=5000)
    ap.add_argument("--device", default=None, help="default: cuda; 'cpu' runs on the host")
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (default: nccl on cuda, gloo on the CPU)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.t, args.backend, args.device)


if __name__ == "__main__":
    main()
