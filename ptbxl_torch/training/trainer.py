"""Training engine (port of ``ptbxl_tpu/training/trainer.py:38-270``).

    run = TrainRun(model=build_ecgcnn(num_labels=5, seed=0), train_ds=..., val_ds=...,
                   batch_size=64, epochs=30, lr=1.5e-3, weight_decay=1e-4, seed=42,
                   run_name="ecg_baseline", metrics_csv="logs/metrics.csv",
                   ckpt_path="ckpts/ecg_baseline_best.npz", config_path="cfg.yaml",
                   classes=["MI", "STTC", "HYP", "CD", "NORM"])
    state = train(run)

A dataset is a PTB-XL dataset (``data/datasets.py``: read through the int16
ADC cache, converted on the device) or any object with ``y`` [N, L],
``__len__``, ``get_raw(idx)`` -> [leads, T] and, for the multimodal task,
``demo`` [N, 5] (``data/pipeline.py``).  Per epoch: a train epoch, a val epoch, one CSV row
(the reference's 10 columns), the best checkpoint by val ``auprc_macro``
(reference scripts/03:164-168) as the native ``.npz``, a reference ``.pth``
and a ``.meta.json`` sidecar with the AUPRC, optional early stopping
(scripts/04:212-216), and a resume point: ``torch.save`` of the model,
optimizer, scheduler, step, epoch, best AUPRC and epochs without
improvement, written to a temp file and ``os.replace``d.

Across ranks (``parallel/multihost.py``, e.g. under ``torchrun``) the data
width is ``mesh_for_batch``'s: the largest rank count that divides the batch
(trainer.py:38-46).  JAX can leave chips idle; launched processes cannot be
dropped, so a width below the world size raises.  Every rank reads the same
global batches (one seed) and takes its rows; only rank 0 writes the CSV,
the best checkpoint, its sidecar and the resume point, and the others wait
at a barrier.

Opt-in switches (trainer.py:132-134, 166-177, 230-234):
``PTBXL_TORCH_TB=<dir>`` writes ``train/bce`` and ``val/<metric>`` every
epoch through a ``SummaryWriter`` under ``<dir>/<run_name>`` (a ``[WARN]``
line when TensorBoard is not installed); ``PTBXL_TORCH_CHECK_NUMERICS=1``
raises ``FloatingPointError`` on the first non-finite loss or gradient,
before its update; ``PTBXL_TORCH_PERF=1`` prints each epoch's step timer
(``training/loop.py``: the epoch's records over the time from its first step
to its last loss read; it waits for the card once an epoch, not each step).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ptbxl_torch.data.pipeline import BatchSource, device_prefetch
from ptbxl_torch.models.params_io import export_pth, save_npz, to_flax_variables
from ptbxl_torch.parallel.mesh import Mesh, make_mesh, shard_model
from ptbxl_torch.training.loop import (
    eval_one_epoch,
    make_eval_step,
    make_train_step,
    train_one_epoch,
)
from ptbxl_torch.training.train_state import TrainState, create_train_state, large_batch_lr
from ptbxl_torch.utils.csv_log import log_epoch_to_csv


def data_width(batch_size: int, world_size: int) -> int:
    """The largest rank count, at most ``world_size``, that divides ``batch_size``."""
    for d in range(min(world_size, batch_size), 0, -1):
        if batch_size % d == 0:
            return d
    return 1


def report_data_width(batch_size: int) -> int:
    """Print and return the data width ``train`` takes for ``batch_size``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_data = data_width(batch_size, world)
    print(f"[INFO] Data-parallel width: {n_data} (world size {world})")
    return n_data


def mesh_for_batch(batch_size: int) -> Optional[Mesh]:
    """A data mesh over every rank of the process group, or None without one."""
    if not dist.is_initialized():
        return None
    world = dist.get_world_size()
    n_data = data_width(batch_size, world)
    if n_data < world:
        raise ValueError(
            f"batch_size {batch_size} splits over at most {n_data} of the {world} ranks; "
            f"launched processes cannot be left idle, so use a batch size divisible by {world}")
    return make_mesh(n_data=n_data, n_model=1)


def _tb_writer(run: "TrainRun"):
    root = os.environ.get("PTBXL_TORCH_TB")
    if not root:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(os.path.join(root, run.run_name))
    except Exception as e:  # tensorboard not installed: an optional logger
        print(f"[WARN] TensorBoard requested but unavailable: {e}")
        return None


@dataclass
class TrainRun:
    """Everything task-specific the engine needs; ``model`` holds the initial weights."""

    model: torch.nn.Module
    train_ds: object
    val_ds: object
    batch_size: int
    epochs: int
    lr: float
    weight_decay: float
    seed: int
    run_name: str
    metrics_csv: str
    ckpt_path: str  # native .npz best checkpoint
    config_path: str
    classes: Optional[List[str]] = None  # saved into the checkpoints when not None
    multimodal: bool = False
    loss_mode: str = "per_sample"  # 'per_batch' for the multimodal task
    normalize: str = "per_lead"
    early_stop_patience: Optional[int] = None
    arch: str = "ecgcnn"  # 'multimodal' for the FiLM model
    train_print: str = "Train BCE"
    val_print: str = "Val metrics"
    best_print: Callable[[float, str], str] = field(
        default=lambda best, path: f"★ New best AUPRC: {best:.4f}"
    )
    resume: bool = False
    pth_export: bool = True
    # large-batch recipe (the reference has no schedule): lr_scaling='linear'
    # applies lr * batch_size / ref_batch_size, warmup_steps ramps it from 0
    warmup_steps: int = 0
    lr_scaling: str = "none"  # 'none' | 'linear'
    ref_batch_size: int = 64
    progress: Optional[Callable[[int, float, Dict[str, float]], None]] = None
    train_desc: Optional[str] = "Train"  # tqdm labels (reference loop.py:22,53); None: no bar
    eval_desc: Optional[str] = "Eval"


def _best_meta_path(ckpt_path: str) -> str:
    return ckpt_path + ".meta.json"


def _resume_path(run: TrainRun) -> str:
    """The resume point beside the best checkpoint: ``<ckpt dir>/<run_name>_resume.pt``."""
    return os.path.join(os.path.dirname(run.ckpt_path), f"{run.run_name}_resume.pt")


def _export_best(run: TrainRun, state: TrainState, val_auprc: float) -> None:
    sd = state.model.state_dict()
    save_npz(run.ckpt_path, to_flax_variables(sd, run.arch), classes=run.classes)
    # the sidecar records the AUPRC, so a crash between this export and the
    # resume save cannot let a later, worse epoch overwrite this checkpoint
    try:
        tmp = _best_meta_path(run.ckpt_path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"val_auprc": float(val_auprc)}, f)
        os.replace(tmp, _best_meta_path(run.ckpt_path))
    except OSError as e:
        print(f"[WARN] could not write best-ckpt sidecar: {e}")
    if run.pth_export:
        try:
            export_pth(os.path.splitext(run.ckpt_path)[0] + ".pth", sd, classes=run.classes)
        except Exception as e:  # a convenience export must not end a training run
            print(f"[WARN] .pth export failed ({e}); native .npz saved")


def _save_resume(path: str, state: TrainState, epoch: int, best_auprc: float,
                 epochs_no_improve: int) -> None:
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict() if state.scheduler is not None else None,
        "step": state.step,
        "epoch": epoch,
        "best_auprc": best_auprc,
        "epochs_no_improve": epochs_no_improve,
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def train(run: TrainRun) -> TrainState:
    """Run the training loop; returns the final TrainState."""
    lr = run.lr
    if run.lr_scaling == "linear":
        lr = large_batch_lr(run.lr, run.batch_size, run.ref_batch_size)
        print(f"[INFO] Large-batch LR scaling: lr {run.lr:g} -> {lr:g} "
              f"(batch {run.batch_size} vs ref {run.ref_batch_size}, "
              f"warmup {run.warmup_steps} steps)")
    elif run.lr_scaling != "none":
        raise ValueError(f"unknown lr_scaling {run.lr_scaling!r} (none|linear)")
    check_numerics = os.environ.get("PTBXL_TORCH_CHECK_NUMERICS", "") not in ("", "0")
    mesh = mesh_for_batch(run.batch_size)
    writer = mesh is None or dist.get_rank() == 0  # the rank that writes files
    if mesh is not None:
        shard_model(run.model, mesh)
    device = next(run.model.parameters()).device
    state = create_train_state(run.model, lr, run.weight_decay, run.warmup_steps)
    train_step = make_train_step(run.multimodal, run.normalize, mesh, check_numerics)
    eval_step = make_eval_step(run.multimodal, run.normalize, mesh)
    # emit_adc ships int16 ADC and converts on the device (half the H2D
    # bytes), as the JAX trainer does; a dataset without the ADC cache (no
    # base_dir/df, e.g. an in-memory one) takes per-record reads and f32
    train_src = BatchSource(run.train_ds, run.batch_size, shuffle=True, seed=run.seed,
                            emit_adc=True)
    val_src = BatchSource(run.val_ds, run.batch_size, shuffle=False, seed=run.seed,
                          emit_adc=True)

    tb = _tb_writer(run) if writer else None

    start_epoch = 0
    best_auprc = -1.0
    epochs_no_improve = 0
    resume = _resume_path(run)
    if run.resume and os.path.exists(resume):
        ck = torch.load(resume, map_location=device, weights_only=True)
        state.model.load_state_dict(ck["model"])
        state.optimizer.load_state_dict(ck["optimizer"])
        if state.scheduler is not None and ck["scheduler"] is not None:
            state.scheduler.load_state_dict(ck["scheduler"])
        state.step = int(ck["step"])
        start_epoch = int(ck["epoch"])
        best_auprc = float(ck["best_auprc"])
        epochs_no_improve = int(ck["epochs_no_improve"])
        # the best checkpoint's sidecar is ahead after a crash between the
        # best export and the resume save (trainer.py:198-206)
        try:
            with open(_best_meta_path(run.ckpt_path)) as f:
                best_auprc = max(best_auprc, float(json.load(f)["val_auprc"]))
        except (OSError, ValueError, KeyError):
            pass
        print(f"[INFO] Resumed from {resume} at epoch {start_epoch} "
              f"(best AUPRC {best_auprc:.4f})")

    for epoch in range(start_epoch, run.epochs):
        print(f"\nEpoch {epoch + 1}/{run.epochs}")
        batches = device_prefetch(train_src.epoch(epoch), device)
        state, train_loss = train_one_epoch(state, train_step, batches, run.loss_mode,
                                            desc=run.train_desc)
        print(f"{run.train_print}: {train_loss:.4f}")

        val_batches = device_prefetch(val_src.epoch(0), device)
        val_metrics = eval_one_epoch(state, eval_step, val_batches, 0.5, run.loss_mode,
                                     desc=run.eval_desc)
        print(f"{run.val_print}:", val_metrics)

        if writer:
            log_epoch_to_csv(run.metrics_csv, run.run_name, epoch + 1, train_loss, val_metrics,
                             run.ckpt_path, run.config_path)
        if run.progress is not None:
            run.progress(epoch + 1, train_loss, val_metrics)
        if tb is not None:
            tb.add_scalar("train/bce", train_loss, epoch + 1)
            for k, v in val_metrics.items():
                tb.add_scalar(f"val/{k}", float(v), epoch + 1)
            tb.flush()

        auprc = float(val_metrics.get("auprc_macro", -1))
        improved = auprc > best_auprc
        if improved:
            best_auprc = auprc
            epochs_no_improve = 0
            if writer:
                _export_best(run, state, auprc)
            print(run.best_print(best_auprc, run.ckpt_path))
        else:
            epochs_no_improve += 1

        # the resume point, every epoch (the early-stop epoch included)
        if writer:
            os.makedirs(os.path.dirname(resume) or ".", exist_ok=True)
            _save_resume(resume, state, epoch + 1, best_auprc, epochs_no_improve)
        if mesh is not None:
            dist.barrier()

        if (not improved and run.early_stop_patience is not None
                and epochs_no_improve >= run.early_stop_patience):
            print("[INFO] Early stopping.")
            break
    if tb is not None:
        tb.close()
    return state
