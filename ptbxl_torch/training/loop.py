"""Train and eval steps and the epoch loops (port of ``ptbxl_tpu/training/loop.py``).

* ``make_train_step``: the two-pass per-lead z-score (the training path keeps
  that form, loop.py:59), a train-mode forward (batch BatchNorm statistics,
  the running ones updated), per-sample BCE meaned over labels,
  ``sum(loss * mask) / sum(mask)``, backward (through K6 at every pool) and
  an AdamW step.  With ``precision='highest'`` the whole step, backward and
  optimizer included, runs with TF32 off: the backward runs after the
  forward's own scope has closed.  The whole step runs with cuDNN held to
  deterministic algorithms and autotuning off (``deterministic_algorithms``),
  so one seed gives one training bit for bit on the card, as on the CPU
  (tests/test_determinism.py's contract); the flags are restored after.
* ``make_eval_step``: eval-mode forward, f32 logits at the boundary, sigmoid
  and per-sample BCE, under the same deterministic scope (validation picks
  the best epoch).
* the final padded batch is masked out of the loss and the metrics; epoch
  losses aggregate ``per_sample`` (dataset-weighted, reference loop.py:36-38)
  or ``per_batch`` (the multimodal task's unweighted batch mean,
  loop_demo.py:40-43).
* ``train_one_epoch`` reads each step's loss one step late, so the host
  queues the next step before it waits for the card: on a GPU the loss and
  the batch's real-row count go to pinned host memory behind their step,
  and the read waits on an event after those copies (a read of the device
  tensor would wait for the whole stream, the step queued after it too);
  under ``PTBXL_TORCH_PERF=1`` it runs the same loop and times it from the
  first step to the last loss read (one wait for the card an epoch, not one
  a step), then prints ``StepTimer.report("train")`` (loop.py:126-159).
* on a CUDA device the whole step (z-score, forward, loss, ``zero_grad``,
  backward, AdamW's step) is captured once as one CUDA graph and replayed
  after: each replay copies the batch into the graph's static inputs and
  returns a copy of its static loss, so a loss read one step late is still
  its own step's.  The first step of a key (``graph_key``: what the graph
  bakes in, the memory it reads and writes included) runs eager on the side
  stream the capture uses, which sets up cuDNN's plans, K6's library and the
  allocator; the next step of the same key captures the graph and replays
  it once; later steps of that key replay it.  A fresh AdamW makes its state
  on its first step, so its key settles on the second and the third
  captures.  A step of another key runs eager and drops the
  graph (its eager backward moves ``p.grad`` off the graph's tensors), so
  a key that comes back is captured again.  Every step runs eager, as
  before, with a ``mesh`` or with ``check_numerics`` (it reads the card
  mid-step), both fixed when the step is made, and, by ``graph_key``, on a
  CPU model, with a ``scheduler`` (it rewrites ``lr`` after every step,
  which a graph would not see) and with an optimizer that cannot be
  captured (``capturable`` off).  A replay launches K6 and the conv weight
  gradient's kernel from the card, not through their wrappers, so the
  ``launches`` of ``ops/kernels/relu_pool.py`` and ``conv_wgrad.py`` count
  the capture's launches and none of the replays'; the device trace counts
  every launch.
* under a ``torch.profiler`` session each step records its spans
  (``utils/profiling.py``): the root ``train.step`` (``rows``, the batch;
  ``graph``: 1 where the graph ran the step, the capture's step included,
  else 0; ``wgrad``: the step's conv weight gradients that the hand-written
  kernel computes (``ops/conv_wgrad.py``), a replay's those of its capture);
  on an eager step ``train.forward`` (z-score, logits, loss),
  ``train.backward`` and ``train.optimizer`` (``zero_grad``, and AdamW's
  step) inside it; on the capture's step ``train.capture``, which holds
  those three as the capture records them; a replay has no host phases.
  The epoch loop records a ``train.settle`` a loss read.
* ``check_numerics=True`` (the trainer's ``PTBXL_TORCH_CHECK_NUMERICS``)
  raises ``FloatingPointError`` on a non-finite loss or gradient after the
  backward and before the optimizer step, so the bad update is never
  applied: one read of the card a step, only when it is on.
* with a ``mesh`` (``parallel/mesh.py``) each rank takes its rows of the
  global batch; the loss is ``sum(local bce * mask) / all_reduce(sum(mask))``
  and the gradients are summed over the data group, so a padded row counts
  the same wherever it falls; the reported loss is the global one.  The eval
  step gathers probs and per-sample losses over the data group, so every
  rank computes the same metrics.  Without a mesh nothing changes.

A batch is a dict of tensors (``device_prefetch``) or numpy arrays; both are
moved to the model's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ptbxl_torch.models.ecg_cnn import precision_scope
from ptbxl_torch.ops.kernels import conv_wgrad
from ptbxl_torch.ops.preprocess import zscore_per_lead_batch
from ptbxl_torch.ops.relu_pool import framework_pool_bwd_forced
from ptbxl_torch.training.metrics import compute_metrics
from ptbxl_torch.training.train_state import TrainState
from ptbxl_torch.utils.device import deterministic_algorithms
from ptbxl_torch.utils.profiling import StepTimer, perf_enabled, span

Batch = Dict[str, object]


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _on(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def per_sample_bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean-over-labels BCE-with-logits per sample [B], in the logits' dtype
    (optax.sigmoid_binary_cross_entropy meaned over the last axis)."""
    return F.binary_cross_entropy_with_logits(
        logits, y.to(logits.dtype), reduction="none").mean(dim=-1)


def _logits(model: torch.nn.Module, b: Dict[str, torch.Tensor], multimodal: bool,
            normalize: str) -> torch.Tensor:
    x = zscore_per_lead_batch(b["ecg"]) if normalize == "per_lead" else b["ecg"]
    return model(x, b["demo"]) if multimodal else model(x)


def check_finite(model: torch.nn.Module, loss: torch.Tensor, step: int) -> None:
    """Raise ``FloatingPointError`` naming ``step`` and the first parameter whose
    gradient holds a NaN or inf (or the loss, if it does); one read of the card."""
    grads = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
    ok = torch.stack([torch.isfinite(loss).all()] + [torch.isfinite(g).all() for _, g in grads])
    if bool(ok.all()):
        return
    ok = ok.tolist()
    if not ok[0]:
        raise FloatingPointError(f"non-finite loss {float(loss.detach())} at step {step}")
    bad = next(n for (n, _), good in zip(grads, ok[1:]) if not good)
    raise FloatingPointError(f"non-finite gradient of {bad} at step {step}")


def graph_key(state: TrainState, b: Mapping[str, torch.Tensor]) -> Optional[Hashable]:
    """What a captured train step bakes in that can change between two calls
    of one step function, or None where the step runs eager.

    None with a ``scheduler``, without an optimizer, with a parameter off
    CUDA, or with a param group that is not ``capturable``.  Else the key:
    the model and the optimizer (as objects), the model's precision, whether
    the pool backward is forced to the framework's; each parameter (as an
    object) with its memory, ``requires_grad`` and the memory of its
    optimizer state, each buffer's memory; each param group's parameters,
    ``lr``, ``betas``, ``eps`` and ``weight_decay``; the batch's keys,
    shapes, dtypes and devices.  ``b`` is the batch on the device.
    """
    model, opt = state.model, state.optimizer
    if state.scheduler is not None or opt is None:
        return None
    params = tuple(model.parameters())
    if not all(p.device.type == "cuda" for p in params) or \
            not all(g.get("capturable", False) for g in opt.param_groups):
        return None
    return (id(model), id(opt), getattr(model, "precision", None), framework_pool_bwd_forced(),
            tuple((id(p), p.data_ptr(), p.requires_grad,
                   tuple(v.data_ptr() for v in opt.state.get(p, {}).values()
                         if hasattr(v, "data_ptr")))
                  for p in params),
            tuple(v.data_ptr() for v in model.buffers()),
            tuple((tuple(map(id, g["params"])),
                   tuple(g.get(k) for k in ("lr", "betas", "eps", "weight_decay")))
                  for g in opt.param_groups),
            tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in sorted(b.items())))


class _Captured:
    """One train step captured as a CUDA graph: the key it was captured for,
    the static batch it reads and the static loss it writes.  Capture inside
    the step's precision and deterministic scopes."""

    def __init__(self, key: Hashable, body: Callable, state: TrainState,
                 b: Dict[str, torch.Tensor], stream: "torch.cuda.Stream"):
        self.key = key
        self.holds = (state.model, state.optimizer)  # the ids in the key stay theirs
        self.inputs = {k: v.clone() for k, v in b.items()}
        self.graph = torch.cuda.CUDAGraph()
        wgrad = conv_wgrad.launches
        # thread_local: the feed's producer thread pins and copies batches
        # while the capture runs
        with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
            self.loss = body(state, self.inputs)
        self.wgrad = conv_wgrad.launches - wgrad  # the conv weight gradients it holds

    def replay(self, b: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The step on ``b``; a fresh copy of its loss (the next replay
        overwrites the static one)."""
        for k, v in self.inputs.items():
            v.copy_(b[k])
        self.graph.replay()
        return self.loss.clone()


def make_train_step(multimodal: bool = False, normalize: str = "per_lead", mesh=None,
                    check_numerics: bool = False
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, torch.Tensor]]:
    """Build ``step(state, batch) -> (state, loss)``; the state is updated in place.

    The returned loss is a 0-d tensor on the device (reading it waits for the step).
    """
    graphable = mesh is None and not check_numerics
    captured: Optional[_Captured] = None
    warm: Optional[Hashable] = None  # the key of the last eager step
    side: Optional[torch.cuda.Stream] = None  # where a key's eager steps and capture run

    def body(state: TrainState, b: Dict[str, torch.Tensor]) -> torch.Tensor:
        model = state.model
        with span("train.forward"):
            logits = _logits(model, b, multimodal, normalize)
            mask = b["mask"]
            n_real = torch.sum(mask)
            if mesh is not None:
                dist.all_reduce(n_real, group=mesh.data_group)
            loss = torch.sum(per_sample_bce(logits, b["y"]) * mask) / n_real
        with span("train.optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        with span("train.backward"):
            loss.backward()
            if mesh is not None:
                loss = mesh.all_reduce_grads(model, loss)
        if check_numerics:
            check_finite(model, loss, state.step)
        with span("train.optimizer"):
            state.optimizer.step()
        return loss.detach()

    def on_side(state: TrainState, b: Dict[str, torch.Tensor]) -> torch.Tensor:
        cur = torch.cuda.current_stream(b["mask"].device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            loss = body(state, b)
        cur.wait_stream(side)
        return loss

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, torch.Tensor]:
        nonlocal captured, warm, side
        model = state.model
        b = _on(batch if mesh is None else mesh.local(batch), _device_of(model))
        key = graph_key(state, b) if graphable else None
        if captured is not None and captured.key != key:
            captured = None
        graph = key is not None and (captured is not None or key == warm)
        with span("train.step", rows=len(batch["mask"]), graph=int(graph)) as rec:
            model.train()
            if graph and captured is None:
                with span("train.capture"), precision_scope(model.precision), \
                        deterministic_algorithms():
                    captured = _Captured(key, body, state, b, side)
            if graph:
                loss = captured.replay(b)
                wgrad = captured.wgrad
            else:
                warm = key
                wgrad = conv_wgrad.launches
                with precision_scope(model.precision), deterministic_algorithms():
                    if key is None:
                        loss = body(state, b)
                    else:
                        if side is None:
                            side = torch.cuda.Stream(b["mask"].device)
                        loss = on_side(state, b)
                wgrad = conv_wgrad.launches - wgrad
            if rec is not None:
                rec.add(wgrad=wgrad)
            if state.scheduler is not None:
                state.scheduler.step()
            state.step += 1
            return state, loss

    return step


def make_eval_step(multimodal: bool = False, normalize: str = "per_lead", mesh=None
                   ) -> Callable[[TrainState, Batch], Tuple[torch.Tensor, torch.Tensor]]:
    """Build ``step(state, batch) -> (probs [B, L], per-sample loss [B])``, both f32,
    for the whole (global) batch."""

    @torch.no_grad()
    def step(state: TrainState, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        model = state.model
        b = _on(batch if mesh is None else mesh.local(batch), _device_of(model))
        model.eval()
        with precision_scope(model.precision), deterministic_algorithms():
            # f32 at the boundary: the host metrics and CSV read these even
            # when the model computes in bf16
            logits = _logits(model, b, multimodal, normalize).float()
        probs, losses = torch.sigmoid(logits), per_sample_bce(logits, b["y"])
        if mesh is None:
            return probs, losses
        return mesh.gather_rows(probs), mesh.gather_rows(losses)

    return step


def _maybe_tqdm(batches: Iterator[Batch], desc: Optional[str]):
    if desc is None:
        return batches
    try:
        from tqdm import tqdm
    except ImportError:
        return batches
    return tqdm(batches, desc=desc, leave=False)


def _n_real(mask):
    """The batch's real-record count, left on the device for a device mask."""
    return mask.sum() if isinstance(mask, torch.Tensor) else float(np.sum(mask))


def _to_host(loss, n_real):
    """Start a step's loss and real-row count on their way to the host:
    ((loss, n_real), the event after their copies, or None off a GPU).  On a
    GPU each is copied into pinned memory behind the step; waiting on the
    event waits for that step alone, where reading the device tensor would
    wait for all its stream holds, the next step's work included."""
    if not (isinstance(loss, torch.Tensor) and loss.is_cuda):
        return (loss, n_real), None
    host = tuple(v.to("cpu", non_blocking=True) if isinstance(v, torch.Tensor) else v
                 for v in (loss, n_real))
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(loss.device))
    return host, done


def train_one_epoch(
    state: TrainState,
    train_step: Callable,
    batches: Iterator[Batch],
    loss_mode: str = "per_sample",
    desc: Optional[str] = None,
) -> Tuple[TrainState, float]:
    """One epoch -> (state, epoch train loss in the reference's aggregation mode)."""
    timer = StepTimer() if perf_enabled() else None
    total = 0.0
    weight = 0.0
    records = 0.0
    pending = None  # _to_host of the previous step, read after the next is queued

    def settle(item):
        nonlocal total, weight, records
        (loss, n_real), done = item
        with span("train.settle"):
            if done is not None:
                done.synchronize()  # that step, not the one queued after it
            loss, n_real = float(loss), float(n_real)
        records += n_real
        if loss_mode == "per_sample":
            total += loss * n_real
            weight += n_real
        else:  # per_batch (loop_demo.py:40-43)
            total += loss
            weight += 1.0

    for batch in _maybe_tqdm(batches, desc):
        n_real = _n_real(batch["mask"])
        if timer and pending is None:  # the epoch's first step
            timer.start()
        state, loss = train_step(state, batch)
        if pending is not None:
            settle(pending)
        pending = _to_host(loss, n_real)
    if pending is not None:
        settle(pending)
    if timer:
        timer.stop(records)  # after the last read: the epoch's steps have run
        print(timer.report("train"))
    return state, total / max(1.0, weight)


def eval_one_epoch(
    state: TrainState,
    eval_step: Callable,
    batches: Iterator[Batch],
    threshold: float = 0.5,
    loss_mode: str = "per_sample",
    desc: Optional[str] = None,
) -> Dict[str, float]:
    """Eval epoch -> {auroc_macro, auprc_macro, f1_macro, bce_loss}."""
    probs_list, y_list = [], []
    total = 0.0
    weight = 0.0
    for batch in _maybe_tqdm(batches, desc):
        probs, per_sample = eval_step(state, batch)
        mask = _host(batch["mask"]).astype(bool)
        probs_list.append(_host(probs)[mask])
        y_list.append(_host(batch["y"])[mask])
        losses = _host(per_sample)[mask]
        if loss_mode == "per_sample":
            total += float(losses.sum())
            weight += float(mask.sum())
        elif mask.any():
            total += float(losses.mean())
            weight += 1.0
        # an all-padding batch adds no per_batch weight: counting it as a
        # 0.0-loss batch would bias the multimodal val loss down
    if not y_list:
        raise ValueError("eval split produced no batches (every record dropped?) - "
                         "check the dataset's validity/demographic filters")
    metrics = compute_metrics(np.concatenate(y_list), np.concatenate(probs_list),
                              threshold=threshold)
    metrics["bce_loss"] = total / max(1.0, weight)
    return metrics


def predict_all(
    state: TrainState,
    eval_step: Callable,
    batches: Iterator[Batch],
    loss_mode: str = "per_sample",
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Whole-split inference -> (y_true, y_prob, mean BCE); ``per_batch`` is the
    unweighted mean of the batch means (the multimodal quirk, scripts/07)."""
    probs_list, y_list, losses, batch_means = [], [], [], []
    for batch in batches:
        probs, per_sample = eval_step(state, batch)
        mask = _host(batch["mask"]).astype(bool)
        probs_list.append(_host(probs)[mask])
        y_list.append(_host(batch["y"])[mask])
        kept = _host(per_sample)[mask]
        losses.append(kept)
        if mask.any():
            batch_means.append(float(kept.mean()))
    if not y_list:
        raise ValueError("test split produced no batches (every record dropped?) - "
                         "check the dataset's validity/demographic filters")
    y_true = np.concatenate(y_list)
    y_prob = np.concatenate(probs_list)
    if loss_mode == "per_batch":
        loss = float(np.mean(batch_means)) if batch_means else 0.0
    else:
        loss = float(np.concatenate(losses).mean())
    return y_true, y_prob, loss
