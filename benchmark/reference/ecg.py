"""The plain reference of both configurations, in float32 PyTorch.

Written from the published description (the configuration files under
``benchmark/configs/``): per-lead z-score ``(x - mean) / (std + 1e-6)`` with
the population std over time; four blocks of Conv1d (k=15, SAME) +
BatchNorm + ReLU + MaxPool(2, floor); the mean over time; ``proj``; for the
multimodal model a demographics MLP (5 -> 64 -> hidden, ReLU after each) and
FiLM (``gamma = 1 + tanh(g)``, ``z = gamma * z + beta``); the head; a
sigmoid.  Train mode normalises with the batch's biased statistics and moves
the running ones by ``momentum`` towards the batch mean and biased variance
(flax's rule, which the JAX package follows); the loss is the per-sample
binary cross-entropy meaned over labels, meaned over the batch; the
optimizer is AdamW with decoupled weight decay on every parameter.

It takes a state dict of plain tensors (the benchmark's own draws) and
nothing that the program made.  ``precision`` is the arithmetic of every
convolution and dense layer: ``"f32"`` (TF32 off, the reference itself), or
one of the controls, one precision below what a cell states: ``"tf32"``
(TF32 allowed; below float32) and ``"fp8"`` (both operands rounded to
float8 e4m3 with a per-tensor scale, products summed in f32; below
bfloat16).  Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

State = Dict[str, torch.Tensor]


PRECISIONS = ("f32", "tf32", "fp8")


@contextlib.contextmanager
def arithmetic(precision: str) -> Iterator[None]:
    """TF32 in cuDNN convolutions and matmuls on for ``"tf32"``, off
    otherwise, for the scope."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, mm.allow_tf32)
    cudnn.allow_tf32 = mm.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a per-tensor scale (its largest
    magnitude to e4m3's 448), returned in f32."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _operands(precision: str, *ts):
    return [fp8(t) for t in ts] if precision == "fp8" else list(ts)


def zscore(x: torch.Tensor, eps: float) -> torch.Tensor:
    """x [B, T, C] -> per-record, per-lead z-score over T."""
    mean = x.mean(dim=1, keepdim=True)
    std = (x - mean).square().mean(dim=1, keepdim=True).sqrt()
    return (x - mean) / (std + eps)


def _prefix(cfg: Mapping) -> str:
    return "ecg_backbone." if cfg["arch"] == "multimodal" else ""


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return F.linear(*_operands(precision, x, w), b)


def block(h: torch.Tensor, p: Mapping[str, torch.Tensor], name: str, cfg: Mapping,
          train: bool, running: Optional[State] = None, precision: str = "f32") -> torch.Tensor:
    """One conv block on channel-major ``[B, C, T]``."""
    k = cfg["kernel_size"]
    a = F.conv1d(*_operands(precision, h, p[name + "net.0.weight"]), p[name + "net.0.bias"],
                 padding=k // 2)
    if train:
        mean = a.mean(dim=(0, 2))
        var = (a - mean[:, None]).square().mean(dim=(0, 2))
        if running is not None:
            m = cfg["bn_momentum"]
            with torch.no_grad():
                running[name + "net.1.running_mean"] = (
                    (1 - m) * running[name + "net.1.running_mean"] + m * mean.detach())
                running[name + "net.1.running_var"] = (
                    (1 - m) * running[name + "net.1.running_var"] + m * var.detach())
    else:
        mean, var = p[name + "net.1.running_mean"], p[name + "net.1.running_var"]
    scale = p[name + "net.1.weight"] / torch.sqrt(var + cfg["bn_eps"])
    y = (a - mean[:, None]) * scale[:, None] + p[name + "net.1.bias"][:, None]
    return F.max_pool1d(torch.relu(y), cfg["pool"])


def logits(p: Mapping[str, torch.Tensor], cfg: Mapping, x: torch.Tensor,
           demo: Optional[torch.Tensor] = None, train: bool = False,
           running: Optional[State] = None, precision: str = "f32") -> torch.Tensor:
    """Raw ``[B, T, 12]`` (+ ``[B, 5]`` demographics) -> logits ``[B, L]``."""
    pre = _prefix(cfg)
    h = zscore(x, cfg["zscore_eps"]).transpose(1, 2)
    for i in range(len(cfg["channels"])):
        h = block(h, p, f"{pre}backbone.{i}.", cfg, train, running, precision)

    def dense(v, name):
        return linear(v, p[name + ".weight"], p[name + ".bias"], precision)

    z = dense(h.mean(dim=2), pre + "proj")
    if cfg["arch"] == "multimodal":
        d = torch.relu(dense(demo, "demo_encoder.mlp.0"))
        d = torch.relu(dense(d, "demo_encoder.mlp.2"))
        gamma, beta = dense(d, "film_gen").chunk(2, dim=-1)
        z = (1.0 + torch.tanh(gamma)) * z + beta
    return dense(z, "head")


@torch.no_grad()
def probs(p: Mapping[str, torch.Tensor], cfg: Mapping, x, demo=None, block_rows: int = 512,
          precision: str = "f32", device=None) -> torch.Tensor:
    """Eval-mode probabilities of host or device rows, in blocks of ``block_rows``."""
    device = device or next(iter(p.values())).device
    out = []
    with arithmetic(precision):
        for i in range(0, len(x), block_rows):
            xb = torch.as_tensor(x[i:i + block_rows], device=device)
            db = None if demo is None else torch.as_tensor(demo[i:i + block_rows], device=device)
            out.append(torch.sigmoid(logits(p, cfg, xb, db, precision=precision)).cpu())
    return torch.cat(out)


def is_parameter(key: str) -> bool:
    return not key.endswith(("running_mean", "running_var"))


def train_steps(state: Mapping[str, torch.Tensor], cfg: Mapping,
                batches: List[Mapping[str, torch.Tensor]], lr: float,
                weight_decay: float, precision: str = "f32", betas=(0.9, 0.999),
                eps: float = 1e-8, rows: Optional[int] = None
                ) -> Tuple[List[float], State, State]:
    """AdamW training steps from ``state`` over ``batches``, each a mapping
    with ``ecg`` ``[B, T, 12]``, ``y`` ``[B, L]`` and, for the multimodal
    model, ``demo`` ``[B, 5]``.

    Returns (each step's loss, the first step's gradients, the state after the
    last step, running statistics included).  ``rows`` trains on the first
    ``rows`` of each batch only (a planted fault)."""
    p = {k: v.detach().clone().requires_grad_(is_parameter(k)) for k, v in state.items()}
    running = {k: v for k, v in p.items() if not is_parameter(k)}
    m = {k: torch.zeros_like(v) for k, v in p.items() if is_parameter(k)}
    v2 = {k: torch.zeros_like(v) for k, v in m.items()}
    losses, first_grads = [], {}
    b1, b2 = betas
    with arithmetic(precision):
        for step, b in enumerate(batches, start=1):
            x, y, demo = b["ecg"], b["y"], b.get("demo")
            if rows is not None:
                x, y = x[:rows], y[:rows]
                demo = None if demo is None else demo[:rows]
            leaves = {**p, **running}
            out = logits(leaves, cfg, x, demo, train=True, running=running, precision=precision)
            loss = F.binary_cross_entropy_with_logits(out, y, reduction="none").mean(1).mean()
            grads = torch.autograd.grad(loss, [p[k] for k in m])
            losses.append(loss.detach().item())
            with torch.no_grad():
                for (k, g) in zip(m, grads):
                    if step == 1:
                        first_grads[k] = g.clone()
                    m[k].mul_(b1).add_((1 - b1) * g)
                    v2[k].mul_(b2).add_((1 - b2) * g * g)
                    mhat = m[k] / (1 - b1 ** step)
                    vhat = v2[k] / (1 - b2 ** step)
                    p[k].mul_(1 - lr * weight_decay)
                    p[k].sub_(lr * mhat / (vhat.sqrt() + eps))
    final = {k: v.detach().clone() for k, v in p.items() if is_parameter(k)}
    final.update({k: v.detach().clone() for k, v in running.items()})
    return losses, first_grads, final
