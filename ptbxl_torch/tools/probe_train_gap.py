"""Where the train step's time goes between forward+backward and the full step
(port of ``tools/probe_train_gap.py``).

    python -m ptbxl_torch.tools.probe_train_gap [--batch 4096] [--iters 10]
        [--dtype bf16|f32] [--t 5000] [--device cpu]

A ladder of step variants of the ECGCNN (``build_ecgcnn`` seed 0, AdamW lr
1.5e-3, wd 1e-4, a seeded random batch), each timed on its own:

  fwdbwd             train-mode forward + masked BCE + backward, the
                     BatchNorm running update left out (JAX drops the
                     mutated statistics, so XLA removes their pass)
  fwdbwd_stats       + the running update (the port's train-mode forward)
  fwdbwd_carry       + a no-op parameter update (p -= 0 * g) in one foreach pass
  step_sgd           the full step (``make_train_step``) with SGD, z-score hoisted
  step_adamw_hoistz  the full step with AdamW, z-score hoisted out of the step
  step_adamw         the port's train step (z-score inside)

Differences between adjacent rungs price each piece.  Times are CUDA events
around ``--iters`` calls (``bench.Clock``; no rung is launch-bound at the
probe's batch); ``--device cpu`` runs it on the host at a tiny size (host
clocks: no device measurement).  ``run`` returns the rows; ``main`` prints them.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from ptbxl_torch.bench import Clock
from ptbxl_torch.models.ecg_cnn import ConvBlock, ECGCNN
from ptbxl_torch.models.factory import build_ecgcnn
from ptbxl_torch.ops.preprocess import zscore_per_lead_batch
from ptbxl_torch.training.loop import make_train_step, per_sample_bce
from ptbxl_torch.training.train_state import TrainState, create_train_state
from ptbxl_torch.utils.device import precision_scope, resolve_device

LR, WD = 1.5e-3, 1e-4
DTYPES = {"f32": (torch.float32, "highest"), "bf16": (torch.bfloat16, "default")}


def device_label(dev: torch.device) -> str:
    """The card's name, or a note that the times are the host's."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (host clock)"


def make_model(dtype_name: str, device: torch.device) -> ECGCNN:
    dtype, precision = DTYPES[dtype_name]
    return build_ecgcnn(num_labels=5, seed=0, precision=precision, dtype=dtype, device=device)


def make_batch(batch: int, t: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The probes' batch: seeded raw-like signals, 5-label targets, no padding."""
    gen = torch.Generator(device=device).manual_seed(0)
    return {"ecg": torch.randn(batch, t, 12, generator=gen, device=device),
            "y": (torch.rand(batch, 5, generator=gen, device=device) > 0.7).float(),
            "mask": torch.ones(batch, device=device)}


def masked_bce(logits: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    mask = batch["mask"]
    return torch.sum(per_sample_bce(logits, batch["y"]) * mask) / torch.sum(mask)


@contextlib.contextmanager
def running_stats_off() -> Iterator[None]:
    """Train-mode BatchNorm without the running update's statistics pass."""
    orig = ConvBlock._train_batch_norm

    def normalize_only(self, a):
        bn = self.net[1]
        return F.batch_norm(a, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)

    ConvBlock._train_batch_norm = normalize_only
    try:
        yield
    finally:
        ConvBlock._train_batch_norm = orig


def _fwdbwd(model: ECGCNN, x0: torch.Tensor, batch: Dict[str, torch.Tensor]) -> None:
    model.train()
    model.zero_grad(set_to_none=True)
    with precision_scope(model.precision):
        masked_bce(model(x0), batch).backward()


def rungs(dtype_name: str, batch: Dict[str, torch.Tensor], device: torch.device
          ) -> List[Tuple[str, object]]:
    """(name, zero-argument step) of each rung, each on its own model from seed 0."""
    x0 = zscore_per_lead_batch(batch["ecg"])
    hoisted = dict(batch, ecg=x0)
    out = []

    m = make_model(dtype_name, device)

    def fwdbwd(m=m):
        with running_stats_off():
            _fwdbwd(m, x0, batch)

    out.append(("fwdbwd", fwdbwd))
    m = make_model(dtype_name, device)
    out.append(("fwdbwd_stats", lambda m=m: _fwdbwd(m, x0, batch)))
    m = make_model(dtype_name, device)
    params = list(m.parameters())

    def fwdbwd_carry(m=m):
        _fwdbwd(m, x0, batch)
        with torch.no_grad():
            torch._foreach_sub_(params, torch._foreach_mul([p.grad for p in params], 0.0))

    out.append(("fwdbwd_carry", fwdbwd_carry))
    m = make_model(dtype_name, device)
    sgd = TrainState(m, torch.optim.SGD(m.parameters(), lr=LR))
    step_none = make_train_step(normalize="none")
    out.append(("step_sgd", lambda: step_none(sgd, hoisted)))
    adamw = create_train_state(make_model(dtype_name, device), LR, WD)
    out.append(("step_adamw_hoistz", lambda: step_none(adamw, hoisted)))
    adamw2 = create_train_state(make_model(dtype_name, device), LR, WD)
    step = make_train_step()
    out.append(("step_adamw", lambda: step(adamw2, batch)))
    return out


def run(batch: int = 4096, dtype_name: str = "bf16", t: int = 5000, iters: int = 10,
        device=None) -> List[dict]:
    """Each rung's ms a step, with its increment over the rung before."""
    dev = resolve_device(device)
    clock = Clock(dev)
    b = make_batch(batch, t, dev)
    rows, prev = [], None
    for name, fn in rungs(dtype_name, b, dev):
        ms = clock.ms(fn, iters)
        rows.append({"rung": name, "ms": ms, "delta_ms": None if prev is None else ms - prev})
        prev = ms
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--t", type=int, default=5000)
    ap.add_argument("--device", default=None, help="'cpu' for a host run; default the GPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"batch={args.batch} dtype={args.dtype} iters={args.iters} T={args.t} "
          f"device={device_label(dev)}")
    for r in run(args.batch, args.dtype, args.t, args.iters, dev):
        delta = "" if r["delta_ms"] is None else f"  (+{r['delta_ms']:7.2f} ms)"
        print(f"{r['rung']:18s} {r['ms']:8.2f} ms/batch{delta}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
