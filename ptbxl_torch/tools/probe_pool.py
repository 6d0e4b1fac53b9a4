"""ReLU -> MaxPool1d(2) forms, forward and forward+backward, at training shape
(port of ``tools/probe_pool.py``).

    python -m ptbxl_torch.tools.probe_pool [--batch 4096] [--iters 10]
        [--dtype bf16|f32] [--t 5000] [--device cpu]

``f(x) = sum(pool(relu(x)))`` in f32 at the four blocks' pool inputs ``[B, C,
T]`` (the port's layout), summed over the blocks, for each form:

  k6       the port's default, ``ops/relu_pool.py::relu_max_pool2``: its
           backward is K6 (``csrc/relu_pool.cu``) on the card
  rw       ``F.max_pool1d`` with autograd (argmax indices kept; JAX's
           reduce_window, whose VJP is SelectAndScatter)
  reshape  a ``[B, C, U, 2]`` view and ``amax`` (elementwise-mask VJP)
  strided  ``maximum(x[..., 0::2], x[..., 1::2])`` (elementwise-mask VJP)
  hybrid   ``F.max_pool1d`` forward, the strided mask as its backward

so the JAX package's alternatives are priced against the form the port runs.
Times are CUDA events around ``--iters`` calls (``bench.Clock``);
``--device cpu`` runs it on the host at a tiny size (host clocks: no device
measurement).
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from ptbxl_torch.bench import Clock
from ptbxl_torch.ops.relu_pool import relu_max_pool2
from ptbxl_torch.tools.probe_train_gap import DTYPES, device_label
from ptbxl_torch.utils.device import resolve_device

CHANNELS = (32, 64, 128, 256)  # the blocks' pool inputs: [B, C, T / 2^i]


def pool_rw(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool1d(x, 2)


def pool_reshape(x: torch.Tensor) -> torch.Tensor:
    b, c, t = x.shape
    return x[..., :2 * (t // 2)].reshape(b, c, t // 2, 2).amax(dim=-1)


def pool_strided(x: torch.Tensor) -> torch.Tensor:
    e = 2 * (x.shape[-1] // 2)
    return torch.maximum(x[..., 0:e:2], x[..., 1:e:2])


class _Hybrid(torch.autograd.Function):
    """``F.max_pool1d`` forward; backward the strided mask, a tie split evenly."""

    @staticmethod
    def forward(ctx, x):
        y = F.max_pool1d(x, 2)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        e = 2 * y.shape[-1]
        me = (x[..., 0:e:2] == y).to(g.dtype)
        mo = (x[..., 1:e:2] == y).to(g.dtype)
        scale = g / (me + mo)
        dx = torch.zeros_like(x, dtype=g.dtype)
        dx[..., 0:e:2] = me * scale
        dx[..., 1:e:2] = mo * scale
        return dx


FORMS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "k6": relu_max_pool2,  # relu(pool(x)) == pool(relu(x))
    "rw": lambda x: pool_rw(torch.relu(x)),
    "reshape": lambda x: pool_reshape(torch.relu(x)),
    "strided": lambda x: pool_strided(torch.relu(x)),
    "hybrid": lambda x: _Hybrid.apply(torch.relu(x)),
}


def shapes(batch: int, t: int) -> List[tuple]:
    return [(batch, c, t >> i) for i, c in enumerate(CHANNELS)]


def run(batch: int = 4096, dtype_name: str = "bf16", t: int = 5000, iters: int = 10,
        device=None) -> List[dict]:
    """Each form's fwd and fwd+bwd ms, summed over the four block shapes."""
    dev = resolve_device(device)
    clock = Clock(dev)
    dtype = DTYPES[dtype_name][0]
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.randn(s, generator=gen, device=dev).to(dtype).requires_grad_(True)
          for s in shapes(batch, t)]
    rows = []
    for name, pool in FORMS.items():
        def fwd(x):
            with torch.no_grad():
                return pool(x).float().sum()

        def fwdbwd(x):
            return torch.autograd.grad(pool(x).float().sum(), x)

        tf = sum(clock.ms(lambda: fwd(x), iters) for x in xs)
        tb = sum(clock.ms(lambda: fwdbwd(x), iters) for x in xs)
        rows.append({"form": name, "fwd_ms": tf, "fwdbwd_ms": tb, "bwd_ms": tb - tf,
                     "default": name == "k6"})
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
          f"device={device_label(dev)}"
          "  (ms a pass, the four block shapes summed)")
    for r in run(args.batch, args.dtype, args.t, args.iters, dev):
        label = r["form"] + (" (port default)" if r["default"] else "")
        print(f"{label:22s} fwd {r['fwd_ms']:7.2f} ms   fwd+bwd {r['fwdbwd_ms']:7.2f} ms   "
              f"bwd-only {r['bwd_ms']:7.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
