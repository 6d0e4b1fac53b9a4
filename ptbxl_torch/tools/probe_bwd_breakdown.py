"""The training backward's cost by block and by gradient kind (port of
``tools/probe_bwd_breakdown.py``).

    python -m ptbxl_torch.tools.probe_bwd_breakdown [--batch 4096] [--iters 10]
        [--dtype bf16|f32] [--t 5000] [--device cpu]

The ECGCNN's train-mode forward + masked BCE + backward (the z-score taken
once outside), block by block as ``ECGCNN.forward`` runs it, with surgical
cuts, each rung timed on its own:

  depth ladder    ``detach()`` after block i: blocks 1..i run forward only, so
                  successive differences price each block's whole backward
                  (dgrad, wgrad, pool/ReLU/BatchNorm backward)
  params ladder   block i's conv and BatchNorm parameters with
                  ``requires_grad_(False)``: its wgrad and the affine grads
  wgrad ladder    block i's conv weight alone with ``requires_grad_(False)``:
                  its wgrad alone (the pool/BN backward stays alive)
  fast_wgrad b1   block 1's conv through ``ops/fast_wgrad.py``'s
                  ``conv1d_fast_wgrad`` (its wgrad one phase-packed matmul,
                  P=8 at T=5000) against the full step's cuDNN wgrad

Blocks are numbered from 1 as in the JAX tool.  Times are CUDA events around
``--iters`` calls (``bench.Clock``); ``--device cpu`` runs it on the host at a
tiny size (host clocks: no device measurement).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from typing import Dict, List, Optional

import torch

from ptbxl_torch.bench import Clock
from ptbxl_torch.models.ecg_cnn import ECGCNN, dense
from ptbxl_torch.ops.fast_wgrad import conv1d_fast_wgrad
from ptbxl_torch.ops.preprocess import zscore_per_lead_batch
from ptbxl_torch.tools.probe_train_gap import (DTYPES, device_label, make_batch, make_model,
                                               masked_bce)
from ptbxl_torch.utils.device import precision_scope, resolve_device


def _fast_block(blk, h: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """``ConvBlock.forward`` with its conv through ``conv1d_fast_wgrad`` (the
    bias after the rounded product, as ``conv_only``)."""
    conv, dt = blk.net[0], blk.dtype
    k = conv.kernel_size[0]
    a = conv1d_fast_wgrad(h.transpose(1, 2).to(dt), conv.weight.to(dt).permute(2, 1, 0),
                          (k // 2, k // 2), precision)
    return blk.post(a.transpose(1, 2) + conv.bias.to(dt)[:, None])


def forward(model: ECGCNN, x0: torch.Tensor, stop_depth: Optional[int] = None,
            fast_block1: bool = False) -> torch.Tensor:
    """Train-mode logits, block by block; ``stop_depth=i`` detaches the
    activation after block i (1-based)."""
    model.train()
    h = x0.transpose(1, 2)
    for i, blk in enumerate(model.backbone, start=1):
        h = _fast_block(blk, h, model.precision) if fast_block1 and i == 1 else blk(h)
        if stop_depth == i:
            h = h.detach()
    z = dense(model.proj, h.mean(dim=2), model.dtype)
    return dense(model.head, z, model.dtype)


@contextlib.contextmanager
def frozen(params):
    """``requires_grad_(False)`` on ``params`` for the scope."""
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def rungs(model: ECGCNN) -> List[tuple]:
    """(label, forward keywords, frozen parameters) of every rung."""
    out = [("full fwdbwd", {}, [])]
    out += [(f"stop after b{d}", {"stop_depth": d}, []) for d in (1, 2, 3)]
    for i, blk in enumerate(model.backbone, start=1):
        conv, bn = blk.net[0], blk.net[1]
        out.append((f"freeze b{i} params", {}, [conv.weight, conv.bias, bn.weight, bn.bias]))
    out += [(f"freeze k{i} kernel", {}, [blk.net[0].weight])
            for i, blk in enumerate(model.backbone, start=1)]
    out.append(("fast_wgrad b1", {"fast_block1": True}, []))
    return out


def run(batch: int = 4096, dtype_name: str = "bf16", t: int = 5000, iters: int = 10,
        device=None) -> List[Dict[str, object]]:
    """Each rung's ms a fwd+bwd and what it prices against the full rung."""
    dev = resolve_device(device)
    clock = Clock(dev)
    b = make_batch(batch, t, dev)
    x0 = zscore_per_lead_batch(b["ecg"])
    model = make_model(dtype_name, dev)

    def fwdbwd(**kw):
        model.zero_grad(set_to_none=True)
        with precision_scope(model.precision):
            masked_bce(forward(model, x0, **kw), b).backward()

    rows = []
    for label, kw, params in rungs(model):
        with frozen(params):
            ms = clock.ms(lambda: fwdbwd(**kw), iters)
        rows.append({"rung": label, "ms": ms})
    full = rows[0]["ms"]
    prev = full
    for r in rows[1:]:
        r["full_minus_ms"] = full - r["ms"]
        if r["rung"].startswith("stop"):
            r["block_bwd_ms"] = prev - r["ms"]  # block d's backward slice
            prev = r["ms"]
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
        note = ""
        if "block_bwd_ms" in r:
            note = f"  block{r['rung'][-1]} bwd slice = {r['block_bwd_ms']:6.2f} ms"
        elif "full_minus_ms" in r:
            note = f"  full - rung = {r['full_minus_ms']:6.2f} ms"
        print(f"{r['rung']:18s} {r['ms']:8.2f} ms/batch{note}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
