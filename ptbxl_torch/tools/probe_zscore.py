"""The z-score variants on the card, standalone (port of ``tools/probe_zscore.py``).

    python -m ptbxl_torch.tools.probe_zscore [--device cpu]

Times each variant (``variants``) on one bf16 batch ``[PROBE_BS, 5000, 12]``
(default 11264, the JAX probe's headline geometry), ``PROBE_ITERS`` calls
(default 20) between CUDA events, median of 3, and prints microseconds a
record beside the variant's bytes bound (its input read once and its output
written once, at 3.35 TB/s).  Variants: the two-pass and one-pass torch forms
(f32 out), K1 ``zscore`` with bf16 out, and K5 ``zscore_wide`` with bf16 out
at ``block_b`` 4/8/16 and ``width`` 240/1200.  The JAX probe's in-model column
runs the int8 forward, which is not ported yet.  ``--device cpu`` runs it on
the host at ``PROBE_BS`` (host clocks: no device measurement).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Dict, List

import torch

from ptbxl_torch.bench import Clock
from ptbxl_torch.ops.kernels import zscore as kz
from ptbxl_torch.ops.preprocess import zscore_per_lead_batch, zscore_per_lead_batch_onepass
from ptbxl_torch.utils.device import resolve_device

BS = int(os.environ.get("PROBE_BS", "11264"))
ITERS = int(os.environ.get("PROBE_ITERS", "20"))
T, LEADS = 5000, 12
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (data sheet)


def variants() -> Dict[str, Callable[[torch.Tensor], torch.Tensor]]:
    """name -> x [B, T, 12] bf16 -> normalized (``variants``, probe_zscore.py:57)."""
    bf16 = torch.bfloat16
    out = {
        "torch_two_pass": lambda x: zscore_per_lead_batch(x.float()),
        "torch_one_pass": zscore_per_lead_batch_onepass,
        "k1": lambda x: kz.zscore(x, out_dtype=bf16),
    }
    for kb in (4, 8, 16):
        out[f"k5_b{kb}"] = lambda x, kb=kb: kz.zscore_wide(x, out_dtype=bf16, block_b=kb)
    for w in (240, 1200):
        out[f"k5_w{w}"] = lambda x, w=w: kz.zscore_wide(x, out_dtype=bf16, width=w)
    return out


def bound_ms(x: torch.Tensor, out_dtype: torch.dtype) -> float:
    """The input read once and the output written once at the HBM rate (ms)."""
    out_bytes = x.numel() * torch.empty((), dtype=out_dtype).element_size()
    return (x.numel() * x.element_size() + out_bytes) / PEAK_BYTES * 1e3


def make_batch(bs: int, device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn(bs, T, LEADS, generator=gen, device=device).to(torch.bfloat16)


def run(batch: torch.Tensor, iters: int = ITERS) -> List[dict]:
    """Each variant's time on ``batch``: ms a call, us a record, and its bound."""
    clock = Clock(batch.device)
    rows = []
    with torch.no_grad():
        for name, fn in variants().items():
            out_dtype = fn(batch[:1]).dtype
            ms = clock.ms(lambda: fn(batch), iters)
            b = bound_ms(batch, out_dtype)
            rows.append({"variant": name, "ms": ms, "us_per_record": ms * 1e3 / batch.shape[0],
                         "bound_ms": b, "bound_us_per_record": b * 1e3 / batch.shape[0],
                         "out_dtype": str(out_dtype).replace("torch.", "")})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu' for a host run; default the GPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    batch = make_batch(BS, device)
    print(f"# bs={BS} iters={ITERS} device={device.type}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    print(f"{'variant':<16} {'us/rec':>9} {'bound us/rec':>13} {'ms':>9}")
    for r in run(batch):
        print(f"{r['variant']:<16} {r['us_per_record']:>9.4f} {r['bound_us_per_record']:>13.4f} "
              f"{r['ms']:>9.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
