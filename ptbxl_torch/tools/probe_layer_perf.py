"""Per-layer conv timing on the card (port of ``tools/probe_layer_perf.py``).

    python -m ptbxl_torch.tools.probe_layer_perf [--batch 2048] [--device cpu]

For each of the ECGCNN's four conv layers (``LAYERS``), one layer conv k=15
+ bias + ReLU + MaxPool(2) on a pre-padded input ``[B, T+14, Cin]`` f32
(bf16 operands, f32 sums): the im2col mode (K4's ``wgmma`` conv block of
``ptbxl_torch/csrc/hybrid_wgmma.cu`` on a VALID f32 input, f32 out), the
direct mode (K2's conv block, 15 shifted products) and cuDNN's bf16 conv +
bias + ReLU + pool (the probe's ``xla_layer``).  Prints microseconds,
TFLOP/s and the layer's bound (the larger of its operations at 989 TFLOP/s
bf16 and its bytes, input and output once, at 3.35 TB/s).  ``--device cpu``
runs it on the host (host clocks: no device measurement).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import torch
import torch.nn.functional as F

from ptbxl_torch.bench import Clock
from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4
from ptbxl_torch.utils.device import resolve_device

K, PAD = 15, 7
# (T_in, Cin, Cout): the four reference layers
LAYERS = [(5000, 12, 32), (2500, 32, 64), (1250, 64, 128), (625, 128, 256)]
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM (data sheet)


def make_layer(t_in: int, cin: int, cout: int, b: int, device: torch.device, seed: int = 1):
    """x [B, T+14, Cin] f32, w [15*Cin, Cout] f32 (scale 0.05), bias [Cout] (scale 0.01)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, t_in + 2 * PAD, cin, generator=gen, device=device)
    w = torch.randn(K * cin, cout, generator=gen, device=device) * 0.05
    bias = torch.randn(cout, generator=gen, device=device) * 0.01
    return x, w, bias


def layer_flops(t_in: int, cin: int, cout: int, b: int) -> float:
    """Operations of one layer: 2*15*Cin*Cout a conv row, T rows (tools/probe_layer_perf.py:143)."""
    return 2.0 * K * cin * cout * t_in * b


def cudnn_layer(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The probe's ``xla_layer`` (:114): cuDNN's bf16 conv (VALID on the pre-padded
    input) + bias + ReLU + floor pool -> [B, T//2, Cout] f32."""
    cin, cout = x.shape[2], w.shape[1]
    wt = w.view(K, cin, cout).permute(2, 1, 0).to(torch.bfloat16)
    y = F.max_pool1d(F.conv1d(x.transpose(1, 2).to(torch.bfloat16), wt), 2)
    return torch.relu(y.transpose(1, 2).float() + bias)


def bound(t_in: int, cin: int, cout: int, b: int) -> Tuple[float, str]:
    """(ms, "operations" or "bytes") of one layer at batch ``b``."""
    t_ops = layer_flops(t_in, cin, cout, b) / PEAK_BF16 * 1e3
    nbytes = (b * (t_in + 2 * PAD) * cin + b * (t_in // 2) * cout + K * cin * cout + cout) * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def run(b: int, device: torch.device, iters: int = 8) -> List[dict]:
    """Each layer's time by mode at batch ``b``."""
    clock = Clock(device)
    rows = []
    with torch.no_grad():
        for t_in, cin, cout in LAYERS:
            x, w, bias = make_layer(t_in, cin, cout, b, device)
            flops = layer_flops(t_in, cin, cout, b)
            row = {"layer": [t_in, cin, cout], "batch": b, "flops": flops,
                   "bound": bound(t_in, cin, cout, b)}
            for name, fn in (("im2col", lambda: k4.conv_layer(x, w, bias, "im2col")),
                             ("direct", lambda: k4.conv_layer(x, w, bias, "direct")),
                             ("cudnn", lambda: cudnn_layer(x, w, bias))):
                ms = clock.ms(fn, iters)
                row[f"{name}_ms"] = ms
                row[f"{name}_tflops"] = flops / (ms / 1e3) / 1e12
            rows.append(row)
            del x
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--device", default=None, help="'cpu' for a host run; default the GPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"batch={args.batch} device={device.type}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    total = {"im2col": 0.0, "direct": 0.0, "cudnn": 0.0, "bound": 0.0}
    for r in run(args.batch, device):
        t_in, cin, cout = r["layer"]
        label = f"L({t_in:5d},{cin:3d}->{cout:3d})"
        for name in ("im2col", "direct", "cudnn"):
            total[name] += r[f"{name}_ms"]
            print(f"{label} {name:<7} {r[f'{name}_ms'] * 1e3:10.1f} us "
                  f"{r[f'{name}_tflops']:7.1f} TF/s")
        total["bound"] += r["bound"][0]
        print(f"{label} bound   {r['bound'][0] * 1e3:10.1f} us ({r['bound'][1]})")
    print("\nstack totals (conv layers only):")
    for name, ms in total.items():
        print(f"  {name:7s}: {ms * 1e3:10.1f} us -> {args.batch / (ms / 1e3):10.0f} rec/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
