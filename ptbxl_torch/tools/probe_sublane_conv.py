"""Channel-major conv layer timing on the card (port of ``tools/probe_sublane_conv.py``, P4).

    python -m ptbxl_torch.tools.probe_sublane_conv [--batch 2048] [--device cpu]

For each of the ECGCNN's four conv layers (``LAYERS``: T_in, Cin, Cout and
the padded channel count Cpad), P4's layer (``conv_layer_cf``: conv k=15
over all Cpad channels with bf16 operands and f32 sums, + bias, ReLU, floor
MaxPool(2)) on a channel-major input ``[B, Cpad, T+14]`` f32, written
``[B, Cout, T/2]``, on K4's ``wgmma`` conv block
(``ptbxl_torch/csrc/hybrid_wgmma.cu``: the rows transposed as they are
staged, the pooled tile written channel-major), beside P3's layer on the same layer (``conv_layer``, in
its im2col and direct modes, channels-last) and cuDNN's bf16 ``F.conv1d`` on
the NCL layout + bias + ReLU + pool.  Prints microseconds, TFLOP/s and P4's
bound (the larger of its operations, 2*15*Cpad*Cout*T a record, at 989
TFLOP/s bf16 and its bytes, input, output and weights once, at 3.35 TB/s).
The TPU tool's ``b_tile`` (8 or 16 records per grid step) has no
counterpart on the card.  ``--device cpu`` runs the plain versions on the
host (host clocks: no device measurement).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import torch
import torch.nn.functional as F

from ptbxl_torch.bench import Clock
from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4
from ptbxl_torch.tools import probe_layer_perf
from ptbxl_torch.utils.device import resolve_device

K, PAD = 15, 7
# (T_in, Cin, Cout, Cin_pad): tools/probe_sublane_conv.py:28
LAYERS = [(5000, 12, 32, 16), (2500, 32, 64, 32), (1250, 64, 128, 64), (625, 128, 256, 128)]
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM (data sheet)


def make_layer(t_in: int, cout: int, cpad: int, b: int, device: torch.device, seed: int = 1):
    """x [B, Cpad, T+14] f32 normals (every channel and pad column random, as
    the TPU tool's input), w [15*Cpad, Cout] (scale 0.05), bias [Cout] (scale 0.01)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, cpad, t_in + 2 * PAD, generator=gen, device=device)
    w = torch.randn(K * cpad, cout, generator=gen, device=device) * 0.05
    bias = torch.randn(cout, generator=gen, device=device) * 0.01
    return x, w, bias


def layer_flops(t_in: int, cout: int, cpad: int, b: int) -> float:
    """Operations of P4's layer: 2*15*Cpad*Cout a conv row, T rows."""
    return 2.0 * K * cpad * cout * t_in * b


def bound(t_in: int, cout: int, cpad: int, b: int) -> Tuple[float, str]:
    """(ms, "operations" or "bytes") of P4's layer at batch ``b``."""
    t_ops = layer_flops(t_in, cout, cpad, b) / PEAK_BF16 * 1e3
    nbytes = (b * cpad * (t_in + 2 * PAD) + b * cout * (t_in // 2) + K * cpad * cout + cout) * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cudnn_layer_cf(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """cuDNN's bf16 conv on the NCL layout (VALID on the time-padded input) +
    bias + ReLU + floor pool -> [B, Cout, T//2] f32."""
    cpad, cout = x.shape[1], w.shape[1]
    wt = w.view(K, cpad, cout).permute(2, 1, 0).to(torch.bfloat16)
    y = F.max_pool1d(F.conv1d(x.to(torch.bfloat16), wt), 2)
    return torch.relu(y.float() + bias[:, None])


def run(b: int, device: torch.device, iters: int = 8) -> List[dict]:
    """Each layer's P4 time beside P3's two modes and cuDNN at batch ``b``."""
    clock = Clock(device)
    rows = []
    with torch.no_grad():
        for t_in, cin, cout, cpad in LAYERS:
            x, w, bias = make_layer(t_in, cout, cpad, b, device)
            flops = layer_flops(t_in, cout, cpad, b)
            row = {"layer": [t_in, cin, cout, cpad], "batch": b, "flops": flops,
                   "bound": bound(t_in, cout, cpad, b)}
            row["p4_ms"] = clock.ms(lambda: k4.conv_layer_cf(x, w, bias), iters)
            row["cudnn_ms"] = clock.ms(lambda: cudnn_layer_cf(x, w, bias), iters)
            del x
            xl, wl, bl = probe_layer_perf.make_layer(t_in, cin, cout, b, device)
            for mode in k4.MODES:
                row[f"p3_{mode}_ms"] = clock.ms(lambda: k4.conv_layer(xl, wl, bl, mode), iters)
            del xl
            for name in ("p4", "cudnn", "p3_im2col", "p3_direct"):
                row[f"{name}_tflops"] = flops / (row[f"{name}_ms"] / 1e3) / 1e12
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--device", default=None, help="'cpu' for a host run; default the GPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"batch={args.batch} sublane-build TN conv, device={device.type}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    total = {"p4": 0.0, "p3_im2col": 0.0, "p3_direct": 0.0, "cudnn": 0.0, "bound": 0.0}
    for r in run(args.batch, device):
        t_in, cin, cout, _ = r["layer"]
        label = f"L({t_in:5d},{cin:3d}->{cout:3d})"
        for name in ("p4", "p3_im2col", "p3_direct", "cudnn"):
            total[name] += r[f"{name}_ms"]
            print(f"{label} {name:<9} {r[f'{name}_ms'] * 1e3:10.1f} us "
                  f"{r[f'{name}_tflops']:7.1f} TF/s")
        total["bound"] += r["bound"][0]
        print(f"{label} bound     {r['bound'][0] * 1e3:10.1f} us ({r['bound'][1]})")
    print("\nstack totals:")
    for name, ms in total.items():
        print(f"  {name:9s}: {ms * 1e3:10.1f} us -> {args.batch / (ms / 1e3):10.0f} rec/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
