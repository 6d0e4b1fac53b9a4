"""Does the card's ``torch._int_mm`` beat a bf16 matmul at the int8 path's
geometry? (port of ``tools/probe_int8.py``)

    python -m ptbxl_torch.tools.probe_int8 [--batch 2048] [--iters 8] [--device cpu]

Prints one JSON line: for each shape, the s8 x s8 -> s32 product
(``torch._int_mm``) and the bf16 x bf16 -> f32 -> bf16 product (``torch.mm``)
in TOP/s and TFLOP/s, beside the H100's dense peaks (1979 TOP/s int8, 989
TFLOP/s bf16):

* ``dot``: a square chained product ``[65536, 2048] @ [2048, 2048]``, each
  iteration's output requantized (``>> 7`` to int8, or rounded to bf16) and
  fed back as the next iteration's input, as the JAX probe chains;
* ``l3_im2col`` / ``l1_im2col``: the deep layers' im2col products
  ``[B*625, 1920] @ [1920, 256]`` and ``[B*2500, 480] @ [480, 64]``
  (``ops/quant.int8_conv1d``'s right operand is the column-major weight
  matrix, as here); ``iters`` launches back to back in one timed window (the
  output's shape is not the input's, so nothing is fed back: eager launches
  run every one, where the JAX probe chains to keep XLA from hoisting);
* ``l3_conv`` / ``l1_conv``: the whole int8 conv (``int8_conv1d``: im2col +
  ``_int_mm``) beside cuDNN's bf16 conv (``F.conv1d``) at those layers.

Timing: CUDA events around ``iters`` calls after a warm-up, median of 3
trials (``bench.Clock``).  ``--device cpu`` is a wiring check on the host
(host clocks; no device measurement).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from ptbxl_torch.bench import Clock, H100_PEAKS
from ptbxl_torch.ops.quant import int8_conv1d
from ptbxl_torch.utils.device import resolve_device

# (name, T, Cin, Cout) of the deep layers' im2col geometry (T after the pools)
LAYERS = (("l3", 625, 128, 256), ("l1", 2500, 32, 64))


def _rates(flops: float, ms: float) -> float:
    return flops / (ms / 1e3) / 1e12


def probe_dot(clock: Clock, m: int, n: int, iters: int) -> dict:
    """Square chained dot, x[M, N] @ w[N, N] -> x, in int8 and in bf16."""
    dev = clock.device
    gen = torch.Generator(device=dev).manual_seed(0)
    flops = 2.0 * m * n * n * iters
    wi = torch.randint(-127, 127, (n, n), generator=gen, device=dev, dtype=torch.int8)
    xi = torch.randint(-127, 127, (m, n), generator=gen, device=dev, dtype=torch.int8)
    wf = (torch.randn(n, n, generator=gen, device=dev) / n ** 0.5).to(torch.bfloat16)
    xf = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
    wit, wft = wi.t().contiguous().t(), wf  # the int8 right operand column-major

    def chain_int8():
        x = xi
        for _ in range(iters):
            x = (torch._int_mm(x, wit) >> 7).to(torch.int8)
        return x

    def chain_bf16():
        x = xf
        for _ in range(iters):
            x = torch.mm(x, wft)
        return x

    ms_i = clock.ms(chain_int8, 1)
    ms_f = clock.ms(chain_bf16, 1)
    return {"shape": f"dot {m}x{n}x{n}", "iters": iters,
            "int8_ms": ms_i / iters, "int8_tops": _rates(flops, ms_i),
            "bf16_ms": ms_f / iters, "bf16_tflops": _rates(flops, ms_f)}


def probe_layer(clock: Clock, name: str, t: int, cin: int, cout: int, batch: int,
                iters: int) -> list:
    """The layer's im2col product alone, then the whole conv, int8 beside bf16."""
    dev = clock.device
    gen = torch.Generator(device=dev).manual_seed(1)
    m, k = batch * t, 15 * cin
    flops = 2.0 * m * k * cout
    cols = torch.randint(-127, 127, (m, k), generator=gen, device=dev, dtype=torch.int8)
    wm = torch.randint(-127, 127, (cout, k), generator=gen, device=dev, dtype=torch.int8)
    ms_i = clock.ms(lambda: torch._int_mm(cols, wm.t()), iters)
    del cols
    cols_f = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    wf = torch.randn(k, cout, generator=gen, device=dev).to(torch.bfloat16)
    ms_f = clock.ms(lambda: torch.mm(cols_f, wf), iters)
    del cols_f
    rows = [{"shape": f"{name}_im2col [{m}, {k}] x [{k}, {cout}]", "iters": iters,
             "int8_ms": ms_i, "int8_tops": _rates(flops, ms_i),
             "bf16_ms": ms_f, "bf16_tflops": _rates(flops, ms_f)}]
    xq = torch.randint(-127, 127, (batch, t, cin), generator=gen, device=dev, dtype=torch.int8)
    xb = torch.randn(batch, cin, t, generator=gen, device=dev).to(torch.bfloat16)
    wc = torch.randn(cout, cin, 15, generator=gen, device=dev).to(torch.bfloat16)
    ms_ci = clock.ms(lambda: int8_conv1d(xq, wm), iters)
    ms_cf = clock.ms(lambda: F.conv1d(xb, wc, padding=7), iters)
    rows.append({"shape": f"{name}_conv B={batch} T={t} {cin}->{cout}", "iters": iters,
                 "int8_ms": ms_ci, "int8_tops": _rates(flops, ms_ci),
                 "bf16_ms": ms_cf, "bf16_tflops": _rates(flops, ms_cf)})
    return rows


def run(device: torch.device, batch: int = 2048, iters: int = 8,
        dot: tuple = (65536, 2048)) -> dict:
    clock = Clock(device)
    with torch.no_grad():
        rows = [probe_dot(clock, *dot, iters)]
        for name, t, cin, cout in LAYERS:
            rows += probe_layer(clock, name, t, cin, cout, batch, iters)
    return {"device": torch.cuda.get_device_name(device) if clock.cuda else "cpu",
            "batch": batch, "peaks": {"int8_tops": H100_PEAKS["int8"] / 1e12,
                                      "bf16_tflops": H100_PEAKS["bf16"] / 1e12},
            "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2048, help="records of the layer geometries")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default=None, help="'cpu' for a host run; default the GPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dot = (65536, 2048) if device.type == "cuda" else (256, 64)
    print(json.dumps(run(device, args.batch, args.iters, dot)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
