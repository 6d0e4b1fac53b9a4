"""The phase-domain block's building forms at training shape (port of
``tools/probe_phase_forms.py``).

    python -m ptbxl_torch.tools.probe_phase_forms [--batch 4096] [--iters 10]
        [--dtype bf16|f32] [--t 5000] [--device cpu]

At the three even-length block geometries (T, Cin, Cout) = (5000, 12, 32),
(2500, 32, 64), (1250, 64, 128), channels first as the port runs them:

  conv_s1    the standard SAME stride-1 conv     [B, Ci, T]   -> [B, Co, T]
  conv_s2p   the stride-2 k+1 phase conv         [B, Ci, T]   -> [B, 2Co, U]
             (``ops/phase_conv.py::phase_conv_cf``, what ``phase_train``
             runs, its phase kernel built in the call)
  conv_pair  the pair-merged stride-1 conv, k=9  [B, 2Ci, U+8] -> [B, 2Co, U]
             (input positions paired into channels: a regrouping copy here,
             where JAX's channels-last reshape is free)
  tail4d     scale + ReLU + max over the phase axis of a [B, 2, Co, U] view
  tail3d     the same math on the two channel halves

plus each conv form's error against ``conv_s1`` (the largest difference
relative to the largest ``|conv_s1|``: the sums run over 15*Cin terms of
unit-normal data).  ``f32`` runs with TF32 off.  Times are CUDA events around
``--iters`` calls (``bench.Clock``); ``--device cpu`` runs it on the host at a
tiny size (host clocks: no device measurement).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from typing import List

import torch
import torch.nn.functional as F

from ptbxl_torch.bench import Clock
from ptbxl_torch.ops.phase_conv import build_phase_kernel, phase_conv_cf
from ptbxl_torch.tools.probe_train_gap import DTYPES, device_label
from ptbxl_torch.utils.device import highest_precision, resolve_device

K = 15
GEOMETRIES = ((12, 32), (32, 64), (64, 128))  # (Cin, Cout) of blocks 0-2; T halves each


def pair_kernel(wp: torch.Tensor) -> torch.Tensor:
    """The phase kernel [2Co, Ci, k+1] as a stride-1 kernel [2Co, 2Ci, 9] over
    position pairs of the input padded 8 a side: out[u] = sum_m xq[u+m] . w2[m],
    xq[v, j*Ci + c] = xpad[2v + j, c], tap k' = 2m + j - 1 of the phase kernel."""
    co2, ci, kp = wp.shape
    w2 = wp.new_zeros(co2, 2 * ci, 9)
    for m in range(9):
        for j in range(2):
            k = 2 * m + j - 1
            if 0 <= k < kp:
                w2[:, j * ci:(j + 1) * ci, m] = wp[:, :, k]
    return w2


def conv_pair(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    b, ci, t = x.shape
    xq = F.pad(x, (8, 8)).view(b, ci, (t + 16) // 2, 2).permute(0, 3, 1, 2)
    return F.conv1d(xq.reshape(b, 2 * ci, (t + 16) // 2), w2)


def _rel_err(got: torch.Tensor, ref: torch.Tensor, co: int) -> float:
    """Phase-major channels ``[j*Co + c]`` of ``got`` against ``ref [B, Co, T]``."""
    b, _, u = got.shape
    inter = got.view(b, 2, co, u).permute(0, 2, 3, 1).reshape(b, co, 2 * u)
    return float((inter.float() - ref.float()).abs().max() / ref.float().abs().max())


def run(batch: int = 4096, dtype_name: str = "bf16", t: int = 5000, iters: int = 10,
        device=None) -> List[dict]:
    """One row a geometry: each form's ms a pass and the conv forms' errors."""
    dev = resolve_device(device)
    clock = Clock(dev)
    dtype = DTYPES[dtype_name][0]
    scope = highest_precision if dtype == torch.float32 else contextlib.nullcontext
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for i, (ci, co) in enumerate(GEOMETRIES):
        tt = t >> i
        u = tt // 2
        x = torch.randn(batch, ci, tt, generator=gen, device=dev).to(dtype)
        w = torch.randn(co, ci, K, generator=gen, device=dev).to(dtype)
        wp = build_phase_kernel(w.permute(2, 1, 0)).permute(2, 1, 0).contiguous()
        w2 = pair_kernel(wp)
        h2 = torch.randn(batch, 2 * co, u, generator=gen, device=dev).to(dtype)
        sc = torch.randn(2 * co, 1, generator=gen, device=dev).to(dtype)
        forms = {
            "conv_s1": lambda: F.conv1d(x, w, padding=K // 2),
            "conv_s2p": lambda: phase_conv_cf(x, w),
            "conv_pair": lambda: conv_pair(x, w2),
            "tail4d": lambda: torch.relu(h2 * sc).view(batch, 2, co, u).amax(dim=1),
            "tail3d": lambda: torch.maximum(*torch.relu(h2 * sc).split(co, dim=1)),
        }
        row = {"T": tt, "Ci": ci, "Co": co, "batch": batch, "dtype": dtype_name}
        with scope(), torch.no_grad():
            ref = forms["conv_s1"]()
            row["err_s2p"] = _rel_err(forms["conv_s2p"](), ref, co)
            row["err_pair"] = _rel_err(forms["conv_pair"](), ref, co)
            del ref
            for name, fn in forms.items():
                row[f"{name}_ms"] = clock.ms(fn, iters)
        rows.append(row)
        del x, h2
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
    print(f"batch={args.batch} dtype={args.dtype} iters={args.iters} "
          f"device={device_label(dev)}"
          "  (ms a pass)")
    for r in run(args.batch, args.dtype, args.t, args.iters, dev):
        print(f"T={r['T']} Ci={r['Ci']} Co={r['Co']}  (form err s2p {r['err_s2p']:.1e} "
              f"pair {r['err_pair']:.1e}, relative to max|conv_s1|)")
        for name in ("conv_s1", "conv_s2p", "conv_pair", "tail4d", "tail3d"):
            print(f"  {name:9s} {r[f'{name}_ms']:7.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
