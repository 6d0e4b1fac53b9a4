"""The z-score variants on the card, standalone (port of ``tools/probe_zscore.py``).

    python -m ptbxl_torch.tools.probe_zscore [--device cpu] [--cases] [--sweep]

Times each variant (``variants``) on one bf16 batch ``[PROBE_BS, 5000, 12]``
(default 11264, the JAX probe's headline geometry), ``PROBE_ITERS`` calls
(default 20) between CUDA events, median of 3, and prints microseconds a
record beside the variant's bytes bound (its input read once and its output
written once, at 3.35 TB/s).  Variants: the two-pass and one-pass torch forms
(f32 out), K1 ``zscore`` with bf16 out, and K5 ``zscore_wide`` with bf16 out
at ``block_b`` 4/8/16 and ``width`` 240/1200.  The in-model column
(``inmodel``, probe_zscore.py:131) runs the shipping int8 forward
(``ops/quant.py``, baseline checkpoint, robust calibration) on the same
batch with only the z-score form swapped: records/s of the forward with its
own one-pass z-score (``ship``), and of each variant's output fed to the
forward without normalization.  ``--device cpu`` runs it on the host at
``PROBE_BS`` (host clocks: no device measurement).

``--cases`` prints one JSON line: the z-score kernels at the main paths'
shapes (``CASES``: K1 f32 and its stats entry at B=1, 512 and 8192, K5
bf16 at 11264), each with its ms, bytes bound, PyTorch call and,
where the module plans clusters, its ``k`` and shared memory a CTA; and the
two paths the stats entry leads (``paths``): ``Predictor``'s kernel-engine
chunk at N=1 and the bench's hybrid row at B=8192.  It uses public entry points alone, so
``PYTHONPATH=<checkout> python ptbxl_torch/tools/probe_zscore.py --cases``
times another checkout (the parent unpacked under ``build/``).
``--sweep`` times each case under other cluster plans (k, records a
cluster, threads) beside ``cluster_plan``'s own choice.
"""

from __future__ import annotations

import argparse
import json
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


def inmodel(batch: torch.Tensor, iters: int = ITERS) -> Dict[str, float]:
    """Records/s of the int8 forward on ``batch`` with each z-score variant in
    front of it (``ship``: the forward's own one-pass z-score)."""
    from ptbxl_torch import bench
    from ptbxl_torch.models.params_io import load_checkpoint
    from ptbxl_torch.ops.quant import (make_quantized_forward, quantize_model, split_meta,
                                       to_device)

    clock = Clock(batch.device)
    state, _ = load_checkpoint(bench.CKPT)
    arrs, n_blocks, layers = split_meta(quantize_model(state, device=batch.device))
    arrs = to_device(arrs, batch.device)
    fwd_norm = make_quantized_forward(n_blocks, layers)
    fwd_raw = make_quantized_forward(n_blocks, layers, normalize=False)
    n = batch.shape[0]
    out = {}
    with torch.no_grad():
        out["ship"] = n / clock.ms(lambda: fwd_norm(arrs, batch), iters) * 1e3
        for name, zs in variants().items():
            out[name] = n / clock.ms(lambda: fwd_raw(arrs, zs(batch)), iters) * 1e3
    return out


# (name, entry, batch, input dtype): the main paths' z-score launches at [B, 5000, 12]
# (f32 K1 in chip_smoke's times, and at the hybrid row's batch; its stats entry
# before every K2/K3 chunk, N=1 the interactive one, and K4's first launch at the
# hybrid row's 8192; K5 the probe's)
CASES = (("k1_f32_b1", "zscore", 1, torch.float32),
         ("k1_f32_b512", "zscore", 512, torch.float32),
         ("k1_f32_b8192", "zscore", 8192, torch.float32),
         ("stats_f32_b1", "zscore_stats", 1, torch.float32),
         ("stats_f32_b512", "zscore_stats", 512, torch.float32),
         ("stats_f32_b8192", "zscore_stats", 8192, torch.float32),
         ("k5_bf16_b11264", "zscore_wide", 11264, torch.bfloat16))


def _case_call(entry: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if entry == "zscore":
        return kz.zscore
    if entry == "zscore_stats":
        return kz.zscore_stats
    return kz.zscore_wide


def _library_call(entry: str) -> Callable[[torch.Tensor], object]:
    """One PyTorch call for the same function: the one-pass torch form (the
    normalized tensor), ``torch.std_mean`` plus the eps (the stats)."""
    if entry == "zscore_stats":
        def std_mean(x):
            sd, mean = torch.std_mean(x.float(), dim=1, correction=0)
            return mean, sd + 1e-6
        return std_mean
    return zscore_per_lead_batch_onepass


def case_bound_ms(entry: str, x: torch.Tensor) -> float:
    """The input read once and the output (the tensor, or [B, C, 2] f32 stats) written once."""
    out = x.shape[0] * x.shape[2] * 8 if entry == "zscore_stats" else x.numel() * x.element_size()
    return (x.numel() * x.element_size() + out) / PEAK_BYTES * 1e3


def time_cases(device: torch.device, iters: int = 20) -> List[dict]:
    """Each case's ms (CUDA events, median of 3), bound and PyTorch call on one seeded batch."""
    clock = Clock(device)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    with torch.no_grad():
        for name, entry, b, dtype in CASES:
            x = (torch.randn(b, T, LEADS, generator=gen, device=device) * 2 + 1).to(dtype)
            fn = _case_call(entry)
            lib = _library_call(entry)
            row = {"case": name, "entry": entry, "batch": b, "dtype": str(dtype)[6:],
                   "ms": clock.ms(lambda: fn(x), iters), "bound_ms": case_bound_ms(entry, x),
                   "library_ms": clock.ms(lambda: lib(x), iters)}
            if hasattr(kz, "cluster_plan"):
                plan = _plan(entry, x)
                row.update(k=plan.k, smem_bytes=plan.smem_bytes)
            rows.append(row)
            del x
    return rows


def time_paths(device: torch.device, iters: int = 20) -> List[dict]:
    """Device ms of ``Predictor``'s kernel-engine chunk at N=1 (K1's stats, then
    K2) and of the bench's hybrid row at B=8192 (K1's stats, then K4)."""
    from ptbxl_torch import bench
    from ptbxl_torch.inference import Predictor

    clock = Clock(device)
    with torch.no_grad():
        pred = Predictor.from_checkpoint(bench.CKPT, engine="kernel")
        x1 = bench._random_batch(1, torch.float32, device)
        rows = [{"path": "predictor_kernel_n1", "batch": 1,
                 "ms": clock.ms(lambda: pred._forward(x1), iters)}]
        fwd = bench.build_forward("hybrid", "bf16", device)
        x = bench._random_batch(8192, torch.float32, device)
        rows.append({"path": "hybrid_row_b8192", "batch": 8192,
                     "ms": clock.ms(lambda: fwd(x), max(2, iters // 4))})
    return rows


def _plan(entry: str, x: torch.Tensor, k=None, per=None, threads=None):
    """The case's cluster plan (K5: width 480, block_b 8), or another one."""
    b, t, c = x.shape
    if entry == "zscore_wide":
        return kz.cluster_plan(b, t, c, 480, x.dtype, x.dtype, entry, k=k, per=8, threads=threads)
    return kz.cluster_plan(b, t, c, c, x.dtype, x.dtype, entry, k=k, per=per, threads=threads)


def sweep(device: torch.device, iters: int = 20) -> List[dict]:
    """Each case under other cluster plans: k in 2/4/8/16, for K1 records a
    cluster 1/2/4/8, threads 128/256; ``chosen`` marks ``cluster_plan``'s own."""
    clock = Clock(device)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    with torch.no_grad():
        for name, entry, b, dtype in CASES:
            x = (torch.randn(b, T, LEADS, generator=gen, device=device) * 2 + 1).to(dtype)
            chosen = _plan(entry, x)
            pers = (None,) if entry == "zscore_wide" else (1, 2, 4, 8)
            for k in (2, 4, 8, 16):
                for per in pers:
                    for threads in (128, 256):
                        try:
                            plan = _plan(entry, x, k=k, per=per, threads=threads)
                        except ValueError:
                            continue
                        ms = clock.ms(lambda: kz.launch_plan(x, plan, entry), iters)
                        rows.append({"case": name, "k": plan.k, "per": plan.per,
                                     "threads": plan.threads, "smem_bytes": plan.smem_bytes,
                                     "ms": ms, "chosen": plan == chosen})
            del x
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu' for a host run; default the GPU")
    ap.add_argument("--cases", action="store_true", help="time the main paths' cases (JSON)")
    ap.add_argument("--sweep", action="store_true", help="time each case under other plans (JSON)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.cases or args.sweep:
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        if args.cases:
            print(json.dumps({"device": name, "rows": time_cases(device),
                              "paths": time_paths(device)}))
        else:
            print(json.dumps({"device": name, "rows": sweep(device)}))
        return 0
    batch = make_batch(BS, device)
    print(f"# bs={BS} iters={ITERS} device={device.type}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    rows = run(batch)
    rps = inmodel(batch, max(2, ITERS // 4))
    print(f"{'variant':<16} {'us/rec':>9} {'bound us/rec':>13} {'ms':>9} {'in-model rec/s':>15}")
    print(f"{'ship (in fwd)':<16} {'-':>9} {'-':>13} {'-':>9} {rps['ship']:>15.0f}")
    for r in rows:
        print(f"{r['variant']:<16} {r['us_per_record']:>9.4f} {r['bound_us_per_record']:>13.4f} "
              f"{r['ms']:>9.3f} {rps[r['variant']]:>15.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
