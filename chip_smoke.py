#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the hand-written kernels from ``ptbxl_torch/csrc`` with nvcc, holds
each against its plain PyTorch version on the card (K1 z-score, K2 ECGCNN
forward, K3 FiLM multimodal forward), drives the main paths (``Predictor``
on the baseline and AF checkpoints, then on the multimodal checkpoint with
demo vectors, Grad-CAM and demo importance on both), checks them against the
golden outputs, and times the kernels beside their plain versions, the
framework (cuDNN) path and their bounds.  The launch counters are set to 0
just before each main path and read just after it.  Each phase
prints one JSON line; any failure raises and exits non-zero.  The last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
non-zero and prints no result.  Imports nothing of JAX or ptbxl_tpu.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "outputs/ecg_baseline/ckpts/ecg_baseline_best.npz")
CKPT_AF = os.path.join(ROOT, "outputs/af_binary/ckpts/af_binary_best.npz")
CKPT_MM = os.path.join(ROOT, "outputs/ecg_multimodal/ckpts/ecg_multimodal_best.npz")
GOLD = os.path.join(ROOT, "tests/golden")
DEMO = os.path.join(ROOT, "data/demo/single")
DEMO_MM = os.path.join(ROOT, "data/demo/multimodal")
T_FULL, LEADS, BIG = 5000, 12, 512

# H100 SXM published peaks (NVIDIA data sheet): FP32 without tensor cores, HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def gate(name: str, err: float, tol: float) -> float:
    if not err <= tol:
        raise AssertionError(f"{name}: max |diff| {err:.3e} > {tol:.1e}")
    return err


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def demo_signals() -> np.ndarray:
    files = sorted(glob.glob(os.path.join(DEMO, "*.npz")))
    return np.stack([np.load(f, allow_pickle=True)["ecg"] for f in files])  # [7, 12, T]


def mm_demo_pack() -> tuple:
    """The 7 multimodal demo records: signals [7, 12, T] and demo vectors [7, 5]."""
    packs = [np.load(f, allow_pickle=True) for f in sorted(glob.glob(os.path.join(DEMO_MM, "*.npz")))]
    return (np.stack([z["ecg"] for z in packs]),
            np.stack([z["demo"] for z in packs]).astype(np.float32))


def raw_batch(b: int, gen: torch.Generator, scale_lo: float = 0.5,
              offset_sd: float = 1.0) -> torch.Tensor:
    """Raw-like [B, T, 12] f32 signals on the card: noise with per-lead scale in
    [scale_lo, 2.5] and offset ~ N(0, offset_sd); the defaults are like the unit
    tests' data (normal * 4 + 2)."""
    x = torch.randn(b, T_FULL, LEADS, generator=gen, device="cuda")
    scale = torch.rand(b, 1, LEADS, generator=gen, device="cuda") * (2.5 - scale_lo) + scale_lo
    offset = torch.randn(b, 1, LEADS, generator=gen, device="cuda") * offset_sd
    return x * scale + offset


def demo_batch(b: int, gen: torch.Generator) -> torch.Tensor:
    """[B, 5] demo vectors on the card in the demo pack's range: age U[0.6, 0.9],
    sex 0.5, height U[0, 0.8], weight U[0, 0.45], pacemaker 0."""
    u = torch.rand(b, 3, generator=gen, device="cuda")
    half, zero = torch.full((b,), 0.5, device="cuda"), torch.zeros(b, device="cuda")
    return torch.stack([0.6 + 0.3 * u[:, 0], half, 0.8 * u[:, 1], 0.45 * u[:, 2], zero], dim=1)


def k2_flops_bytes(x: torch.Tensor, folded) -> tuple:
    """Operations and bytes the fused forward needs for x (pool-floor rows only)."""
    b, t, c = x.shape
    flops = 0
    for i in range(int(folded["n_blocks"])):
        w = folded[f"w{i}"]
        flops += 2 * w.shape[0] * w.shape[1] * w.shape[2] * 2 * (t // 2) * b
        t //= 2
    pw, hw = folded["proj_w"], folded["head_w"]
    flops += 2 * b * (pw.numel() + hw.numel())
    weight_bytes = sum(v.numel() * 4 for k, v in folded.items() if k != "n_blocks")
    return flops, x.numel() * 4 + weight_bytes + b * hw.shape[1] * 4


def k3_flops_bytes(x: torch.Tensor, d: torch.Tensor, folded) -> tuple:
    """K2's count on the multimodal backbone + head, plus the demo MLP, FiLM and demo bytes."""
    flops, nbytes = k2_flops_bytes(x, folded)
    b, feat = x.shape[0], folded["proj_w"].shape[1]
    flops += 2 * b * sum(folded[k].numel() for k in ("fc1_w", "fc2_w", "film_w"))
    flops += 3 * b * feat  # gamma = 1 + tanh, gamma * z + beta
    return flops, nbytes + d.numel() * 4


def launch_breakdown(fn) -> list:
    """[name, device ms] of each kernel ``fn`` launches, from the profiler (CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    return [[e.name[:60], e.device_time_total / 1e3] for e in events]


def bound(flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ptbxl_torch.inference import Predictor
    from ptbxl_torch.interpret.grad_cam import GradCAM, demo_importance
    from ptbxl_torch.models.factory import load_ecgcnn, load_multimodal
    from ptbxl_torch.models.params_io import load_checkpoint
    from ptbxl_torch.ops.kernels import _build, fused_ecgcnn as k2, zscore as k1
    from ptbxl_torch.ops.preprocess import zscore_per_lead_batch_onepass

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    # -- phase 1: the card and the build ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.time()
    libs = _build.build_all()
    build_s = time.time() - t0
    ptxas = {}
    for stem, path in libs.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[stem] = [ln.split("info    : ")[-1] for ln in lines if "Used" in ln or "spill" in ln]
    emit({"phase": "card", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_seconds": round(build_s, 3), "ptxas": ptxas})

    # -- phase 2: K1 against its plain version --------------------------------
    x_raw = raw_batch(BIG, gen)
    err_k1 = gate("zscore f32", max_diff(k1.zscore(x_raw), k1.zscore_plain(x_raw)), 1e-5)
    x16 = x_raw.to(torch.bfloat16)
    err_k1_16 = gate("zscore bf16", max_diff(k1.zscore(x16), k1.zscore_plain(x16)), 2e-2)
    err_st = gate("zscore_stats", max_diff(k1.zscore_stats(x_raw), k1.zscore_stats_plain(x_raw)),
                  1e-5)
    # harsher data: a large DC offset beside a small std (per-lead offset N(0, 3),
    # scale down to 0.1), where f32 sums in one order or another lose bits
    x_harsh = raw_batch(BIG, gen, scale_lo=0.1, offset_sd=3.0)
    err_harsh = gate("zscore f32 harsh", max_diff(k1.zscore(x_harsh), k1.zscore_plain(x_harsh)),
                     1e-5)
    err_st_harsh = gate("zscore_stats harsh", max_diff(k1.zscore_stats(x_harsh),
                                                       k1.zscore_stats_plain(x_harsh)), 1e-5)
    del x_harsh
    torch.cuda.synchronize()
    emit({"phase": "k1", "shape": list(x_raw.shape), "max_abs_err_f32": err_k1,
          "max_abs_err_bf16": err_k1_16, "max_abs_err_stats": err_st,
          "max_abs_err_f32_harsh": err_harsh, "max_abs_err_stats_harsh": err_st_harsh})

    # -- phase 3: K2 against its plain version --------------------------------
    state, _ = load_checkpoint(CKPT)
    folded = k2.fold_bn_into_conv({k: v.to(dev) for k, v in state.items()})
    x_demo = torch.from_numpy(demo_signals().transpose(0, 2, 1).copy()).to(dev)
    x_odd = raw_batch(2, gen)[:, :500].contiguous()  # 500 -> 250 -> 125 -> 62 -> 31: odd floors
    cases = {"1": x_raw[:1], "7": x_demo, str(BIG): x_raw, "2 T=500": x_odd}
    k2_err = {}
    for b, xb in cases.items():
        for normalize in (True, False):
            xin = xb if normalize else k1.zscore_plain(xb)
            for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 5e-3)):
                got = k2.fused_ecgcnn_probs(xin, folded, dt, normalize)
                want = torch.sigmoid(k2.fused_ecgcnn_logits_plain(xin, folded, dt, normalize))
                name = f"B={b} normalize={normalize} {str(dt)[6:]}"
                k2_err[name] = gate(f"fused_ecgcnn {name}", max_diff(got, want), tol)
    torch.cuda.synchronize()
    emit({"phase": "k2", "max_abs_err": k2_err})

    # -- phase 3b: K3 against its plain version -------------------------------
    state_mm, _ = load_checkpoint(CKPT_MM, arch="multimodal")
    folded_mm = k2.fold_multimodal({k: v.to(dev) for k, v in state_mm.items()})
    sigs_mm, demos_mm = mm_demo_pack()
    x_mm = torch.from_numpy(sigs_mm.transpose(0, 2, 1).copy()).to(dev)
    d_mm = torch.from_numpy(demos_mm).to(dev)
    d_big = demo_batch(BIG, gen)
    cases_mm = {"1": (x_raw[:1], d_big[:1]), "7": (x_mm, d_mm), str(BIG): (x_raw, d_big),
                "2 T=500": (x_odd, demo_batch(2, gen))}
    k3_err = {}
    for b, (xb, db) in cases_mm.items():
        for normalize in (True, False):
            xin = xb if normalize else k1.zscore_plain(xb)
            for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 5e-3)):
                got = k2.fused_multimodal_probs(xin, db, folded_mm, dt, normalize)
                want = torch.sigmoid(k2.fused_multimodal_logits_plain(xin, db, folded_mm, dt,
                                                                      normalize))
                name = f"B={b} normalize={normalize} {str(dt)[6:]}"
                k3_err[name] = gate(f"fused_multimodal {name}", max_diff(got, want), tol)
    torch.cuda.synchronize()
    emit({"phase": "k3", "max_abs_err": k3_err})

    # -- phase 4: the main path, Predictor on the card --------------------------
    g_base = np.load(os.path.join(GOLD, "golden_baseline.npz"))
    g_af = np.load(os.path.join(GOLD, "golden_af.npz"))
    sigs = demo_signals()
    requests = x_raw.transpose(1, 2).cpu().numpy()  # [512, 12, T] raw, reference layout
    k1.launches = 0
    k2.launches = 0
    p_auto = Predictor.from_checkpoint(CKPT)
    probs_demo = p_auto(sigs)
    probs_big = p_auto(requests)
    p_af = Predictor.from_checkpoint(CKPT_AF, num_labels=1)
    probs_af = p_af(sigs)
    torch.cuda.synchronize()
    launches = {"zscore": k1.launches, "fused_ecgcnn": k2.launches}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path launched no {name} kernel")
    main_errs = {
        "auto_vs_golden": gate("Predictor auto", float(np.abs(probs_demo - g_base["probs"]).max()),
                               5e-4),
        "af_vs_golden": gate("Predictor AF", float(np.abs(probs_af - g_af["probs"]).max()), 5e-4),
    }
    p_hi = Predictor.from_checkpoint(CKPT, engine="framework")
    p_lo = Predictor.from_checkpoint(CKPT, engine="framework", precision="default")
    hi_demo, lo_demo = p_hi(sigs), p_lo(sigs)
    main_errs["framework_highest_vs_golden"] = gate(
        "framework highest", float(np.abs(hi_demo - g_base["probs"]).max()), 5e-4)
    main_errs["framework_default_vs_highest"] = gate(
        "framework default", float(np.abs(lo_demo - hi_demo).max()), 5e-3)
    # kernel engine vs framework f32 on raw requests: two f32 algorithms, sums in other orders
    main_errs["auto_vs_framework_raw512"] = gate(
        "kernel vs framework raw", float(np.abs(probs_big - p_hi(requests)).max()), 1e-4)
    if not (np.isfinite(probs_big).all() and probs_big.shape == (BIG, 5)):
        raise AssertionError(f"bad Predictor output {probs_big.shape}")
    emit({"phase": "predictor", "launches": launches, "max_abs_err": main_errs})

    # -- phase 4b: the multimodal main path, Predictor with demo vectors ---------
    g_mm = np.load(os.path.join(GOLD, "golden_multimodal.npz"))
    req_demo = d_big.cpu().numpy()
    k1.launches = 0
    k2.launches = 0
    k2.launches_mm = 0
    p_mm = Predictor.from_checkpoint(CKPT_MM, arch="multimodal")
    probs_mm_demo = p_mm(sigs_mm, demo=demos_mm)
    probs_mm_big = p_mm(requests, demo=req_demo)
    torch.cuda.synchronize()
    launches_mm = {"zscore": k1.launches, "fused_ecgcnn": k2.launches,
                   "fused_multimodal": k2.launches_mm}
    for name in ("zscore", "fused_multimodal"):
        if launches_mm[name] <= 0:
            raise AssertionError(f"multimodal main path launched no {name} kernel")
    if launches_mm["fused_ecgcnn"]:
        raise AssertionError("multimodal main path launched the ECGCNN kernel")
    mm_errs = {"auto_vs_golden": gate("Predictor mm auto",
                                      float(np.abs(probs_mm_demo - g_mm["probs"]).max()), 5e-4)}
    p_mm_hi = Predictor.from_checkpoint(CKPT_MM, arch="multimodal", engine="framework")
    p_mm_lo = Predictor.from_checkpoint(CKPT_MM, arch="multimodal", engine="framework",
                                        precision="default")
    hi_mm, lo_mm = p_mm_hi(sigs_mm, demo=demos_mm), p_mm_lo(sigs_mm, demo=demos_mm)
    mm_errs["framework_highest_vs_golden"] = gate(
        "mm framework highest", float(np.abs(hi_mm - g_mm["probs"]).max()), 5e-4)
    mm_errs["framework_default_vs_highest"] = gate(
        "mm framework default", float(np.abs(lo_mm - hi_mm).max()), 5e-3)
    mm_errs["auto_vs_framework_raw512"] = gate(
        "mm kernel vs framework raw",
        float(np.abs(probs_mm_big - p_mm_hi(requests, demo=req_demo)).max()), 1e-4)
    if not (np.isfinite(probs_mm_big).all() and probs_mm_big.shape == (BIG, 5)):
        raise AssertionError(f"bad multimodal Predictor output {probs_mm_big.shape}")
    emit({"phase": "predictor_mm", "launches": launches_mm, "max_abs_err": mm_errs})

    # -- phase 5: Grad-CAM on the card -----------------------------------------
    model, _ = load_ecgcnn(CKPT, strict=False)
    cam_demo = GradCAM(model, signal_length=T_FULL, norm_first=False, eps=1e-9)
    cam_lib = GradCAM(model, signal_length=T_FULL, norm_first=True)
    pr, cam = cam_demo(x_demo, class_idx=0)
    _, caml = cam_lib(x_demo, class_idx=0)
    cam_errs = {
        "probs": gate("cam probs", float(np.abs(pr.cpu().numpy() - g_base["probs"]).max()), 2e-5),
        "cam_demo": gate("cam_demo", float(np.abs(cam.cpu().numpy() - g_base["cam_demo"]).max()),
                         2e-3),
        "cam_library": gate("cam_library",
                            float(np.abs(caml.cpu().numpy() - g_base["cam_library"]).max()), 2e-3),
    }
    emit({"phase": "grad_cam", "max_abs_err": cam_errs})

    # -- phase 5b: multimodal Grad-CAM and demo importance on the card ----------
    model_mm, _ = load_multimodal(CKPT_MM)
    cam_mm = GradCAM(model_mm, signal_length=T_FULL, norm_first=False, eps=1e-8, multimodal=True)
    pr_mm, c_mm = cam_mm(x_mm, class_idx=0, x_demo=d_mm)
    imp = torch.stack([demo_importance(model_mm, x_mm[i:i + 1], d_mm[i:i + 1], 0)
                       for i in range(x_mm.shape[0])])
    cam_mm_errs = {
        "probs": gate("mm cam probs", float(np.abs(pr_mm.cpu().numpy() - g_mm["probs"]).max()),
                      2e-5),
        "cam": gate("mm cam", float(np.abs(c_mm.cpu().numpy() - g_mm["cam"]).max()), 2e-3),
        "demo_importance": gate(
            "demo_importance", float(np.abs(imp.cpu().numpy() - g_mm["demo_importance"]).max()),
            1e-4),
    }
    emit({"phase": "grad_cam_mm", "max_abs_err": cam_mm_errs})

    # -- phase 6: times --------------------------------------------------------
    times = {}
    for b in (1, BIG):
        xb = x_raw[:b].contiguous()
        k2_flops, k2_bytes = k2_flops_bytes(xb, folded)
        k1_bytes = 2 * xb.numel() * 4
        times[b] = {
            "fused_ecgcnn": {
                "ms": time_ms(lambda: k2.fused_ecgcnn_logits(xb, folded)),
                "plain_ms": time_ms(lambda: k2.fused_ecgcnn_logits_plain(xb, folded)),
                # the framework engine: z-score + cuDNN model (f32 TF32 off; bf16)
                "library_ms": time_ms(lambda: p_hi._forward(xb)),
                "library_bf16_ms": time_ms(lambda: p_lo._forward(xb)),
                "bound": bound(k2_flops, k2_bytes),
            },
            "zscore": {
                "ms": time_ms(lambda: k1.zscore(xb)),
                "plain_ms": time_ms(lambda: k1.zscore_plain(xb)),
                "library_ms": time_ms(lambda: zscore_per_lead_batch_onepass(xb)),
                "stats_ms": time_ms(lambda: k1.zscore_stats(xb)),
                "bound": bound(6 * xb.numel(), k1_bytes),
            },
        }
        db = d_big[:b].contiguous()
        times[b]["fused_multimodal"] = {
            "ms": time_ms(lambda: k2.fused_multimodal_logits(xb, db, folded_mm)),
            "plain_ms": time_ms(lambda: k2.fused_multimodal_logits_plain(xb, db, folded_mm)),
            # the framework engine: z-score + cuDNN multimodal model (f32 TF32 off; bf16)
            "library_ms": time_ms(lambda: p_mm_hi._forward(xb, db)),
            "library_bf16_ms": time_ms(lambda: p_mm_lo._forward(xb, db)),
            "bound": bound(*k3_flops_bytes(xb, db, folded_mm)),
        }
    grad_cam_ms = {str(b): time_ms(lambda: cam_demo(x_demo[:b], class_idx=0)) for b in (1, 7)}
    grad_cam_mm_ms = {str(b): time_ms(lambda: cam_mm(x_mm[:b], class_idx=0, x_demo=d_mm[:b]))
                      for b in (1, 7)}
    emit({"phase": "times", "batch": {str(b): t for b, t in times.items()},
          "grad_cam_ms": grad_cam_ms, "grad_cam_mm_ms": grad_cam_mm_ms})

    # engine crossover: device time of one Predictor chunk, kernel vs framework
    p_kern = Predictor.from_checkpoint(CKPT, engine="kernel")
    crossover = {}
    for b in (1, 8, 32, 64, 128, 256, 512, 1024):
        xb = raw_batch(b, gen)
        crossover[b] = {
            "kernel_ms": time_ms(lambda: p_kern._forward(xb), reps=5),
            "framework_f32_ms": time_ms(lambda: p_hi._forward(xb), reps=5),
            "framework_bf16_ms": time_ms(lambda: p_lo._forward(xb), reps=5),
        }
    emit({"phase": "crossover", "ms": crossover})

    # the same for the multimodal Predictor (K3 vs the framework engine)
    p_mm_kern = Predictor.from_checkpoint(CKPT_MM, arch="multimodal", engine="kernel")
    crossover_mm = {}
    for b in (1, 8, 32, 64, 512):
        xb, db = raw_batch(b, gen), demo_batch(b, gen)
        crossover_mm[b] = {
            "kernel_ms": time_ms(lambda: p_mm_kern._forward(xb, db), reps=5),
            "framework_f32_ms": time_ms(lambda: p_mm_hi._forward(xb, db), reps=5),
            "framework_bf16_ms": time_ms(lambda: p_mm_lo._forward(xb, db), reps=5),
        }
    emit({"phase": "crossover_mm", "ms": crossover_mm})

    # where K2's and K3's time goes: per-launch device time from the profiler (CUPTI)
    breakdown, breakdown_mm = {}, {}
    for b in (1, BIG):
        xb, db = x_raw[:b].contiguous(), d_big[:b].contiguous()
        breakdown[b] = launch_breakdown(lambda: k2.fused_ecgcnn_logits(xb, folded))
        breakdown_mm[b] = launch_breakdown(lambda: k2.fused_multimodal_logits(xb, db, folded_mm))
    emit({"phase": "k2_breakdown_ms", "batch": {str(b): v for b, v in breakdown.items()}})
    emit({"phase": "k3_breakdown_ms", "batch": {str(b): v for b, v in breakdown_mm.items()}})

    big = times[BIG]
    one = times[1]
    sources = {
        "zscore": ("ptbxl_torch/csrc/zscore.cu", "ptbxl_tpu/ops/pallas/zscore.py:44",
                   max(err_k1, err_st, err_harsh, err_st_harsh)),
        "fused_ecgcnn": ("ptbxl_torch/csrc/fused_ecgcnn.cu",
                         "ptbxl_tpu/ops/pallas/fused_ecgcnn.py:89",
                         max(v for k, v in k2_err.items() if k.endswith("float32"))),
        "fused_multimodal": ("ptbxl_torch/csrc/fused_ecgcnn.cu",
                             "ptbxl_tpu/ops/pallas/fused_ecgcnn.py:260",
                             max(v for k, v in k3_err.items() if k.endswith("float32"))),
    }
    # launches on the main paths: the baseline/AF path and the multimodal path
    by_path = {name: {"ecgcnn": launches.get(name, 0), "multimodal": launches_mm[name]}
               for name in sources}
    kernels = []
    for name, (src, replaces, err) in sources.items():
        t5, t1 = big[name], one[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
            "max_abs_err": err,
            "ms": t5["ms"], "plain_ms": t5["plain_ms"], "bound_ms": t5["bound"][0],
            "bound_by": t5["bound"][1], "library_ms": t5["library_ms"], "batch": BIG,
            "ms_b1": t1["ms"], "plain_ms_b1": t1["plain_ms"], "bound_ms_b1": t1["bound"][0],
            "library_ms_b1": t1["library_ms"],
        }
        if name != "zscore":
            errs = k2_err if name == "fused_ecgcnn" else k3_err
            entry["max_abs_err_bf16"] = max(v for k, v in errs.items() if k.endswith("bfloat16"))
            entry["library_bf16_ms"] = t5["library_bf16_ms"]
        else:
            entry["max_abs_err_bf16"] = err_k1_16
            entry["stats_ms"] = t5["stats_ms"]
        kernels.append(entry)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
