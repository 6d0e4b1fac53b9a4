#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the hand-written kernels from ``ptbxl_torch/csrc`` with nvcc, holds
each against its plain PyTorch version on the card (K1 z-score at B=1, 512
and 8192, on a ragged T=37 through clusters of 2, 4 and 8 CTAs, its output
bit for bit against ``(x - mean) / sd`` from its own stats, its division
against IEEE division; K2 ECGCNN forward and each of its four 3xTF32 conv
blocks, K3 FiLM multimodal forward, K6 ReLU -> MaxPool backward, K4 hybrid
forward and each of its four ``wgmma`` conv blocks, K5 wide z-score (the
ragged T=37 too), P3 and P4 conv layers (both on K4's ``wgmma``
block: P3's output on a zero-padded input also bit for bit against K4's
launch), the 13 P1/P2 probes, each probe also timed in a CUDA graph, and
P1's TF32 dot and shifted concat beyond the probes' shapes: the dot at the
smallest shape its plan admits, with several tiles and K != 256 and at the
largest K, both forms, its rounding against ``tf32_round``, the concat on its
float4 and 4-byte paths, at an odd row count and on a misaligned view), drives
the main paths (``Predictor`` on the baseline and AF checkpoints, then on the
multimodal checkpoint with demo vectors, Grad-CAM and demo importance on both,
then ``train`` on the baseline ECGCNN at full width with a reload of its best
checkpoint, then the port bench's hybrid row and the tool probes' functions at
their shapes, then the PTB-XL data layer, CLIs 03-08 and 12, the eval path after
them (09, 10, 14-17, 00's pack and exports, 02, printsize, Grad-CAM CLIs 11 and
13, the demo CLI) and the bench's pipeline rows on a synthetic PTB-XL tree of
[12, 5000] records made under ``build/``; then what the trainer gained beside
the step: the step timer, a trace, the numerics switch, the signal ops and
equal-seed epochs; then the data-parallel path: a 1-rank NCCL group, two
gloo ranks on the one card running ``dryrun_multichip(2)`` and a trainer
epoch on that tree, and ``Predictor(data_parallel=True)``; then the int8 path,
each int8 layer's ``torch._int_mm`` exactly against its plain version, the
int8 ``Predictor`` and the 519-signal battery gated, the card against the
CPU, ms and memory at 8192 beside framework bf16 and K4; then the serving
export, every artifact variant exported with ``torch.export``, reloaded and
held against its ``Predictor``, K1/K2/K3 launched from the kernel-engine
artifacts; then the phase-domain training alternatives at full width: a
``phase_train`` step of each checkpoint's model against the standard step
(f32 and bf16, K6 one launch a step against four), ``phase_conv``,
``conv1d_fast_wgrad`` at every block's geometry and the phase-packed front
at B=8192; the four training-backward probes and ``proto_int8``; CLI 01
against a loopback HTTP mirror of the synthetic tree; the WFDB codec fuzz, 1,600 random
records of every format; the JAX package's identical-seeds contract on the card
(one epoch of the tree's train split twice at seed 3, bit for bit, and seed 4
apart, for the ECGCNN in f32 and bf16 and the multimodal model); the training
showdown: the port trained to completion on
the synthetic mini-PTB-XL with the stored configs of JAX's committed artifacts
``outputs/showdown/jax*.json``, labels equal to theirs, each family's final
macro-AUROC within 0.005 of JAX's, one seed twice with equal test
probabilities), checks them against the golden
outputs, the demo-pack parity gate, the JAX scripts' CSV schemas, ``Predictor``,
``GradCAM``, ``compute_metrics`` and ``per_class_scores``, and times the kernels, the
train step and the epoch beside their plain versions, the framework (cuDNN,
torch's own pool backward) path and their bounds; the crossover sweeps give
``Predictor``'s two engine limits, f32 and bf16, and fail below the shipped ones.  The launch counters are set
to 0 just before each main path and read just after it.  Each phase prints one
JSON line; any failure raises and exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero and
prints no result.  Imports nothing of JAX or ptbxl_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import http.server
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "outputs/ecg_baseline/ckpts/ecg_baseline_best.npz")
CKPT_AF = os.path.join(ROOT, "outputs/af_binary/ckpts/af_binary_best.npz")
CKPT_MM = os.path.join(ROOT, "outputs/ecg_multimodal/ckpts/ecg_multimodal_best.npz")
GOLD = os.path.join(ROOT, "tests/golden")
DEMO = os.path.join(ROOT, "data/demo/single")
DEMO_MM = os.path.join(ROOT, "data/demo/multimodal")
T_FULL, LEADS, BIG = 5000, 12, 512
CLASSES = ["MI", "STTC", "HYP", "CD", "NORM"]
# the training path: configs/ecg_baseline.yaml's batch, lr and weight decay
TRAIN_B, TRAIN_LR, TRAIN_WD, TRAIN_EPOCHS = 64, 1.5e-3, 1e-4, 2
TRAIN_N, VAL_N = 256, 64
TRAIN_B_BIG = 256  # the second train-step timing batch
EPOCH_N, VAL_EPOCH_N = 2048, 512  # the timed epoch: 32 steps at B=64; 8 val batches
# the reference's metrics CSV header (ptbxl_tpu/utils/csv_log.py:14-25)
CSV_HEADER = ["datetime", "run_name", "epoch", "train_bce", "val_auroc_macro",
              "val_auprc_macro", "val_f1_macro", "val_bce_loss", "ckpt_path", "config_path"]

# H100 SXM published peaks (NVIDIA data sheet): FP32 without tensor cores,
# dense TF32 and bf16 on the tensor cores, HBM3.
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
HYBRID_B = 8192  # the port bench's hybrid row (bench.py:353)
PROBE_ZS_B = 11264  # tools/probe_zscore.py's batch
PROBE_LAYER_B = 2048  # tools/probe_layer_perf.py's and tools/probe_sublane_conv.py's batch
DATA_N = 1024  # records of the synthetic PTB-XL tree the data, CLI phases read


START = time.monotonic()


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it ended (s since start)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.monotonic() - START, 3)}
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


def launch_breakdown(fn, attempts: int = 3) -> list:
    """[name, device ms] of each kernel ``fn`` launches, from the profiler (CUPTI).

    The profiler can miss the first launches of a window, so each window is a
    traced warm-up step that is discarded (a call), then the kept step: a call,
    a marker kernel (torch.cuda._sleep's spin_kernel) and the call that is
    kept.  A window whose marker was lost, or that recorded nothing after it,
    is profiled again, up to ``attempts`` windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            fn()
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
            prof.step()
        # user annotations (e.g. the optimizer's step range) sit on the device
        # timeline too; only kernels, copies and sets are kept
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False)),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        if marks and marks[-1] + 1 < len(events):
            return [[e.name[:60], e.device_time_total / 1e3] for e in events[marks[-1] + 1:]]
    raise AssertionError(f"launch_breakdown: no marker kernel and launches after it "
                         f"in {attempts} profiled windows")


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32) -> tuple:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def by_kernel(launches: list, top: int = 25) -> dict:
    """Per-launch [name, ms] -> total ms, launch count and the ``top`` kernels by time."""
    agg = {}
    for name, ms in launches:
        n, t = agg.get(name, (0, 0.0))
        agg[name] = (n + 1, t + ms)
    rows = sorted(([k, n, t] for k, (n, t) in agg.items()), key=lambda r: -r[2])
    return {"total_ms": sum(r[2] for r in rows), "launches": len(launches), "top": rows[:top]}


class RawECGSet:
    """An in-memory training set made from a seed: raw-like [12, 5000] records
    (noise with per-lead scale U[0.5, 2.5] and offset N(0, 1)) and 5-label
    targets.  The trainer reads it through ``get_raw``."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        self.x = rng.standard_normal((n, LEADS, T_FULL), dtype=np.float32)
        self.x *= rng.uniform(0.5, 2.5, (n, LEADS, 1)).astype(np.float32)
        self.x += rng.standard_normal((n, LEADS, 1)).astype(np.float32)
        self.y = (rng.uniform(size=(n, 5)) > 0.7).astype(np.float32)

    def __len__(self) -> int:
        return len(self.y)

    def get_raw(self, idx: int) -> np.ndarray:
        return self.x[idx]


def k6_shapes(b: int) -> list:
    """K6's inputs in one ECGCNN train step at T=5000: h [B, C, T] of each block."""
    return [(b, 32, 5000), (b, 64, 2500), (b, 128, 1250), (b, 256, 625)]


def k6_bytes_ops(pairs) -> tuple:
    """Bytes K6 must move (h and g read once, dh written once in g's dtype) and
    its operations (~8 a window: 2 relus, a max, 2 compares, a division, 2 selects)."""
    nbytes = ops = 0
    for h, g in pairs:
        nbytes += (h.numel() * h.element_size() + g.numel() * g.element_size()
                   + h.numel() * g.element_size())
        ops += 8 * g.numel()
    return ops, nbytes


def phase_k6(gen: torch.Generator) -> tuple:
    """K6 against its plain version at the four block shapes of a B=64 train step
    (f32 and bf16), on inputs with many exact positive ties and on the tie case
    of tests/test_relu_pool.py:60-67; and against torch's autograd of
    relu(max_pool1d(h)).  A select and a division by 1 or 2: every gate is 0.0."""
    from ptbxl_torch.ops.kernels import relu_pool as k6

    k6_err = {}
    for dt in (torch.float32, torch.bfloat16):
        for shape in k6_shapes(TRAIN_B):
            h = torch.randn(shape, generator=gen, device="cuda").to(dt)
            g = torch.randn(*shape[:2], shape[2] // 2, generator=gen, device="cuda").to(dt)
            name = f"{list(shape)} {str(dt)[6:]}"
            k6_err[name] = gate(f"relu_pool_bwd {name}",
                                max_diff(k6.relu_pool_bwd(h, g), k6.relu_pool_bwd_plain(h, g)), 0.0)
        # many exact positive ties (quarter steps), an odd T among them
        for shape in ((TRAIN_B, 64, 2500), (TRAIN_B, 256, 625)):
            h = (torch.round(torch.randn(shape, generator=gen, device="cuda") * 4) / 4).to(dt)
            g = torch.randn(*shape[:2], shape[2] // 2, generator=gen, device="cuda").to(dt)
            name = f"{list(shape)} {str(dt)[6:]} ties"
            k6_err[name] = gate(f"relu_pool_bwd {name}",
                                max_diff(k6.relu_pool_bwd(h, g), k6.relu_pool_bwd_plain(h, g)), 0.0)
    h_tie = torch.tensor([[[2.0, 2.0, 3.0, 1.0, -1.0, -2.0]]], device="cuda")
    dh_tie = k6.relu_pool_bwd(h_tie, torch.tensor([[[4.0, 6.0, 8.0]]], device="cuda"))
    if dh_tie[0, 0].tolist() != [2.0, 2.0, 6.0, 0.0, 0.0, 0.0]:
        raise AssertionError(f"relu_pool_bwd tie split: {dh_tie[0, 0].tolist()}")
    # torch's autograd of relu(max_pool1d(h)) routes a tie to its first element;
    # away from exact positive ties the two are the same function
    k6_autograd = {}
    for shape in k6_shapes(TRAIN_B):
        h = torch.randn(shape, generator=gen, device="cuda", requires_grad=True)
        g = torch.randn(*shape[:2], shape[2] // 2, generator=gen, device="cuda")
        (want,) = torch.autograd.grad(F.relu(F.max_pool1d(h, 2)), h, g)
        got = k6.relu_pool_bwd(h.detach(), g)
        e = 2 * g.shape[-1]
        tie = (h[..., 0:e:2] == h[..., 1:e:2]) & (h[..., 0:e:2] > 0)
        keep = torch.ones_like(got, dtype=torch.bool)
        keep[..., :e] = ~tie.repeat_interleave(2, dim=-1)
        k6_autograd[str(list(shape))] = {
            "max_abs_err": gate(f"relu_pool_bwd vs autograd {list(shape)}",
                                float((got - want).abs()[keep].max()), 0.0),
            "tie_windows_left_out": int(tie.sum())}
    return k6_err, k6_autograd


def _train_batch(b: int, gen: torch.Generator, demo: bool = False) -> dict:
    """One training batch on the card: raw [B, T, 12] signals, 5-label targets, no padding."""
    batch = {"ecg": raw_batch(b, gen),
             "y": (torch.rand(b, 5, generator=gen, device="cuda") > 0.7).float(),
             "mask": torch.ones(b, device="cuda")}
    if demo:
        batch["demo"] = demo_batch(b, gen)
    return batch


def _pool_bwd(impl: str):
    from ptbxl_torch.ops.relu_pool import force_framework_pool_bwd

    return force_framework_pool_bwd() if impl == "framework" else contextlib.nullcontext()


def phase_train(seed: int, gen: torch.Generator) -> dict:
    """The training path: ``train(TrainRun)`` on the baseline ECGCNN at full width,
    f32 ``highest``, with the launch counts set to 0 just before and read just
    after; the best checkpoint reloaded; the pool backward's two engines on the
    same three steps; one multimodal step; one bf16 epoch."""
    import csv
    import itertools
    import tempfile

    from ptbxl_torch.data.pipeline import BatchSource, device_prefetch
    from ptbxl_torch.inference import Predictor
    from ptbxl_torch.models.factory import build_ecgcnn, build_multimodal, load_ecgcnn
    from ptbxl_torch.ops.kernels import fused_ecgcnn as k2, relu_pool as k6, zscore as k1
    from ptbxl_torch.ops.preprocess import zscore_per_lead_batch
    from ptbxl_torch.training.loop import make_train_step
    from ptbxl_torch.training.train_state import create_train_state
    from ptbxl_torch.training.trainer import TrainRun, train

    train_ds, val_ds = RawECGSet(TRAIN_N, seed), RawECGSet(VAL_N, seed + 1)
    info = {"phase": "train", "records": {"train": TRAIN_N, "val": VAL_N}, "batch": TRAIN_B,
            "epochs": TRAIN_EPOCHS, "lr": TRAIN_LR, "weight_decay": TRAIN_WD}
    with tempfile.TemporaryDirectory() as out:
        model = build_ecgcnn(num_labels=5, seed=seed)
        snapshots = []  # (val auprc, weights) after each epoch

        def progress(epoch, loss, metrics):
            snapshots.append((float(metrics["auprc_macro"]),
                              {k: v.clone() for k, v in model.state_dict().items()}))

        run = TrainRun(model=model, train_ds=train_ds, val_ds=val_ds, batch_size=TRAIN_B,
                       epochs=TRAIN_EPOCHS, lr=TRAIN_LR, weight_decay=TRAIN_WD, seed=seed,
                       run_name="chip_smoke", metrics_csv=os.path.join(out, "metrics.csv"),
                       ckpt_path=os.path.join(out, "ckpts", "best.npz"),
                       config_path="chip_smoke.py", classes=CLASSES, progress=progress,
                       train_desc=None, eval_desc=None)
        k1.launches = k2.launches = k2.launches_mm = k6.launches = 0
        t0 = time.time()
        state = train(run)
        torch.cuda.synchronize()
        info["wall_s"] = time.time() - t0
        info["launches"] = {"relu_pool_bwd": k6.launches, "zscore": k1.launches,
                            "fused_ecgcnn": k2.launches, "fused_multimodal": k2.launches_mm}
        info["steps"] = state.step
        if k6.launches != 4 * state.step or state.step != TRAIN_EPOCHS * (TRAIN_N // TRAIN_B):
            raise AssertionError(f"train path: {k6.launches} relu_pool_bwd launches for "
                                 f"{state.step} steps (want 4 a step)")
        with open(run.metrics_csv) as f:
            rows = list(csv.reader(f))
        if rows[0] != CSV_HEADER or len(rows) != 1 + TRAIN_EPOCHS:
            raise AssertionError(f"metrics CSV: header {rows[0]}, {len(rows) - 1} rows")
        info["csv"] = [[float(v) for v in r[3:8]] for r in rows[1:]]  # train_bce .. val_bce
        if not np.isfinite([[r[0], r[4]] for r in info["csv"]]).all():
            raise AssertionError(f"non-finite epoch losses {info['csv']}")

        # the best checkpoint reloads as the weights of its epoch
        best_auprc, best_sd = max(snapshots, key=lambda s: s[0])  # the first maximum
        ref = build_ecgcnn(num_labels=5, seed=seed)
        ref.load_state_dict(best_sd)
        ref.eval()
        x_val = np.stack([val_ds.get_raw(i) for i in range(16)])
        xt = torch.from_numpy(x_val.transpose(0, 2, 1).copy()).cuda()
        with torch.no_grad():
            want = torch.sigmoid(ref(zscore_per_lead_batch(xt)).float()).cpu().numpy()
            pth_model, pth_classes = load_ecgcnn(os.path.splitext(run.ckpt_path)[0] + ".pth")
            got_pth = torch.sigmoid(pth_model(zscore_per_lead_batch(xt)).float()).cpu().numpy()
        got_npz = Predictor.from_checkpoint(run.ckpt_path, engine="framework")(x_val)
        if pth_classes != CLASSES:
            raise AssertionError(f"best .pth classes {pth_classes}")
        info["best_val_auprc"] = best_auprc
        info["best_reload_max_abs_err"] = {
            "npz_predictor": gate("best .npz via Predictor", float(np.abs(got_npz - want).max()),
                                  2e-5),
            "pth_load_ecgcnn": gate("best .pth via load_ecgcnn",
                                    float(np.abs(got_pth - want).max()), 2e-5)}

    # the pool backward's two engines on the same three steps from one init
    src = BatchSource(train_ds, TRAIN_B, shuffle=True, seed=seed)
    batches = list(device_prefetch(itertools.islice(src.epoch(0), 3)))

    def three_steps(impl):
        m = build_ecgcnn(num_labels=5, seed=seed)
        st = create_train_state(m, TRAIN_LR, TRAIN_WD)
        step = make_train_step()
        with _pool_bwd(impl):
            losses = [float(step(st, b)[1]) for b in batches]
        return losses, m.state_dict()

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        loss_k, sd_k = three_steps("kernel")
        loss_f, sd_f = three_steps("framework")
    finally:
        cudnn.deterministic = saved
    rel = max(abs(a - b) / abs(b) for a, b in zip(loss_k, loss_f))
    diffs = {k: float((sd_k[k].float() - sd_f[k].float()).abs().max()) for k in sd_k}
    worst = max(diffs, key=diffs.get)
    info["pool_bwd_kernel_vs_framework"] = {
        "losses_kernel": loss_k, "losses_framework": loss_f,
        "max_rel_loss_diff": gate("kernel vs framework step losses (rel)", rel, 1e-6),
        "max_param_diff": diffs[worst], "max_param_diff_at": worst,
        # a conv bias before train-mode BN has a gradient of ~0 that Adam turns
        # into O(lr) steps; every other entry
        "max_param_diff_but_conv_bias": max(
            v for k, v in diffs.items() if not k.endswith("net.0.bias"))}

    # one multimodal train step at full width
    mm = build_multimodal(num_labels=5, seed=seed)
    st = create_train_state(mm, TRAIN_LR, TRAIN_WD)
    k6.launches = 0
    _, loss_mm = make_train_step(multimodal=True)(st, _train_batch(TRAIN_B, gen, demo=True))
    loss_mm = float(loss_mm)
    if k6.launches != 4 or not np.isfinite(loss_mm):
        raise AssertionError(f"multimodal step: loss {loss_mm}, {k6.launches} K6 launches")
    info["multimodal_step"] = {"loss": loss_mm, "relu_pool_bwd_launches": k6.launches}

    # one bf16 epoch (precision='default')
    history = []
    with tempfile.TemporaryDirectory() as out:
        m16 = build_ecgcnn(num_labels=5, seed=seed, precision="default", dtype=torch.bfloat16)
        train(TrainRun(model=m16, train_ds=train_ds, val_ds=val_ds, batch_size=TRAIN_B,
                       epochs=1, lr=TRAIN_LR, weight_decay=TRAIN_WD, seed=seed,
                       run_name="chip_smoke_bf16", metrics_csv=os.path.join(out, "m.csv"),
                       ckpt_path=os.path.join(out, "best.npz"), config_path="chip_smoke.py",
                       pth_export=False, train_desc=None, eval_desc=None,
                       progress=lambda e, loss, m: history.append([loss, m["bce_loss"]])))
    if not np.isfinite(history).all():
        raise AssertionError(f"bf16 epoch losses {history}")
    info["bf16_epoch"] = {"train_bce": history[0][0], "val_bce": history[0][1]}
    return info


def train_step_times(seed: int, gen: torch.Generator) -> tuple:
    """Device time of one train step (z-score, forward, backward, AdamW) at B=64
    and 256, f32 ``highest`` and bf16, with each pool backward (in turns: kernel,
    framework, framework, kernel); K6's four launches of one B=64 step beside
    their plain version, torch's own pool backward and their bound."""
    from ptbxl_torch.models.factory import build_ecgcnn
    from ptbxl_torch.ops.kernels import relu_pool as k6
    from ptbxl_torch.training.loop import make_train_step
    from ptbxl_torch.training.train_state import create_train_state

    steps = {}
    for b in (TRAIN_B, TRAIN_B_BIG):
        batch = _train_batch(b, gen)
        for prec, dtype in (("highest", torch.float32), ("default", torch.bfloat16)):
            res = {"kernel": [], "framework": []}
            peak = {}
            for impl in ("kernel", "framework", "framework", "kernel"):
                m = build_ecgcnn(num_labels=5, seed=seed, precision=prec, dtype=dtype)
                st = create_train_state(m, TRAIN_LR, TRAIN_WD)
                step = make_train_step()
                torch.cuda.reset_peak_memory_stats()
                with _pool_bwd(impl):
                    res[impl].append(time_ms(lambda: step(st, batch)))
                peak[impl] = torch.cuda.max_memory_allocated() / 2 ** 20
                del m, st, step
            steps[f"B={b} {'f32' if prec == 'highest' else 'bf16'}"] = {
                "kernel_ms": res["kernel"], "framework_ms": res["framework"],
                "records_per_s_kernel": b / (statistics.mean(res["kernel"]) / 1e3),
                "records_per_s_framework": b / (statistics.mean(res["framework"]) / 1e3),
                "peak_mib": peak}
        del batch

    k6_times = {}
    for dt in (torch.float32, torch.bfloat16):
        pairs = [(torch.randn(s, generator=gen, device="cuda").to(dt),
                  torch.randn(*s[:2], s[2] // 2, generator=gen, device="cuda").to(dt))
                 for s in k6_shapes(TRAIN_B)]
        hs = [h.clone().requires_grad_(True) for h, _ in pairs]
        ys = [F.relu(F.max_pool1d(h, 2)) for h in hs]  # torch's pool, argmax indices kept
        name = str(dt)[6:]
        k6_times[name] = {
            "ms": time_ms(lambda: [k6.relu_pool_bwd(h, g) for h, g in pairs]),
            "plain_ms": time_ms(lambda: [k6.relu_pool_bwd_plain(h, g) for h, g in pairs]),
            "library_ms": time_ms(lambda: [torch.autograd.grad(y, h, g, retain_graph=True)
                                           for y, h, (_, g) in zip(ys, hs, pairs)]),
            "bound": bound(*k6_bytes_ops(pairs)),
            "per_launch_ms": launch_breakdown(
                lambda: [k6.relu_pool_bwd(h, g) for h, g in pairs]),
        }
        del pairs, hs, ys
    return steps, k6_times


def train_breakdown(seed: int, gen: torch.Generator) -> dict:
    """Where one f32 train step's device time goes at B=64, per pool backward."""
    from ptbxl_torch.models.factory import build_ecgcnn
    from ptbxl_torch.training.loop import make_train_step
    from ptbxl_torch.training.train_state import create_train_state

    batch = _train_batch(TRAIN_B, gen)
    out = {}
    for impl in ("kernel", "framework"):
        m = build_ecgcnn(num_labels=5, seed=seed)
        st = create_train_state(m, TRAIN_LR, TRAIN_WD)
        step = make_train_step()
        with _pool_bwd(impl):
            launches = launch_breakdown(lambda: step(st, batch))
        agg = by_kernel(launches)
        pool = sum(ms for name, ms in launches
                   if "relu_pool_bwd" in name or "max_pool_backward" in name)
        agg["pool_bwd_ms"] = pool
        agg["pool_bwd_share"] = pool / agg["total_ms"]
        out[impl] = agg
    return out


def _busy_ms(prof) -> float:
    """Device busy time of a profiled window: the union of its kernel and copy
    intervals over all streams (ms)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def train_epoch(seed: int, datasets: tuple = None, phase: str = "train_epoch") -> dict:
    """What one training epoch costs end to end at B=64, f32 ``highest``: the
    trainer's loop (``BatchSource`` -> ``device_prefetch`` -> ``train_one_epoch``)
    over EPOCH_N in-memory records after a warm-up epoch, beside the host's
    batch assembly alone, the steps' device time, the card's idle share (from a
    profiled epoch) and the rest of a trainer epoch (a val epoch of VAL_EPOCH_N
    records and the checkpoint writes).  ``datasets`` = (train, val, make_s):
    PTB-XL datasets read as the trainer reads them (the ADC cache, int16
    batches converted on the card) in place of the in-memory records."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from ptbxl_torch.data.pipeline import BatchSource, device_prefetch
    from ptbxl_torch.models.factory import build_ecgcnn
    from ptbxl_torch.ops.kernels import relu_pool as k6
    from ptbxl_torch.training.loop import eval_one_epoch, make_eval_step, make_train_step
    from ptbxl_torch.training.loop import train_one_epoch
    from ptbxl_torch.training.train_state import create_train_state
    from ptbxl_torch.training.trainer import TrainRun, _export_best, _save_resume

    if datasets is None:
        t0 = time.perf_counter()
        ds, val_ds = RawECGSet(EPOCH_N, seed + 2), RawECGSet(VAL_EPOCH_N, seed + 3)
        make_s = time.perf_counter() - t0
    else:
        ds, val_ds, make_s = datasets
    st = create_train_state(build_ecgcnn(num_labels=5, seed=seed), TRAIN_LR, TRAIN_WD)
    step = make_train_step()
    src = BatchSource(ds, TRAIN_B, shuffle=True, seed=seed, emit_adc=True)

    def epoch(i):  # returns after the last step's loss is read: the card is done
        return train_one_epoch(st, step, device_prefetch(src.epoch(i)))[1]

    epoch(0)  # warm-up: cuDNN plans, the pinned-memory cache, the kernels' build
    torch.cuda.synchronize()
    k6.launches = 0
    t0 = time.perf_counter()
    loss = epoch(1)
    wall_s = time.perf_counter() - t0
    launches = k6.launches
    t0 = time.perf_counter()
    for _ in src.epoch(2):  # the producer's host work alone (get_raw, stack, transpose;
        pass                # or the int16 row gather from the ADC cache)
    host_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epoch(3)
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t0
    busy_ms = _busy_ms(prof)
    batch = next(iter(device_prefetch(src.epoch(4))))
    step_ms = time_ms(lambda: step(st, batch))

    # the rest of a trainer epoch: the val epoch and the checkpoint writes
    val_src = BatchSource(val_ds, TRAIN_B, shuffle=False, seed=seed, emit_adc=True)
    eval_step = make_eval_step()
    eval_one_epoch(st, eval_step, device_prefetch(val_src.epoch(0)))
    t0 = time.perf_counter()
    eval_one_epoch(st, eval_step, device_prefetch(val_src.epoch(0)))
    val_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as out:
        run = TrainRun(model=st.model, train_ds=ds, val_ds=val_ds, batch_size=TRAIN_B,
                       epochs=1, lr=TRAIN_LR, weight_decay=TRAIN_WD, seed=seed,
                       run_name="chip_smoke_epoch", metrics_csv=os.path.join(out, "m.csv"),
                       ckpt_path=os.path.join(out, "best.npz"), config_path="chip_smoke.py",
                       classes=CLASSES)
        t0 = time.perf_counter()
        _export_best(run, st, 0.5)
        _save_resume(os.path.join(out, "resume.pt"), st, 1, 0.5, 0)
        ckpt_s = time.perf_counter() - t0

    steps = src.steps_per_epoch
    if launches != 4 * steps or not np.isfinite(loss):
        raise AssertionError(f"timed epoch: loss {loss}, {launches} K6 launches, {steps} steps")
    return {"phase": phase, "records": len(ds), "batch": TRAIN_B, "steps": steps,
            "reader": src.reader, "emit_adc": src.emit_adc,
            "precision": "highest", "dataset_make_s": make_s, "train_bce": loss,
            "relu_pool_bwd_launches": launches,
            "epoch_wall_s": wall_s, "records_per_s": len(ds) / wall_s,
            "step_ms": step_ms, "steps_x_step_ms": steps * step_ms,
            "host_batches_s": host_s, "host_ms_per_batch": host_s / steps * 1e3,
            "profiled_epoch_wall_s": prof_wall_s, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / (prof_wall_s * 1e3),
            "val_records": len(val_ds), "val_epoch_s": val_s, "checkpoint_writes_s": ckpt_s}


EXTRAS_N = 1024  # train_extras' timed epoch: 16 steps at B=64; the equal-seed epochs take half
PERF_LINE = r"\[PERF\] train: (\d+) records in ([\d.]+)s -> ([\d.]+) rec/s"


def phase_train_extras(seed: int, gen: torch.Generator) -> dict:
    """What the trainer gained beside the step, on the card: one epoch under
    ``PTBXL_TORCH_PERF=1`` (the step timer's records/s beside the epoch's own
    clock), a ``torch.profiler`` trace of three steps, the numerics switch on a
    batch with one ``inf`` sample (it raises before the update) and its cost a
    step, the signal ops on [64, 5000, 12] against their CPU result (1e-5, unit
    normal input), and two epochs from equal seeds: the max |diff| of the head
    weights is reported (0 since the step pins cuDNN's deterministic
    algorithms; the ``determinism`` phase gates it).
    K6's launches are counted from 0 over the phase."""
    import io
    import re
    import tempfile

    from ptbxl_torch.data.pipeline import BatchSource, device_prefetch
    from ptbxl_torch.models.factory import build_ecgcnn
    from ptbxl_torch.ops import signal
    from ptbxl_torch.ops.kernels import relu_pool as k6
    from ptbxl_torch.training.loop import make_train_step, train_one_epoch
    from ptbxl_torch.training.train_state import create_train_state
    from ptbxl_torch.utils.profiling import trace

    ds = RawECGSet(EXTRAS_N, seed + 5)
    src = BatchSource(ds, TRAIN_B, shuffle=True, seed=seed)
    half = BatchSource(RawECGSet(EXTRAS_N // 2, seed + 6), TRAIN_B, shuffle=True, seed=seed)
    step = make_train_step()
    k6.launches = 0

    def fresh():
        return create_train_state(build_ecgcnn(num_labels=5, seed=seed), TRAIN_LR, TRAIN_WD)

    st = fresh()
    train_one_epoch(st, step, device_prefetch(half.epoch(0)))  # warm-up
    buf = io.StringIO()
    os.environ["PTBXL_TORCH_PERF"] = "1"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            _, loss = train_one_epoch(st, step, device_prefetch(src.epoch(1)))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        del os.environ["PTBXL_TORCH_PERF"]
    print(buf.getvalue(), end="", flush=True)
    m = re.search(PERF_LINE, buf.getvalue())
    if m is None or int(m.group(1)) != len(ds) or not np.isfinite(loss):
        raise AssertionError(f"timed epoch: loss {loss}, report {buf.getvalue()!r}")

    batch = next(iter(device_prefetch(src.epoch(2))))
    with tempfile.TemporaryDirectory() as tdir:
        with trace(tdir):
            for _ in range(3):
                step(st, batch)
            torch.cuda.synchronize()
        files = glob.glob(os.path.join(tdir, "*.pt.trace.json*"))
        if not files:
            raise AssertionError(f"trace wrote no trace file: {os.listdir(tdir)}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        trace_info = {"files": len(files), "bytes": os.path.getsize(files[0]),
                      "kernel_events": sum(1 for e in events if e.get("cat") == "kernel")}

    checked = make_train_step(check_numerics=True)
    step_ms = time_ms(lambda: step(st, batch))
    checked_ms = time_ms(lambda: checked(st, batch))
    bad = _train_batch(TRAIN_B, gen)
    bad["ecg"][3, 100, 5] = float("inf")
    before = {k: v.clone() for k, v in st.model.state_dict().items()}
    try:
        checked(st, bad)
    except FloatingPointError as e:
        raised = str(e)
    else:
        raise AssertionError("the numerics switch let a batch with an inf sample through")
    moved = [k for k, v in st.model.state_dict().items()
             if "running" not in k and not torch.equal(v, before[k])]
    if moved:
        raise AssertionError(f"the numerics switch raised after the update: {moved[:3]}")

    x = torch.randn(64, T_FULL, LEADS, generator=gen, device="cuda")
    xc = x.cpu()
    ops = {"fir_bandpass": signal.fir_bandpass,
           "remove_baseline_wander": signal.remove_baseline_wander,
           "resample_linear": lambda v: signal.resample_linear(v, 500.0, 250.0)}
    signal_info = {name: {"max_abs_err_vs_cpu": gate(f"{name} vs CPU", max_diff(fn(x).cpu(),
                                                                                 fn(xc)), 1e-5),
                          "ms": time_ms(lambda: fn(x))} for name, fn in ops.items()}
    del x, xc

    heads, losses = [], []
    for _ in range(2):
        st2 = fresh()
        _, l2 = train_one_epoch(st2, step, device_prefetch(half.epoch(3)))
        heads.append(st2.model.head.weight.detach().clone())
        losses.append(l2)
    torch.cuda.synchronize()
    return {"phase": "train_extras", "batch": TRAIN_B, "records": len(ds),
            "timer": {"records": int(m.group(1)), "seconds": float(m.group(2)),
                      "records_per_s": float(m.group(3))},
            "epoch_wall_s": wall_s, "epoch_records_per_s": len(ds) / wall_s, "train_bce": loss,
            "trace": trace_info,
            "check_numerics": {"raised": raised, "step_ms": step_ms, "checked_step_ms": checked_ms},
            "signal": signal_info,
            "equal_seed": {"records": EXTRAS_N // 2, "head_weight_max_abs_diff":
                           float((heads[0] - heads[1]).abs().max()),
                           "losses": losses, "loss_abs_diff": abs(losses[0] - losses[1])},
            "launches": {"relu_pool_bwd": k6.launches}}


def _fit_tree(tree: str, out: str, seed: int) -> None:
    """One trainer epoch of the baseline ECGCNN on the synthetic tree, its CSV
    and best checkpoint in ``out`` (a rank function of ``phase_ddp``)."""
    from ptbxl_torch.data import PTBXLDataset
    from ptbxl_torch.models.factory import build_ecgcnn
    from ptbxl_torch.training.trainer import TrainRun, train

    train(TrainRun(model=build_ecgcnn(num_labels=5, seed=seed),
                   train_ds=PTBXLDataset(tree, "train", CLASSES),
                   val_ds=PTBXLDataset(tree, "val", CLASSES), batch_size=TRAIN_B, epochs=1,
                   lr=TRAIN_LR, weight_decay=TRAIN_WD, seed=seed, run_name="ddp",
                   metrics_csv=os.path.join(out, "m.csv"), ckpt_path=os.path.join(out, "best.npz"),
                   config_path="chip_smoke.py", classes=CLASSES, pth_export=False,
                   train_desc=None, eval_desc=None))


def _eval_tree(tree: str, ckpt: str, seed: int) -> np.ndarray:
    """The val split's probabilities of the checkpoint ``ckpt`` through the eval
    step, sharded over the process group's ranks when there is one (a rank
    function of ``phase_ddp``)."""
    import torch.distributed as dist

    from ptbxl_torch.data import PTBXLDataset
    from ptbxl_torch.data.pipeline import BatchSource, device_prefetch
    from ptbxl_torch.models.factory import load_ecgcnn
    from ptbxl_torch.parallel.mesh import make_mesh
    from ptbxl_torch.training.loop import make_eval_step
    from ptbxl_torch.training.train_state import TrainState

    model, _ = load_ecgcnn(ckpt)
    step = make_eval_step(mesh=make_mesh() if dist.is_initialized() else None)
    src = BatchSource(PTBXLDataset(tree, "val", CLASSES), TRAIN_B, shuffle=False, seed=seed,
                      emit_adc=True)
    probs = []
    for b in device_prefetch(src.epoch(0)):
        p, _ = step(TrainState(model), b)
        probs.append(p.cpu()[b["mask"].cpu() > 0])
    return torch.cat(probs).numpy()


def phase_ddp(seed: int, tree: str, work: str) -> dict:
    """The data-parallel training path on the card: (1) a 1-rank NCCL group in
    this process, the sharded multimodal SGD step at [8, 5000, 12] against the
    plain step (1e-6: loss relative, BN stats, params), K6 counted from 0;
    (2) two processes on the one card over gloo with CUDA tensors (NCCL refuses
    two ranks on one device): ``dryrun_multichip(2)`` at [8, 5000, 12] under
    its three 1e-5 gates; (3) one trainer epoch on the synthetic tree on those
    two ranks against the same epoch in one process, run twice: the train loss
    within 1e-3 (tests/test_training.py:197-258).  The val loss and rank
    metrics of the three epochs are reported, not gated: the conv biases feed
    BatchNorm, so their true gradient is 0 and what reaches them is rounding
    noise (~1e-9), which AdamW's normalized update turns into moves of up to
    ~lr a step; train-mode BatchNorm cancels them, but eval mode subtracts a
    running mean that lags them, so the val outputs follow the noise of the
    sums' order (sharded or not; the second unsharded epoch, which the
    step's deterministic cuDNN makes bit-equal to the first, shows that this
    spread is the sharding's alone).  The
    eval path's gather is held exactly instead: the val probabilities of one
    checkpoint through the eval step on the two ranks against one process
    (1e-5) and their rank metrics."""
    import torch.distributed as dist

    from ptbxl_torch.models.factory import build_multimodal
    from ptbxl_torch.parallel import dryrun
    from ptbxl_torch.parallel.multihost import maybe_initialize_distributed
    from ptbxl_torch.training.metrics import compute_metrics

    state = {k: v.cpu() for k, v in build_multimodal(num_labels=5, seed=seed,
                                                     device="cpu").state_dict().items()}
    batch = dryrun.make_batch(8, T_FULL, seed)
    maybe_initialize_distributed(f"tcp://127.0.0.1:{dryrun.free_port()}", 1, 0, "nccl", "cuda")
    try:
        backend = dist.get_backend()
        sharded = dryrun.one_step(state, batch, "sgd", 1, "cuda")
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    plain = dryrun.one_step(state, batch, "sgd", None, "cuda")
    one_rank = {
        "backend": backend, "relu_pool_bwd_launches": sharded["launches"],
        "loss_rel_err": gate("1-rank loss", abs(sharded["loss"] - plain["loss"])
                             / abs(plain["loss"]), 1e-6),
        "bn_max_abs_err": gate("1-rank BN stats", dryrun.max_diff(
            dryrun.bn_stats(sharded["state"]), dryrun.bn_stats(plain["state"])), 1e-6),
        "params_max_abs_err": gate("1-rank SGD params", dryrun.max_diff(
            dryrun.params(sharded["state"]), dryrun.params(plain["state"])), 1e-6)}
    if sharded["launches"] != 4:
        raise AssertionError(f"the sharded step launched K6 {sharded['launches']} times, not 4")

    t0 = time.perf_counter()
    two_rank = dryrun.dryrun_multichip(2, T_FULL, "gloo", "cuda")
    two_rank["wall_s"] = time.perf_counter() - t0

    outs = {k: os.path.join(work, f"ddp_{k}") for k in ("one", "again", "two")}
    walls = {}
    for k, out in outs.items():
        os.makedirs(out)
        t0 = time.perf_counter()
        if k == "two":
            dryrun.run_ranks(_fit_tree, 2, (tree, out, seed), "gloo", "cuda", timeout=600)
        else:
            _fit_tree(tree, out, seed)
        walls[k] = time.perf_counter() - t0
    rows = {k: _csv_columns(os.path.join(out, "m.csv")) for k, out in outs.items()}
    cols = ("train_bce", "val_auroc_macro", "val_auprc_macro", "val_f1_macro", "val_bce_loss")
    epoch = {k: {c: float(r[c][0]) for c in cols} for k, r in rows.items()}
    gate("sharded epoch train_bce", abs(epoch["two"]["train_bce"] - epoch["one"]["train_bce"]),
         1e-3)

    ckpt = os.path.join(outs["one"], "best.npz")
    want = _eval_tree(tree, ckpt, seed)
    got = dryrun.run_ranks(_eval_tree, 2, (tree, ckpt, seed), "gloo", "cuda", timeout=600)
    if got.shape != want.shape:
        raise AssertionError(f"sharded eval gave {got.shape} probabilities, not {want.shape}")
    from ptbxl_torch.data import PTBXLDataset

    y = PTBXLDataset(tree, "val", CLASSES).y
    m_one, m_two = compute_metrics(y, want), compute_metrics(y, got)
    return {"phase": "ddp", "one_rank_nccl": one_rank, "dryrun_multichip_2": two_rank,
            "epoch": {"ranks": 2, "backend": "gloo", "batch": TRAIN_B, "csv": epoch,
                      "wall_s": walls,
                      "val_bce_abs_diff": {k: abs(epoch[k]["val_bce_loss"]
                                                  - epoch["one"]["val_bce_loss"])
                                           for k in ("two", "again")},
                      "rank_metrics_equal": {
                          "two_vs_one": all(epoch["two"][c] == epoch["one"][c] for c in cols[1:4]),
                          "again_vs_one": all(epoch["again"][c] == epoch["one"][c]
                                              for c in cols[1:4])}},
            "eval_one_checkpoint": {
                "records": int(want.shape[0]),
                "probs_max_abs_err": gate("sharded eval probs", float(np.abs(got - want).max()),
                                          1e-5),
                "metrics_one": m_one, "metrics_two": m_two,
                "rank_metrics_equal": all(m_one[k] == m_two[k]
                                          for k in ("auroc_macro", "auprc_macro", "f1_macro"))}}


def phase_data_parallel_predictor() -> dict:
    """``Predictor(data_parallel=True)`` over every visible GPU against the
    framework engine on one, within PARITY_TOL (2e-5), at N = 7 and 512."""
    from ptbxl_torch.inference import Predictor

    dp = Predictor.from_checkpoint(CKPT, data_parallel=True)
    fw = Predictor.from_checkpoint(CKPT, engine="framework")
    sigs = demo_signals()
    reqs = np.concatenate([sigs] * 74)[:512]
    errs, ms = {}, {}
    for n, xs in (("7", sigs), ("512", reqs)):
        errs[n] = gate(f"data-parallel Predictor N={n}", float(np.abs(dp(xs) - fw(xs)).max()),
                       2e-5)
        t0 = time.perf_counter()
        dp(xs)
        ms[n] = (time.perf_counter() - t0) * 1e3
    return {"phase": "data_parallel_predictor", "devices": len(dp._replicas),
            "engine": dp.engine, "max_abs_err_vs_framework": errs, "host_ms": ms}


def phase_k4(folded, cases: dict) -> dict:
    """K4 against its plain version: each case with the z-score on and off,
    split 1, 2 and 3, f32 (probs 2e-5: K2's 3xTF32 blocks, sums in another
    order) and bf16 (5e-3: the bench's parity gate; the kernels' sums in
    another order can move an intermediate's bf16 rounding by an ulp); and
    the split check."""
    from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4, zscore as k1

    errs = {}
    for name, xb in cases.items():
        for normalize in (True, False):
            xin = xb if normalize else k1.zscore_plain(xb)
            for split in (1, 2, 3):
                for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 5e-3)):
                    got = k4.hybrid_ecgcnn_probs(xin, folded, dt, normalize, split)
                    want = torch.sigmoid(k4.hybrid_ecgcnn_logits_plain(
                        xin, folded, split, dt, normalize))
                    if got.shape != (xb.shape[0], 5):
                        raise AssertionError(f"hybrid_ecgcnn B={name}: shape {tuple(got.shape)}")
                    key = f"B={name} normalize={normalize} split={split} {str(dt)[6:]}"
                    errs[key] = gate(f"hybrid_ecgcnn {key}", max_diff(got, want), tol)
    for split in (0, 4):
        try:
            k4.hybrid_ecgcnn_logits(cases["1"], folded, split)
        except ValueError:
            continue
        raise AssertionError(f"hybrid_ecgcnn took split={split} of 4 blocks")
    return errs


def phase_k4_blocks(x_raw: torch.Tensor, folded) -> dict:
    """Each of K4's bf16 ``wgmma`` launches against its plain block (an im2col
    product of bf16-rounded operands with f32 sums, TF32 off) on the plain
    chain's own activations at that block, at B = 1, 16 and 512, each timed:
    block 0 from the raw record with ``zscore_stats`` (z-scored on load, the
    plain side z-scored with the same stats, then padded), blocks 1 and 2 bf16
    in and out, block 3's per-tile channel sums (its odd 625 rows).  Gates:
    a bf16 output within 2^-8 of each value (one bf16 rounding, which a sum
    in another order can move by an ulp) plus 2^-16 of the block's scale (the
    largest |x| conv |w|, as ``k2_blocks``); a tile's sum within 2^-16 of
    the scale times the pooled rows it adds."""
    from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4, zscore as k1
    from ptbxl_torch.utils.device import highest_precision

    blocks = k4.prepare_weights(folded, compute_dtype=torch.bfloat16)["blocks"]
    by_batch = {}
    for bsz in (1, 16, x_raw.shape[0]):
        x = x_raw[:bsz].contiguous()
        stats = k1.zscore_stats(x)
        h_in, h = x, (x - stats[:, None, :, 0]) / stats[:, None, :, 1]
        rows = []
        for i, wp in enumerate(blocks):
            w, b = folded[f"w{i}"], folded[f"b{i}"]
            w2d = w.reshape(-1, w.shape[2])
            last = i == len(blocks) - 1
            with highest_precision():
                hp = F.pad(h, (0, 0, k4.PAD, k4.PAD))
                want = k4._im2col_block_plain(hp, w2d, b, torch.bfloat16)
                scale = float(k4._im2col_block_plain(hp.abs(), w2d.abs(), torch.zeros_like(b),
                                                     torch.bfloat16).max())
            st = stats if i == 0 else None
            got = k4.wgmma_conv_block(h_in, wp, b, st, last)
            if last:
                per = k4.wg_tile(wp.shape[1] * 16 // 15, w.shape[2])[1] // 2
                want_s = torch.stack([want[:, j * per:(j + 1) * per].sum(1)
                                      for j in range(got.shape[1])], 1)
                tol = 2.0 ** -16 * scale * per
                err = gate(f"wgmma block {i} sums B={bsz}", max_diff(got, want_s), tol)
                excess = err
            else:
                tol = 2.0 ** -16 * scale
                excess = float(((got.float() - want).abs() - 2.0 ** -8 * want.abs()).max())
                gate(f"wgmma block {i} B={bsz} beyond one bf16 rounding", excess, tol)
                err = max_diff(got, want)
            rows.append({"block": i, "shape": [h.shape[1], w.shape[1], w.shape[2]],
                         "out": "sums" if last else "bf16", "max_abs_err": err,
                         "beyond_rounding": excess, "tol": tol, "scale": scale,
                         "ms": time_ms(lambda: k4.wgmma_conv_block(h_in, wp, b, st, last))})
            h_in = want.to(torch.bfloat16)  # the next conv reads the plain output in bf16
            h = h_in.float()
        by_batch[str(bsz)] = rows
    torch.cuda.synchronize()
    return {"phase": "k4_blocks", "batch": by_batch}


def phase_k1(x_raw: torch.Tensor, gen: torch.Generator) -> dict:
    """K1 (both entries) against its plain version: f32 at 1e-5, bf16 at 2e-2,
    the stats at 1e-5, at B=512 (the harsh-offset data too), B=1 and B=8192
    (the hybrid row's batch); a ragged T=37 (a bf16 record is 888 bytes, so
    records and, at k=8, 120-byte pieces are not 16-byte multiples), through
    the wrappers, through plans of 2, 4 and 8 CTAs, and on an offset view;
    the seam gate: K1's f32 output equal bit for bit to ``(x - mean) / sd``
    built on the card from ``zscore_stats``' own output on the same data; and
    the kernels' division against IEEE division (``tools/check_div_rn.py``)."""
    from ptbxl_torch.ops.kernels import zscore as k1
    from ptbxl_torch.tools import check_div_rn

    def seam(x: torch.Tensor) -> float:
        st = k1.zscore_stats(x)
        return max_diff(k1.zscore(x), (x - st[..., 0][:, None, :]) / st[..., 1][:, None, :])

    info = {"phase": "k1", "shape": list(x_raw.shape)}
    info["max_abs_err_f32"] = gate("zscore f32",
                                   max_diff(k1.zscore(x_raw), k1.zscore_plain(x_raw)), 1e-5)
    x16 = x_raw.to(torch.bfloat16)
    info["max_abs_err_bf16"] = gate("zscore bf16", max_diff(k1.zscore(x16), k1.zscore_plain(x16)),
                                    2e-2)
    info["max_abs_err_stats"] = gate("zscore_stats", max_diff(k1.zscore_stats(x_raw),
                                                              k1.zscore_stats_plain(x_raw)), 1e-5)
    # an output of the other size leaves through a staging buffer
    info["max_abs_err_mixed"] = {
        "f32 in, bf16 out": gate("zscore f32 -> bf16", max_diff(
            k1.zscore(x_raw, torch.bfloat16), k1.zscore_plain(x_raw, torch.bfloat16)), 2e-2),
        "bf16 in, f32 out": gate("zscore bf16 -> f32", max_diff(
            k1.zscore(x16, torch.float32), k1.zscore_plain(x16, torch.float32)), 1e-5)}
    # harsher data: a large DC offset beside a small std (per-lead offset N(0, 3),
    # scale down to 0.1), where f32 sums in one order or another lose bits
    x_harsh = raw_batch(BIG, gen, scale_lo=0.1, offset_sd=3.0)
    info["max_abs_err_f32_harsh"] = gate(
        "zscore f32 harsh", max_diff(k1.zscore(x_harsh), k1.zscore_plain(x_harsh)), 1e-5)
    info["max_abs_err_stats_harsh"] = gate(
        "zscore_stats harsh", max_diff(k1.zscore_stats(x_harsh), k1.zscore_stats_plain(x_harsh)),
        1e-5)
    seams = {"B=512": gate("seam B=512", seam(x_raw), 0.0),
             "B=512 harsh": gate("seam B=512 harsh", seam(x_harsh), 0.0)}
    del x_harsh
    by_batch = {}
    for b in (1, HYBRID_B):
        xb = x_raw[:1].contiguous() if b == 1 else raw_batch(b, gen)
        by_batch[str(b)] = {
            "f32": gate(f"zscore f32 B={b}", max_diff(k1.zscore(xb), k1.zscore_plain(xb)), 1e-5),
            "stats": gate(f"zscore_stats B={b}", max_diff(k1.zscore_stats(xb),
                                                         k1.zscore_stats_plain(xb)), 1e-5)}
        seams[f"B={b}"] = gate(f"seam B={b}", seam(xb), 0.0)
        del xb
    info["max_abs_err_by_batch"] = by_batch
    # the ragged T: the wrappers' plans, then plans of 2, 4 and 8 CTAs (launches
    # made here to compare count nowhere on a main path)
    x37 = raw_batch(14, gen, scale_lo=0.1, offset_sd=3.0)[:, :37].contiguous()
    ragged = {}
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        name = str(dt)[6:]
        for label, xr in (("B=13", x37[:13].to(dt)), ("B=13 offset view", x37.to(dt)[1:])):
            ragged[f"{label} {name}"] = gate(f"zscore T=37 {label} {name}", max_diff(
                k1.zscore(xr), k1.zscore_plain(xr)), tol)
            ragged[f"{label} {name} stats"] = gate(f"zscore_stats T=37 {label} {name}", max_diff(
                k1.zscore_stats(xr), k1.zscore_stats_plain(xr)), 1e-5)
            other = torch.bfloat16 if dt == torch.float32 else torch.float32
            ragged[f"{label} {name} -> {str(other)[6:]}"] = gate(
                f"zscore T=37 {label} {name} -> {other}",
                max_diff(k1.zscore(xr, other), k1.zscore_plain(xr, other)), 2e-2)
        xr = x37[:13].to(dt)
        for kk in (2, 4, 8):
            for entry in ("zscore", "zscore_stats"):
                plan = k1.cluster_plan(13, 37, LEADS, LEADS, dt, dt, entry, k=kk)
                got = k1.launch_plan(xr, plan, entry)
                want = (k1.zscore_stats_plain(xr) if entry == "zscore_stats"
                        else k1.zscore_plain(xr))
                ragged[f"k={plan.k} {entry} {name}"] = gate(
                    f"{entry} T=37 k={plan.k} {name}", max_diff(got, want),
                    1e-5 if entry == "zscore_stats" else tol)
        if dt == torch.float32:
            seams["T=37"] = gate("seam T=37", seam(xr), 0.0)
    info["max_abs_err_ragged_t37"] = ragged
    info["seam_max_abs_diff"] = seams
    div = check_div_rn.run(seeds=2)
    if div["mismatches"]:
        raise AssertionError(f"div_rn differs from IEEE division: {div}")
    info["div_rn_vs_ieee"] = div
    torch.cuda.synchronize()
    # the plans the main paths take (k, piece, threads, shared memory a CTA)
    info["plans"] = {f"{entry} {str(dt)[6:]} B={b}": k1.cluster_plan(
        b, T_FULL, LEADS, w, dt, dt, entry, per=8 if entry == "zscore_wide" else None)._asdict()
        for entry, dt, b, w in (("zscore", torch.float32, 1, LEADS),
                                ("zscore", torch.float32, BIG, LEADS),
                                ("zscore_stats", torch.float32, HYBRID_B, LEADS),
                                ("zscore", torch.bfloat16, PROBE_ZS_B, LEADS),
                                ("zscore_wide", torch.bfloat16, PROBE_ZS_B, 480))}
    return info


def phase_k5(x_raw: torch.Tensor, gen: torch.Generator) -> dict:
    """K5 against its plain version and against K1: f32 at 1e-5 (the harsh
    offset data too), bf16 in and out at 2e-2; widths 36 (on T=240, the JAX
    test's geometry: 36 does not divide 5000*12), 12 and 444 on the ragged
    T=37, 240, 480, 1200; B=13 and 512 (13 is not a multiple of block_b)."""
    from ptbxl_torch.ops.kernels import zscore as k1

    x_harsh = raw_batch(BIG, gen, scale_lo=0.1, offset_sd=3.0)
    data = {"raw": x_raw, "harsh": x_harsh}
    errs = {}
    for label, xd in data.items():
        for width, t in ((36, 240), (12, 37), (444, 37), (240, T_FULL), (480, T_FULL),
                         (1200, T_FULL)):
            for b, block_b in ((13, 8), (BIG, 8), (BIG, 16)):
                if width != 480 and block_b != 8:
                    continue
                xb = xd[:b, :t].contiguous()
                for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
                    xin = xb.to(dt)
                    got = k1.zscore_wide(xin, width=width, block_b=block_b)
                    if got.dtype != dt or got.shape != xb.shape:
                        raise AssertionError(f"zscore_wide: {got.dtype} {tuple(got.shape)}")
                    key = f"{label} B={b} T={t} width={width} block_b={block_b} {str(dt)[6:]}"
                    errs[key] = {
                        "vs_plain": gate(f"zscore_wide {key}", max_diff(
                            got, k1.zscore_wide_plain(xin, width=width, block_b=block_b)), tol),
                        "vs_k1": gate(f"zscore_wide vs K1 {key}", max_diff(got, k1.zscore(xin)),
                                      tol)}
    return errs


def phase_p3(gen: torch.Generator) -> tuple:
    """P3's layer in both modes against ``conv_layer_plain`` on the four layers
    at B=16.  Gate 1e-4: bf16 products are exact in f32, so the two sides
    differ only in the order of f32 sums of up to 1,920 products (outputs O(1)).
    Then each layer's ``im2col`` mode (the ``wgmma`` block on a VALID f32
    input) on a zero-padded input of bf16 values, rounded to bf16, against
    K4's launch of the same block (``wgmma_conv_block``, SAME) on the unpadded
    input at B=16: bit for bit, since both run the same tiles, staged rows
    and k16 steps in the same order (block 0 reads f32, the others bf16)."""
    from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4
    from ptbxl_torch.tools.probe_layer_perf import LAYERS, make_layer

    errs = {}
    for t_in, cin, cout in LAYERS + [(501, 64, 128)]:  # an odd length: the floor
        x, w, b = make_layer(t_in, cin, cout, 16, torch.device("cuda"))
        for mode in k4.MODES:
            got = k4.conv_layer(x, w, b, mode)
            want = k4.conv_layer_plain(x, w, b, mode)
            if got.shape != (16, t_in // 2, cout):
                raise AssertionError(f"conv_layer {mode}: shape {tuple(got.shape)}")
            key = f"({t_in},{cin},{cout}) {mode}"
            errs[key] = gate(f"conv_layer {key}", max_diff(got, want), 1e-4)
    differ = {}
    for t_in, cin, cout in LAYERS:
        x, w, b = make_layer(t_in, cin, cout, 16, torch.device("cuda"))
        xb = x[:, k4.PAD:k4.PAD + t_in].to(torch.bfloat16)
        layer = k4.conv_layer(F.pad(xb.float(), (0, 0, k4.PAD, k4.PAD)), w, b).to(torch.bfloat16)
        block = k4.wgmma_conv_block(xb.float() if cin % 16 else xb, k4.wg_weight(
            w.view(k4.K, cin, cout)), b)
        key = f"({t_in},{cin},{cout})"
        differ[key] = int((layer.view(torch.int16) != block.view(torch.int16)).sum())
        if layer.shape != block.shape or differ[key]:
            raise AssertionError(f"conv_layer {key} vs K4's wgmma block: {differ[key]} of "
                                 f"{block.numel()} bf16 values differ")
    return errs, differ


def phase_hybrid(folded) -> dict:
    """The main path of K4: the port bench's hybrid row (K4, bf16) at B=512 and
    8192, its demo-pack parity against the f32 ``highest`` framework path at
    5e-3, launches counted from 0; then the row's probs at B=8192 against K4's
    plain version on the same batch (512 records at a time), 5e-3 as in
    ``phase_k4``."""
    from ptbxl_torch import bench
    from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4, zscore as k1

    dev = torch.device("cuda")
    clock = bench.Clock(dev)
    k4.launches = k1.launches = 0
    forward = bench.build_forward("hybrid", "bf16", dev)
    reference = bench.build_forward("framework", "f32", dev)
    with torch.no_grad():
        parity = bench.parity_check(forward, reference, dev)
        rows = [bench.inference_row("hybrid", "default", "bf16", b, forward, parity, clock,
                                    iters=10) for b in (BIG, HYBRID_B)]
        x_big = bench._random_batch(HYBRID_B, torch.float32, dev)
        probs = forward(x_big)
    torch.cuda.synchronize()
    launches, k1_launches = k4.launches, k1.launches
    gate("hybrid demo-pack parity vs f32 highest", parity[1], bench.PARITY_TOL)
    if launches <= 0 or k1_launches <= 0 or not (torch.isfinite(probs).all()
                                                 and probs.shape == (HYBRID_B, 5)):
        raise AssertionError(f"hybrid row: {launches} K4 and {k1_launches} K1 launches, "
                             f"probs {tuple(probs.shape)}")
    with torch.no_grad():
        want = torch.cat([torch.sigmoid(k4.hybrid_ecgcnn_logits_plain(xc, folded))
                          for xc in x_big.split(BIG)])
    err = gate(f"hybrid_ecgcnn B={HYBRID_B} bfloat16 vs plain", max_diff(probs, want), 5e-3)
    return {"phase": "hybrid", "launches": {"hybrid_ecgcnn": launches, "zscore": k1_launches},
            "rows": rows, "prob_err": parity[1], "max_abs_err_vs_plain": err}


def phase_probes() -> tuple:
    """The main paths of K5 and P3: the two tool probes' functions at their
    shapes, launch counts set to 0 just before each."""
    from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4, zscore as k1
    from ptbxl_torch.tools import probe_layer_perf, probe_zscore

    dev = torch.device("cuda")
    batch = probe_zscore.make_batch(PROBE_ZS_B, dev)
    k1.launches_wide = 0
    zs_rows = probe_zscore.run(batch, iters=10)
    torch.cuda.synchronize()
    zs_launches = k1.launches_wide
    k4.launches_layer = 0
    layer_rows = probe_layer_perf.run(PROBE_LAYER_B, dev, iters=5)
    torch.cuda.synchronize()
    layer_launches = k4.launches_layer
    if zs_launches <= 0 or layer_launches <= 0:
        raise AssertionError(f"probes launched zscore_wide {zs_launches}, "
                             f"conv_layer {layer_launches} times")
    return batch, zs_rows, zs_launches, layer_rows, layer_launches


def phase_p4(gen: torch.Generator) -> dict:
    """P4 against its plain version: the four layers at B=3 on T=300 and 301
    (an odd length: the floor), both output layouts; then at the probe's
    shapes at B=2048 (``transpose_out``, the probe's layout).  Gate 1e-4, as
    P3: the same bf16 products, f32 sums in another order.  Then P4's main
    path, the probe at B=2048, launches counted from 0, with each layer's
    plain-version time."""
    from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4
    from ptbxl_torch.tools import probe_sublane_conv as psc

    dev = torch.device("cuda")
    errs = {}
    for t_in, _, cout, cpad in psc.LAYERS:
        for t in (300, 301):
            x, w, b = psc.make_layer(t, cout, cpad, 3, dev)
            for tr in (True, False):
                got, want = k4.conv_layer_cf(x, w, b, tr), k4.conv_layer_cf_plain(x, w, b, tr)
                shape = (3, cout, t // 2) if tr else (3, t // 2, cout)
                if tuple(got.shape) != shape:
                    raise AssertionError(f"conv_layer_cf: shape {tuple(got.shape)} != {shape}")
                key = f"({t},{cpad},{cout}) transpose_out={tr}"
                errs[key] = gate(f"conv_layer_cf {key}", max_diff(got, want), 1e-4)
    big_errs, plain_ms = {}, []
    with torch.no_grad():
        for t_in, _, cout, cpad in psc.LAYERS:
            x, w, b = psc.make_layer(t_in, cout, cpad, PROBE_LAYER_B, dev)
            key = f"({t_in},{cpad},{cout})"
            big_errs[key] = gate(f"conv_layer_cf {key} B={PROBE_LAYER_B}",
                                 max_diff(k4.conv_layer_cf(x, w, b), k4.conv_layer_cf_plain(x, w, b)),
                                 1e-4)
            plain_ms.append(time_ms(lambda: k4.conv_layer_cf_plain(x, w, b), reps=2, warmup=1))
            del x
    k4.launches_layer_cf = 0
    rows = psc.run(PROBE_LAYER_B, dev, iters=5)
    torch.cuda.synchronize()
    launches = k4.launches_layer_cf
    if launches <= 0:
        raise AssertionError("the P4 probe launched no conv_layer_cf kernel")
    return {"phase": "p4", "max_abs_err": errs, "max_abs_err_b2048": big_errs,
            "launches": {"conv_layer_cf": launches}, "batch": PROBE_LAYER_B, "rows": rows,
            "plain_ms": plain_ms}


def phase_probe_tables() -> dict:
    """P1's and P2's main paths: the two probe tools' tables (13 probes) at the
    JAX tools' shapes, launch counts set to 0 just before each; every probe
    must pass its gate against its plain version."""
    from ptbxl_torch.ops.kernels import probes as kp
    from ptbxl_torch.tools import probe_mosaic, probe_mosaic2

    dev = torch.device("cuda")
    # P1's extra gates (outside the counted paths): the TF32 dot at the
    # smallest shape its plan admits, several tiles with K != 256 and the
    # largest K, both forms; its rounding against tf32_round; p7 on both of
    # its paths, at an odd To and on a misaligned view
    gates = probe_mosaic.gate_cases(dev)
    torch.cuda.synchronize()
    bad = [name for name, g in gates.items() if not g["ok"]]
    if bad:
        raise AssertionError(f"P1 gate cases failed: {[(n, gates[n]) for n in bad]}")
    out = {"phase": "probes", "tables": {}, "launches": {}, "p1_gates": gates}
    for name, probes in (("probe_mosaic", probe_mosaic.PROBES),
                         ("probe_mosaic2", probe_mosaic2.PROBES)):
        kp.launches = 0
        rows = probe_mosaic.run(probes, dev, iters=20)
        torch.cuda.synchronize()
        out["launches"][name] = kp.launches
        out["tables"][name] = rows
        for r in rows:
            print(probe_mosaic.line(r, True) if "error" not in r else
                  f"[FAIL] {r['label']}: {r['error']}", flush=True)
        bad = [r["probe"] for r in rows if not r["ok"]]
        if bad or kp.launches <= 0:
            raise AssertionError(f"{name}: probes {bad} missed their gates "
                                 f"({kp.launches} launches)")
    return out


def phase_data(root: str) -> tuple:
    """The data layer on a synthetic tree at the real record shape: the three
    datasets, the manifest's drop of the record with no .dat, the ADC cache
    built by the native decoder, and the int16 path (``emit_adc``) through
    ``device_prefetch`` against the f32 path on the card, bit for bit with
    NaN positions (sentinels written into a copy of a batch).  Returns
    (info, the train and val datasets, their construction seconds)."""
    import shutil

    from ptbxl_torch.data import PTBXLAFDataset, PTBXLDataset, PTBXLECGMultimodalDataset
    from ptbxl_torch.data.manifest import CACHE_DIRNAME, ValidityManifest
    from ptbxl_torch.data.pipeline import BatchSource, device_prefetch
    from ptbxl_torch.io import native
    from ptbxl_torch.ops.adc_convert import adc_lt_to_physical_batch

    if not native.available():
        raise AssertionError(f"native WFDB decoder did not build: {native.build_error()}")
    shutil.rmtree(os.path.join(root, CACHE_DIRNAME), ignore_errors=True)
    t0 = time.perf_counter()
    sets = {split: PTBXLDataset(root, split, CLASSES) for split in ("train", "val", "test")}
    make_s = time.perf_counter() - t0
    mm = {split: PTBXLECGMultimodalDataset(root, split, CLASSES) for split in ("train", "test")}
    af = PTBXLAFDataset(root, "test")
    missing = "records500/00000/00006_hr"  # the tree's record with no .dat (train fold)
    if ValidityManifest(root).is_valid(missing) or missing in sets["train"].df["filename_hr"]:
        raise AssertionError("the manifest kept the record with no .dat")
    if sets["train"]._num_total - sets["train"]._num_valid != 1:
        raise AssertionError(f"train split dropped {sets['train']._num_total - len(sets['train'])}")
    if len(mm["train"]) != len(sets["train"]) - 1:  # record 4: no age
        raise AssertionError("the multimodal dataset did not drop the row with no age")

    t0 = time.perf_counter()
    src16 = BatchSource(sets["val"], TRAIN_B, shuffle=False, emit_adc=True)
    cache_s = time.perf_counter() - t0
    decoder = src16._cache.decoder
    if src16.reader != "adc_cache" or decoder != "native":
        raise AssertionError(f"reader {src16.reader}, cache decoder {decoder}")
    src32 = BatchSource(sets["val"], TRAIN_B, shuffle=False)
    equal = 0
    for b16, b32 in zip(device_prefetch(src16.epoch(0)), device_prefetch(src32.epoch(0))):
        same_nan = torch.equal(b16["ecg"].isnan(), b32["ecg"].isnan())
        if not (same_nan and torch.equal(b16["ecg"].nan_to_num(), b32["ecg"].nan_to_num())):
            raise AssertionError("emit_adc batch != f32 batch on the card")
        equal += 1
    # the sentinel: -32768 written into a copy of an int16 batch, converted on
    # the card and on the host by the cache's own formula
    hb = next(src16.epoch(0))
    adc = hb["adc_lt"].copy()
    adc[:, 3, ::97] = -32768
    host = (adc.astype(np.float32) - hb["baseline"][:, :, None]) / hb["gain"][:, :, None]
    host[adc == -32768] = np.nan
    dev_phys = adc_lt_to_physical_batch(torch.from_numpy(adc).cuda(),
                                        torch.from_numpy(hb["gain"]).cuda(),
                                        torch.from_numpy(hb["baseline"]).cuda()).cpu()
    want = torch.from_numpy(np.ascontiguousarray(host.transpose(0, 2, 1)))
    nan_pos = int(want.isnan().sum())
    if not (torch.equal(dev_phys.isnan(), want.isnan())
            and torch.equal(dev_phys.nan_to_num(), want.nan_to_num())):
        raise AssertionError("ADC conversion on the card != host float path with sentinels")
    info = {"phase": "data", "root": root, "reader": src16.reader, "cache_decoder": decoder,
            "native_available": native.available(), "cache_build_s": cache_s,
            "datasets_s": make_s,
            "sizes": {f"PTBXLDataset/{k}": len(v) for k, v in sets.items()}
            | {f"PTBXLECGMultimodalDataset/{k}": len(v) for k, v in mm.items()}
            | {"PTBXLAFDataset/test": len(af)},
            "emit_adc_equal_batches": equal, "sentinel_nans_checked": nan_pos,
            "max_abs_err_emit_adc_vs_f32": 0.0}
    return info, (sets["train"], sets["val"], make_s)


def _cli_config(path: str, root: str, out_dir: str, epochs: int, extra: str = "") -> str:
    with open(path, "w") as f:
        f.write(f"""seed: 42
data:
  base_dir: {root}
  normalize: per_lead
  labels: ["MI", "STTC", "HYP", "CD", "NORM"]
train:
  batch_size: {TRAIN_B}
  epochs: {epochs}
  lr: {TRAIN_LR}
  weight_decay: {TRAIN_WD}
  early_stop_patience: 8
{extra}log:
  out_dir: {out_dir}
""")
    return path


@contextlib.contextmanager
def _cudnn_flags_kept():
    """cuDNN's ``deterministic`` and ``benchmark`` flags restored on exit: the
    CLIs' ``set_seed`` pins them for the process, as the reference's does, and
    the phases after the CLIs time cuDNN at torch's defaults."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def _run_cli(main, argv) -> tuple:
    """Run a CLI's ``main(argv)`` in-process; (its return, its stdout), the
    stdout echoed."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    text = buf.getvalue()
    print(text, end="", flush=True)
    return ret, text


def phase_cli_train(root: str, work: str, seed: int, datasets: tuple) -> dict:
    """CLIs 03, 04 and 05 on the tree at full width, batch 64: 03 for two
    epochs (K6 launches counted from 0), its CSV, checkpoints and losses
    checked; 04 for one epoch warm-started from 03's checkpoint; 05 for one.
    Then the epoch measured as ``train_epoch`` measures it, on this tree (the
    ``train_epoch`` phase of the same run gives the in-memory epoch beside it)."""
    import csv

    from ptbxl_torch.cli import train_af_binary, train_ecg_baseline, train_multimodal_prototype
    from ptbxl_torch.ops.kernels import relu_pool as k6

    out = os.path.join(work, "outputs")
    cfg = _cli_config(os.path.join(work, "bl.yaml"), root, out, TRAIN_EPOCHS,
                      "model:\n  ecg:\n    in_leads: 12\n    feat_dim: 256\n")
    k6.launches = 0
    t0 = time.perf_counter()
    state, text = _run_cli(train_ecg_baseline.main, ["--config", cfg])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k6.launches
    run_dir = os.path.join(out, "ecg_baseline")
    ckpt = os.path.join(run_dir, "ckpts", "ecg_baseline_best.npz")
    with open(os.path.join(run_dir, "logs", "metrics_ecg_baseline.csv")) as f:
        rows = list(csv.reader(f))
    losses = [[float(v) for v in r[3:8]] for r in rows[1:]]
    if (rows[0] != CSV_HEADER or len(rows) != 1 + TRAIN_EPOCHS
            or not np.isfinite([[r[0], r[4]] for r in losses]).all()):
        raise AssertionError(f"03 metrics CSV: {rows[:3]}")
    for path in (ckpt, os.path.splitext(ckpt)[0] + ".pth"):
        if not os.path.exists(path):
            raise AssertionError(f"03 wrote no {path}")
    for want in ("Train BCE:", "★ New best AUPRC:"):
        if want not in text:
            raise AssertionError(f"03 printed no {want!r}")
    if launches != 4 * state.step or launches <= 0:
        raise AssertionError(f"03: {launches} relu_pool_bwd launches for {state.step} steps")
    info = {"phase": "cli_train", "train_ecg_baseline": {
        "wall_s": wall, "epochs": TRAIN_EPOCHS, "steps": state.step, "csv": losses,
        "relu_pool_bwd_launches": launches}}

    mm_cfg = _cli_config(os.path.join(work, "mm.yaml"), root, os.path.join(out, "ecg_multimodal"),
                         1, "model:\n  ecg_multimodal:\n    in_leads: 12\n    ecg_feat_dim: 256\n"
                            f"    demo_hidden_dim: 64\n    pretrained_ecg_ckpt: {ckpt}\n")
    t0 = time.perf_counter()
    _, text = _run_cli(train_multimodal_prototype.main, ["--config", mm_cfg])
    mm_dir = os.path.join(out, "ecg_multimodal")
    with open(os.path.join(mm_dir, "logs", "metrics_ecg_multimodal.csv")) as f:
        mm_rows = list(csv.reader(f))
    if ("Loading pretrained ECG encoder" not in text or "Train-ECG-MM BCE:" not in text
            or len(mm_rows) != 2 or not np.isfinite(float(mm_rows[1][3]))
            or not os.path.exists(os.path.join(mm_dir, "ckpts", "ecg_multimodal_best.npz"))):
        raise AssertionError(f"04: CSV {mm_rows}")
    info["train_multimodal_prototype"] = {"wall_s": time.perf_counter() - t0,
                                          "train_bce": float(mm_rows[1][3]), "warm_start": ckpt}
    af_cfg = _cli_config(os.path.join(work, "af.yaml"), root, os.path.join(out, "af_binary"), 1)
    t0 = time.perf_counter()
    _run_cli(train_af_binary.main, ["--config", af_cfg])
    af_dir = os.path.join(out, "af_binary")
    with open(os.path.join(af_dir, "logs", "metrics_af_binary.csv")) as f:
        af_rows = list(csv.reader(f))
    if len(af_rows) != 2 or not os.path.exists(os.path.join(af_dir, "ckpts", "af_binary_best.npz")):
        raise AssertionError(f"05: CSV {af_rows}")
    info["train_af_binary"] = {"wall_s": time.perf_counter() - t0,
                               "train_bce": float(af_rows[1][3])}
    epoch = train_epoch(seed, datasets, phase="cli_train_epoch")
    info["epoch"] = {k: epoch[k] for k in (
        "records", "steps", "reader", "emit_adc", "epoch_wall_s", "records_per_s", "step_ms",
        "host_ms_per_batch", "idle_share", "device_busy_ms", "profiled_epoch_wall_s")}
    return info


def _csv_columns(path: str) -> dict:
    import csv

    with open(path) as f:
        rows = list(csv.reader(f))
    return {name: [r[i] for r in rows[1:]] for i, name in enumerate(rows[0])}


def phase_cli_eval(root: str, work: str) -> dict:
    """CLIs 06, 07 and 08 on the committed checkpoints over the tree's test
    split: the CSV columns, y_true against the labels, y_pred against y_prob
    at 0.5, y_prob against ``Predictor(engine="framework", precision=
    "highest")`` on the same raw records (2e-5); then 12 on the multimodal
    checkpoint, its CAM ``.npy`` against ``GradCAM`` on the same record (2e-3)."""
    from ptbxl_torch.cli import af_binary_test, ecg_baseline_test, ecg_multimodal_test
    from ptbxl_torch.cli import grad_cam_ecg_demo
    from ptbxl_torch.data import PTBXLAFDataset, PTBXLDataset, PTBXLECGMultimodalDataset
    from ptbxl_torch.inference import Predictor
    from ptbxl_torch.interpret.grad_cam import GradCAM
    from ptbxl_torch.models.factory import load_multimodal

    out = {"phase": "cli_eval"}
    cfg = _cli_config(os.path.join(work, "eval.yaml"), root, os.path.join(work, "eval_out"), 1)
    cases = (
        ("ecg_baseline_test", ecg_baseline_test, CKPT, PTBXLDataset(root, "test", CLASSES),
         [(f"y_true_{c}", f"y_prob_{c}", f"y_pred_{c}") for c in CLASSES], {}),
        ("ecg_multimodal_test", ecg_multimodal_test, CKPT_MM,
         PTBXLECGMultimodalDataset(root, "test", CLASSES),
         [(f"y_true_{c}", f"y_prob_{c}_mm", f"y_pred_{c}_mm") for c in CLASSES],
         {"arch": "multimodal"}),
        ("af_binary_test", af_binary_test, CKPT_AF, PTBXLAFDataset(root, "test"),
         [("y_true_AF", "y_prob_AF", "y_pred_AF")], {"num_labels": 1}),
    )
    for name, mod, ckpt, ds, triples, kw in cases:
        csv_path = os.path.join(work, f"{name}.csv")
        _run_cli(mod.main, ["--config", cfg, "--ckpt", ckpt, "--out_csv", csv_path])
        cols = _csv_columns(csv_path)
        if list(cols) != [c for t in triples for c in t]:
            raise AssertionError(f"{name}: CSV columns {list(cols)}")
        sigs = np.stack([ds.get_raw(i) for i in range(len(ds))])
        demo = {"demo": ds.demo} if kw.get("arch") == "multimodal" else {}
        want = Predictor.from_checkpoint(ckpt, engine="framework", precision="highest",
                                         **kw)(sigs, **demo)
        errs = []
        for j, (ct, cp, cd) in enumerate(triples):
            prob = np.array(cols[cp], np.float64)
            if (np.array(cols[ct], int) != ds.y[:, j]).any() or \
                    (np.array(cols[cd], int) != (prob >= 0.5)).any():
                raise AssertionError(f"{name}: {ct}/{cd} disagree with labels / probs")
            errs.append(float(np.abs(prob - want[:, j]).max()))
        out[name] = {"records": len(ds), "max_abs_err_vs_predictor": gate(
            f"{name} y_prob vs Predictor", max(errs), 2e-5)}

    ds = cases[1][3]
    idx = min(10, len(ds) - 1)
    cwd = os.getcwd()
    os.chdir(work)  # the CLI writes outputs/gradcam_multimodal/ under the working directory
    try:
        (cam_path, importance), _ = _run_cli(grad_cam_ecg_demo.main, [
            "--config", cfg, "--ckpt", CKPT_MM, "--index", str(idx)])
        cam_path = os.path.join(work, cam_path)
    finally:
        os.chdir(cwd)
    model, _ = load_multimodal(CKPT_MM, strict=False)
    x_ecg, x_demo, _ = ds[idx]
    _, cam = GradCAM(model, signal_length=x_ecg.shape[-1], norm_first=False, eps=1e-8,
                     multimodal=True)(x_ecg.T[None].copy(), 0, x_demo=x_demo[None])
    out["grad_cam_ecg_demo"] = {
        "index": idx, "cam_file": os.path.basename(cam_path),
        "max_abs_err_vs_grad_cam": gate("12 CAM vs GradCAM", float(np.abs(
            np.load(cam_path) - cam[0].cpu().numpy()).max()), 2e-3),
        "importance": [float(v) for v in importance]}
    return out


def _printed_metrics(text: str) -> dict:
    """{header: {metric: float}} from CLI 10's output."""
    out, header = {}, None
    for line in text.splitlines():
        if line.startswith("[") and line.endswith("metrics:"):
            header = line
            out[header] = {}
        elif header and line.startswith("  ") and ": " in line:
            k, v = line.strip().split(": ")
            out[header][k] = float(v)
    return out


def _rel_err(got, want) -> float:
    """max |got - want| / |want| over finite pairs; raises where nan sits apart."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if g.shape != w.shape or not np.array_equal(np.isnan(g), np.isnan(w)):
        raise AssertionError(f"{g} against {w}")
    fin = ~np.isnan(w)
    return float((np.abs(g[fin] - w[fin]) / np.maximum(np.abs(w[fin]), 1e-300)).max(initial=0.0))


def phase_cli_analysis(root: str, work: str) -> dict:
    """The eval path after CLIs 06-08, on their CSVs in ``work`` and the tree:
    09 (every merged cell its input's text), 10 (its printed metrics against
    ``compute_metrics`` of the merged columns, alphabetical), 14-17
    (``metrics_summary.csv`` against ``per_class_scores``; the figures written
    or skipped), 00 make_demo_pack (indices against ``pick_demo_indices``,
    ``meta.csv``, each ``.npz`` array bit for bit the dataset's item) and the
    raw exports, 02 and printsize (against the CSV and the datasets), then 11,
    13 and the demo CLI (on the bundled record and on one of the new pack) with
    K6's launches counted from 0 over those four runs: 11's and 13's CAMs
    against ``GradCAM`` with their settings (2e-3), the demo's probabilities
    against ``Predictor`` framework ``highest`` without a second z-score
    (2e-5).  Each CLI's wall seconds and 11's and 13's CAM call timed on the
    card (CUDA events)."""
    import collections
    import importlib.util

    from ptbxl_torch import demo_inference
    from ptbxl_torch.analysis.figures import LABELS_DEFAULT, per_class_scores
    from ptbxl_torch.cli import (analyse_merged_test, grad_cam_af, grad_cam_ecg_baseline,
                                 make_demo_pack, merge_all_test, plot_baseline_only,
                                 plot_distributions, plot_mm_only, plot_results, prepare_data,
                                 printsize, save_demo_ecg, save_demo_multimodal)
    from ptbxl_torch.data import PTBXLAFDataset, PTBXLDataset, PTBXLECGMultimodalDataset
    from ptbxl_torch.data.demo_export import pick_demo_indices
    from ptbxl_torch.inference import Predictor
    from ptbxl_torch.interpret.grad_cam import GradCAM
    from ptbxl_torch.models.factory import load_ecgcnn
    from ptbxl_torch.ops.kernels import relu_pool as k6
    from ptbxl_torch.training.metrics import compute_metrics
    from ptbxl_torch.utils.table import read_csv

    wall = {}

    def cli(name, main, argv):
        t0 = time.perf_counter()
        ret, text = _run_cli(main, argv)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        return ret, text

    out = {"phase": "cli_analysis", "wall_s": wall}
    # 09 on the three CSVs of cli_eval
    inputs = [os.path.join(work, f"{n}.csv")
              for n in ("ecg_baseline_test", "ecg_multimodal_test", "af_binary_test")]
    merged = os.path.join(work, "merged", "test_03_04_05_merged.csv")
    cli("merge_all_test", merge_all_test.main, [
        "--baseline_csv", inputs[0], "--multimodal_csv", inputs[1], "--af_csv", inputs[2],
        "--out_csv", merged])
    base, mm, af = (_csv_columns(p) for p in inputs)
    want = base | {c: v for c, v in mm.items() if not c.startswith("y_true_")} | af
    got = _csv_columns(merged)
    if list(got) != list(want) or got != want:
        raise AssertionError(f"09: merged columns {list(got)} != {list(want)} or a cell differs")
    n_rows = len(got["y_true_MI"])
    out["merge_all_test"] = {"rows": n_rows, "columns": len(got), "cells_equal": n_rows * len(got)}

    # 10: its printed metrics against compute_metrics on the merged columns
    t = read_csv(merged)

    def cols(names, dtype=np.float32):
        return np.array([t[c] for c in names], np.float64).T.astype(dtype)

    _, text = cli("analyse_merged_test", analyse_merged_test.main, ["--merged_csv", merged])
    alpha = ["CD", "HYP", "MI", "NORM", "STTC"]
    truth = cols([f"y_true_{c}" for c in alpha])
    want = {
        "[Baseline ECG][TEST] metrics:": compute_metrics(
            truth, cols([f"y_prob_{c}" for c in alpha])),
        "[ECG + demographics][TEST] metrics:": compute_metrics(
            truth, cols([f"y_prob_{c}_mm" for c in alpha])),
        "[AF binary][TEST] metrics:": compute_metrics(cols(["y_true_AF"]), cols(["y_prob_AF"])),
    }
    printed = _printed_metrics(text)
    if list(printed) != list(want) or any(list(printed[h]) != list(m) for h, m in want.items()):
        raise AssertionError(f"10 printed {printed}")
    out["analyse_merged_test"] = {"max_rel_err": gate("10 metrics", max(
        _rel_err(list(printed[h].values()), list(m.values())) for h, m in want.items()), 1e-12),
        "auroc_macro": {h: m["auroc_macro"] for h, m in want.items()}}

    # 14-17: metrics_summary.csv against per_class_scores; figures written or skipped
    fig_dir = os.path.join(work, "figures")
    drawn = {}
    for name, mod in (("plot_results", plot_results), ("plot_distributions", plot_distributions),
                      ("plot_baseline_only", plot_baseline_only), ("plot_mm_only", plot_mm_only)):
        ret, _ = cli(name, mod.main, ["--merged_csv", merged, "--out_dir", fig_dir])
        drawn.update(ret)
    summary = _csv_columns(os.path.join(fig_dir, "metrics_summary.csv"))
    header = (["model", "auroc_macro", "auprc_macro"] + [f"auroc_{c}" for c in LABELS_DEFAULT]
              + [f"auprc_{c}" for c in LABELS_DEFAULT])
    if list(summary) != header or summary["model"] != ["ecg", "mm"]:
        raise AssertionError(f"metrics_summary.csv: {summary}")
    y64 = cols([f"y_true_{c}" for c in LABELS_DEFAULT], np.float64)
    errs = []
    for i, suffix in enumerate(("", "_mm")):
        m = per_class_scores(y64, cols([f"y_prob_{c}{suffix}" for c in LABELS_DEFAULT], np.float64))
        row = [float(summary[c][i]) if summary[c][i] else float("nan") for c in header[1:]]
        errs.append(_rel_err(row, [m["auroc_macro"], m["auprc_macro"], *m["auroc_per_class"],
                                   *m["auprc_per_class"]]))
    written = sorted(f for f, ok in drawn.items() if ok)
    if (len(drawn) != 13 or any(not os.path.exists(os.path.join(fig_dir, f)) for f in written)
            or (written and importlib.util.find_spec("matplotlib") is None)):
        raise AssertionError(f"14-17 figures {drawn}")
    out["plots"] = {"metrics_summary_max_rel_err": gate("14 metrics_summary", max(errs), 1e-12),
                    "figures_written": written,
                    "figures_skipped": sorted(f for f, ok in drawn.items() if not ok)}

    # 00: the demo pack and the raw exports, against the datasets
    test_ds = PTBXLDataset(root, "test", CLASSES)
    mm_ds = PTBXLECGMultimodalDataset(root, "test", CLASSES)
    pack = os.path.join(work, "demo_pack")
    (idx_s, idx_m, meta_path), _ = cli("make_demo_pack", make_demo_pack.main,
                                       ["--base_dir", root, "--out_root", pack])
    meta = _csv_columns(meta_path)
    rows = []
    for ds, prefix, sub, idx in ((test_ds, "single", "single", idx_s),
                                 (mm_ds, "mm", "multimodal", idx_m)):
        want_idx, why = pick_demo_indices(ds.y, 1, 2, 42)
        if idx != want_idx:
            raise AssertionError(f"00 {sub}: indices {idx} != {want_idx}")
        for k, i in enumerate(idx):
            item = ds[i]
            z = np.load(os.path.join(pack, sub, f"{prefix}_sample_{k:02d}.npz"))
            arrays = {"ecg": item[0], "y": item[-1]} | ({"demo": item[1]} if sub != "single"
                                                         else {})
            if sorted(z.files) != sorted([*arrays, "classes"]) or \
                    list(z["classes"]) != CLASSES or \
                    not all(np.array_equal(z[a], v.astype(np.float32)) for a, v in arrays.items()):
                raise AssertionError(f"00 {sub}/{prefix}_sample_{k:02d}.npz != dataset item {i}")
            rows.append([f"{sub}/{prefix}_sample_{k:02d}.npz", sub, str(i), why[i],
                         ";".join(f"{c}={int(item[-1][j])}" for j, c in enumerate(CLASSES)),
                         str(int(item[-1].sum())), str(tuple(item[0].shape)),
                         str(tuple(item[1].shape)) if sub != "single" else ""])
    meta_rows = [list(r) for r in zip(*meta.values())]
    if list(meta) != ["file", "modality", "index_in_split", "chosen_for", "y_true", "y_sum",
                      "ecg_shape", "demo_shape"] or meta_rows != rows:
        raise AssertionError(f"00 meta.csv {meta}")
    raw = os.path.join(work, "demo_raw")
    cli("save_demo_ecg", save_demo_ecg.main, ["--base_dir", root, "--out_dir", raw])
    cli("save_demo_multimodal", save_demo_multimodal.main, ["--base_dir", root, "--out_dir", raw])
    exported = {f"demo_ecg_{i}.npy": test_ds[i][0] for i in range(3)} | {
        "demo_mm_ecg_0.npy": mm_ds[0][0], "demo_mm_demo_0.npy": mm_ds[0][1]}
    if sorted(os.listdir(raw)) != sorted(exported) or not all(
            np.array_equal(np.load(os.path.join(raw, f)), v) for f, v in exported.items()):
        raise AssertionError(f"00 save_demo_*: {sorted(os.listdir(raw))}")
    out["demo_pack"] = {"single": idx_s, "multimodal": idx_m, "npz_files": len(rows),
                        "raw_files": len(exported)}

    # 02 and printsize against the CSV and the datasets
    counts, _ = cli("prepare_data", prepare_data.main, ["--base_dir", root])
    folds = collections.Counter(int(f) for f in _csv_columns(
        os.path.join(root, "ptbxl_database.csv"))["strat_fold"])
    if counts["rows"] != sum(folds.values()) or counts["strat_fold"] != dict(sorted(folds.items())):
        raise AssertionError(f"02 counts {counts}")
    sizes, _ = cli("printsize", printsize.main, ["--base_dir", root])
    want_sizes = {kind: {s: len(cls(root, s, CLASSES)) for s in ("train", "val", "test")}
                  for kind, cls in (("baseline", PTBXLDataset),
                                    ("multimodal", PTBXLECGMultimodalDataset))}
    if sizes != want_sizes:
        raise AssertionError(f"printsize {sizes} != {want_sizes}")
    out["prepare_data"] = {"rows": counts["rows"], "strat_fold": counts["strat_fold"]}
    out["printsize"] = sizes

    # 11, 13 and the demo CLI on the card: K6 counted from 0 over the four runs
    af_ds = PTBXLAFDataset(root, "test")
    idx, idx_af = min(10, len(test_ds) - 1), min(10, len(af_ds) - 1)
    cfg = _cli_config(os.path.join(work, "cam.yaml"), root, os.path.join(work, "cam_out"), 1)
    demo_files = {"demo_bundled": os.path.join(DEMO, "single_sample_00.npz"),
                  "demo_pack": os.path.join(pack, "single", "single_sample_00.npz")}
    launches = {}
    cwd = os.getcwd()
    os.chdir(work)  # 11 and 13 write outputs/gradcam{,_af}/ under the working directory
    try:
        k6.launches = 0
        (cam11, info11, png11), _ = cli("grad_cam_ecg_baseline", grad_cam_ecg_baseline.main,
                                        ["--config", cfg, "--ckpt", CKPT, "--index", str(idx)])
        launches["grad_cam_ecg_baseline"] = k6.launches
        (cam13, png13), _ = cli("grad_cam_af", grad_cam_af.main,
                                ["--base_dir", root, "--ckpt", CKPT_AF, "--index", str(idx_af)])
        launches["grad_cam_af"] = k6.launches - sum(launches.values())
        demo_out = {}
        for name, path in demo_files.items():
            demo_out[name], _ = cli(name, lambda a: demo_inference.main(
                demo_inference.parse_args(a)), ["--demo_path", path, "--ckpt", CKPT,
                                                "--out_dir", os.path.join(work, name)])
            launches[name] = k6.launches - sum(launches.values())
        torch.cuda.synchronize()
        cam11, info11, cam13 = (os.path.join(work, p) for p in (cam11, info11, cam13))
    finally:
        os.chdir(cwd)
    if any(v != 1 for v in launches.values()):
        raise AssertionError(f"relu_pool_bwd launches on the Grad-CAM CLIs: {launches}")
    pngs = [png11, png13] + [p for _, p in demo_out.values()]
    if any((p is None) == (importlib.util.find_spec("matplotlib") is not None) for p in pngs):
        raise AssertionError(f"PNGs {pngs}")

    x, _ = test_ds[idx]
    x_af, _ = af_ds[idx_af]
    cams = {
        "grad_cam_ecg_baseline": (GradCAM(load_ecgcnn(CKPT, strict=False)[0],
                                          signal_length=T_FULL, norm_first=True), x, cam11),
        "grad_cam_af": (GradCAM(load_ecgcnn(CKPT_AF, num_labels=1, strict=True)[0],
                                signal_length=T_FULL, norm_first=False, eps=1e-9), x_af, cam13),
    }
    cam_err, cam_ms = {}, {}
    for name, (gc, rec, path) in cams.items():
        xt = torch.from_numpy(np.ascontiguousarray(rec.T[None])).cuda()
        _, cam = gc(xt, 0)
        cam_err[name] = gate(f"{name} CAM vs GradCAM",
                             float(np.abs(np.load(path) - cam[0].cpu().numpy()).max()), 2e-3)
        cam_ms[name] = time_ms(lambda: gc(xt, 0))
    with open(info11) as f:
        info = f.read()
    want_info = (f"Sample index: {idx}\nClass: MI\nClass idx: 0\nECG shape: (12, {T_FULL})\n"
                 f"CAM shape: ({T_FULL},)\n")
    if info != want_info:
        raise AssertionError(f"11 info.txt: {info!r}")
    pred = Predictor.from_checkpoint(CKPT, engine="framework", precision="highest",
                                     normalize=False)
    demo_err = {name: gate(f"{name} probs vs Predictor", float(np.abs(
        demo_out[name][0] - pred(np.load(path)["ecg"][None])[0]).max()), 2e-5)
        for name, path in demo_files.items()}
    out["grad_cam_cli"] = {"index": idx, "index_af": idx_af, "relu_pool_bwd_launches": launches,
                           "max_abs_err_cam": cam_err, "cam_device_ms": cam_ms,
                           "info_txt_ok": True, "demo_max_abs_err_vs_predictor": demo_err,
                           "pngs": pngs}
    return out


def phase_pipeline() -> dict:
    """The port bench's three pipeline rows at the bench's sizes (2048 records
    of [12, 5000], batch 256) on the card."""
    from ptbxl_torch import bench

    clock = bench.Clock(torch.device("cuda"))
    t0 = time.perf_counter()
    root = bench.pipeline_tree()
    tree_s = time.perf_counter() - t0
    stages = bench.bench_pipeline_stages(clock, root)
    scaling = bench.bench_host_scaling(clock, root)
    e2e = bench.bench_pipeline_e2e(clock, root)
    if scaling is None or stages["reader"] != "adc_cache" or not e2e["rps"] > 0:
        raise AssertionError(f"pipeline rows: stages {stages}, scaling {scaling}")
    return {"phase": "pipeline", "tree_s": tree_s, "stages": stages, "host_scaling": scaling,
            "e2e": e2e}


INT8_B = 8192  # the int8 forward's timing batch, the bench's int8 row


def _timed_with_memory(fn, dev: torch.device) -> dict:
    """Device ms of ``fn`` (median of 5) and the peak device memory it takes."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ms = time_ms(fn, reps=5)
    return {"ms": ms, "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def phase_int8(dev: torch.device, x_raw: torch.Tensor) -> dict:
    """The int8 path (``ops/quant.py``) on the card, every gate raising:

    * each layer's int8 conv (im2col + ``torch._int_mm``) against its plain
      version (exact f64 product) on that layer's int8 input (the four layers
      quantized, layer 0's K padded 180 -> 184), at B = 1 and 64: no value may
      differ; and the epilogue's int32 -> bf16 on the card against the CPU's;
    * the ``Predictor`` gates on the demo packs against the f32 ``highest``
      framework path: robust default < 4e-2, demo-calibrated < 5e-3, the
      multimodal and AF models < 4e-2;
    * the 519-signal battery (``quant_eval``) on the ECGCNN default against
      ``BATTERY_GATE``; the multimodal and AF models' reports beside it;
    * the card's int8 probs against the CPU's int8 path with the same q-params
      (the demo pack and 64 battery records), gated at 5e-3;
    * ms and peak memory of the int8 forward at ``INT8_B`` beside the
      framework bf16 forward and K4's hybrid row (the bench's rows).
    """
    from ptbxl_torch import bench
    from ptbxl_torch.inference import Predictor
    from ptbxl_torch.models.params_io import load_checkpoint
    from ptbxl_torch.ops import quant as q8, quant_eval as qe
    from ptbxl_torch.ops.kernels import fused_ecgcnn as k2
    from ptbxl_torch.ops.preprocess import zscore_per_lead_batch

    t_phase = time.perf_counter()
    state, _ = load_checkpoint(CKPT)
    out = {"phase": "int8", "shipped_layers": {a: list(q8.default_int8_layers(a))
                                               for a in ("ecgcnn", "multimodal")}}
    # each layer's conv on its own int8 input: the _int_mm route vs the plain version
    q_all = q8.quantize_model(state, int8_layers=(0, 1, 2, 3), device=dev)
    folded = k2.fold_bn_into_conv({k: v.to(dev) for k, v in state.items()})
    with torch.no_grad():
        taps = q8.folded_layer_inputs(folded, zscore_per_lead_batch(x_raw[:64]))
        conv = {}
        for i in range(4):
            xq = q8.quantize_act(taps[i], q_all[f"sx{i}"].to(dev))
            wm = q8.int8_weight_matrix(q_all[f"w{i}"].to(dev))
            for b in (1, 64):
                y = q8.int8_conv1d(xq[:b], wm)
                differ = int((y != q8.int8_conv1d_plain(xq[:b], wm)).sum())
                bf16_differ = int((y.to(torch.bfloat16).cpu() != y.cpu().to(torch.bfloat16)).sum())
                conv[f"layer{i} B={b} K={wm.shape[1]}"] = {
                    "values_differing": differ, "bf16_values_differing_from_cpu": bf16_differ,
                    "max_abs_int32": int(y.abs().max())}
                if differ or bf16_differ:
                    raise AssertionError(f"int8 conv layer {i} B={b}: {differ} values differ "
                                         f"from the plain version, {bf16_differ} bf16 values "
                                         "from the CPU's conversion")
        del taps
    out["int8_conv"] = conv

    # the Predictor gates on the three checkpoints
    sigs = demo_signals()
    sigs_mm, demos_mm = mm_demo_pack()
    ref = Predictor.from_checkpoint(CKPT, engine="framework")(sigs)
    q_robust = q8.quantize_model(state, device=dev)
    p_q = Predictor.from_checkpoint(CKPT, precision="int8", qparams=q_robust)
    got = p_q(sigs)
    p_demo = Predictor.from_checkpoint(CKPT, precision="int8",
                                       calib_signals=q8.demo_pack_signals())
    ref_mm = Predictor.from_checkpoint(CKPT_MM, arch="multimodal", engine="framework")(
        sigs_mm, demo=demos_mm)
    p_mm = Predictor.from_checkpoint(CKPT_MM, arch="multimodal", precision="int8")
    ref_af = Predictor.from_checkpoint(CKPT_AF, num_labels=1, engine="framework")(sigs)
    p_af = Predictor.from_checkpoint(CKPT_AF, num_labels=1, precision="int8")
    out["predictor_vs_highest"] = {
        "ecgcnn_robust": gate("int8 Predictor robust", float(np.abs(got - ref).max()), 4e-2),
        "ecgcnn_demo_calibrated": gate("int8 Predictor demo-calibrated",
                                       float(np.abs(p_demo(sigs) - ref).max()), 5e-3),
        "multimodal": gate("int8 Predictor multimodal",
                           float(np.abs(p_mm(sigs_mm, demo=demos_mm) - ref_mm).max()), 4e-2),
        "af": gate("int8 Predictor AF", float(np.abs(p_af(sigs) - ref_af).max()), 4e-2),
    }
    out["engine"] = p_q.engine

    # the battery: gated on the ECGCNN default, reported for the other two
    bat = qe.make_battery()
    keys = ("n", "num_decisions", "int8_layers", "max", "p99", "p50", "mean", "flips",
            "flip_rate", "flip_margin")
    rep = qe.quant_accuracy_report(state, "ecgcnn", signals=bat, q=q_robust, device=dev)
    if not qe.passes_battery_gate(rep):
        raise AssertionError(f"int8 battery {rep} breaches {qe.BATTERY_GATE}")
    state_mm, _ = load_checkpoint(CKPT_MM, arch="multimodal")
    state_af, _ = load_checkpoint(CKPT_AF)
    rep_mm = qe.quant_accuracy_report(state_mm, "multimodal", signals=bat, device=dev)
    rep_af = qe.quant_accuracy_report(state_af, "ecgcnn", signals=bat, num_labels=1, device=dev)
    out["battery"] = {"gate": qe.BATTERY_GATE,
                      "ecgcnn": {k: rep[k] for k in keys},
                      "multimodal_reported": {k: rep_mm[k] for k in keys},
                      "af_reported": {k: rep_af[k] for k in keys}}

    # the card against the CPU's int8 path with the same q-params
    p_cpu = Predictor.from_checkpoint(CKPT, precision="int8", qparams=q_robust, device="cpu")
    x_cmp = np.concatenate([sigs, bat[:64]])
    out["card_vs_cpu_max_abs"] = gate("int8 card vs CPU", float(np.abs(p_q(x_cmp)
                                                                       - p_cpu(x_cmp)).max()), 5e-3)

    # times at the bench's batch, beside framework bf16 and the hybrid row (K4)
    times = {}
    with torch.no_grad():
        for name, path, dtype_name, wire in (("int8", "int8", "int8", torch.bfloat16),
                                             ("framework_bf16", "framework", "bf16", torch.float32),
                                             ("hybrid_k4", "hybrid", "bf16", torch.float32)):
            fwd = bench.build_forward(path, dtype_name, dev)
            xb = bench._random_batch(INT8_B, wire, dev)
            times[name] = _timed_with_memory(lambda: fwd(xb), dev)
            times[name]["rps"] = INT8_B / (times[name]["ms"] / 1e3)
            del xb, fwd
    out["times_b8192"] = times
    out["int8_chunk_records"] = q8.chunk_records(T_FULL, q_robust, q_robust["int8_layers"])
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def phase_serving(dev: torch.device, work: str, x_raw: torch.Tensor) -> dict:
    """The serving export (``ptbxl_torch/serving.py``) on the card: export,
    then a fresh ``ServingModel`` of each artifact against the ``Predictor``
    of the same engine and precision (int8 on the same q-params) on the demo
    pack and 64 raw requests, within 2e-6: ECGCNN ``highest``, ``default``,
    ``int8``, ``with_cam`` (probs against ``highest``, CAMs against
    ``GradCAM.multi`` within 1e-5) and the kernel engine (batch 8, chunked
    and padded), the multimodal model's ``highest`` and kernel engine.  K1,
    K2 and K3 are counted from 0 around the kernel-engine artifacts' calls
    and must have launched.  Export seconds and host ms a call (N = 7)."""
    from ptbxl_torch.inference import Predictor
    from ptbxl_torch.interpret.grad_cam import GradCAM
    from ptbxl_torch.models.factory import load_ecgcnn
    from ptbxl_torch.models.params_io import load_checkpoint
    from ptbxl_torch.ops import quant as q8
    from ptbxl_torch.ops.kernels import fused_ecgcnn as k2, zscore as k1
    from ptbxl_torch.ops.preprocess import zscore_per_lead_batch
    from ptbxl_torch.serving import ServingModel, export_serving_artifact

    sigs = demo_signals()
    sigs_mm, demos_mm = mm_demo_pack()
    reqs = x_raw[:64].transpose(1, 2).cpu().numpy()  # [64, 12, T], the reference layout
    reqs_demo = np.tile(demos_mm, (10, 1))[:64]
    state, _ = load_checkpoint(CKPT)
    q = q8.quantize_model(state, device=dev)
    cases = (("highest", CKPT, {}), ("default", CKPT, {"precision": "default"}),
             ("int8", CKPT, {"precision": "int8", "qparams": q}),
             ("with_cam", CKPT, {"with_cam": True}), ("kernel", CKPT, {"engine": "kernel"}),
             ("multimodal_highest", CKPT_MM, {"arch": "multimodal"}),
             ("multimodal_kernel", CKPT_MM, {"arch": "multimodal", "engine": "kernel"}))
    rows, launches = {}, {"zscore": 0, "fused_ecgcnn": 0, "fused_multimodal": 0}
    for name, ckpt, kw in cases:
        path = os.path.join(work, f"{name}.ptbxlpt")
        t0 = time.perf_counter()
        export_serving_artifact(ckpt, path, **kw)
        export_s = time.perf_counter() - t0
        model = ServingModel(path)
        mm = kw.get("arch") == "multimodal"
        pred = Predictor.from_checkpoint(
            ckpt, arch=kw.get("arch", "ecgcnn"), engine=kw.get("engine", "framework"),
            precision=kw.get("precision", "highest"), qparams=kw.get("qparams"))
        inputs = [((sigs_mm,), {"demo": demos_mm}), ((reqs,), {"demo": reqs_demo})] if mm \
            else [((sigs,), {}), ((reqs,), {})]
        kernel = kw.get("engine") == "kernel"
        if kernel:
            k1.launches = k2.launches = k2.launches_mm = 0
        outs = [model(*a, **k) for a, k in inputs]
        if kernel:
            torch.cuda.synchronize()
            launches["zscore"] += k1.launches
            launches["fused_multimodal" if mm else "fused_ecgcnn"] += (
                k2.launches_mm if mm else k2.launches)
        probs = [o[0] if model.with_cam else o for o in outs]
        err = max(float(np.abs(p - pred(*a, **k)).max()) for p, (a, k) in zip(probs, inputs))
        row = {"export_s": export_s, "max_abs_err_vs_predictor": gate(
            f"serving {name} vs Predictor", err, 2e-6),
               "meta": {k: model.meta[k] for k in ("precision", "engine", "batch_size",
                                                   "platforms", "int8_layers")}}
        if model.with_cam:
            cam_model, _ = load_ecgcnn(CKPT)
            cam = GradCAM(cam_model, signal_length=T_FULL, norm_first=False, eps=1e-9)
            cam_err = 0.0
            for (a, _), o in zip(inputs, outs):
                x = torch.from_numpy(np.ascontiguousarray(a[0].transpose(0, 2, 1))).to(dev)
                _, want = cam.multi(zscore_per_lead_batch(x), range(5))
                cam_err = max(cam_err, float(np.abs(o[1] - want.transpose(0, 1).cpu().numpy())
                                             .max()))
            row["cam_max_abs_err_vs_grad_cam"] = gate(f"serving {name} CAMs", cam_err, 1e-5)
        if not all(np.isfinite(p).all() and p.shape == (len(a[0]), 5)
                   for p, (a, _) in zip(probs, inputs)):
            raise AssertionError(f"serving {name}: bad output {[p.shape for p in probs]}")
        t0 = time.perf_counter()
        model(*inputs[0][0], **inputs[0][1])
        row["call_ms_n7"] = (time.perf_counter() - t0) * 1e3
        rows[name] = row
        os.remove(path)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the kernel-engine artifacts launched no {name} kernel")
    return {"phase": "serving", "launches": launches, "artifacts": rows}


K4_KERNELS = ("zscore", "wgmma_conv_block", "sums_tail")  # the bf16 route's own kernels


PHASE_B = 64  # phase_domain's train steps (configs/ecg_baseline.yaml's batch)
FRONT_B = 8192  # the packed front's batch (the port bench's hybrid row)
TRAIN_PROBE_B = 512  # train_probes' batch; the JAX tools' 4096 runs standalone
TRAIN_PROBE_ITERS = 3
PROTO_INT8_B = 2048  # proto_int8's timing rows
FETCH_DELETED = 24  # records of the fetch phase's local copy with a file deleted


def _phase_models(arch: str, state: dict, prec: str, dtype: torch.dtype) -> dict:
    """{phase_train: model} from one state dict, on the card."""
    from ptbxl_torch.models.ecg_cnn import ECGCNN
    from ptbxl_torch.models.ecg_multimodal import ECGMultimodal

    cls = ECGMultimodal if arch == "multimodal" else ECGCNN
    out = {}
    for phase in (False, True):
        m = cls(num_labels=5, precision=prec, dtype=dtype, phase_train=phase)
        m.load_state_dict(state)
        out[phase] = m.cuda()
    return out


def _phase_steps(arch: str, state: dict, gen: torch.Generator) -> tuple:
    """One train step (``make_train_step``) with ``phase_train`` against the
    standard step from the same weights and batch, f32 ``highest`` and bf16
    ``default``, K6 counted from 0 around each step; eval logits of the two
    forms; the steps' ms in turns (standard, phase, phase, standard)."""
    from ptbxl_torch.ops.kernels import relu_pool as k6
    from ptbxl_torch.ops.preprocess import zscore_per_lead_batch
    from ptbxl_torch.training.loop import make_train_step
    from ptbxl_torch.training.train_state import create_train_state

    mm = arch == "multimodal"
    batch = _train_batch(PHASE_B, gen, demo=mm)
    step = make_train_step(multimodal=mm)
    xz = zscore_per_lead_batch(batch["ecg"])
    out, launches, f32_loss = {}, {"phase_train": 0, "standard": 0}, None
    cudnn = torch.backends.cudnn
    for prec, dtype, name in (("highest", torch.float32, "f32"),
                              ("default", torch.bfloat16, "bf16")):
        models = _phase_models(arch, state, prec, dtype)
        saved = cudnn.deterministic
        cudnn.deterministic = True
        try:
            with torch.no_grad():
                ev = [m.eval()(xz, batch["demo"]) if mm else m.eval()(xz)
                      for m in models.values()]
        finally:
            cudnn.deterministic = saved
        if not torch.equal(ev[0], ev[1]):
            raise AssertionError(f"{arch} {name}: phase_train changed the eval logits")
        res, states = {}, {}
        for phase, m in models.items():
            states[phase] = create_train_state(m, TRAIN_LR, TRAIN_WD)
            k6.launches = 0
            _, loss = step(states[phase], batch)
            torch.cuda.synchronize()
            want = 1 if phase else 4
            if k6.launches != want:
                raise AssertionError(f"{arch} {name} phase_train={phase}: {k6.launches} K6 "
                                     f"launches in a step (want {want})")
            launches["phase_train" if phase else "standard"] += k6.launches
            res[phase] = {"loss": float(loss),
                          "grads": {n: p.grad.detach().clone() for n, p in m.named_parameters()},
                          "bn": {k: v.clone() for k, v in m.state_dict().items()
                                 if "running_" in k}}
        std, ph = res[False], res[True]
        row = {"loss_standard": std["loss"], "loss_phase": ph["loss"],
               "eval_logits_bit_identical": True,
               "relu_pool_bwd_launches": {"standard": 4, "phase_train": 1}}
        if name == "f32":
            f32_loss = std["loss"]
            row["loss_abs_diff"] = gate(f"{arch} phase loss", abs(ph["loss"] - std["loss"]), 1e-5)
            row["bn_max_abs_diff"] = gate(f"{arch} phase BN stats", max(
                max_diff(ph["bn"][k], v) for k, v in std["bn"].items()), 1e-5)
            worst = 0.0
            for n, g in std["grads"].items():
                scale = max(1.0, float(g.abs().max()))
                err = gate(f"{arch} phase grad {n}", max_diff(ph["grads"][n], g), 2e-4 * scale)
                worst = max(worst, err / scale)
            row["grad_max_abs_diff_over_scale"] = worst
        else:
            row["loss_vs_f32_standard"] = {
                "standard": gate(f"{arch} bf16 standard loss vs f32", abs(std["loss"] - f32_loss),
                                 5e-3),
                "phase": gate(f"{arch} bf16 phase loss vs f32", abs(ph["loss"] - f32_loss), 5e-3)}
        ms = {False: [], True: []}
        for phase in (False, True, True, False):
            ms[phase].append(time_ms(lambda: step(states[phase], batch)))
        row["step_ms_standard"], row["step_ms_phase"] = ms[False], ms[True]
        out[name] = row
        del models, states, res
    return out, launches


def _block_inputs(state: dict, x: torch.Tensor) -> list:
    """Each conv block's input [B, Cin, T] of the eval ECGCNN on z-scored
    ``x [B, T, 12]``, f32 ``highest``; and the model."""
    from ptbxl_torch.models.ecg_cnn import ECGCNN
    from ptbxl_torch.utils.device import highest_precision

    m = ECGCNN(num_labels=5)
    m.load_state_dict(state)
    m = m.cuda().eval()
    hs = [x.transpose(1, 2).contiguous()]
    with torch.no_grad(), highest_precision():
        for blk in m.backbone[:-1]:
            hs.append(blk(hs[-1]))
    return hs, m


def _fast_wgrad_case(h: torch.Tensor, w: torch.Tensor, gen: torch.Generator) -> dict:
    """``conv1d_fast_wgrad`` at one block's geometry against autograd's conv:
    dx bit for bit (deterministic cuDNN), dw relative to max|dw|; then the
    backward's ms, with and without dx, against autograd's (TF32 off)."""
    from ptbxl_torch.ops.fast_wgrad import _pick_phases, conv1d_fast_wgrad
    from ptbxl_torch.utils.device import highest_precision

    x = h.transpose(1, 2).contiguous()                 # [B, T, Cin]
    kern = w.detach().permute(2, 1, 0).contiguous()    # [15, Cin, Cout]
    dy = torch.randn(x.shape[0], x.shape[1], kern.shape[2], generator=gen, device="cuda")

    def graph(fast: bool, need_dx: bool):
        xr = x.clone().requires_grad_(need_dx)
        wr = kern.clone().requires_grad_(True)
        if fast:
            y = conv1d_fast_wgrad(xr, wr, (7, 7), "highest")
        else:
            y = F.conv1d(xr.transpose(1, 2), wr.permute(2, 1, 0), padding=7).transpose(1, 2)
        return y, ((xr, wr) if need_dx else (wr,))

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        with highest_precision():
            (yr, ins_r), (yf, ins_f) = graph(False, True), graph(True, True)
            dx_r, dw_r = torch.autograd.grad(yr, ins_r, dy)
            dx_f, dw_f = torch.autograd.grad(yf, ins_f, dy)
    finally:
        cudnn.deterministic = saved
    t = x.shape[1]
    row = {"T": t, "Cin": x.shape[2], "Cout": kern.shape[2], "phases": _pick_phases(t),
           "primal_max_abs_diff": gate(f"fast_wgrad primal T={t}",
                                       max_diff(yf.detach(), yr.detach()), 0.0),
           "dx_max_abs_diff": gate(f"fast_wgrad dx T={t}", max_diff(dx_f, dx_r), 0.0),
           "dw_rel_err": gate(f"fast_wgrad dw T={t}",
                              max_diff(dw_f, dw_r) / float(dw_r.abs().max()), 1e-5)}
    with highest_precision():
        for key, need_dx in (("bwd", True), ("wgrad", False)):
            for fast in (False, True):
                y, ins = graph(fast, need_dx)
                row[f"{'fast' if fast else 'autograd'}_{key}_ms"] = time_ms(
                    lambda: torch.autograd.grad(y, ins, dy, retain_graph=True))
    return row


def phase_domain(gen: torch.Generator) -> dict:
    """The phase-domain training alternatives at full width (T=5000) on the
    committed ECGCNN and multimodal checkpoints: ``phase_train`` steps against
    the standard ones (``_phase_steps``); ``phase_conv_cf`` at blocks 0-2's
    geometries against ``F.conv1d`` interleaved (f32, TF32 off, 1e-5) and
    both timed; ``conv1d_fast_wgrad`` at each block's geometry; the packed
    front at B=8192 against ``_front_plain`` (f32 1e-5 with TF32 off, bf16
    5e-3 with TF32 allowed for both) and both timed."""
    from ptbxl_torch.models.params_io import load_checkpoint
    from ptbxl_torch.ops.kernels.fused_ecgcnn import fold_bn_into_conv
    from ptbxl_torch.ops.kernels.hybrid_ecgcnn import _front_plain
    from ptbxl_torch.ops.phase_conv import phase_conv_cf
    from ptbxl_torch.ops.phase_pack import phase_packed_front, prepack_front
    from ptbxl_torch.ops.preprocess import zscore_per_lead_batch
    from ptbxl_torch.utils.device import highest_precision

    info = {"phase": "phase_domain", "batch": PHASE_B, "steps": {}}
    launches = {"phase_train": 0, "standard": 0}
    for arch, ckpt in (("ecgcnn", CKPT), ("multimodal", CKPT_MM)):
        state, _ = load_checkpoint(ckpt, arch=arch)
        info["steps"][arch], n = _phase_steps(arch, state, gen)
        for k in launches:
            launches[k] += n[k]
    info["relu_pool_bwd_launches"] = launches

    state, _ = load_checkpoint(CKPT)
    hs, model = _block_inputs(state, zscore_per_lead_batch(raw_batch(PHASE_B, gen)))
    info["phase_conv"], info["fast_wgrad"] = [], []
    with torch.no_grad(), highest_precision():
        for i, h in enumerate(hs[:3]):
            conv = model.backbone[i].net[0]
            got = phase_conv_cf(h, conv.weight, conv.bias)
            want = F.conv1d(h, conv.weight, conv.bias, padding=7)
            b, c2, u = got.shape
            inter = got.view(b, 2, c2 // 2, u).permute(0, 2, 3, 1).reshape(want.shape)
            info["phase_conv"].append({
                "T": h.shape[2], "Cin": h.shape[1], "Cout": c2 // 2,
                "max_abs_err": gate(f"phase_conv block {i}", max_diff(inter, want), 1e-5),
                "ms": time_ms(lambda: phase_conv_cf(h, conv.weight, conv.bias)),
                "conv_ms": time_ms(lambda: F.conv1d(h, conv.weight, conv.bias, padding=7))})
    for i, h in enumerate(hs):
        info["fast_wgrad"].append(_fast_wgrad_case(h, model.backbone[i].net[0].weight, gen))
    del hs

    folded = fold_bn_into_conv({k: v.cuda() for k, v in state.items()})
    packed = prepack_front(folded)
    xz = zscore_per_lead_batch(raw_batch(FRONT_B, gen))
    info["packed_front"] = {"batch": FRONT_B}
    for dt, tol, scope in ((torch.float32, 1e-5, highest_precision),
                           (torch.bfloat16, 5e-3, contextlib.nullcontext)):
        with torch.no_grad(), scope():
            err = max_diff(phase_packed_front(xz, None, dt, packed),
                           _front_plain(xz, folded, 2, dt))
            info["packed_front"][str(dt)[6:]] = {
                "max_abs_err": gate(f"packed front {dt}", err, tol),
                "ms": time_ms(lambda: phase_packed_front(xz, None, dt, packed), reps=5),
                "plain_ms": time_ms(lambda: _front_plain(xz, folded, 2, dt), reps=5)}
    del xz
    return info


def phase_train_probes() -> dict:
    """The four training-backward probes and ``proto_int8`` on the card at
    TRAIN_PROBE_B (one line each; the form errors of ``probe_phase_forms``
    gated at 1e-5 relative in f32), then ``proto_int8``'s demo-pack error
    beside the shipped int8 ``Predictor``'s."""
    from ptbxl_torch.inference import Predictor
    from ptbxl_torch.tools import (probe_bwd_breakdown, probe_phase_forms, probe_pool,
                                   probe_train_gap, proto_int8)

    b, it = TRAIN_PROBE_B, TRAIN_PROBE_ITERS
    rows = probe_phase_forms.run(b, "f32", T_FULL, it, "cuda")
    for r in rows:
        gate(f"probe_phase_forms s2p T={r['T']}", r["err_s2p"], 1e-5)
        gate(f"probe_phase_forms pair T={r['T']}", r["err_pair"], 1e-5)
    emit({"phase": "probe_phase_forms", "batch": b, "dtype": "f32", "rows": rows})
    emit({"phase": "probe_pool", "batch": b, "dtype": "bf16",
          "rows": probe_pool.run(b, "bf16", T_FULL, it, "cuda")})
    emit({"phase": "probe_bwd_breakdown", "batch": b, "dtype": "bf16",
          "rows": probe_bwd_breakdown.run(b, "bf16", T_FULL, it, "cuda")})
    emit({"phase": "probe_train_gap", "batch": b, "dtype": "bf16",
          "rows": probe_train_gap.run(b, "bf16", T_FULL, it, "cuda")})
    out = proto_int8.run("cuda", batch=PROTO_INT8_B)
    sigs = demo_signals()
    shipped = Predictor.from_checkpoint(CKPT, precision="int8")(sigs)
    ref = Predictor.from_checkpoint(CKPT, engine="framework")(sigs)
    out["shipped_int8_max_abs_dprob"] = float(np.abs(shipped - ref).max())
    for name, r in out["demo_pack"].items():
        if not np.isfinite(r["max_abs_dprob"]):
            raise AssertionError(f"proto_int8 {name}: {r}")
    return {"phase": "proto_int8", **out}


class _QuietHandler(http.server.SimpleHTTPRequestHandler):
    """A static file server that logs no requests."""

    def log_message(self, *args) -> None:
        pass


def phase_fetch(tree: str, work: str) -> dict:
    """CLI 01 against a loopback mirror: a copy of the synthetic tree served by
    ``http.server`` on 127.0.0.1 (it lacks the ``.dat`` of the one record the
    data layer drops as unreadable) and a local copy with a ``.hea`` or
    ``.dat`` deleted from FETCH_DELETED complete records.  A run capped by
    ``--max_missing`` fetches that many records and exits 0; the full run
    fetches the rest byte for byte, leaves no ``.part``, ends with the record
    the server lacks in ``failed_records`` and exits 1."""
    import functools
    import shutil
    import threading

    from ptbxl_torch.cli import download_missing_records as cli01
    from ptbxl_torch.data.fetch import scan_missing

    served, local = os.path.join(work, "served"), os.path.join(work, "local")
    shutil.copytree(tree, served, ignore=shutil.ignore_patterns(".ptbxl_*"))
    shutil.copytree(served, local)
    lost = scan_missing(served)
    rels = sorted(os.path.relpath(p, served)[:-4] for p in glob.glob(
        os.path.join(served, "records500", "*", "*.dat")))[:FETCH_DELETED]
    for i, rel in enumerate(rels):
        os.remove(os.path.join(local, rel + (".hea", ".dat")[i % 2]))
    cap = len([r for r in rels if r < lost[0]]) if lost else 0
    if not lost or cap < 1:
        raise AssertionError(f"fetch: the tree lacks {lost}; {cap} records before it")
    handler = functools.partial(_QuietHandler, directory=served)
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_port}/"
    t0 = time.perf_counter()
    try:
        capped, _ = _run_cli(cli01.main, ["--base_dir", local, "--base_url", url,
                                          "--max_missing", str(cap)])
        left = scan_missing(local)
        if (capped.attempted, capped.completed, len(left)) != (cap, cap, FETCH_DELETED + 1 - cap):
            raise AssertionError(f"--max_missing {cap}: {capped}, {len(left)} left")
        try:
            _run_cli(cli01.main, ["--base_dir", local, "--base_url", url])
            code = 0
        except SystemExit as e:
            code = e.code
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
    wall_s = time.perf_counter() - t0
    if code != 1 or scan_missing(local) != lost:
        raise AssertionError(f"CLI 01 exit {code}, still missing {scan_missing(local)}")
    differing = [rel + sfx for rel in rels for sfx in (".hea", ".dat")
                 if open(os.path.join(local, rel + sfx), "rb").read()
                 != open(os.path.join(served, rel + sfx), "rb").read()]
    parts = glob.glob(os.path.join(local, "**", "*.part"), recursive=True)
    if differing or parts:
        raise AssertionError(f"fetched files differ {differing}, .part left {parts}")
    return {"phase": "fetch", "records_deleted": FETCH_DELETED, "capped_run": cap,
            "fetched_byte_equal": FETCH_DELETED, "failed_records": lost, "exit_code": code,
            "part_files_left": 0, "wall_s": wall_s}


DET_B = 64  # the determinism phase's batch (configs/ecg_baseline.yaml's)
DET_CASES = (("ecgcnn", "f32"), ("ecgcnn", "bf16"), ("multimodal", "f32"))


def _seed_epoch(ds, arch: str, dtype_name: str, seed: int) -> tuple:
    """tests/test_determinism.py's ``_one_epoch`` on the card: a model from
    ``seed``, one shuffled epoch of ``ds`` (``BatchSource`` seeded with it);
    (epoch loss, state dict, train steps)."""
    from ptbxl_torch.data.pipeline import BatchSource, device_prefetch
    from ptbxl_torch.models.factory import build_ecgcnn, build_multimodal
    from ptbxl_torch.training.loop import make_train_step, train_one_epoch
    from ptbxl_torch.training.train_state import create_train_state

    mm = arch == "multimodal"
    dtype, prec = (torch.float32, "highest") if dtype_name == "f32" else (torch.bfloat16,
                                                                          "default")
    model = (build_multimodal if mm else build_ecgcnn)(num_labels=5, seed=seed,
                                                       precision=prec, dtype=dtype)
    state = create_train_state(model, TRAIN_LR, TRAIN_WD)
    src = BatchSource(ds, DET_B, shuffle=True, seed=seed)
    _, loss = train_one_epoch(state, make_train_step(multimodal=mm),
                              device_prefetch(src.epoch(0)))
    return loss, {k: v.detach().clone() for k, v in model.state_dict().items()}, state.step


def _state_max_diff(a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def phase_determinism(tree: str) -> dict:
    """The JAX package's identical-seeds contract (tests/test_determinism.py)
    on the card: for each of DET_CASES, one epoch of the tree's train split at
    seed 3 twice gives the same loss and every state-dict entry bit for bit,
    and seed 4 another loss; K6, counted from 0 over those epochs, launches
    four times a step.  Then, for the f32 ECGCNN, the same two epochs with
    the train step's deterministic scope replaced by a no-op scope and
    cuDNN's global flags at torch's defaults (what the step did before it
    pinned cuDNN): their spread, reported."""
    from ptbxl_torch.data import PTBXLDataset, PTBXLECGMultimodalDataset
    from ptbxl_torch.ops.kernels import relu_pool as k6
    from ptbxl_torch.training import loop

    t0 = time.perf_counter()
    sets = {"ecgcnn": PTBXLDataset(tree, "train", CLASSES),
            "multimodal": PTBXLECGMultimodalDataset(tree, "train", CLASSES)}
    cases, steps = {}, 0
    k6.launches = 0
    for arch, dtype_name in DET_CASES:
        (l1, s1, n1), (l2, s2, n2) = (_seed_epoch(sets[arch], arch, dtype_name, 3)
                                      for _ in range(2))
        l4, _, n4 = _seed_epoch(sets[arch], arch, dtype_name, 4)
        steps += n1 + n2 + n4
        name = f"{arch} {dtype_name}"
        unequal = [k for k in s1 if not torch.equal(s1[k], s2[k])]
        if l1 != l2 or unequal:
            raise AssertionError(f"determinism {name}: seed 3 twice gave losses {l1} and {l2}, "
                                 f"state-dict entries apart: {unequal[:5]}")
        if l4 == l1:
            raise AssertionError(f"determinism {name}: seeds 3 and 4 gave the same loss {l1}")
        cases[name] = {"records": len(sets[arch]), "steps": n1,
                       "loss_seed3": [l1, l2], "loss_seed4": l4, "state_dict_entries": len(s1),
                       "state_dict_max_abs_diff": _state_max_diff(s1, s2)}
    launches = k6.launches
    if launches != 4 * steps:
        raise AssertionError(f"determinism: {launches} relu_pool_bwd launches for {steps} steps")
    cudnn, scoped = torch.backends.cudnn, loop.deterministic_algorithms
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = False, False
    loop.deterministic_algorithms = contextlib.nullcontext
    try:
        (l1, s1, _), (l2, s2, _) = (_seed_epoch(sets["ecgcnn"], "ecgcnn", "f32", 3)
                                    for _ in range(2))
    finally:
        loop.deterministic_algorithms = scoped
        cudnn.deterministic, cudnn.benchmark = saved
    return {"phase": "determinism", "batch": DET_B, "cases": cases, "train_steps": steps,
            "launches": {"relu_pool_bwd": launches},
            "ecgcnn_f32_without_the_scope": {
                "loss_abs_diff": abs(l1 - l2), "state_dict_max_abs_diff": _state_max_diff(s1, s2),
                "entries_apart": sum(not torch.equal(s1[k], s2[k]) for k in s1)},
            "phase_s": time.perf_counter() - t0}


FUZZ_SEEDS = (0, 1, 2, 3)
FUZZ_TRIALS = 400  # a seed
# The showdown phase's runs: the port with each JAX artifact's stored config
# (baseline, the six baseline-hard seeds, multimodal, AF); `python -m
# ptbxl_torch.tools.showdown run --all` runs all 32, the `_ti`, mm-hard, AF-hard
# and baseline ts43-47 artifacts too.  One seed runs twice: the train and eval
# steps hold cuDNN to deterministic algorithms, so the second run gives the same
# best epoch and the same test probabilities bit for bit.
SHOWDOWN_RUNS = ("jax.json", "jax_hard.json", "jax_hard_ts43.json", "jax_hard_ts44.json",
                 "jax_hard_ts45.json", "jax_hard_ts46.json", "jax_hard_ts47.json",
                 "jax_mm.json", "jax_af.json")
SHOWDOWN_REPEAT = "jax_hard_ts45.json"
SHOWDOWN_AUROC_BUDGET = 0.005  # the north star: final macro-AUROC within 0.005 of JAX's


def phase_fuzz_wfdb() -> dict:
    """The port's WFDB codec under FUZZ_SEEDS x FUZZ_TRIALS random records
    (``tools/fuzz_wfdb.py``'s trials) on this machine's Python and numpy: no
    mismatch with the oracle."""
    from ptbxl_torch.tools import fuzz_wfdb

    t0 = time.perf_counter()
    failures = [f for seed in FUZZ_SEEDS for f in fuzz_wfdb.fuzz(FUZZ_TRIALS, seed)]
    wall_s = time.perf_counter() - t0
    if failures:
        raise AssertionError(f"fuzz_wfdb: {len(failures)} mismatches, first {failures[0]}")
    n = FUZZ_TRIALS * len(FUZZ_SEEDS)
    return {"phase": "fuzz_wfdb", "trials": n, "seeds": list(FUZZ_SEEDS), "mismatches": 0,
            "wall_s": wall_s, "trials_per_s": n / wall_s, "python": sys.version.split()[0],
            "numpy": np.__version__}


def phase_showdown() -> dict:
    """The training showdown on the card against JAX's committed artifacts.

    The regenerated labels equal every ``test_y`` / ``val_y`` the JAX
    artifacts store; the port trains SHOWDOWN_RUNS with their stored configs
    and each family's ``compare`` holds its AUROC deficit (paired seed means
    for hard) within SHOWDOWN_AUROC_BUDGET; K6, counted from 0 over the
    runs, launches exactly 4 times a train step; SHOWDOWN_REPEAT runs twice,
    with the same best epoch and test probabilities equal bit for bit.
    """
    from ptbxl_torch.ops.kernels import relu_pool as k6
    from ptbxl_torch.tools import showdown as sd

    t_phase = time.perf_counter()
    cfgs = {f: sd.jax_config(os.path.join(sd.JAX_DIR, f))
            for f in sorted(os.listdir(sd.JAX_DIR)) if sd.JAX_ARTIFACT.match(f)}
    labels_equal = []
    for f, cfg in cfgs.items():
        with open(os.path.join(sd.JAX_DIR, f)) as fh:
            blob = json.load(fh)
        splits = [s for s in ("test", "val") if blob.get(f"{s}_y")]
        if not splits:
            continue
        data = np.load(sd.ensure_dataset(cfg))
        for s in splits:
            want = sd.arch_labels(data[f"y_{s}"], cfg["arch"])
            if not np.array_equal(np.asarray(blob[f"{s}_y"], np.float32), want):
                raise AssertionError(f"showdown: {f}'s {s}_y differs from the regenerated labels")
            labels_equal.append(f"{f}:{s}")
    data_s = time.perf_counter() - t_phase

    k6.launches = 0
    runs = {f: sd.run_port(cfgs[f], device="cuda") for f in SHOWDOWN_RUNS}
    families = {}
    for f in SHOWDOWN_RUNS:
        families.setdefault(sd.family_of(cfgs[f]), f)
    reports = {fam: sd.compare(cfgs[f]) for fam, f in families.items()}
    again = sd.run_port(cfgs[SHOWDOWN_REPEAT], device="cuda")
    launches, steps = k6.launches, sum(r["train_steps"] for r in runs.values())
    steps += again["train_steps"]
    if launches != 4 * steps:
        raise AssertionError(f"showdown: {launches} relu_pool_bwd launches for {steps} steps")

    out_families = {}
    for fam, rep in reports.items():
        auroc = rep["metrics"]["auroc"]
        deficit = auroc.get("deficit_vs_jax_means", auroc["deficit_vs_jax"])
        out_families[fam or "baseline"] = {
            "port_auroc": auroc.get("mean", {}).get("port", auroc["port"]),
            "jax_auroc": auroc.get("mean", {}).get("jax", auroc["jax"]),
            "auroc_deficit": deficit, "welch_t": {m: e.get("welch_t")
                                                  for m, e in rep["metrics"].items()},
            "seeds": auroc.get("n", 1),
            "deficit": {m: e.get("deficit_vs_jax_means", e["deficit_vs_jax"])
                        for m, e in rep["metrics"].items()},
            "within_budget": rep["within_budget_per_metric"],
            "insignificant": [m for m, e in rep["metrics"].items()
                              if e.get("insignificant_deficit")]}
        if deficit > SHOWDOWN_AUROC_BUDGET:
            raise AssertionError(f"showdown: family '{fam or 'baseline'}' AUROC deficit "
                                 f"{deficit} > {SHOWDOWN_AUROC_BUDGET}")
    first = runs[SHOWDOWN_REPEAT]
    delta_probs = float(np.abs(np.asarray(again["test_probs"])
                               - np.asarray(first["test_probs"])).max())
    if again["best_epoch"] != first["best_epoch"] or not np.array_equal(
            again["test_probs"], first["test_probs"]):
        raise AssertionError(f"showdown: {SHOWDOWN_REPEAT} twice: best epochs "
                             f"{first['best_epoch']} and {again['best_epoch']}, max |d test "
                             f"prob| {delta_probs}")
    return {
        "phase": "showdown", "device": first["device"], "labels_equal": labels_equal,
        "families": out_families,
        "runs": {f: {"auroc": r["test_auroc_macro"], "auprc": r["test_auprc_macro"],
                     "f1": r["test_f1_macro"], "best_epoch": r["best_epoch"],
                     "epochs": r["config"]["epochs"], "wall_s": r["wall_s"]}
                 for f, r in runs.items()},
        "repeat": {"file": SHOWDOWN_REPEAT, "wall_s": again["wall_s"],
                   "best_epochs": [first["best_epoch"], again["best_epoch"]],
                   "abs_delta_auroc": abs(again["test_auroc_macro"] - first["test_auroc_macro"]),
                   "max_abs_delta_test_probs": delta_probs},
        "train_steps": steps, "launches": {"relu_pool_bwd": launches},
        "data_s": data_s, "phase_s": time.perf_counter() - t_phase}


def split_breakdown(launches: list) -> dict:
    """K4's per-launch device times: the stats pass, each ``wgmma`` block and
    the tail.  Raises if the route launched any kernel but the port's own
    (no library conv, matmul or framework z-score)."""
    other = [name for name, _ in launches if not any(k in name for k in K4_KERNELS)]
    if other:
        raise AssertionError(f"K4's bf16 route launched other kernels: {other}")
    blocks = [ms for name, ms in launches if "wgmma_conv_block" in name]
    return {"stats_ms": sum(ms for name, ms in launches if "zscore" in name),
            "block_ms": blocks, "tail_ms": sum(ms for name, ms in launches if "sums_tail" in name),
            "total_ms": sum(ms for _, ms in launches), "launches": launches}


def k4_launch_bounds(b: int, folded) -> list:
    """(name, bound (ms, by)) of each launch of K4's bf16 route on [b, 5000, 12]:
    operations of each block (Cin as the model has it, not padded), each
    input read once and each output written once (the raw f32 record and the
    stats for block 0, bf16 activations, block 3's per-tile sums), weights."""
    from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4

    x_bytes = b * T_FULL * LEADS * 4
    out = [("zscore_stats", bound(6 * b * T_FULL * LEADS, x_bytes + b * LEADS * 8, PEAK_BF16))]
    t, n = T_FULL, int(folded["n_blocks"])
    for i in range(n):
        w = folded[f"w{i}"]
        cin, cout = w.shape[1], w.shape[2]
        flops = 2 * 15 * cin * cout * 2 * (t // 2) * b
        in_bytes = x_bytes + b * LEADS * 8 if i == 0 else b * t * cin * 2
        if i == n - 1:
            cin_p = -(-cin // 16) * 16
            out_bytes = b * -(-2 * (t // 2) // k4.wg_tile(cin_p, cout)[1]) * cout * 4
        else:
            out_bytes = b * (t // 2) * cout * 2
        out.append((f"block{i}", bound(flops, in_bytes + out_bytes + w.numel() * 2 + cout * 4,
                                       PEAK_BF16)))
        t //= 2
    return out


CROSSOVER_N = (1, 8, 16, 32, 64, 128, 256, 512, 1024)


def crossover_n(rows: dict) -> dict:
    """From a crossover sweep: the largest N at which the kernel is no slower than
    cuDNN f32 (what ``KERNEL_MAX_BATCH`` is set to) and than cuDNN bf16 (what
    ``KERNEL_MAX_BATCH_BF16`` is set to: the ``default`` precision's other
    engine).  Raises if the sweep puts the bf16 crossover below the constant
    the port ships."""
    from ptbxl_torch import inference

    out = {}
    for key, col in (("kernel_no_slower_than_f32_max_n", "framework_f32_ms"),
                     ("kernel_no_slower_than_bf16_max_n", "framework_bf16_ms")):
        wins = [b for b in CROSSOVER_N if rows[b]["kernel_ms"] <= rows[b][col]]
        out[key] = max(wins, default=0)
    if out["kernel_no_slower_than_bf16_max_n"] < inference.KERNEL_MAX_BATCH_BF16:
        raise AssertionError(f"the default crossover {out['kernel_no_slower_than_bf16_max_n']} "
                             f"is below KERNEL_MAX_BATCH_BF16={inference.KERNEL_MAX_BATCH_BF16}")
    return out


def default_routing(p_def, p_hi, cases: dict, counter) -> dict:
    """``Predictor(precision='default', engine='auto')`` on each case against
    ``highest`` (5e-3) and the engine it took (``counter()``: the kernel engine's
    launch count, set to 0 by the caller)."""
    out = {}
    for n, args in cases.items():
        before = counter()
        err = float(np.abs(p_def(*args[0], **args[1]) - p_hi(*args[0], **args[1])).max())
        out[n] = {"max_abs_err_vs_highest": gate(f"default auto N={n}", err, 5e-3),
                  "engine": "kernel" if counter() > before else "framework"}
    return out


def conv_block_ms(launches: list) -> list:
    """The conv-block launches' device ms, in order, from ``launch_breakdown``."""
    return [ms for name, ms in launches if "conv_block" in name]


def phase_k2_blocks(x_raw: torch.Tensor, folded, weights: list) -> dict:
    """Each of the four 3xTF32 conv blocks against ``_conv_block_plain`` (exact
    f32, TF32 off) on the plain forward's own activations at that block, at
    B = 1, 16 and 512 (where the launch picks each of its tile shapes), each
    timed.  The gate is 2^-18 of the block's scale (the largest |x| conv
    |w|): two f32 sum orders over up to 15 * 128 terms differ by ~sqrt(1920) *
    2^-24 = 2.6e-6 of it, and the split leaves 2^-21."""
    from ptbxl_torch.ops.kernels import fused_ecgcnn as k2, zscore as k1
    from ptbxl_torch.utils.device import highest_precision

    by_batch = {}
    for bsz in (1, 16, x_raw.shape[0]):
        x = x_raw[:bsz].contiguous()
        stats = k1.zscore_stats(x)
        with highest_precision():
            h = k1.zscore_plain(x)
        rows = []
        for i, w3 in enumerate(weights):
            w, b = folded[f"w{i}"], folded[f"b{i}"]
            with highest_precision():
                hp = F.pad(h, (0, 0, k2.PAD, k2.PAD))
                want = k2._conv_block_plain(hp, w, b, torch.float32)
                scale = float(k2._conv_block_plain(hp.abs(), w.abs(), torch.zeros_like(b),
                                                   torch.float32).max())
            xin, st = (x, stats) if i == 0 else (h, None)
            tol = 2.0 ** -18 * scale
            got = k2.conv_block_tf32x3(xin, w3, b, st)
            err = gate(f"conv block {i} B={bsz}", max_diff(got, want), tol)
            rows.append({"block": i, "shape": [h.shape[1], w.shape[1], w.shape[2]],
                         "max_abs_err": err, "tol": tol, "scale": scale,
                         "max_rel_to_scale": err / scale,
                         "ms": time_ms(lambda: k2.conv_block_tf32x3(xin, w3, b, st))})
            h = want
        by_batch[str(bsz)] = rows
    torch.cuda.synchronize()
    return {"phase": "k2_blocks", "batch": by_batch}


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
    from ptbxl_torch import bench as port_bench
    from ptbxl_torch.ops.kernels import _build, fused_ecgcnn as k2, relu_pool as k6, zscore as k1
    from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4
    from ptbxl_torch.ops.preprocess import zscore_per_lead_batch_onepass
    from ptbxl_torch.tools import probe_layer_perf, probe_zscore

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
    k1_info = phase_k1(x_raw, gen)
    err_k1, err_k1_16 = k1_info["max_abs_err_f32"], k1_info["max_abs_err_bf16"]
    err_st, err_harsh = k1_info["max_abs_err_stats"], k1_info["max_abs_err_f32_harsh"]
    err_st_harsh = k1_info["max_abs_err_stats_harsh"]
    emit(k1_info)

    # -- phase 3: K2 against its plain version --------------------------------
    state, _ = load_checkpoint(CKPT)
    folded = k2.fold_bn_into_conv({k: v.to(dev) for k, v in state.items()})
    k2_w = k2.prepare_weights(folded)  # the f32 conv blocks' split weights, built once
    x_demo = torch.from_numpy(demo_signals().transpose(0, 2, 1).copy()).to(dev)
    x_odd = raw_batch(2, gen)[:, :500].contiguous()  # 500 -> 250 -> 125 -> 62 -> 31: odd floors
    cases = {"1": x_raw[:1], "7": x_demo, str(BIG): x_raw, "2 T=500": x_odd}
    k2_err = {}
    for b, xb in cases.items():
        for normalize in (True, False):
            xin = xb if normalize else k1.zscore_plain(xb)
            for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 5e-3)):
                got = k2.fused_ecgcnn_probs(xin, folded, dt, normalize, k2_w)
                want = torch.sigmoid(k2.fused_ecgcnn_logits_plain(xin, folded, dt, normalize))
                name = f"B={b} normalize={normalize} {str(dt)[6:]}"
                k2_err[name] = gate(f"fused_ecgcnn {name}", max_diff(got, want), tol)
    torch.cuda.synchronize()
    emit({"phase": "k2", "max_abs_err": k2_err})
    emit(phase_k2_blocks(x_raw, folded, k2_w))

    # -- phase 3b: K3 against its plain version -------------------------------
    state_mm, _ = load_checkpoint(CKPT_MM, arch="multimodal")
    folded_mm = k2.fold_multimodal({k: v.to(dev) for k, v in state_mm.items()})
    k3_w = k2.prepare_weights(folded_mm)
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
                got = k2.fused_multimodal_probs(xin, db, folded_mm, dt, normalize, k3_w)
                want = torch.sigmoid(k2.fused_multimodal_logits_plain(xin, db, folded_mm, dt,
                                                                      normalize))
                name = f"B={b} normalize={normalize} {str(dt)[6:]}"
                k3_err[name] = gate(f"fused_multimodal {name}", max_diff(got, want), tol)
    torch.cuda.synchronize()
    emit({"phase": "k3", "max_abs_err": k3_err})

    # -- phase 3c: K6 against its plain version and torch's autograd -----------
    k6_err, k6_autograd = phase_k6(gen)
    torch.cuda.synchronize()
    emit({"phase": "k6", "max_abs_err": k6_err, "vs_autograd": k6_autograd})

    # -- phase 3d: K4, K5 and P3 against their plain versions -------------------
    k4_err = phase_k4(folded, {"1": x_raw[:1], "7": x_demo, str(BIG): x_raw,
                               "5": x_raw[:5].contiguous(), "2 T=500": x_odd})
    torch.cuda.synchronize()
    emit({"phase": "k4", "max_abs_err": k4_err})
    k4_blocks = phase_k4_blocks(x_raw, folded)
    emit(k4_blocks)
    k5_err = phase_k5(x_raw, gen)
    torch.cuda.synchronize()
    emit({"phase": "k5", "max_abs_err": k5_err})
    p3_err, p3_vs_k4 = phase_p3(gen)
    torch.cuda.synchronize()
    emit({"phase": "p3", "max_abs_err": p3_err, "bf16_values_differing_from_k4_block": p3_vs_k4})

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

    # -- phase 5: Grad-CAM on the card (its backward through the pool is K6) ----
    k6.launches = 0
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
    torch.cuda.synchronize()
    launches_cam = k6.launches  # the Grad-CAM path, baseline and multimodal
    if launches_cam <= 0:
        raise AssertionError("the Grad-CAM path launched no relu_pool_bwd kernel")
    emit({"phase": "grad_cam_mm", "max_abs_err": cam_mm_errs,
          "launches": {"relu_pool_bwd": launches_cam}})

    # -- phase 5c: the training path, the trainer at full width ---------------
    train_info = phase_train(args.seed, gen)
    emit(train_info)

    # -- phase 6: times --------------------------------------------------------
    times = {}
    for b in (1, BIG):
        xb = x_raw[:b].contiguous()
        k2_flops, k2_bytes = k2_flops_bytes(xb, folded)
        k1_bytes = 2 * xb.numel() * 4
        times[b] = {
            "fused_ecgcnn": {
                "ms": time_ms(lambda: k2.fused_ecgcnn_logits(xb, folded, weights=k2_w)),
                "plain_ms": time_ms(lambda: k2.fused_ecgcnn_logits_plain(xb, folded)),
                # the framework engine: z-score + cuDNN model (f32 TF32 off; bf16)
                "library_ms": time_ms(lambda: p_hi._forward(xb)),
                "library_bf16_ms": time_ms(lambda: p_lo._forward(xb)),
                # the f32 products on the FMA units, or as three TF32
                # tensor-core products each (3xTF32); the bound is the faster
                "bound_fp32": bound(k2_flops, k2_bytes),
                "bound_3xtf32": bound(3 * k2_flops, k2_bytes, PEAK_TF32),
                "bound": min(bound(k2_flops, k2_bytes), bound(3 * k2_flops, k2_bytes, PEAK_TF32)),
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
        k3_flops, k3_bytes = k3_flops_bytes(xb, db, folded_mm)
        times[b]["fused_multimodal"] = {
            "ms": time_ms(lambda: k2.fused_multimodal_logits(xb, db, folded_mm, weights=k3_w)),
            "plain_ms": time_ms(lambda: k2.fused_multimodal_logits_plain(xb, db, folded_mm)),
            # the framework engine: z-score + cuDNN multimodal model (f32 TF32 off; bf16)
            "library_ms": time_ms(lambda: p_mm_hi._forward(xb, db)),
            "library_bf16_ms": time_ms(lambda: p_mm_lo._forward(xb, db)),
            "bound_fp32": bound(k3_flops, k3_bytes),
            "bound_3xtf32": bound(3 * k3_flops, k3_bytes, PEAK_TF32),
            "bound": min(bound(k3_flops, k3_bytes), bound(3 * k3_flops, k3_bytes, PEAK_TF32)),
        }
    grad_cam_ms = {str(b): time_ms(lambda: cam_demo(x_demo[:b], class_idx=0)) for b in (1, 7)}
    grad_cam_mm_ms = {str(b): time_ms(lambda: cam_mm(x_mm[:b], class_idx=0, x_demo=d_mm[:b]))
                      for b in (1, 7)}
    emit({"phase": "times", "batch": {str(b): t for b, t in times.items()},
          "grad_cam_ms": grad_cam_ms, "grad_cam_mm_ms": grad_cam_mm_ms})

    # engine crossover: device time of one Predictor chunk, kernel vs framework;
    # KERNEL_MAX_BATCH is set from this sweep (the largest N at which the kernel
    # is no slower than cuDNN f32 at 'highest')
    import ptbxl_torch.inference as inference

    p_kern = Predictor.from_checkpoint(CKPT, engine="kernel")
    crossover = {}
    k1.launches = 0
    for b in CROSSOVER_N:
        xb = raw_batch(b, gen)
        crossover[b] = {
            "kernel_ms": time_ms(lambda: p_kern._forward(xb), reps=5),
            "framework_f32_ms": time_ms(lambda: p_hi._forward(xb), reps=5),
            "framework_bf16_ms": time_ms(lambda: p_lo._forward(xb), reps=5),
        }
    torch.cuda.synchronize()
    crossover_k1 = k1.launches  # K1's stats entry before every kernel-engine chunk
    if crossover_k1 <= 0:
        raise AssertionError("the crossover sweep launched no zscore kernel")
    # the default precision on 'auto': its own crossover (KERNEL_MAX_BATCH_BF16),
    # the engine each N took, K1 counted from 0 over the two calls
    # (the 5e-3 gate is the demo pack's, bench.py's parity gate: N=512 is the
    # pack's records repeated; on the raw noise requests the deviation is
    # reported, not gated: bf16 through the whole network on inputs that are
    # not ECGs)
    p_def = Predictor.from_checkpoint(CKPT, precision="default")
    pack512 = np.concatenate([sigs] * -(-BIG // len(sigs)))[:BIG]
    k1.launches = 0
    routing = default_routing(p_def, p_hi, {"7": ((sigs,), {}), str(BIG): ((pack512,), {})},
                              lambda: k2.launches)
    default_k1 = k1.launches
    routing["noise_512_ungated"] = float(np.abs(p_def(requests) - p_hi(requests)).max())
    if routing["7"]["engine"] != "kernel" or routing[str(BIG)]["engine"] != "framework":
        raise AssertionError(f"default routing: {routing}")
    emit({"phase": "crossover", "ms": crossover, "kernel_max_batch": inference.KERNEL_MAX_BATCH,
          "kernel_max_batch_bf16": inference.KERNEL_MAX_BATCH_BF16,
          "launches": {"zscore": crossover_k1, "zscore_default_auto": default_k1},
          "default_auto": routing, **crossover_n(crossover)})

    # the same for the multimodal Predictor (K3 vs the framework engine)
    p_mm_kern = Predictor.from_checkpoint(CKPT_MM, arch="multimodal", engine="kernel")
    crossover_mm = {}
    for b in CROSSOVER_N:
        xb, db = raw_batch(b, gen), demo_batch(b, gen)
        crossover_mm[b] = {
            "kernel_ms": time_ms(lambda: p_mm_kern._forward(xb, db), reps=5),
            "framework_f32_ms": time_ms(lambda: p_mm_hi._forward(xb, db), reps=5),
            "framework_bf16_ms": time_ms(lambda: p_mm_lo._forward(xb, db), reps=5),
        }
    p_mm_def = Predictor.from_checkpoint(CKPT_MM, arch="multimodal", precision="default")
    reps = -(-BIG // len(sigs_mm))
    mm512 = (np.concatenate([sigs_mm] * reps)[:BIG], np.concatenate([demos_mm] * reps)[:BIG])
    routing_mm = default_routing(
        p_mm_def, p_mm_hi, {"7": ((sigs_mm,), {"demo": demos_mm}),
                            str(BIG): ((mm512[0],), {"demo": mm512[1]})},
        lambda: k2.launches_mm)
    routing_mm["noise_512_ungated"] = float(np.abs(p_mm_def(requests, demo=req_demo)
                                                   - p_mm_hi(requests, demo=req_demo)).max())
    if routing_mm["7"]["engine"] != "kernel" or routing_mm[str(BIG)]["engine"] != "framework":
        raise AssertionError(f"multimodal default routing: {routing_mm}")
    emit({"phase": "crossover_mm", "ms": crossover_mm,
          "kernel_max_batch": inference.KERNEL_MAX_BATCH,
          "kernel_max_batch_bf16": inference.KERNEL_MAX_BATCH_BF16,
          "default_auto": routing_mm, **crossover_n(crossover_mm)})

    # where K2's and K3's time goes: per-launch device time from the profiler (CUPTI)
    breakdown, breakdown_mm = {}, {}
    for b in (1, BIG):
        xb, db = x_raw[:b].contiguous(), d_big[:b].contiguous()
        breakdown[b] = launch_breakdown(lambda: k2.fused_ecgcnn_logits(xb, folded, weights=k2_w))
        breakdown_mm[b] = launch_breakdown(
            lambda: k2.fused_multimodal_logits(xb, db, folded_mm, weights=k3_w))
    for name, bd in (("k2_breakdown_ms", breakdown), ("k3_breakdown_ms", breakdown_mm)):
        emit({"phase": name, "batch": {str(b): v for b, v in bd.items()},
              "conv_blocks_ms": {str(b): conv_block_ms(v) for b, v in bd.items()}})

    # the train step: device time per pool backward, and K6 beside its yardsticks
    step_times, k6_times = train_step_times(args.seed, gen)
    emit({"phase": "train_times", "step_ms": step_times, "relu_pool_bwd": k6_times})
    emit({"phase": "train_breakdown_ms", "batch": TRAIN_B,
          "pool_bwd": train_breakdown(args.seed, gen)})
    emit(train_epoch(args.seed))
    extras_info = phase_train_extras(args.seed, gen)
    emit(extras_info)

    # -- phase 7: K4's, K5's and P3's main paths (the bench's hybrid row, the
    # two probes), then their times beside the plain versions and the library
    hybrid_info = phase_hybrid(folded)
    emit(hybrid_info)
    zs_batch, zs_rows, zs_launches, layer_rows, layer_launches = phase_probes()
    emit({"phase": "probe_zscore", "batch": PROBE_ZS_B, "launches": {"zscore_wide": zs_launches},
          "rows": zs_rows})
    emit({"phase": "probe_layer_perf", "batch": PROBE_LAYER_B,
          "launches": {"conv_layer": layer_launches}, "rows": layer_rows})
    k4_times, k4_breakdown = {}, {}
    lib_bf16 = port_bench.build_forward("framework", "bf16", dev)
    k4_weights = k4.prepare_weights(folded, compute_dtype=torch.bfloat16)

    with torch.no_grad():
        for b in (BIG, HYBRID_B):
            xb = raw_batch(b, gen)
            run_k4 = lambda: k4.hybrid_ecgcnn_logits(xb, folded, weights=k4_weights)  # noqa: E731
            k4_times[b] = {
                "ms": time_ms(run_k4, reps=5),
                "plain_ms": time_ms(lambda: [k4.hybrid_ecgcnn_logits_plain(xc, folded)
                                             for xc in xb.split(BIG)], reps=2, warmup=1),
                "library_ms": time_ms(lambda: lib_bf16(xb), reps=5),
                # the hybrid forward does the fused forward's work: K2's count
                "bound": bound(*k2_flops_bytes(xb, folded), PEAK_BF16),
                "launch_bounds": k4_launch_bounds(b, folded),
                # the stats pass alone (the profile of a K4 call can miss its first launch)
                "stats_ms": time_ms(lambda: k1.zscore_stats(xb), reps=5),
            }
            k4_breakdown[b] = split_breakdown(launch_breakdown(run_k4))
            del xb
        k5_plain_ms = time_ms(lambda: k1.zscore_wide_plain(zs_batch, torch.bfloat16), reps=3,
                              warmup=1)
        # K5 and P3 against their plain versions at the probes' shapes and inputs,
        # each variant and mode the probes launch (tolerances as in phase_k5/p3)
        k5_want = k1.zscore_wide_plain(zs_batch, torch.bfloat16)
        k5_probe_err = {name: gate(f"zscore_wide {name} B={PROBE_ZS_B} vs plain",
                                   max_diff(fn(zs_batch), k5_want), 2e-2)
                        for name, fn in probe_zscore.variants().items() if name.startswith("k5")}
        del k5_want
        p3_plain_ms, p3_probe_err = [], {}
        for t_in, cin, cout in probe_layer_perf.LAYERS:
            xl, wl, bl = probe_layer_perf.make_layer(t_in, cin, cout, PROBE_LAYER_B, dev)
            p3_plain_ms.append(time_ms(lambda: k4.conv_layer_plain(xl, wl, bl), reps=2, warmup=1))
            for mode in k4.MODES:
                key = f"({t_in},{cin},{cout}) {mode}"
                p3_probe_err[key] = gate(
                    f"conv_layer {key} B={PROBE_LAYER_B} vs plain",
                    max_diff(k4.conv_layer(xl, wl, bl, mode), k4.conv_layer_plain(xl, wl, bl, mode)),
                    1e-4)
            del xl
    del zs_batch
    emit({"phase": "k4_times", "batch": {str(b): v for b, v in k4_times.items()},
          "k5_plain_ms": k5_plain_ms, "p3_plain_ms": p3_plain_ms,
          "k5_max_abs_err_probe": k5_probe_err, "p3_max_abs_err_probe": p3_probe_err})
    emit({"phase": "k4_breakdown_ms", "batch": {str(b): v for b, v in k4_breakdown.items()}})
    # K1's and K5's cases at the main paths' shapes (both K1 entries at B=1, 512,
    # 8192, the stats beside torch.std_mean; K5 at the probe's batch), each with
    # its cluster plan's k and shared memory a CTA
    zs_cases = probe_zscore.time_cases(dev)
    emit({"phase": "k1_cases", "rows": zs_cases})

    # -- phase 8: P4, P1 and P2 (gates, then their main paths: the three probe
    # tools), the data layer, the CLIs and the pipeline rows on a synthetic tree
    p4_info = phase_p4(gen)
    emit(p4_info)
    probe_info = phase_probe_tables()
    emit(probe_info)
    import tempfile

    from ptbxl_torch.tools.synthetic_ptbxl import make_synthetic_ptbxl

    tree = os.path.join(ROOT, "build", f"chip_smoke_ptbxl_{DATA_N}_{T_FULL}")
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(tree, "ptbxl_database.csv")):
        make_synthetic_ptbxl(tree, n_records=DATA_N, n_samples=T_FULL, seed=args.seed)
    tree_s = time.perf_counter() - t0
    data_info, datasets = phase_data(tree)
    data_info["tree_s"] = tree_s
    emit(data_info)
    with tempfile.TemporaryDirectory() as work, _cudnn_flags_kept():
        emit(phase_cli_train(tree, work, args.seed, datasets))
        emit(phase_cli_eval(tree, work))
        analysis_info = phase_cli_analysis(tree, work)
        emit(analysis_info)
        ddp_info = phase_ddp(args.seed, tree, work)
        emit(ddp_info)
    emit(phase_data_parallel_predictor())
    pipe_info = phase_pipeline()
    emit(pipe_info)

    # -- phase 9: the int8 path and the serving export ------------------------
    emit(phase_int8(dev, x_raw))
    with tempfile.TemporaryDirectory() as work:
        serving_info = phase_serving(dev, work, x_raw)
    emit(serving_info)

    # -- phase 10: the phase-domain training alternatives, the training-backward
    # probes and proto_int8, and CLI 01 against a loopback mirror of the tree
    domain_info = phase_domain(gen)
    emit(domain_info)
    emit(phase_train_probes())
    with tempfile.TemporaryDirectory() as work:
        emit(phase_fetch(tree, work))

    # -- phase 11: the WFDB codec fuzz, the identical-seeds contract, then the
    # training showdown against JAX's committed artifacts (K6 four launches a step)
    emit(phase_fuzz_wfdb())
    det_info = phase_determinism(tree)
    emit(det_info)
    showdown_info = phase_showdown()
    emit(showdown_info)

    big = times[BIG]
    one = times[1]
    sources = {
        "zscore": ("ptbxl_torch/csrc/zscore.cu", "ptbxl_tpu/ops/pallas/zscore.py:44",
                   max([err_k1, err_st, err_harsh, err_st_harsh]
                       + [v for d in k1_info["max_abs_err_by_batch"].values()
                          for v in d.values()])),
        "fused_ecgcnn": ("ptbxl_torch/csrc/fused_ecgcnn.cu",
                         "ptbxl_tpu/ops/pallas/fused_ecgcnn.py:89",
                         max(v for k, v in k2_err.items() if k.endswith("float32"))),
        "fused_multimodal": ("ptbxl_torch/csrc/fused_ecgcnn.cu",
                             "ptbxl_tpu/ops/pallas/fused_ecgcnn.py:260",
                             max(v for k, v in k3_err.items() if k.endswith("float32"))),
    }
    # launches on the main paths: the baseline/AF path and the multimodal path; K1's
    # stats entry also leads the bench's hybrid row and every crossover chunk
    by_path = {name: {"ecgcnn": launches.get(name, 0), "multimodal": launches_mm[name]}
               for name in sources}
    by_path["zscore"].update(bench_hybrid_row=hybrid_info["launches"]["zscore"],
                             crossover=crossover_k1, predictor_default=default_k1)
    for name in sources:  # K1's stats, K2 and K3 inside the exported kernel-engine programs
        by_path[name]["serving_kernel_artifact"] = serving_info["launches"][name]
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
            entry["bound_fp32_ms"] = t5["bound_fp32"][0]
            entry["bound_3xtf32_ms"] = t5["bound_3xtf32"][0]
            entry["bound_3xtf32_ms_b1"] = t1["bound_3xtf32"][0]
            bd = breakdown if name == "fused_ecgcnn" else breakdown_mm
            entry["conv_blocks_ms"] = conv_block_ms(bd[BIG])
            errs = k2_err if name == "fused_ecgcnn" else k3_err
            entry["max_abs_err_bf16"] = max(v for k, v in errs.items() if k.endswith("bfloat16"))
            entry["library_bf16_ms"] = t5["library_bf16_ms"]
        else:
            entry["max_abs_err_bf16"] = err_k1_16
            entry["stats_ms"] = t5["stats_ms"]
            # each case: ms, bytes bound, PyTorch call, cluster size and shared memory
            entry["cases"] = [r for r in zs_cases if r["entry"] != "zscore_wide"]
            entry["seam_max_abs_diff"] = k1_info["seam_max_abs_diff"]
            entry["max_abs_err_by_batch"] = k1_info["max_abs_err_by_batch"]
            entry["max_abs_err_ragged_t37"] = max(k1_info["max_abs_err_ragged_t37"].values())
        kernels.append(entry)
    # K6: one B=64 train step's four launches; launches on the training path, on
    # the Grad-CAM path (baseline + multimodal), on CLIs 11, 13 and the demo CLI
    # on the phase_train steps (one a step: the last block's pool) and on the
    # showdown's training runs and the determinism phase's epochs (four a step)
    t32, t16 = k6_times["float32"], k6_times["bfloat16"]
    k6_by_path = {"train": train_info["launches"]["relu_pool_bwd"], "grad_cam": launches_cam,
                  "grad_cam_cli": sum(
                      analysis_info["grad_cam_cli"]["relu_pool_bwd_launches"].values()),
                  "train_extras": extras_info["launches"]["relu_pool_bwd"],
                  "ddp": ddp_info["one_rank_nccl"]["relu_pool_bwd_launches"],
                  "phase_train": domain_info["relu_pool_bwd_launches"]["phase_train"],
                  "showdown": showdown_info["launches"]["relu_pool_bwd"],
                  "determinism": det_info["launches"]["relu_pool_bwd"]}
    kernels.append({
        "name": "relu_pool_bwd", "route": "cuda", "source": "ptbxl_torch/csrc/relu_pool.cu",
        "replaces": "ptbxl_tpu/ops/relu_pool.py:65",
        "launches": sum(k6_by_path.values()), "launches_by_path": k6_by_path,
        "max_abs_err": max(v for k, v in k6_err.items() if "float32" in k),
        "max_abs_err_bf16": max(v for k, v in k6_err.items() if "bfloat16" in k),
        "ms": t32["ms"], "plain_ms": t32["plain_ms"], "bound_ms": t32["bound"][0],
        "bound_by": t32["bound"][1], "library_ms": t32["library_ms"], "batch": TRAIN_B,
        "ms_bf16": t16["ms"], "bound_ms_bf16": t16["bound"][0],
        "library_bf16_ms": t16["library_ms"],
    })
    # K4: the bench's hybrid row at B=8192 (B=512 beside it); launches on that row;
    # each launch's ms beside its own bound (stats pass, four wgmma blocks, tail)
    t8, t5 = k4_times[HYBRID_B], k4_times[BIG]
    bd8 = k4_breakdown[HYBRID_B]
    per_launch = [{"launch": name, "ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1]}
                  for (name, bnd), ms in zip(t8["launch_bounds"], [t8["stats_ms"]] + bd8["block_ms"])]
    kernels.append({
        "name": "hybrid_ecgcnn", "route": "cuda", "source": "ptbxl_torch/csrc/hybrid_wgmma.cu",
        "replaces": "ptbxl_tpu/ops/pallas/hybrid_ecgcnn.py:63",
        "launches": hybrid_info["launches"]["hybrid_ecgcnn"],
        "launches_by_path": {"bench_hybrid_row": hybrid_info["launches"]["hybrid_ecgcnn"]},
        "max_abs_err": max(v for k, v in k4_err.items() if k.endswith("float32")),
        "max_abs_err_bf16": max([v for k, v in k4_err.items() if k.endswith("bfloat16")]
                                + [hybrid_info["max_abs_err_vs_plain"]]),
        "max_abs_err_b8192": hybrid_info["max_abs_err_vs_plain"],
        "ms": t8["ms"], "plain_ms": t8["plain_ms"], "bound_ms": t8["bound"][0],
        "bound_by": t8["bound"][1], "library_ms": t8["library_ms"], "batch": HYBRID_B,
        "per_launch": per_launch, "tail_ms": bd8["tail_ms"],
        "deep_blocks_ms": sum(bd8["block_ms"][-2:]),
        "deep_blocks_bound_ms": sum(r["bound_ms"] for r in per_launch[-2:]),
        "ms_b512": t5["ms"], "plain_ms_b512": t5["plain_ms"], "bound_ms_b512": t5["bound"][0],
        "library_ms_b512": t5["library_ms"],
    })
    # K5: the probe's default variant (width 480, block_b 8), bf16 in and out
    zs = {r["variant"]: r for r in zs_rows}
    kernels.append({
        "name": "zscore_wide", "route": "cuda", "source": "ptbxl_torch/csrc/zscore.cu",
        "replaces": "ptbxl_tpu/ops/pallas/zscore.py:82",
        "launches": zs_launches, "launches_by_path": {"probe_zscore": zs_launches},
        "max_abs_err": max(v["vs_plain"] for k, v in k5_err.items() if k.endswith("float32")),
        "max_abs_err_bf16": max([v["vs_plain"] for k, v in k5_err.items()
                                 if k.endswith("bfloat16")] + list(k5_probe_err.values())),
        "max_abs_err_probe_shape": max(k5_probe_err.values()),
        "ms": zs["k5_b8"]["ms"], "plain_ms": k5_plain_ms, "bound_ms": zs["k5_b8"]["bound_ms"],
        "bound_by": "bytes", "library_ms": zs["torch_one_pass"]["ms"], "batch": PROBE_ZS_B,
        "k1_ms": zs["k1"]["ms"], "variants_ms": {k: v["ms"] for k, v in zs.items()},
        "cases": [r for r in zs_cases if r["entry"] == "zscore_wide"],
        "variants_k": {name: k1.cluster_plan(
            PROBE_ZS_B, T_FULL, LEADS, width, torch.bfloat16, torch.bfloat16, "zscore_wide",
            per=bb).k for name, width, bb in (("k5_b4", 480, 4), ("k5_b8", 480, 8),
                                              ("k5_b16", 480, 16), ("k5_w240", 240, 8),
                                              ("k5_w1200", 1200, 8))},
    })
    # P3: the four layers at the probe's batch, im2col mode (direct beside it);
    # the bound is the sum of the layers' own, named by the larger share
    by_ops = sum(r["bound"][0] for r in layer_rows if r["bound"][1] == "operations")
    kernels.append({
        "name": "conv_layer", "route": "cuda", "source": "ptbxl_torch/csrc/hybrid_wgmma.cu",
        "replaces": "tools/probe_layer_perf.py:52",
        "launches": layer_launches, "launches_by_path": {"probe_layer_perf": layer_launches},
        "max_abs_err": max(list(p3_err.values()) + list(p3_probe_err.values())),
        "max_abs_err_b2048": max(p3_probe_err.values()),
        "ms": sum(r["im2col_ms"] for r in layer_rows), "plain_ms": sum(p3_plain_ms),
        "bound_ms": sum(r["bound"][0] for r in layer_rows),
        "bound_by": "operations" if 2 * by_ops >= sum(r["bound"][0] for r in layer_rows)
        else "bytes",
        "library_ms": sum(r["cudnn_ms"] for r in layer_rows), "batch": PROBE_LAYER_B,
        "direct_ms": sum(r["direct_ms"] for r in layer_rows),
        "per_layer": [{"layer": r["layer"], "ms": r["im2col_ms"], "direct_ms": r["direct_ms"],
                       "plain_ms": p, "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                       "share_of_bound": r["bound"][0] / r["im2col_ms"],
                       "library_ms": r["cudnn_ms"]} for r, p in zip(layer_rows, p3_plain_ms)],
    })
    # P1 and P2: the two probe tables (every probe's kernel time, plain version,
    # library call and bytes bound, summed over the table)
    for name, replaces, status in (
            ("probe_mosaic", "tools/probe_mosaic.py:44",
             "redesigned: p1/p2 on a wgmma TF32 dot with all of K resident on 128 CTAs, "
             "p7 as float4 row copies"),
            ("probe_mosaic2", "tools/probe_mosaic2.py:35",
             "redesigned: the launch path, p9's FP32 dot on a cp.async ring")):
        prow = probe_info["tables"][name]
        n_ops = sum(r["bound"][0] for r in prow if r["bound"][1] == "operations")
        total_bound = sum(r["bound"][0] for r in prow)
        kernels.append({
            "name": name, "route": "cuda", "source": "ptbxl_torch/csrc/probes.cu",
            "replaces": replaces, "launches": probe_info["launches"][name],
            "launches_by_path": {name: probe_info["launches"][name]},
            "max_abs_err": max(r["max_abs_err"] for r in prow),
            "ms": sum(r["ms"] for r in prow), "plain_ms": sum(r["plain_ms"] for r in prow),
            "bound_ms": total_bound,
            "bound_by": "operations" if 2 * n_ops >= total_bound else "bytes",
            "library_ms": sum(r["library_ms"] for r in prow), "batch": None,
            # device time alone: each probe's calls replayed from a CUDA graph
            "graph_ms": sum(r["graph_ms"] for r in prow),
            "library_graph_ms": sum(r["library_graph_ms"] for r in prow),
            "per_probe": [{k: r[k] for k in ("probe", "err", "max_abs_err", "tol", "ms",
                                             "graph_ms", "plain_ms", "library_ms",
                                             "library_graph_ms", "library", "bound")}
                          for r in prow],
            "status": status,
        })
        if name == "probe_mosaic":
            kernels[-1]["gate_cases"] = {
                case: {k: g[k] for k in ("max_abs_err", "tol", "ctas", "path") if k in g}
                for case, g in probe_info["p1_gates"].items()}
    # P4: the four layers at the probe's batch; P3's two modes and cuDNN beside it
    prows = p4_info["rows"]
    by_ops = sum(r["bound"][0] for r in prows if r["bound"][1] == "operations")
    p4_bound = sum(r["bound"][0] for r in prows)
    kernels.append({
        "name": "sublane_conv", "route": "cuda", "source": "ptbxl_torch/csrc/hybrid_wgmma.cu",
        "replaces": "tools/probe_sublane_conv.py:51",
        "launches": p4_info["launches"]["conv_layer_cf"],
        "launches_by_path": {"probe_sublane_conv": p4_info["launches"]["conv_layer_cf"]},
        "max_abs_err": max(list(p4_info["max_abs_err"].values())
                           + list(p4_info["max_abs_err_b2048"].values())),
        "max_abs_err_b2048": max(p4_info["max_abs_err_b2048"].values()),
        "ms": sum(r["p4_ms"] for r in prows), "plain_ms": sum(p4_info["plain_ms"]),
        "bound_ms": p4_bound, "bound_by": "operations" if 2 * by_ops >= p4_bound else "bytes",
        "library_ms": sum(r["cudnn_ms"] for r in prows), "batch": PROBE_LAYER_B,
        "p3_im2col_ms": sum(r["p3_im2col_ms"] for r in prows),
        "p3_direct_ms": sum(r["p3_direct_ms"] for r in prows),
        "per_layer": [{"layer": r["layer"], "ms": r["p4_ms"], "plain_ms": p,
                       "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                       "share_of_bound": r["bound"][0] / r["p4_ms"],
                       "library_ms": r["cudnn_ms"], "p3_im2col_ms": r["p3_im2col_ms"],
                       "p3_direct_ms": r["p3_direct_ms"]}
                      for r, p in zip(prows, p4_info["plain_ms"])],
    })
    if len(kernels) != 10 or not all(k["launches"] > 0 for k in kernels):
        raise AssertionError(f"kernels line: {[(k['name'], k['launches']) for k in kernels]}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
