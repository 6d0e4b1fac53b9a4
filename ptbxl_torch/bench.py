"""The port's benchmark: device rows of ``bench.py`` with the port's modules.

    python -m ptbxl_torch.bench [--full] [--out PATH] [--device cpu]

Prints ONE JSON line, the headline: the best inference records/s among the
rows whose probabilities stay within 5e-3 of the f32 ``highest`` framework
path on the bundled demo pack (``data/demo/single``).  Every measured number
goes to a sidecar (``--out``, by default ``build/ptbxl_torch/
bench_results.json`` for ``--full`` and ``bench_results_headline.json``
otherwise), with a regression block against the sidecar found at that path.

Rows (``bench.py`` line numbers):

* inference (``bench_inference``, :339): ``framework`` f32 ``highest`` (the
  two-pass z-score, TF32 off), ``framework`` bf16 (``precision='default'``:
  bf16 compute, the one-pass z-score, f32 wire), ``bf16_act`` (bf16 wire and
  activations), ``kernel`` (K2, f32) and ``hybrid`` (K4, bf16; ``bench.py``'s
  ``block_b=16`` has no counterpart on the card) and ``int8`` (the
  post-training int8 model of ``ops/quant.py`` with its shipped layer set and
  robust calibration, bf16 wire; :313), each gated by ``_parity_check``
  (:231) and naming the gate in ``parity_gate``: the int8 row at the
  battery's max 4e-2 (``battery_max``, :385, :413-418), the others at 5e-3.
  Each row on the card also records its peak device memory.  Headline mode
  runs the rows that can win on the card, as ``bench.py``'s runs only the
  configurations that can win (:361-368): ``bf16_act`` at 16384 and the
  hybrid at 8192.  The int8 row, which can win on the TPU, runs under
  ``--full`` alone: on the H100 it is the slowest bulk row but f32 (PERF.md).
* the pipeline rows, which read the data layer on a synthetic PTB-XL tree
  (``ptbxl_torch/tools/synthetic_ptbxl.py``, 2048 records of [12, 5000],
  made once under the temp directory): ``bench_pipeline_stages`` (:1130,
  records/s of each host stage and of the int16 H2D copy),
  ``bench_host_scaling`` (:794, the C++ decoder's and row gather's records/s
  by thread count, interleaved repeats, ``valid`` only with more than one
  core) and ``bench_pipeline_e2e`` (:1080, the ADC cache -> ``BatchSource(
  emit_adc=True)`` -> ``device_prefetch`` -> device conversion, one-pass
  z-score and the bf16 forward, full epochs timed with one sync at the end).
  They are measurements, not guarded by the regression gate.
* ``bench_multimodal`` (:430), bf16 at 12288 with its own 5e-3 parity gate on
  ``data/demo/multimodal``, and the int8 backbone at 12288 gated at 4e-2
  (``battery_max``, :488-492); ``bench_ceiling`` (:901): the shipping int8
  model decomposed by block (progressive prefixes: z-score, + block 0..3,
  + tail, at 11264), each block bounded by the H100's data-sheet peaks (dense
  int8 and bf16 tensor-core rates, HBM bandwidth), beside that bound
  ratcheted to its measurement; ``bench_demo_latency`` (:520): forward + Grad-CAM
  of one record, one class and all 5 (``GradCAM.multi``); ``bench_train_step``
  (:605) f32 at 256 and bf16 at 256, 1024 and 4096; ``bench_train_phases``
  (:674): forward, forward + backward and the full step, bf16 at 256 and 4096.

Timing: CUDA events around ``iters`` calls after 2 warm-up calls, median of 3
trials, per call.  TFLOP/s and ``mfu_pct`` are against the H100's dense peaks
(67 TFLOP/s FP32 without tensor cores for the f32 rows, 989 TFLOP/s bf16),
named in the sidecar beside ``nvidia-smi``'s name and power limit.  With
``--device cpu`` the same rows run on the host with host clocks: a wiring
check whose numbers are no device measurement (the sidecar says so).
``PTBXL_TORCH_BENCH_SMOKE=1`` shrinks every row to batch <= 8 and iters <= 2
(the pipeline rows to 24 records of [12, 512]).

A row that raises or misses its parity gate is written to the sidecar with
its ``error`` and makes the process exit with 1 after the headline line.
Without a GPU, and without ``--device cpu``, it raises.  Imports nothing of
JAX or ptbxl_tpu; the FLOP model is this file's own copy of ``bench.py``'s.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ptbxl_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "outputs/ecg_baseline/ckpts/ecg_baseline_best.npz")
CKPT_MM = os.path.join(ROOT, "outputs/ecg_multimodal/ckpts/ecg_multimodal_best.npz")
DEMO = os.path.join(ROOT, "data/demo/single")
DEMO_MM = os.path.join(ROOT, "data/demo/multimodal")
OUT_DIR = os.path.join(ROOT, "build", "ptbxl_torch")
T_FULL, LEADS = 5000, 12
NORTH_STAR_RPS = 1000.0  # BASELINE.json's target, records/s
HEADLINE_METRIC = "ecg_inference_records_per_sec_per_gpu"
PARITY_TOL = 5e-3

SMOKE = os.environ.get("PTBXL_TORCH_BENCH_SMOKE", "") not in ("", "0", "false")

# Per-record matmul FLOPs (bench.py:51-55, 97-99): 2*K*Cin*Cout*T_out a conv.
CONV_FLOPS_PER_REC = [57.6e6, 153.6e6, 307.2e6, 614.4e6]
DENSE_FLOPS_PER_REC = 2 * 256 * 256 + 2 * 256 * 5
FWD_FLOPS_PER_REC = sum(CONV_FLOPS_PER_REC) + DENSE_FLOPS_PER_REC  # ~1.133 GF
TRAIN_FLOPS_PER_REC = (3 * sum(CONV_FLOPS_PER_REC) - CONV_FLOPS_PER_REC[0]
                       + 3 * DENSE_FLOPS_PER_REC)  # ~3.341 GF
MM_EXTRA_FLOPS_PER_REC = 2 * 5 * 64 + 2 * 64 * 64 + 2 * 64 * 512
MM_FWD_FLOPS_PER_REC = FWD_FLOPS_PER_REC + MM_EXTRA_FLOPS_PER_REC

# H100 SXM dense peaks (NVIDIA data sheet), at the full 700 W power limit
H100_PEAKS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12, "bytes": 3.35e12}
INT8_TOL = 4e-2  # the int8 rows' gate: the 519-signal battery's max (quant_eval.BATTERY_GATE)

Forward = Callable[[torch.Tensor], torch.Tensor]


def _n(v: int) -> int:
    """A batch size, shrunk under PTBXL_TORCH_BENCH_SMOKE."""
    return min(v, 8) if SMOKE else v


def _iters(v: int) -> int:
    return min(v, 2) if SMOKE else v


class Clock:
    """Per-call time of a function on one device: CUDA events on the card,
    the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def ms(self, fn: Callable[[], object], iters: int, warmup: int = 2, trials: int = 3) -> float:
        """Median over ``trials`` of the mean time of ``iters`` calls (ms)."""
        for _ in range(warmup):
            fn()
        self.sync()
        times = []
        for _ in range(trials):
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / iters)
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                times.append((time.perf_counter() - t0) * 1e3 / iters)
        return statistics.median(times)


def _mfu(rps: float, flops_per_rec: float, peak_key: str, on_card: bool) -> Tuple[float, Optional[float]]:
    """(TFLOP/s, % of the H100 peak or None off the card).  ``int8``: the
    shipping layer set's convs against the int8 peak, the rest against bf16."""
    tflops = rps * flops_per_rec / 1e12
    if not on_card:
        return tflops, None
    if peak_key == "int8":
        from ptbxl_torch.ops.quant import default_int8_layers

        int8_f = sum(CONV_FLOPS_PER_REC[i] for i in default_int8_layers("ecgcnn"))
        bound_s = int8_f / H100_PEAKS["int8"] + (flops_per_rec - int8_f) / H100_PEAKS["bf16"]
        return tflops, 100.0 * bound_s * rps
    return tflops, 100.0 * tflops * 1e12 / H100_PEAKS[peak_key]


def _demo_pack(device: torch.device) -> torch.Tensor:
    files = sorted(glob.glob(os.path.join(DEMO, "*.npz")))
    x = np.stack([np.load(f, allow_pickle=True)["ecg"] for f in files])  # [7, 12, T]
    return torch.from_numpy(x.transpose(0, 2, 1).copy()).to(device)


def _random_batch(b: int, dtype: torch.dtype, device: torch.device, seed: int = 0) -> torch.Tensor:
    """A [B, T, 12] batch made on the device: its content does not change the time."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(b, T_FULL, LEADS, generator=gen, device=device).to(dtype)


# -- inference ------------------------------------------------------------------

def build_forward(path: str, dtype_name: str, device: torch.device) -> Forward:
    """x [B, T, 12] raw -> probs [B, 5] f32 for one row of the inference table."""
    from ptbxl_torch.models.factory import load_ecgcnn
    from ptbxl_torch.models.params_io import load_checkpoint
    from ptbxl_torch.ops.kernels import fused_ecgcnn as k2
    from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4
    from ptbxl_torch.ops.preprocess import zscore_per_lead_batch, zscore_per_lead_batch_onepass

    if path == "int8":
        from ptbxl_torch.ops.quant import (make_quantized_forward, quantize_model, split_meta,
                                           to_device)

        state, _ = load_checkpoint(CKPT)
        arrs, n_blocks, layers = split_meta(quantize_model(state, arch="ecgcnn", device=device))
        fwd = make_quantized_forward(n_blocks, layers, arch="ecgcnn")
        arrs = to_device(arrs, device)
        return lambda x: fwd(arrs, x)
    if path in ("kernel", "hybrid"):
        state, _ = load_checkpoint(CKPT)
        folded = k2.fold_bn_into_conv({k: v.to(device) for k, v in state.items()})
        if path == "kernel":
            k2_weights = k2.prepare_weights(folded)
            return lambda x: k2.fused_ecgcnn_probs(x, folded, torch.float32, True, k2_weights)
        weights = k4.prepare_weights(folded, compute_dtype=torch.bfloat16)
        return lambda x: k4.hybrid_ecgcnn_probs(x, folded, torch.bfloat16, True, weights=weights)
    if dtype_name == "f32":
        model, _ = load_ecgcnn(CKPT, device=device, precision="highest")

        def forward(x):
            return torch.sigmoid(model(zscore_per_lead_batch(x.float())).float())
        return forward
    model, _ = load_ecgcnn(CKPT, device=device, precision="default", dtype=torch.bfloat16)
    act = dtype_name == "bf16_act"

    def forward(x):
        h = zscore_per_lead_batch_onepass(x)  # f32 whatever the wire dtype
        return torch.sigmoid(model(h.to(torch.bfloat16) if act else h).float())
    return forward


def parity_check(forward: Forward, reference: Forward, device: torch.device,
                 tol: float = PARITY_TOL) -> Tuple[bool, float]:
    """Worst |prob diff| vs the f32 parity path on the demo pack (``_parity_check``)."""
    x = _demo_pack(device)
    worst = float((forward(x).float() - reference(x).float()).abs().max())
    return worst <= tol, worst


def inference_configs(full: bool) -> List[Tuple[str, str, str, List[int]]]:
    """(path, precision, dtype, batch sizes) of ``bench_inference`` (:346-368)."""
    if full:
        configs = [
            ("framework", "highest", "f32", [512, 2048]),
            ("framework", "default", "bf16", [512, 2048, 8192]),
            ("framework", "default", "bf16_act", [8192, 16384]),
            ("int8", "int8", "int8", [8192, 11264, 12288, 16384]),
            ("kernel", "highest", "f32", [512, 2048]),
            ("hybrid", "default", "bf16", [8192]),
        ]
    elif SMOKE:
        configs = [("framework", "highest", "f32", [8]), ("framework", "default", "bf16", [8])]
    else:
        configs = [("framework", "default", "bf16_act", [16384]),
                   ("hybrid", "default", "bf16", [8192])]
    return [(p, prec, d, sorted({_n(b) for b in bs})) for p, prec, d, bs in configs]


def inference_row(path: str, precision: str, dtype_name: str, batch: int, forward: Forward,
                  parity: Tuple[bool, float], clock: Clock, iters: int = 20) -> dict:
    """One row of the inference table: records/s of ``forward`` at ``batch``."""
    wire = torch.bfloat16 if dtype_name in ("bf16_act", "int8") else torch.float32
    x = _random_batch(batch, wire, clock.device)
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats(clock.device)
    with torch.no_grad():
        ms = clock.ms(lambda: forward(x), _iters(iters))
    rps = batch / (ms / 1e3)
    peak = {"f32": "f32", "int8": "int8"}.get(dtype_name, "bf16")
    tflops, mfu = _mfu(rps, FWD_FLOPS_PER_REC, peak, clock.cuda)
    ok, worst = parity
    gate = ({"name": "battery_max", "tol": INT8_TOL} if path == "int8"
            else {"name": "demo_pack_parity", "tol": PARITY_TOL})
    return dict(path=path, precision=precision, dtype=dtype_name, batch=batch, ms=ms, rps=rps,
                prob_err=worst, parity_ok=ok, parity_gate=gate, tflops=tflops, mfu_pct=mfu,
                peak_mem_gb=(torch.cuda.max_memory_allocated(clock.device) / 1e9
                             if clock.cuda else None))


def bench_inference(full: bool, clock: Clock, failures: list) -> Tuple[Optional[dict], list]:
    rows = []
    reference = build_forward("framework", "f32", clock.device)
    for path, precision, dtype_name, batches in inference_configs(full):
        try:
            forward = build_forward(path, dtype_name, clock.device)
            with torch.no_grad():
                parity = parity_check(forward, reference, clock.device,
                                      INT8_TOL if path == "int8" else PARITY_TOL)
        except Exception as e:  # noqa: BLE001 -- recorded, and the exit code says so
            parity, forward = None, e
        for bs in batches:
            name = f"{path}/{precision}/{dtype_name} bs={bs}"
            try:
                if parity is None:
                    raise forward
                row = inference_row(path, precision, dtype_name, bs, forward, parity, clock)
                if not row["parity_ok"]:
                    row["error"] = f"parity {row['prob_err']:.3e} > {row['parity_gate']['tol']}"
            except Exception as e:  # noqa: BLE001
                row = dict(path=path, precision=precision, dtype=dtype_name, batch=bs,
                           error=f"{type(e).__name__}: {e}"[:500])
            if "error" in row:
                failures.append(f"inference {name}: {row['error']}")
                print(f"# config {name} failed: {row['error']}", file=sys.stderr)
            rows.append(row)
    ok_rows = [r for r in rows if r.get("parity_ok") and "error" not in r]
    best = max(ok_rows, key=lambda r: r["rps"]) if ok_rows else None
    return best, rows


# -- the other rows -------------------------------------------------------------

def bench_multimodal(clock: Clock, batch_size: int = 12288, iters: int = 10,
                     precision: str = "default") -> dict:
    """FiLM multimodal records/s: bf16 activations and the one-pass z-score,
    or with ``precision='int8'`` the quantized backbone (``ops/quant.py``,
    the multimodal layer set, robust calibration); gated against the f32
    multimodal path on the multimodal demo pack at 5e-3, int8 at 4e-2."""
    from ptbxl_torch.models.factory import load_multimodal
    from ptbxl_torch.ops.preprocess import zscore_per_lead_batch, zscore_per_lead_batch_onepass

    dev = clock.device
    ref, _ = load_multimodal(CKPT_MM, device=dev, precision="highest")
    files = sorted(glob.glob(os.path.join(DEMO_MM, "*.npz")))
    packs = [np.load(f, allow_pickle=True) for f in files]
    xd = torch.from_numpy(np.stack([z["ecg"].T for z in packs])).to(dev)
    dd = torch.from_numpy(np.stack([z["demo"] for z in packs]).astype(np.float32)).to(dev)
    if precision == "int8":
        from ptbxl_torch.models.params_io import load_checkpoint
        from ptbxl_torch.ops.quant import (make_quantized_forward, quantize_model, split_meta,
                                           to_device)

        state, _ = load_checkpoint(CKPT_MM, arch="multimodal")
        arrs, n_blocks, layers = split_meta(quantize_model(state, arch="multimodal", device=dev))
        qf = make_quantized_forward(n_blocks, layers, arch="multimodal")
        arrs = to_device(arrs, dev)
        tol, gate = INT8_TOL, "battery_max"

        def forward(x, d):
            return qf(arrs, x, d)
    else:
        model, _ = load_multimodal(CKPT_MM, device=dev, precision="default", dtype=torch.bfloat16)
        tol, gate = PARITY_TOL, "demo_pack_parity_multimodal"

        def forward(x, d):
            h = zscore_per_lead_batch_onepass(x).to(torch.bfloat16)
            return torch.sigmoid(model(h, d).float())

    with torch.no_grad():
        worst = float((forward(xd, dd) - torch.sigmoid(ref(zscore_per_lead_batch(xd), dd))).abs().max())
        if worst > tol:
            raise AssertionError(f"multimodal {precision} parity {worst:.3e} > {tol}")
        b = _n(batch_size)
        x = _random_batch(b, torch.bfloat16, dev)
        d = torch.rand(b, 5, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        ms = clock.ms(lambda: forward(x, d), _iters(iters))
    rps = b / (ms / 1e3)
    tflops, mfu = _mfu(rps, MM_FWD_FLOPS_PER_REC, "bf16", clock.cuda)
    return {"precision": precision, "batch": b, "ms": ms, "rps": rps, "prob_err": worst,
            "parity_ok": True, "parity_gate": {"name": gate, "tol": tol},
            "tflops": tflops, "mfu_pct": mfu}


def bench_demo_latency(clock: Clock, n: int = 20, iters: int = 50) -> dict:
    """Forward + Grad-CAM of one demo record (class 0), f32 ``highest``: the p50
    of the host-clocked call (synchronised), and the device time a call for one
    class and for all 5 classes (``GradCAM.multi``, one forward), interleaved."""
    from ptbxl_torch.interpret.grad_cam import GradCAM
    from ptbxl_torch.models.factory import load_ecgcnn

    model, _ = load_ecgcnn(CKPT, device=clock.device)
    cam_fn = GradCAM(model, signal_length=T_FULL, norm_first=False, eps=1e-9)
    x = _demo_pack(clock.device)[:1]
    n, iters = _iters(n), _iters(iters)
    cam_fn(x, class_idx=0)
    clock.sync()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        cam_fn(x, class_idx=0)
        clock.sync()
        times.append((time.perf_counter() - t0) * 1e3)
    single, all5 = [], []
    for _ in range(5 if not SMOKE else 1):
        single.append(clock.ms(lambda: cam_fn(x, class_idx=0), iters, warmup=1, trials=1))
        all5.append(clock.ms(lambda: cam_fn.multi(x, range(5)), iters, warmup=1, trials=1))
    return {"p50_dispatch_ms": float(np.percentile(times, 50)),
            "onchip_ms": statistics.median(single), "onchip_all5_ms": statistics.median(all5)}


def _train_setup(batch_size: int, dtype_name: str, device: torch.device):
    from ptbxl_torch.models.factory import build_ecgcnn
    from ptbxl_torch.training.train_state import create_train_state

    dtype = torch.float32 if dtype_name == "f32" else torch.bfloat16
    model = build_ecgcnn(num_labels=5, seed=0, device=device, dtype=dtype,
                         precision="highest" if dtype_name == "f32" else "default")
    state = create_train_state(model, 1.5e-3, 1e-4)
    gen = torch.Generator(device=device).manual_seed(0)
    batch = {"ecg": torch.randn(batch_size, T_FULL, LEADS, generator=gen, device=device),
             "y": (torch.rand(batch_size, 5, generator=gen, device=device) > 0.7).float(),
             "mask": torch.ones(batch_size, device=device)}
    return state, batch


def bench_train_step(clock: Clock, batch_size: int, dtype_name: str, iters: int = 15) -> dict:
    """Records/s of the full train step (z-score, train-mode forward, backward, AdamW)."""
    from ptbxl_torch.training.loop import make_train_step

    b = _n(batch_size)
    state, batch = _train_setup(b, dtype_name, clock.device)
    step = make_train_step()
    ms = clock.ms(lambda: step(state, batch), _iters(iters))
    rps = b / (ms / 1e3)
    tflops, mfu = _mfu(rps, TRAIN_FLOPS_PER_REC, dtype_name, clock.cuda)
    return {"dtype": dtype_name, "batch": b, "ms": ms, "rps": rps, "tflops": tflops,
            "mfu_pct": mfu}


def bench_train_phases(clock: Clock, batch_size: int, dtype_name: str = "bf16",
                       iters: int = 10) -> dict:
    """The train step in phases: train-mode forward + loss, + backward, + AdamW
    (``bench_train_phases``, :674); the z-score is taken once outside the first two."""
    from ptbxl_torch.models.ecg_cnn import precision_scope
    from ptbxl_torch.ops.preprocess import zscore_per_lead_batch
    from ptbxl_torch.training.loop import make_train_step, per_sample_bce

    b = _n(batch_size)
    state, batch = _train_setup(b, dtype_name, clock.device)
    model = state.model
    x0 = zscore_per_lead_batch(batch["ecg"])

    def loss():
        model.train()
        with precision_scope(model.precision):
            per = per_sample_bce(model(x0), batch["y"])
            return torch.sum(per * batch["mask"]) / torch.sum(batch["mask"])

    def fwd():
        with torch.no_grad():
            loss()

    def fwdbwd():
        state.optimizer.zero_grad(set_to_none=True)
        with precision_scope(model.precision):
            loss().backward()

    step = make_train_step()
    n = _iters(iters)
    t_fwd = clock.ms(fwd, n)
    t_fwdbwd = clock.ms(fwdbwd, n)
    t_step = clock.ms(lambda: step(state, batch), n)
    rps = {k: b / (v / 1e3) for k, v in (("fwd", t_fwd), ("fwdbwd", t_fwdbwd), ("step", t_step))}
    out = {"batch": b, "dtype": dtype_name,
           "fwd_rps": rps["fwd"], "fwdbwd_rps": rps["fwdbwd"], "step_rps": rps["step"],
           "fwd_ms": t_fwd, "bwd_ms": t_fwdbwd - t_fwd, "optimizer_ms": t_step - t_fwdbwd}
    out["fwd_mfu_pct"] = _mfu(rps["fwd"], FWD_FLOPS_PER_REC, dtype_name, clock.cuda)[1]
    out["fwdbwd_mfu_pct"] = _mfu(rps["fwdbwd"], TRAIN_FLOPS_PER_REC, dtype_name, clock.cuda)[1]
    return out


CEIL_ROUNDS = 3  # bench_ceiling's interleaved rounds of part timings


def bench_ceiling(clock: Clock, batch_size: int = 11264, iters: int = 5) -> dict:
    """The shipping int8 model's attainable ceiling on this card (``bench_ceiling``, :901).

    A per-block decomposition, each part timed alone at ``batch_size`` in the
    forward's own chunks of records: the one-pass z-score on the raw batch
    with block 0's bf16 operand (``quant.block0_operand``), blocks 0..3
    (``quant.conv_stack_block``) each on its own input, and the tail (mean,
    proj, head; ``quant.dense_tail``) on the last block's output.  The inputs
    come from one untimed forward (``quant.conv_stack_inputs``), kept chunk
    by chunk in the dtype and layout ``quant._conv_stack`` hands each block,
    so no part's time is a difference of two timings.  Each part's time is
    its least over ``CEIL_ROUNDS`` interleaved rounds (host contention only
    adds time); ``config.decomposition_check`` is the parts' sum over one
    whole forward timed the same way (reported, not gated).  Each block is
    bounded by this card's data-sheet peaks: its conv operations over the
    dense int8 (an int8 layer) or bf16 rate, or its input read once and its
    output written once (int8 where the consumer is int8, else bf16; the
    z-score reads the bf16 wire and writes bf16) over the HBM rate, whichever
    is longer: ``bound_us``, and ``analytic_ceiling_rps`` is 1 / their sum.
    ``ratcheted_bound_us`` is the least of that bound and the measurement (a
    measurement is attainable), and ``ceiling_rps`` 1 / their sum, as
    ``bench.py`` ratchets.
    """
    from ptbxl_torch.models.params_io import load_checkpoint
    from ptbxl_torch.ops.quant import (block0_operand, chunk_records, conv_stack_block,
                                       conv_stack_inputs, dense_tail, make_quantized_forward,
                                       quantize_model, split_meta, to_device)

    dev = clock.device
    state, _ = load_checkpoint(CKPT)
    arrs, n_blocks, layers = split_meta(quantize_model(state, arch="ecgcnn", device=dev))
    arrs = to_device(arrs, dev)
    full = make_quantized_forward(n_blocks, layers, arch="ecgcnn")
    b = _n(batch_size)
    x = _random_batch(b, torch.bfloat16, dev)
    n = chunk_records(T_FULL, arrs, layers)
    chunks = x.split(n)
    with torch.no_grad():  # each part's input, chunk by chunk, from one untimed forward
        per_chunk = [conv_stack_inputs(arrs, xc, n_blocks, layers) for xc in chunks]
    inputs = [list(chunks)] + [list(hs) for hs in zip(*per_chunk)]

    def part(k):
        if k == 0:
            return lambda: [block0_operand(xc, layers) for xc in inputs[0]]
        if k <= n_blocks:
            return lambda: [conv_stack_block(arrs, h, k - 1, n_blocks, layers)
                            for h in inputs[k]]
        return lambda: [dense_tail(arrs, h.transpose(1, 2)) for h in inputs[k]]

    fns = [part(k) for k in range(n_blocks + 2)] + [lambda: full(arrs, x)]
    with torch.no_grad():
        rounds = [[clock.ms(f, _iters(iters)) for f in fns] for _ in range(CEIL_ROUNDS)]
    per_rec = [min(ts) / 1e3 / b for ts in zip(*rounds)]
    names = ["zscore"] + [f"block{i}" for i in range(n_blocks)] + ["tail"]
    meas, whole = per_rec[:-1], per_rec[-1]
    cins, couts = [12, 32, 64, 128], [32, 64, 128, 256]
    bounds = [(T_FULL * LEADS * (2 + 2) / H100_PEAKS["bytes"], "memory")]
    for i in range(n_blocks):
        t_in = T_FULL >> i
        rate = H100_PEAKS["int8" if i in layers else "bf16"]
        compute = CONV_FLOPS_PER_REC[i] / rate
        mem = (t_in * cins[i] * (1 if i in layers else 2)
               + (t_in // 2) * couts[i] * (1 if i + 1 in layers else 2)) / H100_PEAKS["bytes"]
        bounds.append((compute, "compute") if compute >= mem else (mem, "memory"))
    bounds.append(((T_FULL >> n_blocks) * couts[-1] * 2 / H100_PEAKS["bytes"], "memory"))
    rows = [{"block": name, "measured_us": m * 1e6, "bound_us": analytic * 1e6,
             "bound_kind": kind, "ratcheted_bound_us": min(analytic, m) * 1e6,
             "headroom_us": (m - analytic) * 1e6}
            for name, m, (analytic, kind) in zip(names, meas, bounds)]
    total_b = sum(r["ratcheted_bound_us"] for r in rows) / 1e6
    total_m = sum(meas)
    return {"config": {"int8_layers": list(layers), "batch": b, "iters": _iters(iters),
                       "rounds": CEIL_ROUNDS, "chunk_records": n,
                       "decomposition_check": total_m / whole},
            "peaks_assumed": {"int8_dense_tops": H100_PEAKS["int8"] / 1e12,
                              "bf16_dense_tflops": H100_PEAKS["bf16"] / 1e12,
                              "hbm_GBps": H100_PEAKS["bytes"] / 1e9,
                              "source": "NVIDIA H100 SXM data sheet, 700 W"},
            "blocks": rows, "decomposition_rps": 1.0 / total_m, "ceiling_rps": 1.0 / total_b,
            "analytic_ceiling_rps": 1e6 / sum(r["bound_us"] for r in rows),
            "pct_of_ceiling_decomposition": 100.0 * total_b / total_m}


# -- the data pipeline ------------------------------------------------------------

PIPE_RECORDS, PIPE_SAMPLES, PIPE_BATCH = 2048, 5000, 256
PIPE_CLASSES = ["MI", "STTC", "HYP", "CD", "NORM"]


def pipeline_tree(n_records: int = PIPE_RECORDS, n_samples: int = PIPE_SAMPLES) -> str:
    """A synthetic PTB-XL tree under the temp directory (seed 7, as bench.py's),
    made once: written beside its final path and renamed into place."""
    import shutil
    import tempfile

    from ptbxl_torch.tools.synthetic_ptbxl import make_synthetic_ptbxl

    if SMOKE:
        n_records, n_samples = min(n_records, 24), min(n_samples, 512)
    root = os.path.join(tempfile.gettempdir(), f"ptbxl_torch_bench_{n_records}_{n_samples}")
    if not os.path.exists(os.path.join(root, "ptbxl_database.csv")):
        tmp = f"{root}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        make_synthetic_ptbxl(tmp, n_records=n_records, n_samples=n_samples, seed=7)
        try:
            os.replace(tmp, root)
        except OSError:  # another process made it first
            shutil.rmtree(tmp, ignore_errors=True)
    return root


def _pipeline_dataset(root: str):
    from ptbxl_torch.data import PTBXLDataset

    return PTBXLDataset(root, "train", PIPE_CLASSES)


def bench_pipeline_stages(clock: Clock, root: Optional[str] = None,
                          batch_size: int = PIPE_BATCH) -> dict:
    """Records/s of each input-pipeline stage (``bench_pipeline_stages``, :1130):
    ``host_cold`` (the ADC cache built from the .dat files, then one epoch of
    int16 batches), ``host_warm`` (an epoch of int16 batches from the warm
    cache), ``host_nocache`` (per-batch threaded decode, f32 batches) and
    ``h2d`` / ``h2d_MBps`` (each int16 batch copied from pageable memory to
    the device and waited for, as ``jax.device_put`` + ``block_until_ready``)."""
    import shutil

    from ptbxl_torch.data.manifest import CACHE_DIRNAME
    from ptbxl_torch.data.pipeline import BatchSource

    root = root or pipeline_tree()
    ds = _pipeline_dataset(root)
    n, bs = len(ds), _n(batch_size)
    out = {"records": n, "batch": bs}
    shutil.rmtree(os.path.join(root, CACHE_DIRNAME, ""), ignore_errors=True)
    t0 = time.perf_counter()
    src = BatchSource(ds, bs, shuffle=False, emit_adc=True)
    for _ in src.epoch(0):
        pass
    out["host_cold"] = n / (time.perf_counter() - t0)
    out["reader"] = src.reader
    for _ in src.epoch(0):
        pass
    t0 = time.perf_counter()
    for _ in src.epoch(1):
        pass
    out["host_warm"] = n / (time.perf_counter() - t0)
    src2 = BatchSource(ds, bs, shuffle=False, use_adc_cache=False)
    for _ in src2.epoch(0):
        pass
    t0 = time.perf_counter()
    for _ in src2.epoch(1):
        pass
    out["host_nocache"] = n / (time.perf_counter() - t0)
    out["nocache_reader"] = src2.reader
    batches = [b["adc_lt"] for b in src.epoch(0)]
    torch.from_numpy(batches[0]).to(clock.device)
    clock.sync()
    t0 = time.perf_counter()
    moved = 0
    for a in batches:
        torch.from_numpy(a).to(clock.device)
        clock.sync()
        moved += a.shape[0]
    dt = time.perf_counter() - t0
    out["h2d"] = moved / dt
    out["h2d_MBps"] = moved * batches[0][0].nbytes / dt / 1e6
    return out


def bench_host_scaling(clock: Clock, root: Optional[str] = None, batch_size: int = PIPE_BATCH,
                       threads: Optional[List[int]] = None) -> Optional[dict]:
    """Records/s of the C++ decoder and of the warm-cache row gather at 1..N
    threads (``bench_host_scaling``, :794): one untimed warm-up pass, then 3
    repeats with the thread counts interleaved, medians; ``valid`` is False on
    a one-core host, where scaling cannot show.  None without the native
    library, as the JAX row."""
    from ptbxl_torch.data.cache import ADCCache
    from ptbxl_torch.io import native
    from ptbxl_torch.io.wfdb_io import read_header

    if not native.available():
        return None
    ncpu = os.cpu_count() or 1
    if threads is None:
        threads = [t for t in (1, 2, 4, 8, 16) if t <= max(2 * ncpu, 2)]
    root = root or pipeline_tree()
    ds = _pipeline_dataset(root)
    rels = list(ds.df["filename_hr"])
    cache = ADCCache(root, rels).ensure_built(verbose=False)
    n, bs = len(ds), _n(batch_size)
    dat_paths = []
    for rel in rels:
        rec = os.path.join(root, rel)
        dat_paths.append(os.path.join(os.path.dirname(rec), read_header(rec).signals[0].file_name))
    t_len, leads = cache.n_samples, cache.n_leads
    rng = np.random.default_rng(0)

    def decode_pass(k):
        t0 = time.perf_counter()
        for s in range(0, n, bs):
            _, ok = native.decode_batch_fmt16(dat_paths[s:s + bs], t_len, leads, n_threads=k)
            if not ok.all():
                raise RuntimeError("native decode failed")
        return n / (time.perf_counter() - t0)

    def gather_pass(k):
        order = rng.permutation(n)
        t0 = time.perf_counter()
        for s in range(0, n, bs):
            native.gather_rows(cache._adc, order[s:s + bs].astype(np.int64), n_threads=k)
        return n / (time.perf_counter() - t0)

    decode_pass(threads[0])
    gather_pass(threads[0])
    repeats = 3
    dec = {k: [] for k in threads}
    gat = {k: [] for k in threads}
    for _ in range(repeats):
        for k in threads:
            dec[k].append(decode_pass(k))
            gat[k].append(gather_pass(k))
    rows = [{"threads": k, "decode_rps": float(np.median(dec[k])),
             "gather_rps": float(np.median(gat[k]))} for k in threads]
    return {"cpu_count": ncpu, "records": n, "batch": bs, "rows": rows, "repeats": repeats,
            "method": "warmup + interleaved round-robin, median of repeats",
            "valid": ncpu > 1,
            "note": None if ncpu > 1 else
            "cpu_count==1: thread scaling unobservable; table is non-evidence"}


def bench_pipeline_e2e(clock: Clock, root: Optional[str] = None, batch_size: int = PIPE_BATCH,
                       epochs: int = 2) -> dict:
    """Sustained end-to-end records/s (``bench_pipeline_e2e``, :1080): the
    int16 ADC cache -> ``BatchSource(emit_adc=True)`` -> ``device_prefetch``
    (pinned memory, a side stream, depth 2) -> on the device the ADC
    conversion, the one-pass z-score and the bf16 framework forward, over
    ``epochs`` full epochs after a warm epoch, with one sync at the end.
    Records are counted on the host, before the copy."""
    from ptbxl_torch.data.pipeline import BatchSource, device_prefetch

    root = root or pipeline_tree()
    ds = _pipeline_dataset(root)
    src = BatchSource(ds, _n(batch_size), shuffle=True, emit_adc=True)
    forward = build_forward("framework", "bf16", clock.device)
    counted = [0]

    def counting(gen):
        for hb in gen:
            counted[0] += int(hb["mask"].sum())
            yield hb

    with torch.no_grad():
        for b in device_prefetch(src.epoch(0), clock.device):  # warm: cuDNN plans, pinned pool
            out = forward(b["ecg"])
        clock.sync()
        t0 = time.perf_counter()
        for e in range(1, 1 + epochs):
            for b in device_prefetch(counting(src.epoch(e)), clock.device):
                out = forward(b["ecg"])
        clock.sync()
        dt = time.perf_counter() - t0
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("pipeline e2e: non-finite probabilities")
    return {"rps": counted[0] / dt, "records": counted[0], "epochs": epochs,
            "batch": src.batch_size, "wall_s": dt, "reader": src.reader,
            "emit_adc": src.emit_adc, "forward": "framework bf16 (one-pass z-score)"}


# -- sidecar and regression gate ------------------------------------------------

def _extract_perf_keys(suite: dict) -> Dict[str, Tuple[float, int]]:
    """``{name: (value, direction)}`` of a sidecar's guarded metrics; +1 higher
    is better (records/s), -1 lower is better (ms) (bench.py:1209)."""
    out = {}
    h = suite.get("headline") or {}
    if isinstance(h.get("value"), (int, float)):
        out["headline_rps"] = (h["value"], +1)
    inf = suite.get("inference") or {}
    best = inf.get("best")
    if isinstance(best, dict) and isinstance(best.get("rps"), (int, float)):
        out["inference_best_rps"] = (best["rps"], +1)
    for r in inf.get("rows") or []:
        if isinstance(r.get("rps"), (int, float)) and r.get("parity_ok"):
            out[f"inference_{r['path']}_{r['dtype']}_bs{r['batch']}_rps"] = (r["rps"], +1)
    for r in suite.get("train") or []:
        if isinstance(r, dict) and isinstance(r.get("rps"), (int, float)):
            out[f"train_{r['dtype']}_bs{r['batch']}_rps"] = (r["rps"], +1)
    lat = suite.get("demo_latency")
    if isinstance(lat, dict):
        for k in ("onchip_ms", "onchip_all5_ms"):
            if isinstance(lat.get(k), (int, float)):
                out[f"demo_{k}"] = (lat[k], -1)
    for key in ("multimodal_bf16", "multimodal_int8"):
        mm = suite.get(key)
        if isinstance(mm, dict) and isinstance(mm.get("rps"), (int, float)):
            out[f"{key}_rps"] = (mm["rps"], +1)
    return out


def _check_regressions(suite: dict, out_path: str, threshold_pct: float = 5.0) -> None:
    """Compare this run's guarded metrics with the sidecar at ``out_path`` and
    attach a ``regressions`` block; a move past ``threshold_pct`` in the bad
    direction is flagged (bench.py:1240)."""
    try:
        with open(out_path) as f:
            old = json.load(f)
    except (OSError, ValueError):
        suite["regressions"] = {"baseline_unix_time": None, "threshold_pct": threshold_pct,
                                "rows": [], "flagged": [],
                                "note": "no prior sidecar at this path to compare against"}
        return
    old_keys = _extract_perf_keys(old)
    rows, flagged = [], []
    for name, (new_v, direction) in sorted(_extract_perf_keys(suite).items()):
        if name not in old_keys or not old_keys[name][0]:
            continue
        old_v = old_keys[name][0]
        delta_pct = 100.0 * (new_v - old_v) / old_v
        regressed = (-delta_pct * direction) > threshold_pct
        rows.append({"row": name, "old": old_v, "new": new_v, "delta_pct": delta_pct,
                     "regressed": regressed})
        if regressed:
            flagged.append(name)
            print(f"# PERF REGRESSION {name}: {old_v:.4g} -> {new_v:.4g} ({delta_pct:+.1f}%)",
                  file=sys.stderr)
    suite["regressions"] = {"baseline_unix_time": old.get("unix_time"),
                            "baseline_mode": old.get("mode"),
                            "baseline_device": (old.get("device") or {}).get("kind"),
                            "threshold_pct": threshold_pct, "rows": rows, "flagged": flagged}


def _write_sidecar(suite: dict, out_path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(suite, f, indent=1)
    os.replace(tmp, out_path)
    print(f"# wrote {out_path}", file=sys.stderr)


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "nvidia_smi": None,
                "note": "host run: a wiring check, no device measurement"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(), "nvidia_smi": smi}


# -- main -----------------------------------------------------------------------

def _record(suite: dict, failures: list, key: str, fn, *a, **kw):
    try:
        suite[key] = fn(*a, **kw)
        return suite[key]
    except Exception as e:  # noqa: BLE001 -- recorded, and the exit code says so
        print(f"# {key} failed: {e}", file=sys.stderr)
        failures.append(f"{key}: {type(e).__name__}: {e}"[:500])
        suite[key] = {"error": f"{type(e).__name__}: {e}"[:500]}
        return None


def run(full: bool, device: torch.device, out_path: str) -> Tuple[dict, List[str]]:
    """Every row of the chosen mode; returns (suite, failures)."""
    clock = Clock(device)
    failures: List[str] = []
    suite = {"schema": "ptbxl_torch_bench_v1", "mode": "full" if full else "headline",
             "smoke": SMOKE, "unix_time": time.time(), "device": device_info(device),
             "torch": torch.__version__, "cuda": torch.version.cuda,
             "mfu_model": {"fwd_flops_per_record": FWD_FLOPS_PER_REC,
                           "train_flops_per_record": TRAIN_FLOPS_PER_REC,
                           "mm_fwd_flops_per_record": MM_FWD_FLOPS_PER_REC,
                           "peaks_assumed": {"device": "NVIDIA H100 SXM (data sheet, 700 W)",
                                             "f32_no_tensor_cores": H100_PEAKS["f32"],
                                             "bf16_dense": H100_PEAKS["bf16"]},
                           "note": "MFU counts matmul FLOPs only (convs + dense); f32 rows "
                                   "against the FP32 peak, bf16 rows against the bf16 peak; "
                                   "null off the card"}}
    best, rows = bench_inference(full, clock, failures)
    suite["inference"] = {"best": best, "rows": rows}
    for r in rows:
        if "error" not in r:
            print(f"#  {r['path']:>9} prec={r['precision']:>7} dtype={r['dtype']:>8} "
                  f"bs={r['batch']:>5} -> {r['rps']:>10.1f} rec/s ({r['ms']:.3f} ms, "
                  f"{r['tflops']:.1f} TF/s, prob_err={r['prob_err']:.2e})", file=sys.stderr)
    if full:
        _record(suite, failures, "multimodal_bf16", bench_multimodal, clock)
        _record(suite, failures, "multimodal_int8", bench_multimodal, clock, precision="int8")
        ceil = _record(suite, failures, "ceiling", bench_ceiling, clock)
        if ceil is not None:
            int8_rows = [r for r in rows if r.get("path") == "int8" and "error" not in r]
            if int8_rows:
                top = max(int8_rows, key=lambda r: r["rps"])
                ceil["int8_row_pct_of_ceiling"] = 100.0 * top["rps"] / ceil["ceiling_rps"]
        _record(suite, failures, "demo_latency", bench_demo_latency, clock)
        suite["train"] = []
        for dtype_name, bs in (("f32", 256), ("bf16", 256), ("bf16", 1024), ("bf16", 4096)):
            key = f"train_{dtype_name}_{bs}"
            r = _record(suite, failures, key, bench_train_step, clock, bs, dtype_name)
            suite.pop(key)
            suite["train"].append(r if r is not None else
                                  {"dtype": dtype_name, "batch": bs, "error": failures[-1]})
        suite["train_phases"] = []
        for bs in (256, 4096):
            key = f"train_phases_{bs}"
            r = _record(suite, failures, key, bench_train_phases, clock, bs)
            suite.pop(key)
            suite["train_phases"].append(r if r is not None else
                                         {"batch": bs, "error": failures[-1]})
        # the data layer's log lines go to stderr: stdout is the headline alone
        with contextlib.redirect_stdout(sys.stderr):
            root = _record(suite, failures, "pipeline_tree", pipeline_tree)
            if root is not None:
                _record(suite, failures, "pipeline_stages", bench_pipeline_stages, clock, root)
                _record(suite, failures, "host_scaling", bench_host_scaling, clock, root)
                _record(suite, failures, "pipeline_e2e", bench_pipeline_e2e, clock, root)
    value = best["rps"] if best else 0.0
    suite["headline"] = {
        "metric": HEADLINE_METRIC, "value": value, "unit": "records/s",
        "vs_baseline": value / NORTH_STAR_RPS,
        "device": suite["device"]["kind"],
        "tflops": best.get("tflops") if best else None,
        "mfu_pct": best.get("mfu_pct") if best else None,
        "parity_gate": best.get("parity_gate") if best else None,
        "row": {k: best[k] for k in ("path", "precision", "dtype", "batch")} if best else None,
    }
    suite["failures"] = failures
    _check_regressions(suite, out_path)
    return suite, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="the whole table, not just the headline")
    ap.add_argument("--out", default=None, help="sidecar path (default under build/ptbxl_torch/)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for a host wiring run; default the GPU, which must exist")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = args.out or os.path.join(
        OUT_DIR, "bench_results.json" if args.full else "bench_results_headline.json")
    suite, failures = run(args.full, device, out)
    _write_sidecar(suite, out)
    print(json.dumps(suite["headline"]), flush=True)
    if failures:
        print(f"# {len(failures)} row(s) failed: " + "; ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
