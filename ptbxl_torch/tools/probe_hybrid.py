"""K4, the hybrid engine, timed on the card beside the framework's bf16 forward.

    python -m ptbxl_torch.tools.probe_hybrid [--batch 512 8192] [--iters 5] [--out PATH]

For each batch of raw-like records (``bench._random_batch``): the device ms
of one ``hybrid_ecgcnn_logits`` call in bf16 at ``split=2`` on the baseline
checkpoint with weights from ``prepare_weights`` (the bench's hybrid row
without the sigmoid), the framework bf16 forward's ms (``bench.build_forward(
"framework", "bf16")``, the library yardstick), and the device ms of every
launch of one K4 call from ``torch.profiler`` (CUPTI), in order; and what
``-Xptxas -v`` reported for each instantiation of the ``wgmma`` conv block
in the build it ran (registers, spill bytes, static shared memory), keyed by
its template arguments.  Beside them, at each batch, K2's and K3's
bf16 forwards (``fused_ecgcnn_logits`` on the baseline checkpoint,
``fused_multimodal_logits`` on the multimodal one with random demo vectors,
``compute_dtype=torch.bfloat16``, weights from K4's ``prepare_weights``):
their device ms, the framework bf16 forward's (the default-precision
framework ``Predictor``), their bound at the dense bf16 peak and their
launches.  Uses only the port's public K2 / K4 API and its build
directory, so the same file times any commit of the port
(``PYTHONPATH=<checkout> python <this file>``), which is how a change and its
parent are compared in one call.  Prints one JSON object; ``--out`` writes it
to a file as well.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import torch

from ptbxl_torch import bench
from ptbxl_torch.ops.kernels import _build
from ptbxl_torch.models.params_io import load_checkpoint
from ptbxl_torch.ops.kernels import fused_ecgcnn as k2
from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4

PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM data sheet: dense bf16, HBM3


def launch_ms(fn) -> list:
    """[name, device ms] of each kernel ``fn`` launches, in order (CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: e.time_range.start)
    return [[e.name[:80], e.device_time_total / 1e3] for e in events]


def block_ptxas(log: str) -> dict:
    """{"CinP,BN,RM,CTAs,steps,in,out": "<registers, barriers, smem>; <stack,
    spills>"} for each ``wgmma_conv_block_kernel`` in an ``-Xptxas -v``
    report (the template arguments read from the mangled name)."""
    out = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        if "wgmma_conv_block_kernel" not in name:
            continue
        args = ",".join(re.findall(r"L[ib](\d+)E", name.split("wgmma_conv_block_kernelI", 1)[1]))
        lines = [ln.split("info    : ")[-1].strip() for ln in chunk.splitlines()
                 if "Used" in ln or "spill" in ln]
        out[args] = "; ".join(lines)
    return out


def run(batches, iters: int) -> dict:
    dev = torch.device("cuda")
    clock = bench.Clock(dev)
    state, _ = load_checkpoint(bench.CKPT)
    folded = k2.fold_bn_into_conv({k: v.to(dev) for k, v in state.items()})
    weights = k4.prepare_weights(folded, compute_dtype=torch.bfloat16)
    framework = bench.build_forward("framework", "bf16", dev)
    rows = {}
    with torch.no_grad():
        for b in batches:
            x = bench._random_batch(b, torch.float32, dev)
            fn = lambda: k4.hybrid_ecgcnn_logits(x, folded, 2, torch.bfloat16, True,  # noqa: E731
                                                 weights)
            rows[str(b)] = {"ms": clock.ms(fn, iters),
                            "framework_bf16_ms": clock.ms(lambda: framework(x), iters),
                            "launches": launch_ms(fn)}
            del x
    return rows


def bound_bf16_ms(folded, b: int, t: int) -> float:
    """The least time of the fused forward on [b, t, 12]: its operations (every
    block's pooled rows, proj and head) at the dense bf16 peak, or the input,
    the f32 folded weights and the logits at the memory rate, the larger."""
    nbytes = (b * t * 12 * 4 + sum(v.numel() * 4 for k, v in folded.items() if k != "n_blocks")
              + b * folded["head_w"].shape[1] * 4)
    flops = 2 * b * (folded["proj_w"].numel() + folded["head_w"].numel())
    for i in range(int(folded["n_blocks"])):
        w = folded[f"w{i}"]
        flops += 2 * w.shape[0] * w.shape[1] * w.shape[2] * 2 * (t // 2) * b
        t //= 2
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3


def run_fused(batches, iters: int) -> dict:
    """K2's and K3's bf16 forwards at each batch beside the framework's bf16."""
    from ptbxl_torch.inference import Predictor

    dev = torch.device("cuda")
    clock = bench.Clock(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for arch, ckpt in (("ecgcnn", bench.CKPT), ("multimodal", bench.CKPT_MM)):
        state, _ = load_checkpoint(ckpt, arch=arch)
        fold = k2.fold_bn_into_conv if arch == "ecgcnn" else k2.fold_multimodal
        folded = fold({k: v.to(dev) for k, v in state.items()})
        weights = k4.prepare_weights(folded, compute_dtype=torch.bfloat16)
        framework = Predictor.from_checkpoint(ckpt, arch=arch, engine="framework",
                                              precision="default")
        rows = {}
        with torch.no_grad():
            for b in batches:
                x = bench._random_batch(b, torch.float32, dev)
                if arch == "ecgcnn":
                    fn = lambda: k2.fused_ecgcnn_logits(x, folded, torch.bfloat16, True,  # noqa: E731
                                                        weights)
                    lib = lambda: framework._forward(x)  # noqa: E731
                else:
                    d = torch.rand(b, 5, generator=gen, device=dev) * 0.9
                    fn = lambda: k2.fused_multimodal_logits(x, d, folded,  # noqa: E731
                                                            torch.bfloat16, True, weights)
                    lib = lambda: framework._forward(x, d)  # noqa: E731
                rows[str(b)] = {"ms_bf16": clock.ms(fn, iters),
                                "framework_bf16_ms": clock.ms(lib, iters),
                                "bound_bf16_ms": bound_bf16_ms(folded, b, x.shape[1]),
                                "launches": launch_ms(fn)}
                del x
        out[arch] = rows
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[512, 8192])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_hybrid: needs a CUDA GPU", file=sys.stderr)
        return 2
    result = {"device": torch.cuda.get_device_name(0), "iters": args.iters,
              "batch": run(args.batch, args.iters),
              "fused_bf16": run_fused(args.batch, args.iters),
              "ptxas": block_ptxas(_build.build_all()["hybrid_wgmma"].with_suffix(".log")
                                   .read_text())}
    text = json.dumps(result)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
