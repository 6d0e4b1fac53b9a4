"""K4, the hybrid engine, timed on the card beside the framework's bf16 forward.

    python -m ptbxl_torch.tools.probe_hybrid [--batch 512 8192] [--iters 5] [--out PATH]

For each batch of raw-like records (``bench._random_batch``): the device ms
of one ``hybrid_ecgcnn_logits`` call in bf16 at ``split=2`` on the baseline
checkpoint with weights from ``prepare_weights`` (the bench's hybrid row
without the sigmoid), the framework bf16 forward's ms (``bench.build_forward(
"framework", "bf16")``, the library yardstick), and the device ms of every
launch of one K4 call from ``torch.profiler`` (CUPTI), in order.  Uses only
the port's public K4 API, so the same file times any commit of the port
(``PYTHONPATH=<checkout> python <this file>``), which is how a change and its
parent are compared in one call.  Prints one JSON object; ``--out`` writes it
to a file as well.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ptbxl_torch import bench
from ptbxl_torch.models.params_io import load_checkpoint
from ptbxl_torch.ops.kernels import fused_ecgcnn as k2
from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4


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
              "batch": run(args.batch, args.iters)}
    text = json.dumps(result)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
