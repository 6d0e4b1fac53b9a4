"""Re-tune the int8 layer set on the card (port of ``tools/tune_int8.py``).

    python -m ptbxl_torch.tools.tune_int8 [--arch multimodal --ckpt ...] [--num_labels 1]
        [--batch 8192 ...] [--sets "3|1,3|2,3|1,2,3"] [--calib robust|demo]
        [--battery 512] [--bias_correct] [--device cpu]

The layer sets ``ops/quant.default_int8_layers`` ships were measured on a
TPU; this sweep measures them on this card.  For each layer set and batch it
prints one JSON line: records/s of the quantized forward (``bench.Clock``,
bf16 wire batch made on the device), the demo pack's worst |dprob| against
the f32 ``highest`` framework ``Predictor``, and the battery's quantiles
(``ops/quant_eval.quant_accuracy_report``).  The winner is the fastest row
within the active gate: the battery gate (``quant_eval.BATTERY_GATE``) with
the default robust calibration, the demo-parity ``--gate`` (5e-3) with
``--calib demo``.  The last line names it, with the card's name.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np
import torch

from ptbxl_torch.bench import CKPT, ROOT, Clock, _random_batch
from ptbxl_torch.utils.device import resolve_device


def parse_sets(spec: str) -> list:
    out = []
    for part in spec.split("|"):
        part = part.strip()
        out.append(tuple(int(i) for i in part.split(",")) if part else ())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=CKPT)
    ap.add_argument("--arch", default="ecgcnn", choices=["ecgcnn", "multimodal"])
    ap.add_argument("--num_labels", type=int, default=5,
                    help="checkpoint head size (1 for the AF model)")
    ap.add_argument("--batch", type=int, nargs="+", default=[8192])
    ap.add_argument("--sets", default="3|1,3|2,3|1,2,3")
    ap.add_argument("--gate", type=float, default=5e-3,
                    help="demo-parity gate, used with --calib demo")
    ap.add_argument("--battery", type=int, default=512,
                    help="synthetic records of the battery (ops/quant_eval.py)")
    ap.add_argument("--calib", default="robust", choices=["robust", "demo"])
    ap.add_argument("--bias_correct", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None, help="'cpu' for a host run; default the GPU")
    args = ap.parse_args(argv)
    if not args.battery and args.calib == "robust":
        ap.error("--battery 0 with --calib robust has no usable gate; keep the battery "
                 "or use --calib demo")

    from ptbxl_torch.inference import Predictor
    from ptbxl_torch.models.params_io import load_checkpoint
    from ptbxl_torch.ops.quant import (demo_pack_signals, make_quantized_forward,
                                       quantize_model, split_meta, to_device)
    from ptbxl_torch.ops.quant_eval import (make_battery, passes_battery_gate,
                                            quant_accuracy_report)

    dev = resolve_device(args.device)
    clock = Clock(dev)
    state, _ = load_checkpoint(args.ckpt, arch=args.arch)
    kind = "multimodal" if args.arch == "multimodal" else "single"
    packs = [np.load(f, allow_pickle=True)
             for f in sorted(glob.glob(os.path.join(ROOT, "data", "demo", kind, "*.npz")))]
    ecgs = np.stack([p["ecg"] for p in packs])
    demo = np.stack([p["demo"] for p in packs]).astype(np.float32) if kind == "multimodal" else None
    extra = {} if demo is None else {"demo": demo}
    ref = Predictor(state, arch=args.arch, engine="framework", precision="highest",
                    num_labels=args.num_labels, device=dev)(ecgs, **extra)
    calib = demo_pack_signals() if args.calib == "demo" else None  # None: the robust preset
    battery = make_battery(n=args.battery) if args.battery else None

    name = torch.cuda.get_device_name(dev) if clock.cuda else "cpu"
    best = None
    for layers in parse_sets(args.sets):
        q = quantize_model(state, arch=args.arch, int8_layers=layers, calib_signals=calib,
                           bias_correct=args.bias_correct, device=dev)
        probs = Predictor(state, arch=args.arch, precision="int8", qparams=q,
                          num_labels=args.num_labels, device=dev)(ecgs, **extra)
        err = float(np.abs(probs - ref).max())
        rep = None
        if battery is not None:
            rep = quant_accuracy_report(state, args.arch, signals=battery, q=q,
                                        num_labels=args.num_labels,
                                        bias_correct=args.bias_correct, device=dev)
        gate_ok = passes_battery_gate(rep) if args.calib == "robust" else err <= args.gate
        arrs, nb, ls = split_meta(q)
        fwd = make_quantized_forward(nb, ls, arch=args.arch)
        arrs = to_device(arrs, dev)
        for bs in args.batch:
            x = _random_batch(bs, torch.bfloat16, dev)
            d = torch.rand(bs, 5, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
            with torch.no_grad():
                ms = clock.ms(lambda: fwd(arrs, x, d) if args.arch == "multimodal"
                              else fwd(arrs, x), args.iters)
            del x
            row = {"layers": list(layers), "batch": bs, "ms": ms, "rps": bs / (ms / 1e3),
                   "demo_parity": err, "gate_ok": gate_ok, "device": name}
            if rep is not None:
                row["battery"] = {k: rep[k] for k in ("n", "max", "p99", "flips",
                                                      "num_decisions", "flip_rate")}
            print(json.dumps(row), flush=True)
            if gate_ok and (best is None or row["rps"] > best["rps"]):
                best = row
    print(json.dumps({"winner": best, "arch": args.arch, "calib": args.calib,
                      "device": name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
