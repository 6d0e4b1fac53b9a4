"""Prototype int8 PTQ forward of the ECGCNN, accuracy against the f32 path
(port of ``tools/proto_int8.py``).

    python -m ptbxl_torch.tools.proto_int8 [--batch 8192] [--device cpu]

The JAX package's first int8 sweep, kept as evidence beside the shipped int8
path (``ops/quant.py``): its own weight quantization (per-input-channel
activation scales folded into per-output-channel int8 weights, every layer;
``ops/quant.py`` keeps the same math for its selected layers), absmax
calibration on the z-scored demo pack, and a mixed forward whose int8 layers
quantize their input, multiply in int8 with int32 sums and dequantize into a
bf16 epilogue (``* sw``, ``+ b``, ReLU, then the pool), the other layers bf16.
Unlike the shipped path it requantizes after the pool, z-scores in two
passes and corrects no bias.  The int8 product is ``ops/quant.py``'s
``int8_conv1d`` (``torch._int_mm``) on the card and ``int8_conv1d_plain`` on
the CPU; the bf16 layers ``quant.bf16_conv1d``.

``main`` prints each layer set's max and mean |dprob| against the f32
``highest`` ``Predictor`` on the 7-record demo pack, then on the card one
timing row a layer set at ``--batch`` (CUDA events, ``bench.Clock``).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ptbxl_torch.bench import Clock
from ptbxl_torch.inference import Predictor
from ptbxl_torch.models.params_io import load_checkpoint
from ptbxl_torch.ops.kernels.fused_ecgcnn import fold_bn_into_conv
from ptbxl_torch.ops.preprocess import zscore_per_lead_batch
from ptbxl_torch.ops.quant import (
    _absmax_scales,
    _pool2,
    bf16_conv1d,
    folded_layer_inputs,
    int8_conv1d,
    int8_conv1d_plain,
    int8_weight_matrix,
    quantize_act,
    quantize_folded,
)
from ptbxl_torch.utils.device import highest_precision, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CKPT = os.path.join(ROOT, "outputs/ecg_baseline/ckpts/ecg_baseline_best.npz")
DEMO = os.path.join(ROOT, "data/demo/single")
LAYER_SETS = (("all-int8", (0, 1, 2, 3)), ("L3-only", (3,)), ("L23", (2, 3)))
TIMED_SETS = (("all-bf16", ()), ("L3 int8", (3,)))


def quantize_weights(folded: Dict[str, object], act_scales: Sequence[np.ndarray]
                     ) -> Dict[str, object]:
    """int8 weights of every layer with its per-input-channel activation scales
    folded in (``act_scales[i]`` [Cin]): JAX's numpy math, which
    ``quant.quantize_folded`` keeps, with every layer selected."""
    n = int(folded["n_blocks"])
    return quantize_folded(folded, dict(enumerate(act_scales)), range(n))


# the folded f32 forward's conv inputs (TF32 off), the last entry the mean's input
f32_layer_inputs = folded_layer_inputs


def calibrate(folded: Dict[str, object], x: torch.Tensor) -> List[np.ndarray]:
    """Per-input-channel absmax scales of every conv layer's input (z-scored ``x``)."""
    n = int(folded["n_blocks"])
    scales = _absmax_scales(f32_layer_inputs(folded, x), range(n))
    return [scales[i] for i in range(n)]


def make_int8_forward(q: Dict[str, object], epilogue_dtype: torch.dtype = torch.bfloat16,
                      int8_layers: Optional[Sequence[int]] = None,
                      folded: Optional[Dict[str, object]] = None
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Raw ``x [B, T, 12]`` -> probs: the layers in ``int8_layers`` int8, the
    rest bf16 (from ``folded``'s f32 weights); ``q`` on ``x``'s device."""
    n = int(q["n_blocks"])
    layers = set(range(n) if int8_layers is None else int8_layers)
    ep = epilogue_dtype
    mats = {i: int8_weight_matrix(q[f"w{i}"]) for i in layers}
    bf16_w = {i: folded[f"w{i}"].permute(2, 1, 0).to(torch.bfloat16)
              for i in range(n) if i not in layers}

    def fwd(x: torch.Tensor) -> torch.Tensor:
        h = zscore_per_lead_batch(x.float())
        for i in range(n):
            if i in layers:
                xq = quantize_act(h, q[f"sx{i}"])
                conv = int8_conv1d if xq.device.type == "cuda" else int8_conv1d_plain
                hsc = conv(xq, mats[i]).to(ep) * q[f"sw{i}"].to(ep)
            else:
                hsc = bf16_conv1d(h.transpose(1, 2), bf16_w[i]).transpose(1, 2).to(ep)
            h = _pool2(torch.relu(hsc + q[f"b{i}"].to(ep)))
        with highest_precision():
            g = h.float().mean(dim=1)
            z = g @ q["proj_w"] + q["proj_b"]
            return torch.sigmoid(z @ q["head_w"] + q["head_b"])

    return fwd


def demo_pack() -> np.ndarray:
    """The 7 demo records, channels last [7, T, 12]."""
    files = sorted(glob.glob(os.path.join(DEMO, "*.npz")))
    return np.stack([np.load(f, allow_pickle=True)["ecg"].T for f in files]).astype(np.float32)


def run(device=None, batch: Optional[int] = None, ckpt: str = CKPT) -> dict:
    """Each layer set's |dprob| against ``highest`` on the demo pack; on the card
    with ``batch``, each timed set's ms and records/s."""
    dev = resolve_device(device)
    state, _ = load_checkpoint(ckpt)
    folded = fold_bn_into_conv({k: v.to(dev) for k, v in state.items()})
    x = torch.from_numpy(demo_pack()).to(dev)
    ref = Predictor(state, engine="framework", precision="highest", device=dev)(x.cpu().numpy())
    with torch.no_grad():
        q = quantize_weights(folded, calibrate(folded, zscore_per_lead_batch(x)))
        q = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in q.items()}
        out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "demo_pack": {}}
        for name, layers in LAYER_SETS:
            probs = make_int8_forward(q, int8_layers=layers, folded=folded)(x).cpu().numpy()
            d = np.abs(probs - ref)
            out["demo_pack"][name] = {"max_abs_dprob": float(d.max()),
                                      "mean_abs_dprob": float(d.mean())}
        if batch and dev.type == "cuda":
            clock = Clock(dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            xb = torch.randn(batch, x.shape[1], 12, generator=gen, device=dev)
            out["timing"] = {}
            for name, layers in TIMED_SETS:
                fwd = make_int8_forward(q, int8_layers=layers, folded=folded)
                ms = clock.ms(lambda: fwd(xb), 3)
                out["timing"][name] = {"batch": batch, "ms": ms, "records_per_s": batch / ms * 1e3}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192, help="the timing rows' batch (card only)")
    ap.add_argument("--device", default=None, help="'cpu' for a host run; default the GPU")
    args = ap.parse_args(argv)
    out = run(args.device, args.batch)
    print(f"device={out['device']}")
    for name, r in out["demo_pack"].items():
        print(f"{name:8s}: max|dprob|={r['max_abs_dprob']:.2e} mean={r['mean_abs_dprob']:.2e}")
    for name, r in out.get("timing", {}).items():
        print(f"{name:10s} bs={r['batch']}: {r['records_per_s']:,.0f} rec/s ({r['ms']:.2f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
