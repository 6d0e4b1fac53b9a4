"""Does ``torch.export`` trace the autograd Grad-CAM (``GradCAM.multi``)?

    python -m ptbxl_torch.tools.probe_cam_export [--samples 5000] [--device cpu]

The ``with_cam`` serving artifact needs every class's CAM inside one
exported program.  ``GradCAM.multi`` pulls each class's cotangent back with
``torch.autograd.grad``; ``GradCAM.all_classes`` writes that backward out as
tensor ops.  This probe exports a forward that calls ``multi`` on the
baseline checkpoint under ``force_framework_pool_bwd()`` (as the serving
export traces), in each tracer mode: non-strict (the default), strict, and
strict with ``torch._dynamo.config.trace_autograd_ops``, each with the
batch symbolic (``Dim.AUTO``, as the artifact) and fixed at 3.  For each
attempt it prints one JSON line: the stage it reached (export, a call at
another batch or the same one, save, load), the error where one stopped it,
and otherwise the CAMs' max |diff| from the eager ``multi``.  A last line
holds ``all_classes``'s max |diff| from ``multi`` on the same input.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import warnings

import torch

from ptbxl_torch.interpret.grad_cam import GradCAM
from ptbxl_torch.models.factory import load_ecgcnn
from ptbxl_torch.ops.preprocess import zscore_per_lead_batch
from ptbxl_torch.ops.relu_pool import force_framework_pool_bwd
from ptbxl_torch.utils.device import resolve_device

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    "outputs/ecg_baseline/ckpts/ecg_baseline_best.npz")


class _CamForward(torch.nn.Module):
    def __init__(self, model: torch.nn.Module, n_samples: int):
        super().__init__()
        self.model = model
        self.cam = GradCAM(model, signal_length=n_samples, norm_first=False, eps=1e-9)

    def forward(self, x: torch.Tensor):
        probs, cams = self.cam.multi(zscore_per_lead_batch(x), range(5))
        return probs, cams.transpose(0, 1)


def attempt(module: _CamForward, x: torch.Tensor, x2: torch.Tensor, strict: bool,
            trace_autograd_ops: bool, symbolic: bool) -> dict:
    row = {"strict": strict, "trace_autograd_ops": trace_autograd_ops,
           "batch": "symbolic" if symbolic else "fixed", "torch": torch.__version__}
    dyn = {"x": {0: torch.export.Dim.AUTO}} if symbolic else None
    probe = x2 if symbolic else x  # a symbolic batch is called at another size
    stage = "export"
    has_flag = hasattr(torch._dynamo.config, "trace_autograd_ops")
    if trace_autograd_ops and not has_flag:
        return {**row, "stage": stage, "error": "this torch has no trace_autograd_ops"}
    flag = (torch._dynamo.config.patch(trace_autograd_ops=trace_autograd_ops) if has_flag
            else contextlib.nullcontext())
    try:
        with flag, torch.no_grad(), force_framework_pool_bwd():
            ep = torch.export.export(module, (x,), strict=strict, dynamic_shapes=dyn)
            stage = "call"
            got = ep.module()(probe)
            want = module(probe)
            row["cam_max_abs_diff"] = float((got[1] - want[1]).abs().max())
            stage = "save"
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            stage = "load"
            torch.export.load(io.BytesIO(buf.getvalue())).module()(probe)
        row["stage"] = "ok"
    except Exception as e:  # noqa: BLE001 -- what stopped the attempt is the finding
        row["stage"] = stage
        row["error"] = f"{type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}"[:300]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=5000)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    model, _ = load_ecgcnn(CKPT, device=dev)
    module = _CamForward(model, args.samples)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, args.samples, 12, generator=gen).to(dev)
    x2 = torch.randn(5, args.samples, 12, generator=gen).to(dev)
    warnings.filterwarnings("ignore")
    for strict, tao in ((False, False), (True, False), (True, True)):
        for symbolic in (True, False):
            print(json.dumps(attempt(module, x, x2, strict, tao, symbolic)), flush=True)
    h = zscore_per_lead_batch(x2)
    with force_framework_pool_bwd():
        _, ref = module.cam.multi(h, range(5))
    _, cams = module.cam.all_classes(h)
    print(json.dumps({"all_classes_vs_multi_max_abs_diff": float((cams - ref).abs().max()),
                      "device": str(dev), "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
