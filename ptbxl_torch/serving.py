"""Serialized serving artifacts via ``torch.export`` (port of ``ptbxl_tpu/serving.py``).

Export a trained checkpoint once into a self-contained artifact (weights
baked in, the per-lead z-score included, the batch dimension symbolic) and
serve it with no model code and no checkpoint on the serving host:

    from ptbxl_torch.serving import export_serving_artifact, ServingModel

    export_serving_artifact("outputs/ecg_baseline/ckpts/ecg_baseline_best.npz",
                            "/models/ecg_baseline.ptbxlpt")
    model = ServingModel("/models/ecg_baseline.ptbxlpt")
    probs = model(signals)            # [N, 12, T] or [N, T, 12] -> [N, L]

The program is the forward ``Predictor`` runs on one chunk:

The symbolic batch's range is what the tracer derives (``meta['batch_range']``:
2 up, and at most 65535 where a card's launch limit binds); ``ServingModel``
pads a single record to the least and splits a call above the most.

* ``engine='framework'`` (JAX's ``'xla'``): ``precision='highest'`` (f32,
  the two-pass z-score), ``'default'`` (bf16, one-pass) or ``'int8'``
  (``ops/quant.py``: calibrated at export time on the robust preset, or
  ``calib_signals``, ``int8_layers``, ``qparams`` as the ``Predictor`` takes
  them; one-pass).  ``platforms`` ``["cpu", "cuda"]``: the program names no
  device, and ``ServingModel`` moves it to its own.
* ``with_cam=True``: ``(probs [B, L], cams [B, L, T])``, every class's
  Grad-CAM (demo normalization, eps 1e-9) from ``GradCAM.all_classes``,
  whose backward is written out as tensor ops: ``torch.export`` does not
  give a working program for ``GradCAM.multi``'s ``torch.autograd.grad``
  in any tracer mode (``ptbxl_torch/tools/probe_cam_export.py``).  The
  pool's backward is the framework one, as the JAX artifact traces under
  ``force_xla_pool_bwd()``.
* ``engine='kernel'`` (JAX's ``'pallas'``): the custom ops
  ``ptbxl::fused_ecgcnn_probs`` / ``ptbxl::fused_multimodal_probs``, which
  launch K1's stats, K2's (or K3's) conv blocks and tail on the card; the
  batch is fixed at ``batch_size`` (default 8), which ``ServingModel``
  chunks and pads.  ``platforms`` ``["cuda"]`` (on the CPU the ops run their
  plain versions, which the tests use).
* ``data_parallel=True``: ``n_devices`` (every visible GPU, or the list given
  as ``device``) is recorded; the program takes ``batch_size / n_devices``
  rows (``batch_size`` default 512), and ``ServingModel`` puts one copy on
  each device and splits every chunk's rows over them in order.

TF32 is a process flag and no part of a program: ``ServingModel`` runs a
``highest`` or ``int8`` artifact under ``utils.device.highest_precision()``.
On the card the int8 program's bf16 layers are cuDNN's bf16 conv when it was
exported on the card and the CPU's exact form when exported on the CPU
(``quant.bf16_conv1d``).

Artifact layout: ``b"PTBXLPT1\\n"``, the JSON meta's length as u64 little
endian, the JSON meta (every key the JAX artifact writes, plus
``payload_bytes`` and ``torch``), then the ``torch.export.save`` bytes.
Writes are atomic.  ``_read_artifact`` raises on another file, on a
truncated one, and on a JAX (``PTBXLSRV1``) artifact, which holds StableHLO
the port does not load.

    python -m ptbxl_torch.serving export CKPT OUT [--arch ...] [--device cpu]
    python -m ptbxl_torch.serving info ARTIFACT
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import struct
import warnings
from functools import partial
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

# registers ptbxl::fused_ecgcnn_probs / fused_multimodal_probs, which a
# kernel-engine program calls by name
from ptbxl_torch.ops.kernels import fused_ecgcnn
from ptbxl_torch.utils.device import DeviceLike, highest_precision, resolve_device

_MAGIC = b"PTBXLPT1\n"
_JAX_MAGIC = b"PTBXLSRV1\n"
_ENGINES = ("framework", "kernel")
_PRECISIONS = ("highest", "default", "int8")


class _Program(torch.nn.Module):
    """The forward ``fn(x[, d])`` as the module ``torch.export`` traces."""

    def __init__(self, fn: Callable, multimodal: bool):
        super().__init__()
        self.fn = fn
        self.multimodal = multimodal

    def forward(self, x: torch.Tensor, d: Optional[torch.Tensor] = None):
        return self.fn(x, d) if self.multimodal else self.fn(x)


def _ecg_op(folded, weights, normalize: bool, x: torch.Tensor) -> torch.Tensor:
    return fused_ecgcnn.fused_ecgcnn_probs_op(x, folded, normalize=normalize, weights=weights)


def _mm_op(folded, weights, normalize: bool, x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return fused_ecgcnn.fused_multimodal_probs_op(x, d, folded, normalize=normalize,
                                                  weights=weights)


def _build_forward(state, classes, arch: str, num_labels: int, feat_dim: int,
                   demo_hidden_dim: int, normalize: bool, precision: str, engine: str,
                   with_cam: bool, n_samples: int, device: torch.device, int8_layers,
                   calib_signals, qparams):
    """(forward of one chunk, the int8 layer set or None)."""
    from ptbxl_torch.inference import Predictor
    from ptbxl_torch.interpret.grad_cam import GradCAM
    from ptbxl_torch.ops.preprocess import zscore_per_lead_batch
    from ptbxl_torch.ops.quant import make_quantized_forward, resolve_qparams, split_meta, to_device

    if precision == "int8":
        arrs, n_blocks, layers = split_meta(resolve_qparams(
            state, arch, num_labels, qparams, calib_signals, int8_layers, normalize, device))
        # one chunk: the exported batch is symbolic, so no chunking by records
        qf = make_quantized_forward(n_blocks, layers, arch=arch, normalize=normalize,
                                    budget=None)
        return partial(qf, to_device(arrs, device)), layers
    p = Predictor(state, classes=classes, num_labels=num_labels, feat_dim=feat_dim, arch=arch,
                  demo_hidden_dim=demo_hidden_dim, engine=engine, normalize=normalize,
                  precision=precision, device=device)
    if engine == "kernel":  # the Predictor's kernel forward as one custom-op call
        if arch == "multimodal":
            return partial(_mm_op, p._folded, p._weights, normalize), None
        return partial(_ecg_op, p._folded, p._weights, normalize), None
    if not with_cam:
        return p._forward, None
    cam = GradCAM(p.model, signal_length=n_samples, norm_first=False, eps=1e-9,
                  multimodal=arch == "multimodal")

    def forward(x, d=None):
        h = zscore_per_lead_batch(x) if normalize else x
        probs, cams = cam.all_classes(h, d)
        return probs.float(), cams.transpose(0, 1).float()  # [L, B, T] -> [B, L, T]
    return forward, None


def export_serving_artifact(
    ckpt_path: str,
    out_path: str,
    arch: str = "ecgcnn",
    num_labels: int = 5,
    feat_dim: int = 256,
    demo_hidden_dim: int = 64,
    n_samples: int = 5000,
    n_leads: int = 12,
    normalize: bool = True,
    precision: str = "highest",
    platforms: Optional[Sequence[str]] = None,
    with_cam: bool = False,
    engine: str = "framework",
    batch_size: Optional[int] = None,
    data_parallel: bool = False,
    int8_layers: Optional[Sequence[int]] = None,
    calib_signals=None,
    qparams=None,
    device: DeviceLike = None,
) -> str:
    """Export a checkpoint to a serving artifact at ``out_path`` (see the
    module docstring).  ``device`` is where the export traces (the GPU by
    default; with ``data_parallel`` a list of devices).  Returns ``out_path``."""
    from ptbxl_torch.inference import ENGINE_ALIASES, _device_list
    from ptbxl_torch.models.params_io import load_checkpoint
    from ptbxl_torch.ops.relu_pool import force_framework_pool_bwd

    engine = ENGINE_ALIASES.get(engine, engine)
    if engine not in _ENGINES:
        raise ValueError(f"engine must be one of {_ENGINES + tuple(ENGINE_ALIASES)}, "
                         f"got {engine!r}")
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {precision!r}")
    if precision == "int8" and (with_cam or engine == "kernel"):
        raise ValueError("precision='int8' supports only the framework probs forward "
                         "(CAM needs the differentiable model; the kernel engine is f32)")
    if engine == "kernel" and with_cam:
        raise ValueError("engine='kernel' does not support with_cam")
    if engine == "kernel" and data_parallel:
        raise ValueError("data_parallel does not combine with engine='kernel'")
    requested = tuple(platforms) if platforms is not None else None

    def constrain(forced, why):
        # an explicit request that an engine or sharding constraint replaces warns
        if requested is not None and requested != tuple(forced):
            warnings.warn(f"platforms={list(requested)} overridden to {list(forced)}: {why}",
                          stacklevel=3)
        return list(forced)

    n_devices = 1
    if data_parallel:
        devices = _device_list(device)
        n_devices = len(devices)
        batch_size = batch_size or 512
        if batch_size % n_devices:
            raise ValueError(f"batch_size {batch_size} not divisible by {n_devices} devices")
        dev = devices[0]
        platforms = constrain((dev.type,), "data_parallel artifacts serve on the exporting "
                                           "device type only")
    else:
        dev = resolve_device(device)
        if engine == "kernel":
            platforms = constrain(("cuda",), "engine='kernel' launches CUDA kernels")
            batch_size = batch_size or 8
        else:
            platforms = list(requested or ("cpu", "cuda"))

    state, classes = load_checkpoint(ckpt_path, arch=arch)
    forward, layers = _build_forward(
        state, classes, arch, num_labels, feat_dim, demo_hidden_dim, normalize, precision,
        engine, with_cam, n_samples, dev, int8_layers, calib_signals, qparams)
    mm = arch == "multimodal"
    rows = (batch_size // n_devices) if batch_size else 2
    args = (torch.zeros(rows, n_samples, n_leads, device=dev),)
    if mm:
        args += (torch.zeros(rows, 5, device=dev),)
    dynamic = None
    if batch_size is None:
        # the tracer sets the batch's range from its guards: 0 and 1 are
        # specialised, and on the card a launch limit bounds it (2..65535)
        dynamic = {"x": {0: torch.export.Dim.AUTO}}
        if mm:
            dynamic["d"] = {0: torch.export.Dim.AUTO}
    # trace under the framework pool backward, as JAX's export does
    # (force_xla_pool_bwd): the CAM's backward is written out, and K6 stays
    # out of every program
    with torch.no_grad(), force_framework_pool_bwd():
        ep = torch.export.export(_Program(forward, mm), args, dynamic_shapes=dynamic)
    batch_range = [batch_size // n_devices] * 2 if batch_size else _batch_range(ep)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    blob = buf.getvalue()

    meta = {
        "arch": arch,
        "classes": list(classes) if classes is not None else None,
        "num_labels": num_labels,
        "n_samples": n_samples,
        "n_leads": n_leads,
        "normalize": normalize,
        "precision": precision,
        "int8_layers": [int(i) for i in layers] if layers is not None else None,
        "platforms": platforms,
        "with_cam": with_cam,
        "engine": engine,
        "batch_size": batch_size,
        "data_parallel": data_parallel,
        "n_devices": n_devices,
        "batch_range": batch_range,
        "payload_bytes": len(blob),
        "torch": torch.__version__,
    }
    meta_bytes = json.dumps(meta).encode()
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(meta_bytes)))
        f.write(meta_bytes)
        f.write(blob)
    os.replace(tmp, out_path)  # atomic: no truncated artifact on a crash
    return out_path


def _batch_range(ep) -> List[Optional[int]]:
    """[least, most] rows a call of the program takes (most None: unbounded)."""
    (name,) = ep.graph_signature.user_inputs[:1]
    x = next(n for n in ep.graph.nodes if n.op == "placeholder" and n.name == name)
    rows = x.meta["val"].shape[0]
    if isinstance(rows, int):
        raise ValueError(f"the export fixed the symbolic batch at {rows}")
    vr = ep.range_constraints[rows.node.expr]
    return [int(vr.lower), int(vr.upper) if vr.upper < 2 ** 63 else None]


def _read_artifact(path: str, meta_only: bool = False):
    """Parse an artifact file -> (meta dict, the ``torch.export`` bytes or None)."""
    with open(path, "rb") as f:
        head = f.read(len(_JAX_MAGIC))
        if head == _JAX_MAGIC:
            raise ValueError(f"{path} is a JAX (ptbxl_tpu, PTBXLSRV1) serving artifact; "
                             "the port does not load JAX artifacts: export the checkpoint "
                             "with ptbxl_torch.serving")
        if head[:len(_MAGIC)] != _MAGIC:
            raise ValueError(f"{path} is not a ptbxl_torch serving artifact")
        f.seek(len(_MAGIC))
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: truncated artifact (no meta length)")
        (meta_len,) = struct.unpack("<Q", raw)
        meta_bytes = f.read(meta_len)
        if len(meta_bytes) != meta_len:
            raise ValueError(f"{path}: truncated artifact (meta)")
        meta = json.loads(meta_bytes.decode())
        if meta_only:
            return meta, None
        blob = f.read()
    if len(blob) != meta["payload_bytes"]:
        raise ValueError(f"{path}: truncated artifact (payload {len(blob)} of "
                         f"{meta['payload_bytes']} bytes)")
    return meta, blob


class ServingModel:
    """Load and run a serving artifact: no model code, no checkpoint.

    Accepts reference-layout ``[N, 12, T]`` or channels-last ``[N, T, 12]``
    raw signals like the ``Predictor``; the program holds the z-score when it
    was exported with ``normalize=True``.  ``device`` is where it runs (the
    GPU by default; for a ``data_parallel`` artifact every visible GPU, or a
    list of at least ``n_devices`` devices).
    """

    def __init__(self, path: str, device=None):
        from torch.export.passes import move_to_device_pass

        from ptbxl_torch.inference import _device_list

        self.meta, blob = _read_artifact(path)
        self.classes: Optional[List[str]] = self.meta["classes"]
        self.arch: str = self.meta["arch"]
        self.n_samples: int = self.meta["n_samples"]
        self.n_leads: int = self.meta["n_leads"]
        self.with_cam: bool = bool(self.meta.get("with_cam", False))
        self.batch_size: Optional[int] = self.meta.get("batch_size")  # None: symbolic
        if self.meta.get("data_parallel"):
            n = int(self.meta["n_devices"])
            devices = _device_list(device)
            if len(devices) < n:
                raise ValueError(f"artifact was exported for {n} devices; only "
                                 f"{len(devices)} visible")
            devices = devices[:n]
        else:
            devices = [resolve_device(device)]
        self.devices = devices
        # one copy of the program on each device
        self._programs = [move_to_device_pass(torch.export.load(io.BytesIO(blob)), d).module()
                          for d in devices]
        precise = self.meta["precision"] in ("highest", "int8")
        self._scope = highest_precision if precise else contextlib.nullcontext

    def _canon(self, signals) -> np.ndarray:
        x = np.asarray(signals, dtype=np.float32)
        if x.ndim == 2:
            x = x[None]
        if x.shape[1] == self.n_leads and x.shape[2] != self.n_leads:
            x = x.transpose(0, 2, 1)
        if x.shape[1:] != (self.n_samples, self.n_leads):
            raise ValueError(f"expected [N, {self.n_samples}, {self.n_leads}] (or the "
                             f"lead-major transpose), got {x.shape}")
        return np.ascontiguousarray(x)

    def _call(self, x: np.ndarray, d: Optional[np.ndarray]):
        """One call of the program(s): rows split over the devices in order,
        every device's work queued before the first result is read."""
        n = len(self._programs)
        xs = np.split(x, n)
        ds = np.split(d, n) if d is not None else [None] * n
        outs = []
        with torch.no_grad(), self._scope():
            for prog, dev, xi, di in zip(self._programs, self.devices, xs, ds):
                args = [torch.from_numpy(xi).to(dev)]
                if self.arch == "multimodal":
                    args.append(torch.from_numpy(di).to(dev))
                outs.append(prog(*args))
        if self.with_cam:
            return (np.concatenate([o[0].cpu().numpy() for o in outs]),
                    np.concatenate([o[1].cpu().numpy() for o in outs]))
        return np.concatenate([o.cpu().numpy() for o in outs])

    def __call__(self, signals, demo=None):
        """probs [N, L] (numpy f32), or ``(probs, cams [N, L, T])`` for a
        ``with_cam`` artifact."""
        x = self._canon(signals)
        d = None
        if self.arch == "multimodal":
            if demo is None:
                raise ValueError("multimodal artifact requires demo vectors")
            d = np.asarray(demo, dtype=np.float32)
            if d.ndim == 1:
                d = d[None]
            if d.shape != (x.shape[0], 5):
                raise ValueError(f"demo must be [N, 5] matching signals N={x.shape[0]}; "
                                 f"got {d.shape}")
        n_cls = len(self.classes) if self.classes else self.meta["num_labels"]
        if x.shape[0] == 0:  # no call for no rows
            probs0 = np.empty((0, n_cls), np.float32)
            if self.with_cam:
                return probs0, np.empty((0, n_cls, self.n_samples), np.float32)
            return probs0
        # a fixed batch (kernel engine, data_parallel) takes chunks of that
        # size; a symbolic one any N in its range (one call when N fits);
        # a short chunk is padded with its last row
        lo, hi = ((self.batch_size, self.batch_size) if self.batch_size
                  else self.meta["batch_range"])
        step = hi or x.shape[0]
        probs, cams = [], []
        for i0 in range(0, x.shape[0], step):
            cx = x[i0:i0 + step]
            cd = d[i0:i0 + step] if d is not None else None
            real = cx.shape[0]
            if real < lo:
                cx = np.concatenate([cx, np.repeat(cx[-1:], lo - real, axis=0)])
                if cd is not None:
                    cd = np.concatenate([cd, np.repeat(cd[-1:], lo - real, axis=0)])
            out = self._call(cx, cd)
            if self.with_cam:
                probs.append(out[0][:real])
                cams.append(out[1][:real])
            else:
                probs.append(out[:real])
        if self.with_cam:
            return np.concatenate(probs), np.concatenate(cams)
        return np.concatenate(probs)


def load_serving_artifact(path: str, device=None) -> ServingModel:
    return ServingModel(path, device=device)


def _main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: ``python -m ptbxl_torch.serving export|info ...``."""
    import argparse

    parser = argparse.ArgumentParser(prog="python -m ptbxl_torch.serving")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("export", help="export a checkpoint to a serving artifact")
    pe.add_argument("ckpt")
    pe.add_argument("out")
    pe.add_argument("--arch", default="ecgcnn", choices=["ecgcnn", "multimodal"])
    pe.add_argument("--num_labels", type=int, default=5)
    pe.add_argument("--engine", default="framework",
                    choices=["framework", "kernel", "xla", "pallas"])
    pe.add_argument("--precision", default="highest", choices=list(_PRECISIONS))
    pe.add_argument("--batch_size", type=int, default=None)
    pe.add_argument("--with_cam", action="store_true")
    pe.add_argument("--data_parallel", action="store_true")
    pe.add_argument("--int8_layers", default=None,
                    help="comma-separated conv layer indices to quantize "
                         "(precision=int8; default: quant.default_int8_layers)")
    pe.add_argument("--qparams", default=None,
                    help="save_qparams() .npz path: skip fold and calibration (precision=int8)")
    pe.add_argument("--no_normalize", action="store_true")
    pe.add_argument("--platforms", default=None,
                    help="comma-separated platforms (default cpu,cuda; the engine or "
                         "data_parallel may constrain them)")
    pe.add_argument("--device", default=None,
                    help="device the export traces on; default the GPU, which must exist")

    pi = sub.add_parser("info", help="print an artifact's embedded contract")
    pi.add_argument("artifact")

    args = parser.parse_args(argv)
    if args.cmd == "export":
        out = export_serving_artifact(
            args.ckpt, args.out, arch=args.arch, num_labels=args.num_labels,
            normalize=not args.no_normalize, precision=args.precision,
            platforms=(tuple(p.strip() for p in args.platforms.split(",") if p.strip())
                       if args.platforms else None),
            with_cam=args.with_cam, engine=args.engine, batch_size=args.batch_size,
            data_parallel=args.data_parallel,
            int8_layers=(tuple(int(i) for i in args.int8_layers.split(","))
                         if args.int8_layers else None),
            qparams=args.qparams, device=args.device,
        )
        print(f"[SAVE] serving artifact: {out}")
    else:
        meta, _ = _read_artifact(args.artifact, meta_only=True)
        try:
            print(json.dumps(meta, indent=2))
        except BrokenPipeError:  # e.g. piped into `head`
            os.dup2(os.open(os.devnull, os.O_WRONLY), 1)
    return 0


if __name__ == "__main__":  # pragma: no cover - thin CLI shim
    raise SystemExit(_main())
