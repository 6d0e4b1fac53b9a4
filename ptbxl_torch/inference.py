"""Batched ECG classifier inference (port of ``ptbxl_tpu/inference.py``).

    predictor = Predictor.from_checkpoint("outputs/ecg_baseline/ckpts/ecg_baseline_best.npz")
    probs = predictor(signals)                  # [N, 12, T] raw -> [N, L]

    mm = Predictor.from_checkpoint("outputs/ecg_multimodal/ckpts/ecg_multimodal_best.npz",
                                   arch="multimodal")
    probs = mm(signals, demo=demo_vectors)      # + [N, 5] demographics

* accepts reference-layout ``[N, 12, T]`` or channels-last ``[N, T, 12]`` raw
  signals; the per-lead z-score runs on the device
* ``engine='kernel'`` runs the hand-written fused forward (K2, or K3 for
  ``arch='multimodal'``; f32 compute, its conv blocks in 3xTF32 on the tensor
  cores), ``engine='framework'`` the ``nn.Module`` on cuDNN (the JAX
  Predictor's names ``'pallas'`` and ``'xla'`` are taken for them), and
  ``engine='auto'`` takes the kernel for chunks of at most
  ``KERNEL_MAX_BATCH`` records at ``'highest'`` (1024, the largest chunk at
  which the kernel engine was no slower than cuDNN f32 on the H100) and at
  most ``KERNEL_MAX_BATCH_BF16`` at ``'default'`` (16, where it was no slower
  than cuDNN bf16; chip_smoke.py's ``crossover`` phases, PERF.md).
  ``PTBXL_TORCH_KERNEL_MAX_BATCH``, when set, overrides both, as the JAX
  package's single ``PTBXL_TPU_PALLAS_MAX_BATCH`` does.
* ``data_parallel=True`` runs one framework-engine replica on each device
  (every visible GPU, or the list given as ``device``) and splits each chunk's
  rows across them in order (inference.py:94-97, 123-142, 285-305)
* ``precision='highest'`` is f32 with TF32 off and the two-pass z-score;
  ``'default'`` runs the framework engine in bf16 with the one-pass z-score
  (inference.py:198-202).  The kernel engine computes in f32 either way, as
  the JAX kernel engine does.
* ``precision='int8'`` is the post-training int8 path (``ops/quant.py``:
  BatchNorm folded, the ``int8_layers`` as int8 convs, the others bf16,
  inference.py:101-180).  It is a framework-engine feature: ``'auto'``
  resolves to it and ``'kernel'`` raises.  The q-params come from
  ``qparams`` (a ``quantize_model`` dict or a ``save_qparams`` path), or are
  calibrated here on ``calib_signals`` (raw [N, 12, T] or [N, T, 12]; by
  default the robust synthetic preset, ``quant.default_calib_signals``) for
  ``int8_layers`` (default ``quant.default_int8_layers(arch)``).
* chunking, and power-of-two buckets for small N with the last row (signal
  and demo vector) repeated as padding (inference.py:289-319)
* under a ``torch.profiler`` session a call records its spans
  (``utils/profiling.py``): the root ``predictor.call`` (``rows``, the real
  ones), and a chunk's ``predictor.prepare`` (bucketing and padding;
  ``pad_rows``), ``predictor.h2d`` (the host->device copy; ``bytes``), the
  engine branch ``predictor.kernel`` / ``.framework`` / ``.int8`` (``rows``
  launched) and ``predictor.d2h`` (the probabilities' read; ``bytes``)
"""

from __future__ import annotations

import copy
import os
from functools import partial
from typing import List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ptbxl_torch.models.ecg_cnn import ECGCNN
from ptbxl_torch.models.ecg_multimodal import ECGMultimodal
from ptbxl_torch.models.factory import merge_state
from ptbxl_torch.models.params_io import load_checkpoint
from ptbxl_torch.ops.kernels.fused_ecgcnn import (
    fold_bn_into_conv,
    fold_multimodal,
    fused_ecgcnn_probs,
    fused_multimodal_probs,
    prepare_weights,
)
from ptbxl_torch.ops.preprocess import zscore_per_lead_batch, zscore_per_lead_batch_onepass
from ptbxl_torch.ops.quant import make_quantized_forward, resolve_qparams, split_meta, to_device
from ptbxl_torch.utils.device import DeviceLike, resolve_device
from ptbxl_torch.utils.profiling import span

_MAX_BATCH_ENV = os.environ.get("PTBXL_TORCH_KERNEL_MAX_BATCH")
KERNEL_MAX_BATCH = int(_MAX_BATCH_ENV or 1024)  # 'highest': the crossover against cuDNN f32
KERNEL_MAX_BATCH_BF16 = int(_MAX_BATCH_ENV or 16)  # 'default': the crossover against cuDNN bf16

_ARCHS = ("ecgcnn", "multimodal")
_ENGINES = ("auto", "framework", "kernel")
ENGINE_ALIASES = {"xla": "framework", "pallas": "kernel"}  # the JAX Predictor's names
_PRECISIONS = ("highest", "default", "int8")


class Predictor:
    """Batched baseline / AF ECGCNN or FiLM multimodal inference on one device."""

    def __init__(
        self,
        state_dict: Mapping[str, torch.Tensor],
        classes: Optional[List[str]] = None,
        num_labels: int = 5,
        feat_dim: int = 256,
        arch: str = "ecgcnn",
        demo_hidden_dim: int = 64,
        engine: str = "auto",
        chunk_size: int = 512,
        normalize: bool = True,
        data_parallel: bool = False,
        precision: str = "highest",
        device: Union[DeviceLike, Sequence[DeviceLike]] = None,
        calib_signals=None,
        int8_layers: Optional[Sequence[int]] = None,
        qparams=None,
    ):
        """``state_dict`` is reference-layout (``params_io.load_checkpoint``).
        ``device`` is one device, or with ``data_parallel`` a list of them.
        ``calib_signals``, ``int8_layers`` and ``qparams`` tune
        ``precision='int8'`` (module docstring)."""
        if arch not in _ARCHS:
            raise ValueError(f"arch must be one of {_ARCHS}, got {arch!r}")
        if precision not in _PRECISIONS:
            raise ValueError(f"precision must be one of {_PRECISIONS}, got {precision!r}")
        engine = ENGINE_ALIASES.get(engine, engine)
        if engine not in _ENGINES:
            raise ValueError(
                f"engine must be one of {_ENGINES + tuple(ENGINE_ALIASES)}, got {engine!r}")
        if precision == "int8":
            # an XLA-path feature in JAX (inference.py:101-106): the framework engine
            if engine == "kernel":
                raise ValueError("precision='int8' runs on the framework engine only "
                                 "(engine='framework' or 'auto'), not engine='kernel'")
            engine = "framework"
        devices = None
        if data_parallel:
            # one replica a device on the framework engine, the only engine
            # the JAX Predictor shards; 'auto' resolves to it
            if engine == "auto":
                engine = "framework"
            if engine != "framework":
                raise ValueError("data_parallel currently supports engine='xla'")
            devices = _device_list(device)
            if chunk_size % len(devices):
                raise ValueError(
                    f"chunk_size {chunk_size} not divisible by {len(devices)} devices")
            device = devices[0]
        self.device = resolve_device(device)
        self.classes = classes
        self.chunk_size = chunk_size
        self.normalize = normalize
        self.arch = arch
        self.engine = engine
        self.precision = precision
        self._num_labels = num_labels

        dtype = torch.float32 if precision == "highest" else torch.bfloat16
        model_precision = "default" if precision == "int8" else precision
        if arch == "multimodal":
            self.model = ECGMultimodal(feat_dim=feat_dim, num_labels=num_labels,
                                       demo_hidden_dim=demo_hidden_dim,
                                       precision=model_precision, dtype=dtype)
        else:
            self.model = ECGCNN(feat_dim=feat_dim, num_labels=num_labels,
                                precision=model_precision, dtype=dtype)
        merge_state(self.model, state_dict, strict=True)
        self.model.to(self.device).eval()
        self._quant = self.int8_layers = None
        if precision == "int8":
            arrs, n_blocks, self.int8_layers = split_meta(resolve_qparams(
                state_dict, arch, num_labels, qparams, calib_signals, int8_layers, normalize,
                self.device))
            fwd = make_quantized_forward(n_blocks, self.int8_layers, arch=arch,
                                         normalize=normalize)
            # one copy of the q-params on each device
            self._quant = [(d, partial(fwd, to_device(arrs, d)))
                           for d in (devices or [self.device])]
        self._replicas = None  # (device, forward of a row block) a device
        if devices is not None and self._quant is not None:
            self._replicas = self._quant
        elif devices is not None:
            models = [self.model] + [copy.deepcopy(self.model).to(d) for d in devices[1:]]
            self._replicas = [(d, partial(self._framework, m)) for d, m in zip(devices, models)]
        self._folded = self._weights = None
        if engine != "framework":
            fold = fold_multimodal if arch == "multimodal" else fold_bn_into_conv
            self._folded = fold({k: v.to(self.device) for k, v in self.model.state_dict().items()})
            self._weights = prepare_weights(self._folded)  # the kernel's split f32 weights, once
        self._zscore = (zscore_per_lead_batch if precision == "highest"
                        else zscore_per_lead_batch_onepass)

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, num_labels: int = 5, arch: str = "ecgcnn",
                        **kwargs) -> "Predictor":
        state, classes = load_checkpoint(ckpt_path, arch=arch)
        return cls(state, classes=classes, num_labels=num_labels, arch=arch, **kwargs)

    def _use_kernel(self, batch: int) -> bool:
        if self.engine == "auto":
            limit = KERNEL_MAX_BATCH if self.precision == "highest" else KERNEL_MAX_BATCH_BF16
            return batch <= limit
        return self.engine == "kernel"

    def _framework(self, model: torch.nn.Module, x: torch.Tensor,
                   d: Optional[torch.Tensor]) -> torch.Tensor:
        h = self._zscore(x) if self.normalize else x
        logits = model(h, d) if self.arch == "multimodal" else model(h)
        return torch.sigmoid(logits.float())

    @torch.no_grad()
    def _forward(self, x: torch.Tensor, d: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One chunk on the device: x [B, T, 12] (+ d [B, 5] for multimodal) -> probs."""
        rows = x.shape[0]
        if self._quant is not None:
            with span("predictor.int8", rows=rows):
                return self._quant[0][1](x, d)
        if self._use_kernel(rows):
            with span("predictor.kernel", rows=rows):
                if self.arch == "multimodal":
                    return fused_multimodal_probs(x, d, self._folded, normalize=self.normalize,
                                                  weights=self._weights)
                return fused_ecgcnn_probs(x, self._folded, normalize=self.normalize,
                                          weights=self._weights)
        with span("predictor.framework", rows=rows):
            return self._framework(self.model, x, d)

    @torch.no_grad()
    def _forward_replicas(self, x: torch.Tensor, d: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """One host chunk split in equal row blocks over the replicas, in order;
        every replica's work is queued before the first result is read."""
        n = len(self._replicas)
        xs = x.chunk(n)
        ds = d.chunk(n) if d is not None else [None] * n
        branch = "predictor.int8" if self._quant is not None else "predictor.framework"
        outs = []
        for (dev, run), xi, di in zip(self._replicas, xs, ds):
            with span("predictor.h2d", bytes=xi.nbytes + (0 if di is None else di.nbytes)):
                xi, di = xi.to(dev), None if di is None else di.to(dev)
            with span(branch, rows=xi.shape[0]):
                outs.append(run(xi, di))
        with span("predictor.d2h", bytes=sum(o.nbytes for o in outs)):
            return torch.cat([o.cpu() for o in outs])

    def __call__(self, signals, demo=None) -> np.ndarray:
        """signals: [N, 12, T] or [N, T, 12] raw (+ demo [N, 5] for multimodal)
        -> probs [N, num_labels] (numpy f32)."""
        x = np.asarray(signals, dtype=np.float32)
        if x.ndim == 2:
            x = x[None]
        if x.shape[1] == 12 and x.shape[2] != 12:
            x = x.transpose(0, 2, 1)  # -> channels-last
        n = x.shape[0]
        if self.arch == "multimodal":
            if demo is None:
                raise ValueError("multimodal Predictor requires demo vectors")
            demo = np.asarray(demo, dtype=np.float32)
            if demo.ndim == 1:
                demo = demo[None]
            if demo.shape != (n, 5):
                raise ValueError(f"demo must be [N, 5] matching signals N={n}; got {demo.shape}")
        if n == 0:
            return np.empty((0, self._num_labels), np.float32)

        n_dev = len(self._replicas) if self._replicas else 1
        outs = []
        cs = self.chunk_size
        with span("predictor.call", rows=n):
            for i0 in range(0, n, cs):
                chunk = x[i0:i0 + cs]
                real = chunk.shape[0]
                if real < cs and n > cs:
                    target = cs
                elif real < cs:
                    # bucket small one-shot batches to the next power of two, as
                    # the JAX Predictor does (pad rows are dropped below)
                    target = 1 << (real - 1).bit_length() if real > 1 else 1
                else:
                    target = real
                if target % n_dev:  # the replicas take equal row blocks
                    target += n_dev - target % n_dev
                with span("predictor.prepare", pad_rows=target - real):
                    args = [chunk, demo[i0:i0 + cs]] if self.arch == "multimodal" else [chunk]
                    if real < target:
                        args = [np.concatenate([a, np.repeat(a[-1:], target - real, axis=0)])
                                for a in args]
                    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
                if self._replicas:  # copies, engines and the read are the replicas' spans
                    outs.append(self._forward_replicas(*args)[:real].numpy())
                    continue
                with span("predictor.h2d", bytes=sum(a.nbytes for a in args)):
                    args = [a.to(self.device) for a in args]
                probs = self._forward(*args)[:real]
                with span("predictor.d2h", bytes=probs.nbytes):
                    outs.append(probs.cpu().numpy())
        return np.concatenate(outs, axis=0)


def _device_list(device) -> List[torch.device]:
    """The data-parallel devices: every visible GPU for ``None``, else the
    device or list given (``["cpu", "cpu"]`` in the tests)."""
    if device is None:
        resolve_device(None)  # raises without a GPU
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("data_parallel needs at least one device")
        return [resolve_device(d) for d in device]
    return [resolve_device(device)]
