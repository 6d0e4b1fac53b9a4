"""Batched ECG classifier inference (port of ``ptbxl_tpu/inference.py``).

    predictor = Predictor.from_checkpoint("outputs/ecg_baseline/ckpts/ecg_baseline_best.npz")
    probs = predictor(signals)                  # [N, 12, T] raw -> [N, L]

    mm = Predictor.from_checkpoint("outputs/ecg_multimodal/ckpts/ecg_multimodal_best.npz",
                                   arch="multimodal")
    probs = mm(signals, demo=demo_vectors)      # + [N, 5] demographics

    vit = Predictor(state_dict, arch="st_mem", precision="default")
    probs = vit(signals)                        # ST-MEM's ViT-B/75 in bf16

    founder = Predictor(state_dict, arch="ecgfounder", precision="default")
    probs = founder(signals)                    # ECGFounder's Net1D in bf16, 150 labels

* accepts reference-layout ``[N, 12, T]`` or channels-last ``[N, T, 12]`` raw
  signals; the per-lead z-score runs on the device
* ``arch='st_mem'`` serves ST-MEM's ViT encoder (``models/st_mem.py``) on the
  framework engine alone (``'auto'`` resolves to it; ``'kernel'`` and
  ``precision='int8'`` raise): its front end (resampling to 250 Hz, the crop
  to 9 s, then the z-score) is the model's own, ``precision='default'`` runs it
  in bf16 with the attention through ``F.scaled_dot_product_attention``;
  its sizes are read from ``state_dict``'s shapes, its heads 64 wide
* ``arch='ecgfounder'`` serves ECGFounder's Net1D (``models/ecgfounder.py``)
  on the framework engine alone, as ``'st_mem'`` (``'kernel'`` and
  ``precision='int8'`` raise), at ``'highest'`` (f32, TF32 off) or
  ``'default'`` (bf16: cuBLAS GEMMs for the 1x1 convs, cuDNN's grouped and
  strided convs); its front end is the CNNs' z-score; its widths and its
  label count (150 for the released model) are read from ``state_dict``'s
  shapes, so ``num_labels`` is not consulted; at ``'default'`` it holds
  the parameters in bf16 (rounded once, as the module would round them on
  every call); on one GPU it replays Net1D's stem, stages and head as CUDA
  graphs, captured at the first chunk of each shape (``Net1D.graphed``).  No
  ECGFounder checkpoint format is read (``from_checkpoint`` raises)
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
* on one GPU the chunks go through a staging ring of two slots (pinned host
  buffers and their device twins, allocated at the first call and again
  when the record shape changes or a call needs more rows): the host copies
  chunk i+1's rows into a free slot and enqueues its copy to the device on a
  side stream while chunk i's engine runs; the compute stream (the caller's
  current stream) waits for the copy by an event, and the probabilities are
  read back once, at the end of the call.  Calls on one Predictor take
  turns (a lock).  On the CPU and on the replicas every chunk is padded and
  handed over as it comes.
* under a ``torch.profiler`` session a call records its spans
  (``utils/profiling.py``): the root ``predictor.call`` (``rows``, the real
  ones), a chunk's ``predictor.prepare`` (``pad_rows``; bucketing and
  padding, on a GPU the wait for a free slot), on a GPU ``predictor.stage``
  (the rows and pad rows into the slot's pinned buffers; ``bytes``),
  ``predictor.h2d`` (the host->device copy, on a GPU its enqueue; ``bytes``,
  and on a GPU ``overlap``: 1 when an earlier chunk of the call has engine
  work the host has not waited for), the engine branch ``predictor.kernel``
  / ``.framework`` / ``.int8`` (``rows`` launched), and the call's one
  ``predictor.d2h`` (the probabilities' read, which waits for the engines;
  ``bytes``; a replica chunk's read is its own)
"""

from __future__ import annotations

import copy
import os
import threading
from functools import partial
from typing import List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ptbxl_torch.models.ecg_cnn import ECGCNN
from ptbxl_torch.models.ecg_multimodal import ECGMultimodal
from ptbxl_torch.models.ecgfounder import Net1D
from ptbxl_torch.models.ecgfounder import widths as net1d_widths
from ptbxl_torch.models.factory import merge_state
from ptbxl_torch.models.params_io import load_checkpoint
from ptbxl_torch.models.st_mem import STMEM, widths
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

_ARCHS = ("ecgcnn", "multimodal", "st_mem", "ecgfounder")
_FRAMEWORK_ONLY = ("st_mem", "ecgfounder")  # no kernel engine and no int8 path
_ENGINES = ("auto", "framework", "kernel")
ENGINE_ALIASES = {"xla": "framework", "pallas": "kernel"}  # the JAX Predictor's names
_PRECISIONS = ("highest", "default", "int8")


class Predictor:
    """Batched baseline / AF ECGCNN, FiLM multimodal, ST-MEM or ECGFounder inference
    on one device."""

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
        if arch in _FRAMEWORK_ONLY:
            if engine == "kernel" or precision == "int8":
                raise ValueError(f"arch={arch!r} runs on the framework engine only, at "
                                 "precision 'highest' or 'default' (engine='framework' or "
                                 f"'auto'), not engine={engine!r}, precision={precision!r}")
            engine = "framework"
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
        if arch == "st_mem":
            self.model = STMEM(**{**widths(state_dict), "num_labels": num_labels},
                               precision=model_precision, dtype=dtype)
            # resolved once: the model runs its own front end before the z-score
            self._framework = self._framework_st_mem
        elif arch == "ecgfounder":
            sizes = net1d_widths(state_dict)
            self._num_labels = sizes["num_labels"]
            self.model = Net1D(**sizes, precision=model_precision, dtype=dtype)
        elif arch == "multimodal":
            self.model = ECGMultimodal(feat_dim=feat_dim, num_labels=num_labels,
                                       demo_hidden_dim=demo_hidden_dim,
                                       precision=model_precision, dtype=dtype)
        else:
            self.model = ECGCNN(feat_dim=feat_dim, num_labels=num_labels,
                                precision=model_precision, dtype=dtype)
        merge_state(self.model, state_dict, strict=True)
        self.model.to(self.device).eval()
        if arch == "ecgfounder":
            # its parameters rounded to the compute dtype once: the values the
            # module would round on every call, without 204 casts a chunk
            self.model.to(dtype)
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
        self._lock = threading.Lock()  # a call holds the staging ring
        self._ring: Optional[_Ring] = None
        self._pipelined = self.device.type == "cuda" and self._replicas is None
        if arch == "ecgfounder":
            # its pieces replayed as CUDA graphs: ~370 launches a chunk set the pace otherwise
            self.model.graphed = self._pipelined

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, num_labels: int = 5, arch: str = "ecgcnn",
                        **kwargs) -> "Predictor":
        if arch == "ecgfounder":
            raise ValueError("arch='ecgfounder' has no checkpoint format: build Net1D's "
                             "state dict (models/ecgfounder.py) and pass it to Predictor")
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

    def _framework_st_mem(self, model: torch.nn.Module, x: torch.Tensor,
                          d: Optional[torch.Tensor]) -> torch.Tensor:
        return torch.sigmoid(model(x, self.normalize).float())

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
        cs = self.chunk_size
        plan = []  # (first row, real rows, launched rows) a chunk
        for i0 in range(0, n, cs):
            real = min(cs, n - i0)
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
            plan.append((i0, real, target))
        arrays = [x, demo] if self.arch == "multimodal" else [x]
        with self._lock, span("predictor.call", rows=n):
            if self._replicas:  # copies, engines and the reads are the replicas' spans
                outs = [self._forward_replicas(*_padded([a[i0:i0 + real] for a in arrays],
                                                        target))[:real].numpy()
                        for i0, real, target in plan]
                return np.concatenate(outs)
            ring = None
            if self._pipelined:
                ring = self._ring = _Ring.fit(self._ring, max(t for _, _, t in plan),
                                              [a.shape[1:] for a in arrays], self.device)
            outs = []  # each chunk's probabilities, left on the device until the end
            for k, (i0, real, target) in enumerate(plan):
                parts = [a[i0:i0 + real] for a in arrays]
                if ring is None:
                    args = _padded(parts, target)
                    with span("predictor.h2d", bytes=sum(a.nbytes for a in args)):
                        args = [a.to(self.device) for a in args]
                    outs.append(self._forward(*args)[:real])
                    continue
                # the host waits for no engine inside a call, so every chunk
                # after the first is copied while earlier engines may run
                args = ring.stage(k, parts, target, overlap=bool(outs))
                outs.append(self._forward(*args)[:real])
                ring.release(k)
            with span("predictor.d2h", bytes=sum(o.nbytes for o in outs)):
                return torch.cat(outs).cpu().numpy()


def _padded(parts: Sequence[np.ndarray], target: int) -> List[torch.Tensor]:
    """A chunk's host arrays as tensors of ``target`` rows, the last real row
    (signal and demo vector) repeated as padding."""
    real = parts[0].shape[0]
    with span("predictor.prepare", pad_rows=target - real):
        if real < target:
            parts = [np.concatenate([a, np.repeat(a[-1:], target - real, axis=0)])
                     for a in parts]
        return [_as_tensor(np.ascontiguousarray(a)) for a in parts]


def _as_tensor(a: np.ndarray) -> torch.Tensor:
    """A host array as a tensor over its memory.  ``from_numpy`` takes no
    negative stride, which a reversed view keeps even where numpy counts it
    contiguous (one row)."""
    return torch.from_numpy(a if min(a.strides, default=0) >= 0 else a.copy())


class _Ring:
    """``Predictor``'s staging ring on a GPU: two slots, each a pinned host
    buffer an input ([rows, T, 12], and [rows, 5] for the multimodal
    demographics) with a device buffer of the same shape, and two events:
    ``copied``, recorded on the side stream after the copy into the device
    buffers, and ``used``, recorded on the compute stream after the engine
    that read them.  Chunk k takes slot k % 2.  The host rewrites a slot's
    pinned buffers only after its ``copied``, and the side stream rewrites its
    device buffers only after its ``used``: events only, never a wait for the
    whole device."""

    def __init__(self, rows: int, shapes: List[tuple], device: torch.device,
                 side: "torch.cuda.Stream"):
        self.rows, self.shapes, self.device, self.side = rows, shapes, device, side
        pin = device.type == "cuda"
        self.slots = []
        for _ in range(2):
            host = [torch.empty((rows, *sh), dtype=torch.float32, pin_memory=pin)
                    for sh in shapes]
            dev = [torch.empty((rows, *sh), dtype=torch.float32, device=device)
                   for sh in shapes]
            self.slots.append((host, dev, torch.cuda.Event(), torch.cuda.Event()))

    @classmethod
    def fit(cls, ring: Optional["_Ring"], rows: int, shapes: List[tuple],
            device: torch.device) -> "_Ring":
        """``ring`` if its slots hold ``rows`` rows of ``shapes``, else a new
        ring of that size on ``ring``'s side stream (a new one for the first)."""
        if ring is None:
            return cls(rows, shapes, device, torch.cuda.Stream(device))
        if ring.rows >= rows and ring.shapes == shapes:
            return ring
        ring.side.synchronize()  # no copy into the old buffers is left when they are freed
        return cls(rows, shapes, device, ring.side)

    def stage(self, k: int, parts: Sequence[np.ndarray], target: int,
              overlap: bool) -> List[torch.Tensor]:
        """Chunk ``k``'s rows (host arrays of ``real`` rows) into its slot's
        pinned buffers, padded to ``target`` rows with the last real row, and
        their copy to the device enqueued on the side stream; the compute
        stream waits for it.  Returns the device views the engine reads."""
        host, dev, copied, used = self.slots[k % 2]
        real = parts[0].shape[0]
        with span("predictor.prepare", pad_rows=target - real):
            copied.synchronize()
        nbytes = sum(h[:target].nbytes for h in host)
        with span("predictor.stage", bytes=nbytes):
            for h, a in zip(host, parts):
                h[:real].copy_(_as_tensor(a))  # torch's threads share a large copy
                h[real:target] = h[real - 1]
        with span("predictor.h2d", bytes=nbytes, overlap=int(overlap)):
            self.side.wait_event(used)
            with torch.cuda.stream(self.side):
                for d, h in zip(dev, host):
                    d[:target].copy_(h[:target], non_blocking=True)
            copied.record(self.side)
            torch.cuda.current_stream(self.device).wait_event(copied)
        return [d[:target] for d in dev]

    def release(self, k: int) -> None:
        """Mark chunk ``k``'s engine as the last reader of its slot."""
        self.slots[k % 2][3].record(torch.cuda.current_stream(self.device))


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
