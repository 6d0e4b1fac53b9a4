"""Post-training int8 quantization of the ECG conv stack (port of
``ptbxl_tpu/ops/quant.py``; inference only).

* BatchNorm is folded into the conv weights first (the port's
  ``fold_bn_into_conv`` / ``fold_multimodal``, the JAX folded layout).
* Mixed per-layer precision: the layers in ``int8_layers`` run as int8 convs,
  the others as bf16 convs.  Default (``default_int8_layers``): the deep
  layer (3,) for every model, the H100 sweep's fastest gate-passing set
  (``tools/tune_int8.py``); the JAX package ships (1, 3) for the ECGCNN and
  AF models, measured on a TPU.
* Per-input-channel activation scales ``sx`` (absmax over the calibration set,
  no clipping) fold into the weights before per-output-channel weight
  quantization (``sw``), so per-channel activation quantization costs nothing
  at run time.
* The epilogue is bf16 in JAX's order: int32 -> bf16, ``* sw`` in bf16,
  ``+ b`` in bf16, ReLU; when the next layer is int8 the requantization
  (``round`` half to even, clip to +-127) runs before the max-pool (max
  commutes with the monotone round and clip), so the pool moves int8.

The int8 conv is ``int8_conv1d``: the input padded by 7 each side with int8
zeros, im2col to ``[B*T, 15*Cin]`` (K zero-padded to a multiple of 8, M to
more than 16, as ``torch._int_mm`` on the card requires), and
``torch._int_mm`` (s8 x s8 -> s32) against the ``[15*Cin, Cout]`` weights.  It
is not a TPU kernel: the JAX package computes it in XLA
(``preferred_element_type=int32``), so here it is stock PyTorch.  The bf16
layers are ``F.conv1d`` in bf16 (cuDNN on the card, f32 sums, one rounding to
bf16), the bias added after the rounding.  The forward's z-score is the
one-pass form, calibration's the two-pass form.

The q-param dict (``quantize_folded``) has the JAX keys and dtypes: int8
layers ``w{i}`` int8 [K, Cin, Cout], ``sw{i}`` f32 [Cout], ``sx{i}`` f32
[Cin]; other layers ``w{i}`` bf16; ``b{i}`` f32; the dense tail f32; plus
``n_blocks`` and ``int8_layers``.  ``save_qparams`` / ``load_qparams`` keep
the JAX ``.npz`` format, so a file written by either package loads in the
other.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ptbxl_torch.ops.preprocess import zscore_per_lead_batch, zscore_per_lead_batch_onepass
from ptbxl_torch.utils.device import DeviceLike, highest_precision, resolve_device

K = 15
PAD = K // 2
K_MULT = 8  # torch._int_mm on the card: K and N multiples of 8
MIN_ROWS = 17  # ... and M > 16
IM2COL_BUDGET = 1 << 30  # bytes of int8 columns one chunk of records may hold

# The layer sets shipped, from the H100's sweep (tools/tune_int8.py, PERF.md):
# the deep layer alone is the fastest set within the battery gate for every
# model (JAX ships (1, 3) for the ECGCNN, measured on a TPU)
DEFAULT_INT8_LAYERS: Tuple[int, ...] = (3,)  # ecgcnn / AF
_ARCH_DEFAULT_LAYERS = {"ecgcnn": (3,), "multimodal": (3,)}

QParams = Dict[str, Any]


def default_int8_layers(arch: str) -> Tuple[int, ...]:
    """The layer set shipped for this architecture."""
    return _ARCH_DEFAULT_LAYERS.get(arch, DEFAULT_INT8_LAYERS)


def _np32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def _conv_f32(h: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME conv k=15 in f32 on channels-last h [B, T, Cin], w [K, Cin, Cout] -> [B, T, Cout]."""
    y = F.conv1d(h.transpose(1, 2), w.permute(2, 1, 0), padding=PAD)
    if b is not None:
        y = y + b[:, None]
    return y.transpose(1, 2)


def _pool2(a: torch.Tensor) -> torch.Tensor:
    """MaxPool(2) over T of [B, T, C], the odd tail dropped (VALID)."""
    return a.unfold(1, 2, 2).amax(-1)


def folded_layer_inputs(folded: Dict[str, Any], x: torch.Tensor) -> List[torch.Tensor]:
    """f32 inputs of each conv layer of the BN-folded stack (calibration).

    ``x`` [N, T, 12] on the device, already z-scored if the serving path
    normalizes.  ``taps[i]`` is the input of conv ``i``, ``taps[n_blocks]``
    the last block's output; f32 with TF32 off.
    """
    taps = []
    h = x.float()
    with highest_precision():
        for i in range(int(folded["n_blocks"])):
            taps.append(h)
            w = torch.as_tensor(folded[f"w{i}"], dtype=torch.float32, device=h.device)
            b = torch.as_tensor(folded[f"b{i}"], dtype=torch.float32, device=h.device)
            h = _pool2(torch.relu(_conv_f32(h, w, b)))
    taps.append(h)
    return taps


def _validate_int8_layers(int8_layers: Sequence[int], n_blocks: int) -> None:
    """Out-of-range conv indices raise here, not mid-forward."""
    bad = [i for i in int8_layers if not 0 <= int(i) < n_blocks]
    if bad:
        raise ValueError(
            f"int8_layers {bad} out of range: this stack has {n_blocks} conv "
            f"blocks (valid indices 0..{n_blocks - 1})"
        )


def _absmax_scales(taps: List[torch.Tensor], int8_layers: Sequence[int]) -> Dict[int, np.ndarray]:
    scales = {}
    for i in set(int8_layers):
        amax = taps[i].abs().amax(dim=(0, 1)).cpu().numpy()
        scales[i] = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
    return scales


def calibrate_act_scales(folded: Dict[str, Any], x_calib: torch.Tensor,
                         int8_layers: Sequence[int] = DEFAULT_INT8_LAYERS
                         ) -> Dict[int, np.ndarray]:
    """Per-input-channel absmax scales of each int8 layer's input.

    ``x_calib``: [N, T, 12] z-scored calibration signals (channels-last).
    """
    _validate_int8_layers(int8_layers, int(folded["n_blocks"]))
    taps = folded_layer_inputs(folded, torch.as_tensor(x_calib))
    return _absmax_scales(taps, int8_layers)


def quantize_folded(folded: Dict[str, Any], act_scales: Dict[int, np.ndarray],
                    int8_layers: Sequence[int] = DEFAULT_INT8_LAYERS) -> QParams:
    """Quantize the selected conv layers of a BN-folded dict (numpy math, as JAX).

    int8 layers get ``w{i}`` int8 [K, Cin, Cout] (the activation scale folded
    in), ``sw{i}`` f32 [Cout] dequant scales and ``sx{i}`` f32 [Cin] activation
    scales; the other layers keep bf16 weights; dense tails pass through as
    f32.  CPU tensors.
    """
    n_blocks = int(folded["n_blocks"])
    _validate_int8_layers(int8_layers, n_blocks)
    q: QParams = {"n_blocks": n_blocks, "int8_layers": tuple(sorted(int(i) for i in int8_layers))}
    for i in range(n_blocks):
        w = _np32(folded[f"w{i}"])
        b = _np32(folded[f"b{i}"])
        if i in act_scales:
            sx = np.asarray(act_scales[i], np.float32)  # [Cin]
            wf = w * sx[None, :, None]
            sw = np.maximum(np.abs(wf).max(axis=(0, 1)) / 127.0, 1e-12).astype(np.float32)
            q[f"w{i}"] = torch.from_numpy(np.clip(np.round(wf / sw), -127, 127).astype(np.int8))
            q[f"sw{i}"] = torch.from_numpy(sw)
            q[f"sx{i}"] = torch.from_numpy(sx.copy())
        else:
            q[f"w{i}"] = torch.from_numpy(w).to(torch.bfloat16)
        q[f"b{i}"] = torch.from_numpy(b)
    for k, v in folded.items():
        if k.endswith("_w") or k.endswith("_b"):
            q[k] = torch.from_numpy(_np32(v))
    return q


def quantize_act(a: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """``clip(round(a / sx), -127, 127)`` in f32, round half to even, as int8."""
    return torch.clamp(torch.round(a.float() / sx), -127, 127).to(torch.int8)


def int8_weight_matrix(w: torch.Tensor) -> torch.Tensor:
    """int8 [K, Cin, Cout] -> [Cout, Kp] contiguous, Kp = 15*Cin zero-padded to
    a multiple of 8; row ``o`` column ``k*Cin + c`` is ``w[k, c, o]``.  Its
    transpose is ``int8_conv1d``'s right operand (column-major)."""
    k, cin, cout = w.shape
    m = w.reshape(k * cin, cout).t()
    kp = -(-k * cin // K_MULT) * K_MULT
    return F.pad(m, (0, kp - k * cin)).contiguous()


def im2col(xq: torch.Tensor, kp: int) -> torch.Tensor:
    """int8 [B, T, Cin] -> the SAME conv's columns [max(B*T, 17), kp]: column
    ``k*Cin + c`` of row ``b*T + t`` is ``x[b, t + k - 7, c]`` (0 outside),
    zero columns up to ``kp`` and zero rows up to 17."""
    b, t, cin = xq.shape
    xp = F.pad(xq, (0, 0, PAD, PAD))
    # one record's reshape is a view whose rows overlap (row stride Cin):
    # _int_mm wants each row whole, so copy
    cols = xp.unfold(1, K, 1).transpose(2, 3).reshape(b * t, K * cin).contiguous()
    rows = b * t
    if kp > K * cin or rows < MIN_ROWS:
        cols = F.pad(cols, (0, kp - K * cin, 0, max(MIN_ROWS - rows, 0)))
    return cols


def int8_conv1d(xq: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """SAME int8 conv k=15: xq [B, T, Cin] int8, wm = ``int8_weight_matrix(w)``
    [Cout, Kp] -> int32 [B, T, Cout], exact (im2col + ``torch._int_mm``)."""
    b, t, _ = xq.shape
    y = torch._int_mm(im2col(xq, wm.shape[1]), wm.t())
    return y[:b * t].view(b, t, wm.shape[0])


def int8_conv1d_plain(xq: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """Plain version of ``int8_conv1d``: the same im2col and an f64 ``matmul``,
    exact since every partial sum is an integer below 127 * 127 * 15 * Cin
    < 2^53 (the card has no integer matmul but ``_int_mm``)."""
    b, t, _ = xq.shape
    y = torch.matmul(im2col(xq, wm.shape[1]).double(), wm.t().double())
    return y[:b * t].view(b, t, wm.shape[0]).to(torch.int32)


def bf16_conv1d(h: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """bf16 SAME conv of h [B, Cin, T] with ``wc`` [Cout, Cin, K] bf16 ->
    [B, Cout, T] bf16: bf16 operands, f32 sums, one rounding; no bias.

    On the card cuDNN's bf16 conv; on the CPU the same arithmetic spelled
    out, an f32 conv (TF32 off) of the bf16 values (their products are exact
    in f32) rounded once, since torch's CPU bf16 conv rounds otherwise.
    """
    hb = h.to(torch.bfloat16)
    if hb.device.type == "cuda":
        return F.conv1d(hb, wc, padding=PAD)
    with highest_precision():
        return F.conv1d(hb.float(), wc.float(), padding=PAD).to(torch.bfloat16)


def conv_stack_block(q: QParams, h: torch.Tensor, i: int, n_blocks: int,
                     int8_layers: Tuple[int, ...]) -> torch.Tensor:
    """Block ``i`` of ``_conv_stack``: its channel-major input [B, C, T] (int8
    when block ``i`` is int8 and block ``i - 1`` requantized, else the previous
    block's bf16 or the z-score's f32) -> its pooled output [B, Cout, T // 2],
    contiguous unless ``i`` is the last block (an int8 block's output is a
    channel-major view of its channels-last rows)."""
    bf16 = torch.bfloat16
    w, b = q[f"w{i}"], q[f"b{i}"].to(bf16)
    nxt = q.get(f"sx{i + 1}") if i + 1 in int8_layers else None
    if i in int8_layers:
        xq = h if h.dtype == torch.int8 else quantize_act(h, q[f"sx{i}"][:, None])
        y = int8_conv1d(xq.transpose(1, 2).contiguous(), int8_weight_matrix(w))
        a = torch.relu(y.to(bf16) * q[f"sw{i}"].to(bf16) + b)  # [B, T, Cout]
        if nxt is not None:
            a = quantize_act(a, nxt)
        h = _pool2(a).transpose(1, 2)
    else:
        a = torch.relu(bf16_conv1d(h, w.to(bf16).permute(2, 1, 0)) + b[:, None])
        if nxt is not None:
            a = quantize_act(a, nxt[:, None])
        h = a.unfold(2, 2, 2).amax(-1)  # [B, Cout, T // 2]
    return h.contiguous() if i + 1 < n_blocks else h


def _conv_stack(q: QParams, h: torch.Tensor, n_blocks: int, int8_layers: Tuple[int, ...]
                ) -> torch.Tensor:
    """Mixed int8/bf16 conv stack: h [B, T, 12] z-scored -> [B, T', C_last].

    When the next layer is int8 the requantization happens before the pool
    (byte-identical: round and clip are monotone), so the pool moves int8.
    Between layers the activation is channel-major [B, C, T], cuDNN's
    layout, so the bf16 layers' epilogues read it in order; an int8 layer
    takes its input channels-last for im2col (an int8 copy) and its
    epilogue and pool run on ``_int_mm``'s channels-last rows.  Each block is
    ``conv_stack_block``.
    """
    h = h.transpose(1, 2)  # channel-major view
    for i in range(n_blocks):
        h = conv_stack_block(q, h, i, n_blocks, int8_layers)
    return h.transpose(1, 2)


def block0_operand(x: torch.Tensor, int8_layers: Tuple[int, ...]) -> torch.Tensor:
    """Raw x [B, T, 12] -> block 0's input: the one-pass z-score, channel-major,
    rounded to bf16 when block 0 is a bf16 layer (its conv's operand)."""
    h = zscore_per_lead_batch_onepass(x).transpose(1, 2)
    return h if 0 in int8_layers else h.to(torch.bfloat16)


def conv_stack_inputs(q: QParams, x: torch.Tensor, n_blocks: int,
                      int8_layers: Tuple[int, ...]) -> List[torch.Tensor]:
    """Raw x [B, T, 12] -> every block's input as ``_conv_stack`` hands it on
    (dtype and layout), then the last block's output: ``n_blocks + 1`` tensors;
    the last, transposed, is ``_conv_stack``'s result bit for bit."""
    hs = [block0_operand(x, int8_layers)]
    for i in range(n_blocks):
        hs.append(conv_stack_block(q, hs[-1], i, n_blocks, int8_layers))
    return hs


def split_meta(q: QParams) -> Tuple[Dict[str, torch.Tensor], int, Tuple[int, ...]]:
    """Split a ``quantize_folded`` dict into (tensors, n_blocks, int8_layers)."""
    arrs = {k: v for k, v in q.items() if isinstance(v, torch.Tensor)}
    return arrs, int(q["n_blocks"]), tuple(int(i) for i in q["int8_layers"])


def to_device(arrs: Dict[str, torch.Tensor], device: DeviceLike) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in arrs.items()}


def chunk_records(t: int, arrs: Dict[str, torch.Tensor], int8_layers: Sequence[int],
                  budget: int = IM2COL_BUDGET) -> int:
    """Records a chunk of the forward may hold so that one layer's im2col
    columns stay within ``budget`` bytes (T halves at every block)."""
    def cols(w):
        return -(-w.shape[0] * w.shape[1] // K_MULT) * K_MULT

    per_rec = max([(t >> i) * cols(arrs[f"w{i}"]) for i in int8_layers] or [1])
    return max(1, budget // per_rec)


def dense_tail(q: QParams, h: torch.Tensor, arch: str = "ecgcnn",
               demo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The quantized forward's tail: h [B, T', C] -> probs f32 (mean over time,
    proj, the FiLM demo branch for ``multimodal``, head, sigmoid), in f32 with
    TF32 off."""
    with highest_precision():
        z = h.float().mean(1) @ q["proj_w"] + q["proj_b"]
        if arch == "multimodal":
            e = torch.relu(demo.float() @ q["fc1_w"] + q["fc1_b"])
            e = torch.relu(e @ q["fc2_w"] + q["fc2_b"])
            film = e @ q["film_w"] + q["film_b"]
            gamma, beta = film.chunk(2, dim=-1)
            z = (1.0 + torch.tanh(gamma)) * z + beta
        return torch.sigmoid(z @ q["head_w"] + q["head_b"])


def make_quantized_forward(n_blocks: int, int8_layers: Tuple[int, ...], arch: str = "ecgcnn",
                           normalize: bool = True, budget: Optional[int] = IM2COL_BUDGET
                           ) -> Callable[..., torch.Tensor]:
    """``fwd(arrs, x[, demo]) -> probs`` f32 for the quantized stack.

    ``arrs`` are ``split_meta``'s tensors on x's device; x [B, T, 12] raw.  The
    z-score is the one-pass form.  The records run in chunks whose im2col
    columns stay within ``budget`` bytes; ``budget=None`` runs the batch as
    one chunk (the exported program, whose batch is symbolic).  The dense
    tail runs in f32 with TF32 off.
    """

    def probs(q, x, demo):
        h = zscore_per_lead_batch_onepass(x) if normalize else x
        return dense_tail(q, _conv_stack(q, h, n_blocks, int8_layers), arch, demo)

    def fwd(q, x, demo=None):
        if arch == "multimodal" and demo is None:
            raise ValueError("the multimodal quantized forward needs demo vectors")
        if budget is None:
            return probs(q, x, demo)
        n = chunk_records(x.shape[1], q, int8_layers, budget)
        ds = demo.split(n) if demo is not None else [None] * -(-x.shape[0] // n)
        return torch.cat([probs(q, xc, dc) for xc, dc in zip(x.split(n), ds)])

    return fwd


def demo_pack_signals(n: Optional[int] = None) -> np.ndarray:
    """The bundled demo-pack ECGs, [N, T, 12] f32: the in-distribution parity
    oracle, not the default calibration set (``default_calib_signals``)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    files = sorted(glob.glob(os.path.join(root, "data", "demo", "single", "*.npz")))
    if not files:
        raise FileNotFoundError("no bundled demo pack found for int8 calibration; "
                                "pass calib_signals")
    ecgs = [np.load(f, allow_pickle=True)["ecg"].T for f in files[: n or len(files)]]
    return np.stack(ecgs).astype(np.float32)


def default_calib_signals() -> np.ndarray:
    """The default int8 calibration set, [N, T, 12]: the robust synthetic
    preset (``quant_eval.robust_calibration_signals``, 64 synthetic records +
    the 7 demo records), which bounds the 519-signal battery.  Calibrating
    on ``demo_pack_signals()`` instead tightens demo-pack parity and fails the
    battery out of distribution."""
    from ptbxl_torch.ops.quant_eval import robust_calibration_signals

    return np.ascontiguousarray(robust_calibration_signals().transpose(0, 2, 1))


def _bias_correct_inplace(q: QParams, folded: Dict[str, Any], taps: List[torch.Tensor],
                          int8_layers: Sequence[int]) -> None:
    """Per-output-channel mean-error bias correction: for each int8 layer the
    mean over the calibration set and time of (dequantized int8 conv - f32
    conv), computed on the f32 taps, is taken out of the conv bias."""
    for i in sorted(int8_layers):
        x = taps[i]
        dev = x.device
        xq = quantize_act(x, q[f"sx{i}"].to(dev))
        yq = int8_conv1d(xq, int8_weight_matrix(q[f"w{i}"].to(dev))).float() * q[f"sw{i}"].to(dev)
        with highest_precision():
            yf = _conv_f32(x, torch.as_tensor(folded[f"w{i}"], dtype=torch.float32, device=dev))
        delta = (yq - yf).mean(dim=(0, 1))  # [Cout]
        q[f"b{i}"] = q[f"b{i}"] - delta.cpu()


def _channels_last(signals) -> np.ndarray:
    x = np.asarray(signals, np.float32)
    if x.ndim == 2:
        x = x[None]
    if x.shape[1] == 12 and x.shape[2] != 12:
        x = x.transpose(0, 2, 1)
    return np.ascontiguousarray(x)


def quantize_model(state: Dict[str, torch.Tensor], arch: str = "ecgcnn",
                   calib_signals: Optional[np.ndarray] = None,
                   int8_layers: Optional[Sequence[int]] = None,
                   normalize: bool = True, bias_correct: bool = False,
                   device: DeviceLike = None) -> QParams:
    """One call: fold BatchNorm, calibrate, quantize.  Returns the q-param dict.

    ``state`` is a reference-layout state dict.  ``calib_signals``: raw
    [N, 12, T] or [N, T, 12]; default the robust preset
    (``default_calib_signals``).  They are z-scored (two-pass) iff the serving
    path normalizes.  ``int8_layers`` defaults to ``default_int8_layers(arch)``.
    ``bias_correct`` folds the calibration set's mean quantization error into
    the conv biases.  The calibration forward runs on ``device`` (the GPU by
    default).
    """
    from ptbxl_torch.ops.kernels.fused_ecgcnn import fold_bn_into_conv, fold_multimodal

    dev = resolve_device(device)
    if int8_layers is None:
        int8_layers = default_int8_layers(arch)
    fold = fold_multimodal if arch == "multimodal" else fold_bn_into_conv
    folded = fold({k: v.to(dev) for k, v in state.items()})
    _validate_int8_layers(int8_layers, int(folded["n_blocks"]))
    x = _channels_last(calib_signals if calib_signals is not None else default_calib_signals())
    xt = torch.from_numpy(x).to(dev)
    if normalize:
        xt = zscore_per_lead_batch(xt)
    taps = folded_layer_inputs(folded, xt)
    q = quantize_folded(folded, _absmax_scales(taps, int8_layers), int8_layers)
    if bias_correct:
        _bias_correct_inplace(q, folded, taps, int8_layers)
    return q


def resolve_qparams(state: Dict[str, torch.Tensor], arch: str = "ecgcnn", num_labels: int = 5,
                    qparams=None, calib_signals: Optional[np.ndarray] = None,
                    int8_layers: Optional[Sequence[int]] = None, normalize: bool = True,
                    device: DeviceLike = None) -> QParams:
    """The q-params of an int8 ``Predictor`` or artifact: ``qparams`` (a dict,
    or a ``save_qparams`` path), else ``quantize_model`` of ``state``; a head
    of another size than ``num_labels`` raises (the quantized forward never
    builds the model that would)."""
    if qparams is None:
        q = quantize_model(state, arch=arch, calib_signals=calib_signals,
                           int8_layers=int8_layers, normalize=normalize, device=device)
    else:
        q = load_qparams(qparams) if isinstance(qparams, str) else qparams
    head_labels = int(q["head_w"].shape[1])
    if head_labels != num_labels:
        raise ValueError(f"checkpoint head has {head_labels} labels but "
                         f"num_labels={num_labels} was requested")
    return q


def save_qparams(q: QParams, path: str) -> str:
    """Write a ``quantize_model`` result to ``.npz`` (atomic), in the JAX
    package's format: bf16 arrays stored as f32 and named in
    ``__bf16_keys__``, plus ``__n_blocks__`` and ``__int8_layers__``."""
    arrs = {}
    bf16_keys = []
    for k, v in q.items():
        if not isinstance(v, torch.Tensor):
            continue
        if v.dtype == torch.bfloat16:  # npz has no bf16; f32 holds it exactly
            arrs[k] = v.float().cpu().numpy()
            bf16_keys.append(k)
        else:
            arrs[k] = v.cpu().numpy()
    arrs["__n_blocks__"] = np.asarray(q["n_blocks"], np.int64)
    arrs["__int8_layers__"] = np.asarray(sorted(q["int8_layers"]), np.int64)
    arrs["__bf16_keys__"] = np.asarray(bf16_keys)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)
    return path


def load_qparams(path: str) -> QParams:
    """Read a ``save_qparams`` file (either package's) into a q-param dict of CPU tensors."""
    with np.load(path, allow_pickle=False) as z:
        bf16_keys = {str(k) for k in z["__bf16_keys__"]}
        q: QParams = {"n_blocks": int(z["__n_blocks__"]),
                      "int8_layers": tuple(int(i) for i in z["__int8_layers__"])}
        for k in z.files:
            if k.startswith("__"):
                continue
            t = torch.from_numpy(np.array(z[k]))
            q[k] = t.to(torch.bfloat16) if k in bf16_keys else t
    return q
