"""K4: the hybrid inference engine, and P3's conv layer: CUDA kernels + plain
PyTorch versions.

K4 replaces ``ptbxl_tpu/ops/pallas/hybrid_ecgcnn.py``: ``_make_tail_kernel``
(:63), launched by ``hybrid_ecgcnn_logits`` (:143, pallas_call :214), and
``hybrid_ecgcnn_probs`` (:230).  P3's layer replaces
``tools/probe_layer_perf.py::make_pallas_layer`` (:52).  Kernel:
``ptbxl_torch/csrc/hybrid_ecgcnn.cu`` (the tensor-core conv block), beside
K2's conv-block and tail kernels (``csrc/fused_ecgcnn.cu``).

What K4 computes (``hybrid_ecgcnn_logits``): the two-pass z-score
(``ops/preprocess.py``) when ``normalize``; a framework front over the first
``split`` BN-folded blocks (cuDNN, as JAX leaves it to XLA); the deep blocks,
each conv k=15 with ``compute_dtype`` operands and f32 sums, + bias, ReLU and
the floor pool; then the mean over T as a ones-mean in f32, and proj and head
with both operands rounded to ``compute_dtype`` and the bias added in f32.

What bounds it on the H100: operations.  Deep blocks 2 and 3 are 921.6 MFLOP
a record against 989 TFLOP/s of dense bf16 (0.932 us a record, 7.63 ms at
B=8192); their f32 input is 0.32 MB a record (0.096 us at 3.35 TB/s).

Design.  In bf16 each deep block is one launch of the tensor-core conv block
(an implicit-GEMM im2col with ``mma.sync`` bf16 -> f32; the source says
how).  In f32 (which the JAX tests use) a deep block is K2's f32 conv block
(3xTF32 on the tensor cores, ``fused_ecgcnn.conv_block_tf32x3``): the same
function with its sums in another order.  The tail is K2's tail
launch, which computes exactly the hybrid tail.  The front's convolutions run
on cuDNN: in bf16, a convolution of bf16 tensors returns bf16 where JAX keeps
the conv output in f32, so its output takes one extra rounding to bf16 before
the f32 bias (the next block rounds its input to bf16 anyway; the result is
held to the bench's 5e-3 gate).  That is taken over the exact form (operands
rounded to bf16, f32 convs with TF32 off) for speed: PERF.md has both times.
In f32 the front runs with TF32 off.  The pool is taken before the bias and
ReLU, which is the same function (``max(a + b, c + b) = max(a, c) + b``
exactly, and ReLU commutes with max) on half the bytes.

The JAX function's ``block_b`` is not taken: on the TPU it sets the grid's
record tile and pads B to it, while the H100 kernels' grid is time tiles x
records, so it would change nothing here but padding records that are
computed and thrown away.  The card's weight layouts (the front's
channels-last conv weights, the deep blocks' padded bf16 tap weights, or in
f32 their split 3xTF32 weights) are built once by ``prepare_weights`` and
passed as ``weights``; without them a call builds its own.

``conv_layer`` (P3) is one layer on a pre-padded input ``[B, T+14, Cin]`` f32
with weights ``[15*Cin, Cout]``: ``mode="im2col"`` launches the tensor-core
conv block, ``mode="direct"`` K2's bf16 FMA conv block (15 shifted products);
both compute conv k=15 with bf16 operands and f32 sums, + bias, ReLU and the
floor pool, ``[B, T//2, Cout]`` f32.

``conv_layer_cf`` (P4) replaces ``tools/probe_sublane_conv.py::make_layer``
(:51): the same layer on a channel-major input ``[B, Cpad, T+14]`` f32 with
weights ``[15*Cpad, Cout]`` (row ``k*Cpad + c``), contracting over all
``Cpad`` channels (the probe's padded channels hold data too), and an output
``[B, Cout, T//2]`` (``transpose_out``) or ``[B, T//2, Cout]``.  Its kernel
(``ptbxl_conv_layer_cf``) runs K4's tap loop on a tile staged transposed.
The probe's ``b_tile`` (records per TPU grid step) has no counterpart and is
not taken.

A CPU tensor takes the plain versions (``hybrid_ecgcnn_logits_plain``,
``conv_layer_plain``, ``conv_layer_cf_plain``); a CUDA tensor launches the
kernels or raises.  ``launches`` counts K4 forwards on the card,
``launches_layer`` P3 layers, ``launches_layer_cf`` P4 layers.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ptbxl_torch.models.ecg_cnn import precision_scope
from ptbxl_torch.ops.kernels import _build
from ptbxl_torch.ops.kernels import fused_ecgcnn as k2
from ptbxl_torch.ops.kernels.fused_ecgcnn import MAX_LABELS, Folded, _dot1, _round
from ptbxl_torch.ops.preprocess import zscore_per_lead_batch
from ptbxl_torch.utils.device import highest_precision

K = 15
PAD = K // 2
launches = 0
launches_layer = 0
launches_layer_cf = 0
MODES = ("im2col", "direct")

_I, _P = _build.INT, _build.VOIDP
_SIGNATURES = {
    # device, x, w, b, y, B, Tx, T, off, Cin, CinP, Cout, stream
    "ptbxl_tc_conv_block": [_I, _P, _P, _P, _P] + [_I] * 7 + [_P],
    # device, x, w, b, y, B, Tx, CinP, Cout, transpose_out, stream
    "ptbxl_conv_layer_cf": [_I, _P, _P, _P, _P] + [_I] * 5 + [_P],
}


def _floor_pool(h: torch.Tensor) -> torch.Tensor:
    """[B, T, C] -> [B, T//2, C]: MaxPool1d(2), odd lengths floored."""
    half = h.shape[1] // 2
    return torch.maximum(h[:, 0:2 * half:2], h[:, 1:2 * half:2])


def _im2col_block_plain(xp: torch.Tensor, w2d: torch.Tensor, b: torch.Tensor,
                        compute_dtype: torch.dtype) -> torch.Tensor:
    """xp [B, T+14, Cin] -> pool(relu(im2col(xp) @ w2d + b)) [B, T//2, Cout].

    The im2col is ``[B, T, 15*Cin]`` with column ``k*Cin + c`` = xp[t+k, c]
    (the concatenation of 15 shifted slices, hybrid_ecgcnn.py:81-89); one
    product with both operands rounded to ``compute_dtype``, f32 sums.
    """
    bsz, tp, cin = xp.shape
    t = tp - 2 * PAD
    cols = _round(xp, compute_dtype).unfold(1, K, 1)          # [B, T, Cin, 15]
    cols = cols.transpose(2, 3).reshape(bsz, t, K * cin)
    acc = torch.matmul(cols, _round(w2d, compute_dtype))
    return _floor_pool(torch.relu(acc + b))


def _front_plain(h: torch.Tensor, folded: Folded, n_front: int,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """``_xla_front`` (:44-60): pad 7, both operands rounded to ``compute_dtype``,
    an f32 conv, + the f32 bias, ReLU, floor pool; [B, T, C] f32 in and out."""
    for i in range(n_front):
        w = _round(folded[f"w{i}"], compute_dtype)           # [15, Cin, Cout]
        hp = _round(F.pad(h, (0, 0, PAD, PAD)), compute_dtype)
        y = F.conv1d(hp.transpose(1, 2), w.permute(2, 1, 0)).transpose(1, 2)
        h = _floor_pool(torch.relu(y + folded[f"b{i}"]))
    return h


def _check_split(split: int, n_blocks: int) -> None:
    if not 0 < split < n_blocks:
        raise ValueError(
            f"split must leave at least one framework front block and one kernel "
            f"deep block: 0 < split ({split}) < n_blocks ({n_blocks})")


def _check_args(folded: Folded, split: int) -> None:
    _check_split(split, int(folded["n_blocks"]))
    if folded["head_b"].shape[0] > MAX_LABELS:
        raise ValueError(f"fused kernels support num_labels <= {MAX_LABELS}")


def hybrid_ecgcnn_logits_plain(x: torch.Tensor, folded: Folded, split: int = 2,
                               compute_dtype: torch.dtype = torch.bfloat16,
                               normalize: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K4: x [B, T, C] raw -> logits [B, L].

    ``hybrid_ecgcnn_logits``' arithmetic step by step, with TF32 off on the
    card as well.
    """
    _check_args(folded, split)
    with highest_precision():
        h = x.float()
        if normalize:
            h = zscore_per_lead_batch(h)
        h = _front_plain(h, folded, split, compute_dtype)
        for i in range(split, int(folded["n_blocks"])):
            w = folded[f"w{i}"]
            h = _im2col_block_plain(F.pad(h, (0, 0, PAD, PAD)), w.reshape(-1, w.shape[2]),
                                    folded[f"b{i}"], compute_dtype)
        t_f = h.shape[1]
        ones = torch.full((t_f,), 1.0 / t_f, dtype=torch.float32, device=h.device)
        g = torch.einsum("t,btc->bc", ones, h)
        z = _dot1(g, folded["proj_w"], compute_dtype) + folded["proj_b"]
        return _dot1(z, folded["head_w"], compute_dtype) + folded["head_b"]


def tc_weight(w: torch.Tensor) -> torch.Tensor:
    """[15, Cin, Cout] f32 -> [15, CinP, Cout] bf16, channels zero-padded to a multiple of 16."""
    k, cin, cout = w.shape
    cin_p = -(-cin // 16) * 16
    out = torch.zeros((k, cin_p, cout), dtype=torch.bfloat16, device=w.device)
    out[:, :cin] = w
    return out


def front_weight(w: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """[15, Cin, Cout] f32 -> the front's cuDNN weight [Cout, CinP, 1, 15], channels-last
    in ``compute_dtype``, channels zero-padded to a multiple of 16."""
    cin = w.shape[1]
    wt = F.pad(w, (0, 0, 0, -(-cin // 16) * 16 - cin)).permute(2, 1, 0).unsqueeze(2)
    return wt.to(compute_dtype, memory_format=torch.channels_last)


def prepare_weights(folded: Folded, split: int = 2,
                    compute_dtype: torch.dtype = torch.bfloat16) -> dict:
    """The card's weight layouts for one ``split`` and ``compute_dtype``, built
    once: the front's (``front_weight``) and the deep blocks' tap weights
    (``tc_weight`` in bf16, K2's split ``tf32x3_weight`` in f32)."""
    _check_split(split, int(folded["n_blocks"]))
    deep_weight = tc_weight if compute_dtype == torch.bfloat16 else k2.tf32x3_weight
    return {"split": split, "dtype": compute_dtype,
            "front": [front_weight(folded[f"w{i}"], compute_dtype) for i in range(split)],
            "deep": [deep_weight(folded[f"w{i}"])
                     for i in range(split, int(folded["n_blocks"]))]}


def _tc_conv(x: torch.Tensor, wt: torch.Tensor, b: torch.Tensor, t: int, off: int) -> torch.Tensor:
    """One launch of the tensor-core conv block: x [B, Tx, Cin] f32, conv rows
    t + k - off, wt [15, CinP, Cout] bf16 from ``tc_weight`` -> [B, t//2, Cout] f32."""
    bsz, tx, cin = x.shape
    cout = wt.shape[2]
    if cin % 4 or cout % 32 or t < 2:
        raise ValueError(f"tensor-core conv block needs Cin % 4 == 0, Cout % 32 == 0 and "
                         f"T >= 2, got Cin={cin}, Cout={cout}, T={t}")
    y = torch.empty((bsz, t // 2, cout), dtype=torch.float32, device=x.device)
    lib = _build.load_library("hybrid_ecgcnn", _SIGNATURES)
    err = lib.ptbxl_tc_conv_block(
        x.get_device(), x.data_ptr(), wt.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, tx, t,
        off, cin, wt.shape[1], cout, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "tensor-core conv block launch")
    return y


def _front(x: torch.Tensor, folded: Folded, front_w: list,
           compute_dtype: torch.dtype) -> torch.Tensor:
    """The framework front on the card: cuDNN convs with the weights
    ``front_w`` (``front_weight``, one a block), [B, T, C] f32 in and out.

    The activations stay ``[B, T, C]``, which is a channels-last
    ``[B, C, 1, T]``, so cuDNN takes its NHWC kernels without layout
    conversions.  Channels are zero-padded to a multiple of 16 (block 0's 12:
    cuDNN's kernel for 12 takes 2.6x the time, and zeros add nothing).  The
    pool is one ``maximum`` of the even and odd rows, before the bias.  Into
    the next block goes ``bf16(relu(p + b))``, the f32 add rounded once and
    the ReLU taken in bf16, which is the same value; the last block's output
    is f32.
    """
    h = x
    n_front = len(front_w)
    for i, wt in enumerate(front_w):
        cin, cin_p = h.shape[2], wt.shape[1]
        if cin_p == cin:
            hc = h.to(compute_dtype)
        else:
            hc = h.new_zeros(h.shape[:2] + (cin_p,), dtype=compute_dtype)
            hc[..., :cin] = h
        y = F.conv2d(hc.transpose(1, 2).unsqueeze(2), wt, padding=(0, PAD))  # [B, Cout, 1, T]
        p = _floor_pool(y.permute(0, 2, 3, 1).flatten(1, 2))  # [B, T//2, Cout]
        out_dtype = compute_dtype if i + 1 < n_front else torch.float32
        h = torch.add(p, folded[f"b{i}"], out=torch.empty_like(p, dtype=out_dtype)).relu_()
    return h


def _check_cuda(x: torch.Tensor, folded: Folded, compute_dtype: torch.dtype) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"hybrid_ecgcnn kernels need a CUDA tensor, got {x.device}")
    if x.dim() != 3 or x.dtype != torch.float32:
        raise TypeError(f"expected f32 [B, T, C], got {x.dtype} {tuple(x.shape)}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    for key, v in folded.items():
        if key != "n_blocks" and (v.device != x.device or v.dtype != torch.float32
                                  or not v.is_contiguous()):
            raise ValueError(f"folded[{key!r}] must be contiguous f32 on {x.device}")


def hybrid_ecgcnn_logits(x: torch.Tensor, folded: Folded, split: int = 2,
                         compute_dtype: torch.dtype = torch.bfloat16, normalize: bool = True,
                         weights: Optional[dict] = None) -> torch.Tensor:
    """x [B, T, 12] raw -> logits [B, num_labels].

    ``folded`` from ``fold_bn_into_conv`` on x's device; the first ``split``
    blocks run on the framework, the rest on the kernels.  ``weights`` from
    ``prepare_weights(folded, split, compute_dtype)``, or None to build them.
    """
    global launches
    if x.device.type == "cpu":
        return hybrid_ecgcnn_logits_plain(x, folded, split, compute_dtype, normalize)
    _check_args(folded, split)
    if weights is not None and (weights["split"], weights["dtype"]) != (split, compute_dtype):
        raise ValueError(f"weights were prepared for split={weights['split']} "
                         f"{weights['dtype']}, not split={split} {compute_dtype}")
    _check_cuda(x, folded, compute_dtype)
    if weights is None:
        weights = prepare_weights(folded, split, compute_dtype)
    bsz = x.shape[0]
    num_labels = folded["head_b"].shape[0]
    if bsz == 0:
        return torch.empty((0, num_labels), dtype=torch.float32, device=x.device)
    lib = _build.load_library("fused_ecgcnn", k2._SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dev = x.get_device()
    f32 = compute_dtype == torch.float32
    with precision_scope("highest" if f32 else None):
        h = zscore_per_lead_batch(x) if normalize else x
        h = _front(h, folded, weights["front"], compute_dtype)
    for i in range(split, int(folded["n_blocks"])):
        wt, b = weights["deep"][i - split], folded[f"b{i}"]
        if f32:
            h = k2.conv_block_tf32x3(h, wt, b)
        else:
            h = _tc_conv(h, wt, b, h.shape[1], PAD)
    pw, hw = folded["proj_w"], folded["head_w"]
    logits = torch.empty((bsz, num_labels), dtype=torch.float32, device=x.device)
    err = lib.ptbxl_tail(dev, h.data_ptr(), pw.data_ptr(), folded["proj_b"].data_ptr(),
                         hw.data_ptr(), folded["head_b"].data_ptr(), logits.data_ptr(),
                         bsz, h.shape[1], pw.shape[0], pw.shape[1], num_labels,
                         int(not f32), stream)
    _build.check(lib, err, "tail launch")
    launches += 1
    return logits


def hybrid_ecgcnn_probs(x: torch.Tensor, folded: Folded,
                        compute_dtype: torch.dtype = torch.bfloat16, normalize: bool = True,
                        split: int = 2, weights: Optional[dict] = None) -> torch.Tensor:
    """x [B, T, 12] raw -> probs; ``n_blocks`` is read from ``folded``."""
    return torch.sigmoid(hybrid_ecgcnn_logits(x, folded, split, compute_dtype, normalize,
                                              weights))


# -- P3: one conv layer ----------------------------------------------------------

def _check_layer(x: torch.Tensor, w2d: torch.Tensor, b: torch.Tensor, mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.dim() != 3 or x.shape[1] < 2 * PAD + 2:
        raise ValueError(f"expected a pre-padded [B, T+14, Cin] with T >= 2, got {tuple(x.shape)}")
    cin = x.shape[2]
    if tuple(w2d.shape) != (K * cin, b.shape[0]):
        raise ValueError(f"w must be [15*Cin, Cout] = [{K * cin}, {b.shape[0]}], "
                         f"got {tuple(w2d.shape)}")
    return cin


def conv_layer_plain(x: torch.Tensor, w2d: torch.Tensor, b: torch.Tensor,
                     mode: str = "im2col") -> torch.Tensor:
    """Plain version of P3's layer: x [B, T+14, Cin] pre-padded, w2d [15*Cin, Cout],
    b [Cout] -> [B, T//2, Cout] f32; bf16 operands, f32 sums (TF32 off).

    ``im2col``: one product over the im2col; ``direct``: 15 shifted products.
    """
    cin = _check_layer(x, w2d, b, mode)
    with highest_precision():
        if mode == "im2col":
            return _im2col_block_plain(x.float(), w2d, b, torch.bfloat16)
        return k2._conv_block_plain(x.float(), w2d.reshape(K, cin, -1), b, torch.bfloat16)


def conv_layer(x: torch.Tensor, w2d: torch.Tensor, b: torch.Tensor,
               mode: str = "im2col") -> torch.Tensor:
    """P3's layer on the card (``mode`` im2col: the tensor-core conv block;
    direct: K2's bf16 FMA conv block); see ``conv_layer_plain``."""
    global launches_layer
    if x.device.type == "cpu":
        return conv_layer_plain(x, w2d, b, mode)
    cin = _check_layer(x, w2d, b, mode)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv_layer kernels need a CUDA tensor, got {x.device}")
    for name, v in (("x", x), ("w", w2d), ("b", b)):
        if v.device != x.device or v.dtype != torch.float32:
            raise TypeError(f"{name} must be f32 on {x.device}, got {v.dtype} on {v.device}")
    x, w2d, b = x.contiguous(), w2d.contiguous(), b.contiguous()
    bsz, tx, _ = x.shape
    cout = w2d.shape[1]
    t = tx - 2 * PAD
    if mode == "im2col":
        y = _tc_conv(x, tc_weight(w2d.view(K, cin, cout)), b, t, 0)
    else:
        if cout % 32:
            raise ValueError(f"direct mode needs Cout % 32 == 0, got {cout}")
        lib = _build.load_library("fused_ecgcnn", k2._SIGNATURES)
        y = torch.empty((bsz, t // 2, cout), dtype=torch.float32, device=x.device)
        err = lib.ptbxl_conv_block_valid(
            x.get_device(), x.data_ptr(), w2d.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, tx,
            cin, cout, torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, err, "direct conv layer launch")
    launches_layer += 1
    return y



# -- P4: one conv layer on a channel-major input --------------------------------

def _check_layer_cf(x: torch.Tensor, w2d: torch.Tensor, b: torch.Tensor) -> int:
    if x.dim() != 3 or x.shape[2] < 2 * PAD + 2:
        raise ValueError(f"expected a time-padded [B, Cpad, T+14] with T >= 2, "
                         f"got {tuple(x.shape)}")
    cpad = x.shape[1]
    if tuple(w2d.shape) != (K * cpad, b.shape[0]):
        raise ValueError(f"w must be [15*Cpad, Cout] = [{K * cpad}, {b.shape[0]}], "
                         f"got {tuple(w2d.shape)}")
    return cpad


def conv_layer_cf_plain(x: torch.Tensor, w2d: torch.Tensor, b: torch.Tensor,
                        transpose_out: bool = True) -> torch.Tensor:
    """Plain version of P4's layer: x [B, Cpad, T+14], w2d [15*Cpad, Cout] with
    row ``k*Cpad + c``, b [Cout] -> ``[B, Cout, T//2]`` (``transpose_out``) or
    ``[B, T//2, Cout]`` f32: ``relu(sum_k sum_c bf16(x[b,c,t+k]) *
    bf16(W[k*Cpad+c,o]) + b)`` with f32 sums (TF32 off), then the floor pool."""
    _check_layer_cf(x, w2d, b)
    with highest_precision():
        y = _im2col_block_plain(x.float().transpose(1, 2), w2d, b, torch.bfloat16)
    return y.transpose(1, 2).contiguous() if transpose_out else y


def conv_layer_cf(x: torch.Tensor, w2d: torch.Tensor, b: torch.Tensor,
                  transpose_out: bool = True) -> torch.Tensor:
    """P4's layer on the card (``ptbxl_conv_layer_cf``); see ``conv_layer_cf_plain``.
    Needs Cpad % 16 == 0 and Cout % 32 == 0."""
    global launches_layer_cf
    if x.device.type == "cpu":
        return conv_layer_cf_plain(x, w2d, b, transpose_out)
    cpad = _check_layer_cf(x, w2d, b)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv_layer_cf needs a CUDA tensor, got {x.device}")
    for name, v in (("x", x), ("w", w2d), ("b", b)):
        if v.device != x.device or v.dtype != torch.float32:
            raise TypeError(f"{name} must be f32 on {x.device}, got {v.dtype} on {v.device}")
    cout = w2d.shape[1]
    if cpad % 16 or cout % 32:
        raise ValueError(f"conv_layer_cf needs Cpad % 16 == 0 and Cout % 32 == 0, "
                         f"got Cpad={cpad}, Cout={cout}")
    x, b = x.contiguous(), b.contiguous()
    bsz, _, tx = x.shape
    half = (tx - 2 * PAD) // 2
    shape = (bsz, cout, half) if transpose_out else (bsz, half, cout)
    y = torch.empty(shape, dtype=torch.float32, device=x.device)
    wt = w2d.reshape(K, cpad, cout).to(torch.bfloat16).contiguous()
    lib = _build.load_library("hybrid_ecgcnn", _SIGNATURES)
    err = lib.ptbxl_conv_layer_cf(
        x.get_device(), x.data_ptr(), wt.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, tx, cpad,
        cout, int(transpose_out), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "channel-major conv layer launch")
    launches_layer_cf += 1
    return y
