"""K2 and K3: the ECGCNN and FiLM multimodal inference forwards, CUDA
kernels + plain PyTorch versions.

Replaces ``ptbxl_tpu/ops/pallas/fused_ecgcnn.py``: ``_make_kernel`` (:89),
``_fused_logits_jit`` (:155, pallas_call :194), ``fused_ecgcnn_logits`` /
``_probs`` (:138/:213) and the host helper ``fold_bn_into_conv`` (:42) (K2);
``_make_mm_kernel`` (:260), ``_fused_mm_jit`` (:319, pallas_call :348),
``fused_multimodal_logits`` / ``_probs`` (:305/:360) and ``fold_multimodal``
(:224) (K3).  Kernels: ``ptbxl_torch/csrc/fused_ecgcnn.cu``, plus K1's
``zscore_stats``.

What bounds it on the H100: operations (1.133 GFLOP a record at T=5000 of
non-tensor-core FP32).  The TPU kernel keeps a whole record on chip; an H100
block cannot (227 KB of shared memory, a 240 KB input), so the forward is a
short sequence of launches on the current stream: ``zscore_stats`` (when
``normalize``), one conv-block kernel per block (z-score applied on load for
block 0, 15 taps accumulated in f32 registers, folded bias, ReLU and floor
pool in registers, pooled tile written), and one tail kernel (mean over T,
proj, head).  Intermediates go through device memory, allocated here with
``torch.empty``; the source says why that costs little at f32.  K3 runs the
same backbone launches and ends in its own tail kernel (mean over T, proj,
demographics MLP, FiLM, head); its bound is K2's.

A CPU tensor takes the plain versions (``fused_ecgcnn_logits_plain``,
``fused_multimodal_logits_plain``), which follow ``_make_kernel``'s and
``_make_mm_kernel``'s arithmetic: 15 shifted products, the folded bias, the
floor pool, a ones-mean and bf16 operand rounding where the JAX products
round.  A CUDA tensor launches the kernels or raises.  ``launches`` counts
K2 forwards launched on the card and ``launches_mm`` K3 forwards (each is
the sequence above).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from ptbxl_torch.models.ecg_cnn import BN_EPS
from ptbxl_torch.ops.kernels import _build
from ptbxl_torch.ops.kernels.zscore import zscore_plain, zscore_stats
from ptbxl_torch.utils.device import highest_precision

K = 15
PAD = K // 2
MAX_LABELS = 128  # the TPU kernels' output tile (fused_ecgcnn.py:131, :298)
launches = 0
launches_mm = 0

_I, _P = _build.INT, _build.VOIDP
_SIGNATURES = {
    # device, x, stats, w, b, y, B, T, Cin, Cout, bf16, stream
    "ptbxl_conv_block": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # device, x, w, b, y, B, Tx, Cin, Cout, bf16, stream (pre-padded x, P3's direct layer)
    "ptbxl_conv_block_valid": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # device, h, pw, pb, hw, hb, logits, B, T, C, F, L, bf16, stream
    "ptbxl_tail": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # device, h, pw, pb, fc1_w, fc1_b, fc2_w, fc2_b, film_w, film_b, hw, hb, demo, logits,
    # B, T, C, F, D, H1, H, L, bf16, stream
    "ptbxl_mm_tail": [_I] + [_P] * 13 + [_I] * 9 + [_P],
}

Folded = Dict[str, object]


def fold_bn_into_conv(state: Mapping[str, torch.Tensor]) -> Folded:
    """Fold BatchNorm running stats into the conv weights (inference only).

    ``state`` is a reference-layout state dict (``backbone.{i}.net.{0,1}.*``,
    ``proj.*``, ``head.*``; no head for a backbone).  Returns the JAX
    package's folded layout: ``w{i}`` [K, Cin, Cout] = w * scale/sqrt(var+eps),
    ``b{i}`` [Cout] = (b - mean) * scale/sqrt(var+eps) + bias, ``proj_w``
    [C, F], ``head_w`` [F, L] (in, out), their biases and ``n_blocks``; f32,
    on the state's device.
    """
    out: Folded = {}
    i = 0
    while f"backbone.{i}.net.0.weight" in state:
        p = f"backbone.{i}.net."
        inv = state[p + "1.weight"].float() / torch.sqrt(state[p + "1.running_var"].float() + BN_EPS)
        w = state[p + "0.weight"].float().permute(2, 1, 0)  # (out,in,k) -> (k,in,out)
        out[f"w{i}"] = (w * inv[None, None, :]).contiguous()
        out[f"b{i}"] = ((state[p + "0.bias"].float() - state[p + "1.running_mean"].float()) * inv
                        + state[p + "1.bias"].float()).contiguous()
        i += 1
    out["n_blocks"] = i
    for name in ("proj", "head"):
        if name + ".weight" in state:
            _dense(state, name, name, out)
    return out


def _dense(state: Mapping[str, torch.Tensor], src: str, dst: str, out: Folded) -> None:
    out[f"{dst}_w"] = state[src + ".weight"].float().t().contiguous()  # (out, in) -> (in, out)
    out[f"{dst}_b"] = state[src + ".bias"].float().contiguous()


def fold_multimodal(state: Mapping[str, torch.Tensor]) -> Folded:
    """The multimodal state dict folded for K3.

    The ECG backbone (``ecg_backbone.*``) folds as in ``fold_bn_into_conv``;
    then ``fc1_w/b``, ``fc2_w/b`` (``demo_encoder.mlp.{0,2}``), ``film_w/b``
    and ``head_w/b`` are added as (in, out), f32 and contiguous.
    """
    pre = "ecg_backbone."
    out = fold_bn_into_conv({k[len(pre):]: v for k, v in state.items() if k.startswith(pre)})
    for src, dst in (("demo_encoder.mlp.0", "fc1"), ("demo_encoder.mlp.2", "fc2"),
                     ("film_gen", "film"), ("head", "head")):
        _dense(state, src, dst, out)
    return out


def _round(v: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Operand rounding of a ``compute_dtype`` product with f32 accumulation."""
    return v if compute_dtype == torch.float32 else v.to(compute_dtype).float()


def _conv_block_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      compute_dtype: torch.dtype) -> torch.Tensor:
    """x [B, T+14, Cin] (padded) -> relu(conv + b) floor-pooled [B, T//2, Cout]."""
    t_out = x.shape[1] - 2 * PAD
    xc, wc = _round(x, compute_dtype), _round(w, compute_dtype)
    acc = torch.zeros(x.shape[0], t_out, w.shape[2], dtype=torch.float32, device=x.device)
    for k in range(K):
        acc = acc + torch.matmul(xc[:, k:k + t_out, :], wc[k])
    h = torch.relu(acc + b[None, None, :])
    half = t_out // 2  # MaxPool1d(2) floors odd lengths
    return h[:, :2 * half].reshape(h.shape[0], half, 2, -1).amax(dim=2)


def _dot1(v: torch.Tensor, w: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``v @ w`` with both operands rounded to ``compute_dtype``, f32 sums (``_dot1``, :252)."""
    return torch.matmul(_round(v, compute_dtype), _round(w, compute_dtype))


def _z_ecg_plain(x: torch.Tensor, folded: Folded, compute_dtype: torch.dtype,
                 normalize: bool) -> torch.Tensor:
    """z-score, the folded blocks, the ones-mean and proj: x [B, T, C] -> [B, F] f32."""
    h = x.float()
    if normalize:
        h = zscore_plain(h)
    for i in range(int(folded["n_blocks"])):
        hp = torch.nn.functional.pad(h, (0, 0, PAD, PAD))
        h = _conv_block_plain(hp, folded[f"w{i}"], folded[f"b{i}"], compute_dtype)
    ones = torch.full((h.shape[1],), 1.0 / h.shape[1], dtype=torch.float32, device=h.device)
    g = torch.einsum("t,btc->bc", ones, h)
    return _dot1(g, folded["proj_w"], compute_dtype) + folded["proj_b"]


def fused_ecgcnn_logits_plain(x: torch.Tensor, folded: Folded,
                              compute_dtype: torch.dtype = torch.float32,
                              normalize: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the fused forward: x [B, T, C] -> logits [B, L].

    Runs its f32 products in full f32 (TF32 off) on the card as well.
    """
    with highest_precision():
        z = _z_ecg_plain(x, folded, compute_dtype, normalize)
        return _dot1(z, folded["head_w"], compute_dtype) + folded["head_b"]


def _check_labels(folded: Folded) -> None:
    if folded["head_b"].shape[0] > MAX_LABELS:
        raise ValueError(f"fused kernels support num_labels <= {MAX_LABELS}")


def fused_multimodal_logits_plain(x: torch.Tensor, demo: torch.Tensor, folded: Folded,
                                  compute_dtype: torch.dtype = torch.float32,
                                  normalize: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K3: x [B, T, C], demo [B, D] -> logits [B, L].

    ``_make_mm_kernel`` step by step: backbone and proj as in K2, then the
    demographics MLP, FiLM (``gamma = 1 + tanh``; ``z_ecg`` enters in f32)
    and the head, rounding both operands of every product to
    ``compute_dtype``.  TF32 off.
    """
    _check_labels(folded)
    with highest_precision():
        z_ecg = _z_ecg_plain(x, folded, compute_dtype, normalize)
        d = demo.float()
        h1 = torch.relu(_dot1(d, folded["fc1_w"], compute_dtype) + folded["fc1_b"])
        h2 = torch.relu(_dot1(h1, folded["fc2_w"], compute_dtype) + folded["fc2_b"])
        film = _dot1(h2, folded["film_w"], compute_dtype) + folded["film_b"]
        feat = z_ecg.shape[1]
        gamma = 1.0 + torch.tanh(film[:, :feat])
        z_cond = gamma * z_ecg + film[:, feat:]
        return _dot1(z_cond, folded["head_w"], compute_dtype) + folded["head_b"]


def _check(x: torch.Tensor, folded: Folded, compute_dtype: torch.dtype) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_ecgcnn kernels need a CUDA tensor, got {x.device}")
    if x.dim() != 3 or x.dtype != torch.float32:
        raise TypeError(f"expected f32 [B, T, C], got {x.dtype} {tuple(x.shape)}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    t = x.shape[1]
    for i in range(int(folded["n_blocks"])):
        w = folded[f"w{i}"]
        if t < 2 or w.shape[2] % 32:
            raise ValueError(f"block {i}: needs T >= 2 and Cout % 32 == 0, "
                             f"got T={t}, Cout={w.shape[2]}")
        t //= 2
    for key, v in folded.items():
        if key != "n_blocks" and (v.device != x.device or v.dtype != torch.float32
                                  or not v.is_contiguous()):
            raise ValueError(f"folded[{key!r}] must be contiguous f32 on {x.device}")


def _backbone(lib, x: torch.Tensor, folded: Folded, bf16: int, normalize: bool,
              stream: int) -> torch.Tensor:
    """Launch ``zscore_stats`` (when ``normalize``) and one conv-block kernel a block."""
    b, t, _ = x.shape
    dev = x.get_device()
    stats = zscore_stats(x) if normalize else None
    h = x
    for i in range(int(folded["n_blocks"])):
        w, bias = folded[f"w{i}"], folded[f"b{i}"]
        cin, cout = w.shape[1], w.shape[2]
        y = torch.empty((b, t // 2, cout), dtype=torch.float32, device=x.device)
        err = lib.ptbxl_conv_block(
            dev, h.data_ptr(), stats.data_ptr() if (i == 0 and stats is not None) else None,
            w.data_ptr(), bias.data_ptr(), y.data_ptr(), b, t, cin, cout, bf16, stream)
        _build.check(lib, err, f"conv block {i} launch")
        h, t = y, t // 2
    return h


def fused_ecgcnn_logits(x: torch.Tensor, folded: Folded,
                        compute_dtype: torch.dtype = torch.float32,
                        normalize: bool = True) -> torch.Tensor:
    """x: [B, T, 12] raw signals -> logits [B, num_labels].

    ``folded`` from ``fold_bn_into_conv`` on x's device.  ``normalize``
    applies the per-lead z-score (False for pre-normalized input).
    """
    global launches
    if x.device.type == "cpu":
        return fused_ecgcnn_logits_plain(x, folded, compute_dtype, normalize)
    _check(x, folded, compute_dtype)
    x = x.contiguous()
    b = x.shape[0]
    num_labels = folded["head_b"].shape[0]
    if b == 0:
        return torch.empty((0, num_labels), dtype=torch.float32, device=x.device)
    lib = _build.load_library("fused_ecgcnn", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bf16 = int(compute_dtype == torch.bfloat16)
    h = _backbone(lib, x, folded, bf16, normalize, stream)
    pw, hw = folded["proj_w"], folded["head_w"]
    logits = torch.empty((b, num_labels), dtype=torch.float32, device=x.device)
    err = lib.ptbxl_tail(
        x.get_device(), h.data_ptr(), pw.data_ptr(), folded["proj_b"].data_ptr(), hw.data_ptr(),
        folded["head_b"].data_ptr(), logits.data_ptr(), b, h.shape[1], pw.shape[0], pw.shape[1],
        num_labels, bf16, stream)
    _build.check(lib, err, "tail launch")
    launches += 1
    return logits


def fused_ecgcnn_probs(x: torch.Tensor, folded: Folded,
                       compute_dtype: torch.dtype = torch.float32,
                       normalize: bool = True) -> torch.Tensor:
    return torch.sigmoid(fused_ecgcnn_logits(x, folded, compute_dtype, normalize))


def fused_multimodal_logits(x: torch.Tensor, demo: torch.Tensor, folded: Folded,
                            compute_dtype: torch.dtype = torch.float32,
                            normalize: bool = True) -> torch.Tensor:
    """x: [B, T, 12] raw signals, demo: [B, 5] -> logits [B, num_labels] (K3).

    ``folded`` from ``fold_multimodal`` on x's device; the demo rows are
    passed as they are (D = ``fc1_w.shape[0]``).
    """
    global launches_mm
    _check_labels(folded)
    if x.device.type == "cpu":
        return fused_multimodal_logits_plain(x, demo, folded, compute_dtype, normalize)
    _check(x, folded, compute_dtype)
    b = x.shape[0]
    d_in = folded["fc1_w"].shape[0]
    if (demo.device != x.device or demo.dtype != torch.float32
            or tuple(demo.shape) != (b, d_in)):
        raise ValueError(f"demo must be f32 [{b}, {d_in}] on {x.device}, "
                         f"got {demo.dtype} {tuple(demo.shape)} on {demo.device}")
    x, demo = x.contiguous(), demo.contiguous()
    num_labels = folded["head_b"].shape[0]
    if b == 0:
        return torch.empty((0, num_labels), dtype=torch.float32, device=x.device)
    lib = _build.load_library("fused_ecgcnn", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bf16 = int(compute_dtype == torch.bfloat16)
    h = _backbone(lib, x, folded, bf16, normalize, stream)
    pw, w1, w2 = folded["proj_w"], folded["fc1_w"], folded["fc2_w"]
    c, f, h1, hid = pw.shape[0], pw.shape[1], w1.shape[1], w2.shape[1]
    want = {"proj_w": (h.shape[2], f), "fc2_w": (h1, hid), "film_w": (hid, 2 * f),
            "head_w": (f, num_labels)}
    for key, shape in want.items():
        if tuple(folded[key].shape) != shape:
            raise ValueError(f"folded[{key!r}] must be {shape}, got {tuple(folded[key].shape)}")
    ptrs = [folded[f"{n}_{s}"].data_ptr() for n in ("proj", "fc1", "fc2", "film", "head")
            for s in "wb"]
    logits = torch.empty((b, num_labels), dtype=torch.float32, device=x.device)
    err = lib.ptbxl_mm_tail(
        x.get_device(), h.data_ptr(), *ptrs, demo.data_ptr(), logits.data_ptr(),
        b, h.shape[1], c, f, d_in, h1, hid, num_labels, bf16, stream)
    _build.check(lib, err, "multimodal tail launch")
    launches_mm += 1
    return logits


def fused_multimodal_probs(x: torch.Tensor, demo: torch.Tensor, folded: Folded,
                           compute_dtype: torch.dtype = torch.float32,
                           normalize: bool = True) -> torch.Tensor:
    return torch.sigmoid(fused_multimodal_logits(x, demo, folded, compute_dtype, normalize))
