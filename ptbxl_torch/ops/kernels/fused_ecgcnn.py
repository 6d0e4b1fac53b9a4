"""K2 and K3: the ECGCNN and FiLM multimodal inference forwards, CUDA
kernels + plain PyTorch versions.

Replaces ``ptbxl_tpu/ops/pallas/fused_ecgcnn.py``: ``_make_kernel`` (:89),
``_fused_logits_jit`` (:155, pallas_call :194), ``fused_ecgcnn_logits`` /
``_probs`` (:138/:213) and the host helper ``fold_bn_into_conv`` (:42) (K2);
``_make_mm_kernel`` (:260), ``_fused_mm_jit`` (:319, pallas_call :348),
``fused_multimodal_logits`` / ``_probs`` (:305/:360) and ``fold_multimodal``
(:224) (K3).  Kernels: ``ptbxl_torch/csrc/fused_ecgcnn.cu``, plus K1's
``zscore_stats``.

What bounds it on the H100: operations, 1.133 GFLOP a record at T=5000: at
B=512, 8.65 ms at the FP32 FMA rate, 3.52 ms as the three TF32 products a
f32 product takes on the tensor cores (3xTF32, 495 TFLOP/s).  The TPU kernel
keeps a whole record on chip; an H100 block cannot (227 KB of shared memory,
a 240 KB input), so the forward is a short sequence of launches on the
current stream: ``zscore_stats`` (when ``normalize``), one conv-block kernel
per block, and one tail kernel (mean over T, proj, head).  In f32 the conv
block is an implicit GEMM on the tensor cores in 3xTF32: the input is split
as ``big + small`` in registers, the weights once on the host
(``prepare_weights``), and each product is three TF32 ``mma.sync`` products
with f32 sums, to about 2^-22 of each product; the z-score is applied while
block 0's input is staged, and bias, ReLU and the floor pool happen in the
epilogue.  In bf16 it is an FMA kernel with bf16-rounded operands.
Intermediates go through device memory, allocated here with
``torch.empty``; the source says why that costs little.  K3 runs the same
backbone launches and ends in its own tail kernel (mean over T, proj,
demographics MLP, FiLM, head); its bound is K2's.  Left for later: ``wgmma``
with TF32 operands fed by TMA, and fusing blocks.

A CPU tensor takes the plain versions (``fused_ecgcnn_logits_plain``,
``fused_multimodal_logits_plain``), which follow ``_make_kernel``'s and
``_make_mm_kernel``'s arithmetic: 15 shifted products in exact f32 (TF32
off), the folded bias, the floor pool, a ones-mean and bf16 operand rounding
where the JAX products round.  A CUDA tensor launches the kernels or raises.
``launches`` counts K2 forwards launched on the card and ``launches_mm`` K3
forwards (each is the sequence above).

The probability forwards are also the custom ops ``ptbxl::fused_ecgcnn_probs``
and ``ptbxl::fused_multimodal_probs`` (registered when this module is
imported), which take tensors and scalars alone: the folded dict and the
split weights travel as one tensor list (``_op_params``).  Only an exported
program calls them (``fused_*_probs_op``; ``ptbxl_torch/serving.py``,
``engine='kernel'``): their body is ``fused_*_probs``, the same launch
sequence ``Predictor``'s kernel engine calls directly, without the op's
dispatch.  The fake implementation gives ``[B, L]`` f32 from the shapes alone.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ptbxl_torch.models.ecg_cnn import BN_EPS
from ptbxl_torch.ops.kernels import _build
from ptbxl_torch.ops.kernels.probes import tf32_round
from ptbxl_torch.ops.kernels.zscore import zscore_plain, zscore_stats
from ptbxl_torch.utils.device import highest_precision

K = 15
PAD = K // 2
MAX_LABELS = 128  # the TPU kernels' output tile (fused_ecgcnn.py:131, :298)
CH_MULT = 8  # the tensor-core conv block pads channels to a multiple of the mma depth
launches = 0
launches_mm = 0

_I, _P = _build.INT, _build.VOIDP
_SIGNATURES = {
    # device, x, stats, w3, b, y, B, T, Cin, CinP, Cout, stream
    "ptbxl_conv_block_tf32x3": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # device, x, stats, w, b, y, B, T, Cin, Cout, stream
    "ptbxl_conv_block_bf16": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # device, x, w, b, y, B, Tx, Cin, Cout, stream (pre-padded x, P3's direct layer)
    "ptbxl_conv_block_valid": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
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


def tf32x3_weight(w: torch.Tensor) -> torch.Tensor:
    """[15, Cin, Cout] f32 -> the tensor-core conv block's weights [2, Cout, 15*CinP] f32.

    Channels are zero-padded to ``CinP``, a multiple of ``CH_MULT``; column
    ``k*CinP + c`` of row ``o`` is ``w[k, c, o]``, so the kernel's B fragments
    load without a transpose.  Plane 0 is ``big = tf32_round(w)``, plane 1
    ``small = tf32_round(w - big)``: both TF32 values, ``big + small`` within
    2^-22 of ``w``.
    """
    k, cin, cout = w.shape
    cin_p = -(-cin // CH_MULT) * CH_MULT
    wt = F.pad(w.float(), (0, 0, 0, cin_p - cin)).permute(2, 0, 1).reshape(cout, k * cin_p)
    big = tf32_round(wt)
    return torch.stack([big, tf32_round(wt - big)]).contiguous()


def prepare_weights(folded: Folded) -> list:
    """The f32 conv blocks' split weights (``tf32x3_weight``), one a block, built
    once and passed as ``weights``; without them a call builds its own."""
    return [tf32x3_weight(folded[f"w{i}"]) for i in range(int(folded["n_blocks"]))]


def conv_block_tf32x3_plain(x: torch.Tensor, w3: torch.Tensor, b: torch.Tensor,
                            stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``conv_block_tf32x3``: the exact-f32 block
    (``_conv_block_plain``, TF32 off) with ``w = big + small`` read back from ``w3``."""
    cin = x.shape[2]
    cout, cin_p = w3.shape[1], w3.shape[2] // K
    w = (w3[0] + w3[1]).view(cout, K, cin_p).permute(1, 2, 0)[:, :cin]
    h = x if stats is None else (x - stats[:, None, :, 0]) / stats[:, None, :, 1]
    with highest_precision():
        return _conv_block_plain(F.pad(h, (0, 0, PAD, PAD)), w, b, torch.float32)


def conv_block_tf32x3(x: torch.Tensor, w3: torch.Tensor, b: torch.Tensor,
                      stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One f32 conv block on the tensor cores (3xTF32): x [B, T, Cin] f32 ->
    pool(relu(conv_SAME(z(x), w) + b)) [B, T//2, Cout], where ``w3`` is
    ``tf32x3_weight(w)`` and ``z`` the z-score from ``stats`` ([B, Cin, 2],
    ``zscore_stats``) or none.  The kernel picks its tile from the grid.  A
    CPU tensor takes ``conv_block_tf32x3_plain``."""
    bsz, t, cin = x.shape
    cout, cin_p = w3.shape[1], w3.shape[2] // K
    if (t < 2 or cout % 32 or cin_p % CH_MULT or cin_p < cin
            or tuple(w3.shape) != (2, cout, K * cin_p) or tuple(b.shape) != (cout,)):
        raise ValueError(f"conv block needs T >= 2, Cout % 32 == 0 and w3 [2, Cout, 15*CinP] "
                         f"with CinP % {CH_MULT} == 0, CinP >= Cin; got x {tuple(x.shape)}, "
                         f"w3 {tuple(w3.shape)}, b {tuple(b.shape)}")
    if stats is not None and tuple(stats.shape) != (bsz, cin, 2):
        raise ValueError(f"stats must be [{bsz}, {cin}, 2], got {tuple(stats.shape)}")
    for name, v in (("x", x), ("w3", w3), ("b", b), ("stats", stats)):
        if v is not None and (v.device != x.device or v.dtype != torch.float32
                              or not v.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 on {x.device}")
    if x.device.type == "cpu":
        return conv_block_tf32x3_plain(x, w3, b, stats)
    y = torch.empty((bsz, t // 2, cout), dtype=torch.float32, device=x.device)
    lib = _build.load_library("fused_ecgcnn", _SIGNATURES)
    err = lib.ptbxl_conv_block_tf32x3(
        x.get_device(), x.data_ptr(), None if stats is None else stats.data_ptr(), w3.data_ptr(),
        b.data_ptr(), y.data_ptr(), bsz, t, cin, cin_p, cout,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "tf32x3 conv block launch")
    return y


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


def _backbone(x: torch.Tensor, folded: Folded, bf16: int, normalize: bool,
              weights: Optional[list]) -> torch.Tensor:
    """Launch ``zscore_stats`` (when ``normalize``) and one conv-block kernel a block:
    the 3xTF32 block with ``weights`` (``prepare_weights``, built here when None)
    in f32, the bf16 block in bf16 (CUDA tensors only)."""
    b, t, _ = x.shape
    stats = zscore_stats(x) if normalize else None
    n_blocks = int(folded["n_blocks"])
    if not bf16:
        weights = prepare_weights(folded) if weights is None else weights
        if len(weights) != n_blocks:
            raise ValueError(f"weights hold {len(weights)} blocks, the model {n_blocks}")
    h = x
    for i in range(n_blocks):
        w, bias = folded[f"w{i}"], folded[f"b{i}"]
        st = stats if i == 0 else None
        if bf16:
            cin, cout = w.shape[1], w.shape[2]
            y = torch.empty((b, t // 2, cout), dtype=torch.float32, device=x.device)
            lib = _build.load_library("fused_ecgcnn", _SIGNATURES)
            err = lib.ptbxl_conv_block_bf16(
                x.get_device(), h.data_ptr(), None if st is None else st.data_ptr(),
                w.data_ptr(), bias.data_ptr(), y.data_ptr(), b, t, cin, cout,
                torch.cuda.current_stream(x.device).cuda_stream)
            _build.check(lib, err, f"conv block {i} launch")
        else:
            y = conv_block_tf32x3(h, weights[i], bias, st)
        h, t = y, t // 2
    return h


def card_logits(x: torch.Tensor, folded: Folded, compute_dtype: torch.dtype,
                normalize: bool = True, weights: Optional[list] = None) -> torch.Tensor:
    """K2's launch sequence, not counted: ``_backbone``, then the tail kernel
    (``ptbxl_tail``: mean over T, proj, head) -> logits [B, L].  K4 runs it
    as its f32 route.  On CPU tensors (f32) each launch takes its plain
    version: the 3xTF32 blocks' and an exact-f32 tail."""
    bf16 = int(compute_dtype == torch.bfloat16)
    h = _backbone(x, folded, bf16, normalize, weights)
    pw, hw = folded["proj_w"], folded["head_w"]
    if h.device.type == "cpu":
        with highest_precision():
            return (h.mean(1) @ pw + folded["proj_b"]) @ hw + folded["head_b"]
    b, num_labels = h.shape[0], hw.shape[1]
    logits = torch.empty((b, num_labels), dtype=torch.float32, device=h.device)
    lib = _build.load_library("fused_ecgcnn", _SIGNATURES)
    err = lib.ptbxl_tail(
        h.get_device(), h.data_ptr(), pw.data_ptr(), folded["proj_b"].data_ptr(), hw.data_ptr(),
        folded["head_b"].data_ptr(), logits.data_ptr(), b, h.shape[1], pw.shape[0], pw.shape[1],
        num_labels, bf16, torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(lib, err, "tail launch")
    return logits


def fused_ecgcnn_logits(x: torch.Tensor, folded: Folded,
                        compute_dtype: torch.dtype = torch.float32,
                        normalize: bool = True, weights: Optional[list] = None) -> torch.Tensor:
    """x: [B, T, 12] raw signals -> logits [B, num_labels].

    ``folded`` from ``fold_bn_into_conv`` on x's device.  ``normalize``
    applies the per-lead z-score (False for pre-normalized input).
    ``weights`` from ``prepare_weights(folded)`` (f32 only), or None to build them.
    """
    global launches
    if x.device.type == "cpu":
        return fused_ecgcnn_logits_plain(x, folded, compute_dtype, normalize)
    _check(x, folded, compute_dtype)
    x = x.contiguous()
    if x.shape[0] == 0:
        return torch.empty((0, folded["head_b"].shape[0]), dtype=torch.float32, device=x.device)
    logits = card_logits(x, folded, compute_dtype, normalize, weights)
    launches += 1
    return logits


_ECG_DENSE = ("proj_w", "proj_b", "head_w", "head_b")
_MM_DENSE = ("proj_w", "proj_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b", "film_w", "film_b",
             "head_w", "head_b")


def _op_params(folded: Folded, weights: Optional[list], dense: Sequence[str]) -> List[torch.Tensor]:
    """The custom ops' tensor list: ``w0, b0, .., w{n-1}, b{n-1}``, the dense
    tail in ``dense`` order, then the split weights (none: built per call)."""
    n = int(folded["n_blocks"])
    return ([folded[f"{p}{i}"] for i in range(n) for p in "wb"]
            + [folded[k] for k in dense] + list(weights or []))


def _op_unpack(params: Sequence[torch.Tensor], n_blocks: int, dense: Sequence[str]
               ) -> Tuple[Folded, Optional[list]]:
    folded: Folded = {"n_blocks": n_blocks}
    for i in range(n_blocks):
        folded[f"w{i}"], folded[f"b{i}"] = params[2 * i], params[2 * i + 1]
    folded.update(zip(dense, params[2 * n_blocks:2 * n_blocks + len(dense)]))
    weights = list(params[2 * n_blocks + len(dense):])
    return folded, weights or None


def _op_out(x: torch.Tensor, params: Sequence[torch.Tensor], n_blocks: int,
            dense: Sequence[str]) -> torch.Tensor:
    head_b = params[2 * n_blocks + len(dense) - 1]
    return x.new_empty((x.shape[0], head_b.shape[0]), dtype=torch.float32)


@torch.library.custom_op("ptbxl::fused_ecgcnn_probs", mutates_args=())
def _ecgcnn_probs_op(x: torch.Tensor, params: List[torch.Tensor], n_blocks: int,
                     normalize: bool, bf16: bool) -> torch.Tensor:
    folded, weights = _op_unpack(params, n_blocks, _ECG_DENSE)
    dt = torch.bfloat16 if bf16 else torch.float32
    return fused_ecgcnn_probs(x, folded, dt, normalize, weights)


@_ecgcnn_probs_op.register_fake
def _(x, params, n_blocks, normalize, bf16):
    return _op_out(x, params, n_blocks, _ECG_DENSE)


def fused_ecgcnn_probs(x: torch.Tensor, folded: Folded,
                       compute_dtype: torch.dtype = torch.float32,
                       normalize: bool = True, weights: Optional[list] = None) -> torch.Tensor:
    return torch.sigmoid(fused_ecgcnn_logits(x, folded, compute_dtype, normalize, weights))


def fused_ecgcnn_probs_op(x: torch.Tensor, folded: Folded,
                          compute_dtype: torch.dtype = torch.float32,
                          normalize: bool = True, weights: Optional[list] = None) -> torch.Tensor:
    """``fused_ecgcnn_probs`` as one call of ``ptbxl::fused_ecgcnn_probs``."""
    return torch.ops.ptbxl.fused_ecgcnn_probs(
        x, _op_params(folded, weights, _ECG_DENSE), int(folded["n_blocks"]), normalize,
        compute_dtype == torch.bfloat16)


def fused_multimodal_logits(x: torch.Tensor, demo: torch.Tensor, folded: Folded,
                            compute_dtype: torch.dtype = torch.float32,
                            normalize: bool = True, weights: Optional[list] = None) -> torch.Tensor:
    """x: [B, T, 12] raw signals, demo: [B, 5] -> logits [B, num_labels] (K3).

    ``folded`` from ``fold_multimodal`` on x's device; the demo rows are
    passed as they are (D = ``fc1_w.shape[0]``).  ``weights`` as in
    ``fused_ecgcnn_logits``.
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
    bf16 = int(compute_dtype == torch.bfloat16)
    h = _backbone(x, folded, bf16, normalize, weights)
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
    lib = _build.load_library("fused_ecgcnn", _SIGNATURES)
    err = lib.ptbxl_mm_tail(
        x.get_device(), h.data_ptr(), *ptrs, demo.data_ptr(), logits.data_ptr(),
        b, h.shape[1], c, f, d_in, h1, hid, num_labels, bf16,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "multimodal tail launch")
    launches_mm += 1
    return logits


@torch.library.custom_op("ptbxl::fused_multimodal_probs", mutates_args=())
def _multimodal_probs_op(x: torch.Tensor, demo: torch.Tensor, params: List[torch.Tensor],
                         n_blocks: int, normalize: bool, bf16: bool) -> torch.Tensor:
    folded, weights = _op_unpack(params, n_blocks, _MM_DENSE)
    dt = torch.bfloat16 if bf16 else torch.float32
    return fused_multimodal_probs(x, demo, folded, dt, normalize, weights)


@_multimodal_probs_op.register_fake
def _(x, demo, params, n_blocks, normalize, bf16):
    return _op_out(x, params, n_blocks, _MM_DENSE)


def fused_multimodal_probs(x: torch.Tensor, demo: torch.Tensor, folded: Folded,
                           compute_dtype: torch.dtype = torch.float32,
                           normalize: bool = True, weights: Optional[list] = None) -> torch.Tensor:
    return torch.sigmoid(fused_multimodal_logits(x, demo, folded, compute_dtype, normalize,
                                                 weights))


def fused_multimodal_probs_op(x: torch.Tensor, demo: torch.Tensor, folded: Folded,
                              compute_dtype: torch.dtype = torch.float32,
                              normalize: bool = True, weights: Optional[list] = None
                              ) -> torch.Tensor:
    """``fused_multimodal_probs`` as one call of ``ptbxl::fused_multimodal_probs``."""
    return torch.ops.ptbxl.fused_multimodal_probs(
        x, demo, _op_params(folded, weights, _MM_DENSE), int(folded["n_blocks"]), normalize,
        compute_dtype == torch.bfloat16)
