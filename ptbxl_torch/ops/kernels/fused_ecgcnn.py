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
B=512, 8.65 ms at the FP32 FMA rate, 3.51 ms as the three TF32 products a
f32 product takes on the tensor cores (3xTF32, 495 TFLOP/s; the blocks 0.18
/ 0.48 / 0.95 / 1.91 ms).  The TPU kernel keeps a whole record on chip; an
H100 block cannot (227 KB of shared memory, a 240 KB input), so the forward
is a short sequence of launches on the current stream: ``zscore_stats``
(when ``normalize``), one conv-block kernel per block, and one tail kernel
(mean over T, proj, head).  In f32 the conv block is an implicit GEMM on
Hopper's warpgroup MMA in 3xTF32 (``wgmma`` m64nNk8, TF32 operands, f32
sums): each tile's input rows are staged once with their halo, read as
register-A fragments and split as ``big + small`` in registers; the weights
are split once on the host (``prepare_weights``, in ``wgmma``'s core-matrix
order) and streamed by a producer warp through a ring of stages of up to 64
reduction columns; each product is three TF32 products, small terms first,
into sums that restart every stage and are added up in f32, to about 2^-22
of each product.  The z-score is applied to block 0's staged rows, and bias,
ReLU and the floor pool happen in the epilogue.  The tile follows the grid
(m128 x n128 for blocks 2 and 3, m256 x n64 and m256 x n32 for blocks 1 and
0, m64 x n32 where a grid would not give every SM a tile); the source says
why.  Intermediates go through device memory, allocated here with
``torch.empty``.  K3 runs the same backbone launches and ends in its own
tail kernel (mean over T, proj, demographics MLP, FiLM, head); its bound is
K2's.  Left for later: fusing blocks.

In bf16 both run K4's launch sequence on the tensor cores
(``hybrid_ecgcnn.wgmma_sums``): the stats, one ``wgmma`` conv block a block
with bf16 activations between blocks and the last block's per-tile channel
sums, then ``sums_tail`` (K2) or ``mm_sums_tail`` (K3).  JAX keeps f32
between its bf16 blocks and rounds at the next conv; ReLU and the pool
commute with round-to-nearest, so storing in bf16 is the same value.  Their
weights are ``hybrid_ecgcnn.prepare_weights(folded, torch.bfloat16)``.

A CPU tensor takes the plain versions (``fused_ecgcnn_logits_plain``,
``fused_multimodal_logits_plain``), which follow ``_make_kernel``'s and
``_make_mm_kernel``'s arithmetic: 15 shifted products in exact f32 (TF32
off), the folded bias, the floor pool, a ones-mean and bf16 operand rounding
where the JAX products round.  A CUDA tensor launches the kernels or raises.
``card_logits`` / ``card_mm_logits`` on CPU tensors run the card's launch
sequence with every launch's plain version.  ``launches`` counts K2 forwards
launched on the card and ``launches_mm`` K3 forwards (each is the sequence
above, in either dtype); ``conv_block_launches`` counts the 3xTF32 conv
blocks launched (four an f32 forward, K4's f32 deep blocks too).

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

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

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
CH_MULT = 8  # the tensor-core conv block pads channels to whole k8 steps
launches = 0
launches_mm = 0
conv_block_launches = 0  # 3xTF32 conv blocks launched on the card (``conv_block_tf32x3``)

_I, _P = _build.INT, _build.VOIDP
LIB = _build.Library("fused_ecgcnn", {
    # x, stats, w3, b, y, B, T, Cin, CinP, Cout
    "ptbxl_conv_block_tf32x3": [_P] * 5 + [_I] * 5,
    # x, w, b, y, B, Tx, Cin, Cout (pre-padded x, P3's direct layer)
    "ptbxl_conv_block_valid": [_P] * 4 + [_I] * 4,
    # h, pw, pb, hw, hb, logits, B, T, C, F, L
    "ptbxl_tail": [_P] * 6 + [_I] * 5,
    # h, pw, pb, fc1_w, fc1_b, fc2_w, fc2_b, film_w, film_b, hw, hb, demo, logits,
    # B, T, C, F, D, H1, H, L
    "ptbxl_mm_tail": [_P] * 13 + [_I] * 8,
})

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
        return _mm_tail_plain(z_ecg, demo, folded, compute_dtype)


def _mm_tail_plain(z_ecg: torch.Tensor, demo: torch.Tensor, folded: Folded,
                   compute_dtype: torch.dtype) -> torch.Tensor:
    """K3's tail after proj: the demographics MLP, FiLM and the head, both
    operands of every product rounded to ``compute_dtype``; z_ecg [B, F] f32."""
    d = demo.float()
    h1 = torch.relu(_dot1(d, folded["fc1_w"], compute_dtype) + folded["fc1_b"])
    h2 = torch.relu(_dot1(h1, folded["fc2_w"], compute_dtype) + folded["fc2_b"])
    film = _dot1(h2, folded["film_w"], compute_dtype) + folded["film_b"]
    feat = z_ecg.shape[1]
    gamma = 1.0 + torch.tanh(film[:, :feat])
    z_cond = gamma * z_ecg + film[:, feat:]
    return _dot1(z_cond, folded["head_w"], compute_dtype) + folded["head_b"]


def tf32x3_weight(w: torch.Tensor) -> torch.Tensor:
    """[15, Cin, Cout] f32 -> the tensor-core conv block's weights [15*CinP/8, 2, 8*Cout] f32.

    Channels are zero-padded to ``CinP``, a multiple of ``CH_MULT``, and the
    reduction runs over columns ``k*CinP + c`` in k8 steps.  Step ``s`` holds
    two planes, ``big = tf32_round(w)`` and ``small = tf32_round(w - big)``
    (both TF32 values, ``big + small`` within 2^-22 of ``w``), each in
    ``wgmma``'s K-major core-matrix order without swizzle: ``[Cout/8][2][8][4]``
    (8-channel group, K half, channel, column), so a slice of channels of one
    step's plane is one contiguous run the kernel copies as it is.
    ``tf32x3_weight_unpack`` reads it back.
    """
    k, cin, cout = w.shape
    cin_p = -(-cin // CH_MULT) * CH_MULT
    wt = F.pad(w.float(), (0, 0, 0, cin_p - cin)).permute(2, 0, 1).reshape(cout, k * cin_p)
    big = tf32_round(wt)
    planes = torch.stack([big, tf32_round(wt - big)])  # [2, Cout, 15*CinP]
    steps = k * cin_p // 8
    # [plane, group, channel, step, K half, column] -> [step, plane, group, K half, channel, column]
    core = planes.view(2, cout // 8, 8, steps, 2, 4).permute(3, 0, 1, 4, 2, 5)
    return core.reshape(steps, 2, 8 * cout).contiguous()


def tf32x3_weight_unpack(w3: torch.Tensor) -> torch.Tensor:
    """``tf32x3_weight``'s layout back to its planes: [2, Cout, 15*CinP], big
    then small, column ``k*CinP + c`` of row ``o`` from ``w[k, c, o]``."""
    steps, cout = w3.shape[0], w3.shape[2] // 8
    core = w3.view(steps, 2, cout // 8, 2, 8, 4).permute(1, 2, 4, 0, 3, 5)
    return core.reshape(2, cout, steps * 8)


def _w3_shape(w3: torch.Tensor) -> Tuple[int, int]:
    """(Cout, CinP) of ``tf32x3_weight``'s layout, or (0, 0) when it is not one."""
    if w3.dim() != 3 or w3.shape[1] != 2 or w3.shape[2] % 8 or (w3.shape[0] * 8) % K:
        return 0, 0
    return w3.shape[2] // 8, w3.shape[0] * 8 // K


def prepare_weights(folded: Folded) -> list:
    """The f32 conv blocks' split weights (``tf32x3_weight``), one a block, built
    once and passed as ``weights``; without them a call builds its own."""
    return [tf32x3_weight(folded[f"w{i}"]) for i in range(int(folded["n_blocks"]))]


Weights = Union[list, Mapping[str, object]]


def block_weights(folded: Folded, compute_dtype: torch.dtype,
                  weights: Optional[Weights] = None) -> list:
    """The conv blocks' weights for ``compute_dtype``, one a block.

    ``weights``: f32, ``prepare_weights(folded)``; bf16, the ``wgmma``
    block's (``hybrid_ecgcnn.prepare_weights(folded, torch.bfloat16)``); that
    function's dict for either dtype, or its list of blocks; None builds
    them.  Weights prepared for the other dtype raise."""
    from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4

    if weights is None:
        return k4.prepare_weights(folded, compute_dtype)["blocks"]
    if isinstance(weights, Mapping):
        prepared, blocks = weights["dtype"], list(weights["blocks"])
    else:
        blocks = list(weights)
        prepared = blocks[0].dtype if blocks else compute_dtype  # wg_weight bf16, tf32x3 f32
    if prepared != compute_dtype:
        raise ValueError(f"weights were prepared for {prepared}, not {compute_dtype}")
    n_blocks = int(folded["n_blocks"])
    if len(blocks) != n_blocks:
        raise ValueError(f"weights hold {len(blocks)} blocks, the model {n_blocks}")
    return blocks


def conv_block_tf32x3_plain(x: torch.Tensor, w3: torch.Tensor, b: torch.Tensor,
                            stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``conv_block_tf32x3``: the exact-f32 block
    (``_conv_block_plain``, TF32 off) with ``w = big + small`` read back from ``w3``."""
    cin = x.shape[2]
    cout, cin_p = _w3_shape(w3)
    big, small = tf32x3_weight_unpack(w3)
    w = (big + small).view(cout, K, cin_p).permute(1, 2, 0)[:, :cin]
    h = x if stats is None else (x - stats[:, None, :, 0]) / stats[:, None, :, 1]
    with highest_precision():
        return _conv_block_plain(F.pad(h, (0, 0, PAD, PAD)), w, b, torch.float32)


def conv_block_tf32x3(x: torch.Tensor, w3: torch.Tensor, b: torch.Tensor,
                      stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One f32 conv block on ``wgmma`` (3xTF32): x [B, T, Cin] f32 ->
    pool(relu(conv_SAME(z(x), w) + b)) [B, T//2, Cout], where ``w3`` is
    ``tf32x3_weight(w)`` and ``z`` the z-score from ``stats`` ([B, Cin, 2],
    ``zscore_stats``) or none.  The kernel picks its tile from the grid;
    each launch counts in ``conv_block_launches``.  A CPU tensor takes
    ``conv_block_tf32x3_plain``."""
    global conv_block_launches
    bsz, t, cin = x.shape
    cout, cin_p = _w3_shape(w3)
    if (t < 2 or not cout or cout % 32 or cin_p % CH_MULT or cin_p < cin
            or tuple(b.shape) != (cout,)):
        raise ValueError(f"conv block needs T >= 2, Cout % 32 == 0 and w3 [15*CinP/8, 2, 8*Cout] "
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
    LIB.launch("ptbxl_conv_block_tf32x3", x, stats, w3, b, y, bsz, t, cin, cin_p, cout)
    conv_block_launches += 1
    return y


def conv_block_valid(x: torch.Tensor, w2d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The bf16 FMA conv block on a pre-padded input (P3's ``direct`` layer):
    contiguous f32 CUDA tensors x [B, T+14, Cin], w2d [15*Cin, Cout] with
    Cout % 32 == 0 and b [Cout] -> pool(relu(conv_VALID + b)) [B, T//2, Cout]
    f32, bf16 operands and f32 sums."""
    bsz, tx, cin = x.shape
    cout = w2d.shape[1]
    if cout % 32:
        raise ValueError(f"direct mode needs Cout % 32 == 0, got {cout}")
    y = torch.empty((bsz, (tx - 2 * PAD) // 2, cout), dtype=torch.float32, device=x.device)
    LIB.launch("ptbxl_conv_block_valid", x, w2d, b, y, bsz, tx, cin, cout)
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


def _backbone(x: torch.Tensor, folded: Folded, normalize: bool, blocks: list) -> torch.Tensor:
    """Launch ``zscore_stats`` (when ``normalize``) and one 3xTF32 conv block a
    block with ``blocks`` (``prepare_weights``): the f32 backbone."""
    stats = zscore_stats(x) if normalize else None
    h = x
    for i, w3 in enumerate(blocks):
        h = conv_block_tf32x3(h, w3, folded[f"b{i}"], stats if i == 0 else None)
    return h


def card_logits(x: torch.Tensor, folded: Folded, compute_dtype: torch.dtype,
                normalize: bool = True, weights: Optional[Weights] = None) -> torch.Tensor:
    """K2's launch sequence, not counted -> logits [B, L].  f32: ``_backbone``,
    then the tail kernel (``ptbxl_tail``: mean over T, proj, head); K4 runs it
    as its f32 route.  bf16: K4's bf16 route (``hybrid_ecgcnn.wgmma_sums``,
    then ``sums_tail``).  ``weights`` as ``block_weights`` takes them.  On
    CPU tensors each launch takes its plain version (f32: the 3xTF32 blocks'
    and an exact-f32 tail)."""
    blocks = block_weights(folded, compute_dtype, weights)
    if compute_dtype == torch.bfloat16:
        from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4

        part, t = k4.wgmma_sums(x, folded, blocks, normalize)
        return k4.sums_tail(part, t, folded)
    h = _backbone(x, folded, normalize, blocks)
    pw, hw = folded["proj_w"], folded["head_w"]
    if h.device.type == "cpu":
        with highest_precision():
            return (h.mean(1) @ pw + folded["proj_b"]) @ hw + folded["head_b"]
    b, num_labels = h.shape[0], hw.shape[1]
    logits = torch.empty((b, num_labels), dtype=torch.float32, device=h.device)
    LIB.launch("ptbxl_tail", h, pw, folded["proj_b"], hw, folded["head_b"], logits, b, h.shape[1],
               pw.shape[0], pw.shape[1], num_labels)
    return logits


def fused_ecgcnn_logits(x: torch.Tensor, folded: Folded,
                        compute_dtype: torch.dtype = torch.float32,
                        normalize: bool = True, weights: Optional[Weights] = None
                        ) -> torch.Tensor:
    """x: [B, T, 12] raw signals -> logits [B, num_labels].

    ``folded`` from ``fold_bn_into_conv`` on x's device.  ``normalize``
    applies the per-lead z-score (False for pre-normalized input).
    ``weights`` for ``compute_dtype`` (``block_weights``: f32
    ``prepare_weights(folded)``, bf16 ``hybrid_ecgcnn.prepare_weights(folded,
    torch.bfloat16)``), or None to build them.
    """
    global launches
    if x.device.type == "cpu":
        return fused_ecgcnn_logits_plain(x, folded, compute_dtype, normalize)
    blocks = block_weights(folded, compute_dtype, weights)
    _check(x, folded, compute_dtype)
    x = x.contiguous()
    if x.shape[0] == 0:
        return torch.empty((0, folded["head_b"].shape[0]), dtype=torch.float32, device=x.device)
    logits = card_logits(x, folded, compute_dtype, normalize, blocks)
    launches += 1
    return logits


_ECG_DENSE = ("proj_w", "proj_b", "head_w", "head_b")
_MM_DENSE = ("proj_w", "proj_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b", "film_w", "film_b",
             "head_w", "head_b")


def _op_params(folded: Folded, weights: Optional[Weights], dense: Sequence[str]
               ) -> List[torch.Tensor]:
    """The custom ops' tensor list: ``w0, b0, .., w{n-1}, b{n-1}``, the dense
    tail in ``dense`` order, then the blocks' weights (none: built per call)."""
    n = int(folded["n_blocks"])
    if isinstance(weights, Mapping):
        weights = weights["blocks"]
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
                       normalize: bool = True, weights: Optional[Weights] = None
                       ) -> torch.Tensor:
    return torch.sigmoid(fused_ecgcnn_logits(x, folded, compute_dtype, normalize, weights))


def fused_ecgcnn_probs_op(x: torch.Tensor, folded: Folded,
                          compute_dtype: torch.dtype = torch.float32,
                          normalize: bool = True, weights: Optional[Weights] = None
                          ) -> torch.Tensor:
    """``fused_ecgcnn_probs`` as one call of ``ptbxl::fused_ecgcnn_probs``."""
    return torch.ops.ptbxl.fused_ecgcnn_probs(
        x, _op_params(folded, weights, _ECG_DENSE), int(folded["n_blocks"]), normalize,
        compute_dtype == torch.bfloat16)


def _check_mm_dense(folded: Folded, c: int) -> None:
    """K3's dense tail: proj_w [C, F], fc1_w [D, H1], fc2_w [H1, H], film_w
    [H, 2F], head_w [F, L] (L <= ``MAX_LABELS``) for the backbone's C channels."""
    _check_labels(folded)
    f, h1 = folded["proj_w"].shape[1], folded["fc1_w"].shape[1]
    want = {"proj_w": (c, f), "fc2_w": (h1, folded["fc2_w"].shape[1]),
            "film_w": (folded["fc2_w"].shape[1], 2 * f),
            "head_w": (f, folded["head_b"].shape[0])}
    for key, shape in want.items():
        if tuple(folded[key].shape) != shape:
            raise ValueError(f"folded[{key!r}] must be {shape}, got {tuple(folded[key].shape)}")


def card_mm_logits(x: torch.Tensor, demo: torch.Tensor, folded: Folded,
                   compute_dtype: torch.dtype, normalize: bool = True,
                   weights: Optional[Weights] = None) -> torch.Tensor:
    """K3's launch sequence, not counted -> logits [B, L].  f32: ``_backbone``,
    then the tail kernel (``ptbxl_mm_tail``: mean over T, proj, demographics
    MLP, FiLM, head).  bf16: K4's ``wgmma`` backbone (``hybrid_ecgcnn.
    wgmma_sums``), then ``hybrid_ecgcnn.mm_sums_tail`` on the last block's
    tile sums.  ``weights`` as ``block_weights`` takes them.  On CPU tensors
    each launch takes its plain version."""
    blocks = block_weights(folded, compute_dtype, weights)
    if compute_dtype == torch.bfloat16:
        from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4

        part, t = k4.wgmma_sums(x, folded, blocks, normalize)
        return k4.mm_sums_tail(part, t, folded, demo)
    h = _backbone(x, folded, normalize, blocks)
    pw = folded["proj_w"]
    if h.device.type == "cpu":
        with highest_precision():
            z_ecg = h.mean(1) @ pw + folded["proj_b"]
            return _mm_tail_plain(z_ecg, demo, folded, torch.float32)
    b, t, c = h.shape
    f, d_in, h1, hid = pw.shape[1], demo.shape[1], folded["fc1_w"].shape[1], folded["fc2_w"].shape[1]
    num_labels = folded["head_b"].shape[0]
    logits = torch.empty((b, num_labels), dtype=torch.float32, device=x.device)
    LIB.launch("ptbxl_mm_tail", h, *[folded[k] for k in _MM_DENSE], demo, logits,
               b, t, c, f, d_in, h1, hid, num_labels)
    return logits


def fused_multimodal_logits(x: torch.Tensor, demo: torch.Tensor, folded: Folded,
                            compute_dtype: torch.dtype = torch.float32,
                            normalize: bool = True, weights: Optional[Weights] = None
                            ) -> torch.Tensor:
    """x: [B, T, 12] raw signals, demo: [B, 5] -> logits [B, num_labels] (K3).

    ``folded`` from ``fold_multimodal`` on x's device; the demo rows are
    passed as they are (D = ``fc1_w.shape[0]``).  ``weights`` as in
    ``fused_ecgcnn_logits``.
    """
    global launches_mm
    _check_labels(folded)
    if x.device.type == "cpu":
        return fused_multimodal_logits_plain(x, demo, folded, compute_dtype, normalize)
    blocks = block_weights(folded, compute_dtype, weights)
    _check(x, folded, compute_dtype)
    b = x.shape[0]
    d_in = folded["fc1_w"].shape[0]
    if (demo.device != x.device or demo.dtype != torch.float32
            or tuple(demo.shape) != (b, d_in)):
        raise ValueError(f"demo must be f32 [{b}, {d_in}] on {x.device}, "
                         f"got {demo.dtype} {tuple(demo.shape)} on {demo.device}")
    _check_mm_dense(folded, folded[f"w{int(folded['n_blocks']) - 1}"].shape[2])
    x, demo = x.contiguous(), demo.contiguous()
    if b == 0:
        return torch.empty((0, folded["head_b"].shape[0]), dtype=torch.float32, device=x.device)
    logits = card_mm_logits(x, demo, folded, compute_dtype, normalize, blocks)
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
                           normalize: bool = True, weights: Optional[Weights] = None
                           ) -> torch.Tensor:
    return torch.sigmoid(fused_multimodal_logits(x, demo, folded, compute_dtype, normalize,
                                                 weights))


def fused_multimodal_probs_op(x: torch.Tensor, demo: torch.Tensor, folded: Folded,
                              compute_dtype: torch.dtype = torch.float32,
                              normalize: bool = True, weights: Optional[Weights] = None
                              ) -> torch.Tensor:
    """``fused_multimodal_probs`` as one call of ``ptbxl::fused_multimodal_probs``."""
    return torch.ops.ptbxl.fused_multimodal_probs(
        x, demo, _op_params(folded, weights, _MM_DENSE), int(folded["n_blocks"]), normalize,
        compute_dtype == torch.bfloat16)
