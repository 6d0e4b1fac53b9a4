"""K4: the hybrid inference engine, and P3's and P4's conv layers: CUDA
kernels + plain PyTorch versions.

K4 replaces ``ptbxl_tpu/ops/pallas/hybrid_ecgcnn.py``: ``_make_tail_kernel``
(:63), launched by ``hybrid_ecgcnn_logits`` (:143, pallas_call :214), and
``hybrid_ecgcnn_probs`` (:230).  P3's layer replaces
``tools/probe_layer_perf.py::make_pallas_layer`` (:52).  Kernels:
``ptbxl_torch/csrc/hybrid_wgmma.cu`` (K4's bf16 conv block on ``wgmma`` and
its tail), K2's 3xTF32 conv block and tail (``csrc/fused_ecgcnn.cu``, K4 in
f32), K1's ``zscore_stats``, and ``csrc/hybrid_ecgcnn.cu`` (P3's and P4's
``mma.sync`` conv blocks).

What K4 computes (``hybrid_ecgcnn_logits``): the two-pass z-score when
``normalize``; every conv block, conv k=15 with ``compute_dtype`` operands
and f32 sums, + bias, ReLU and the floor pool; then the mean over T as a
ones-mean in f32, and proj and head with both operands rounded to
``compute_dtype`` and the bias added in f32.  JAX runs the first ``split``
blocks on XLA and the rest in its Pallas kernel; the function is the same
for every split, so on the card ``split`` is only checked, and every block
is a kernel launch.

What bounds it on the H100: operations.  The blocks are 1.133 GFLOP a
record against 989 TFLOP/s of dense bf16 (9.38 ms at B=8192); the bytes
(raw input read once, each bf16 activation written and read once) take
2.9 ms at 3.35 TB/s.

Design (the card route, ``card_route_logits``).  In bf16: ``zscore_stats``
(K1) when ``normalize``, then one launch of the ``wgmma`` conv block a block
(``wgmma_conv_block``): block 0 reads the raw f32 input and applies the
z-score while it stages its tile, each block stores its pooled output in
bf16 (the value the next conv reads: JAX rounds it there), and the last
block stores only its per-tile channel sums, which ``sums_tail`` adds in
tile order before proj and head.  The source says how the kernel tiles; its
tile table (``PTBXL_WG_TILES``) is read from there into ``WG_TILES``.  In f32
(which the JAX tests use) the route is K2's launch sequence
(``fused_ecgcnn.card_logits``: 3xTF32 conv blocks, block 0 with the stats,
and K2's tail), the same function.  No block runs on a library.  The JAX
function's ``block_b`` (its record tile on the TPU) is not taken.  The
weights' layouts (the ``wgmma`` core order of ``wg_weight`` in bf16, K2's
split weights in f32) are built once by ``prepare_weights`` and passed as
``weights``; without them a call builds its own.

``conv_layer`` (P3) is one layer on a pre-padded input ``[B, T+14, Cin]`` f32
with weights ``[15*Cin, Cout]``: ``mode="im2col"`` launches the tensor-core
conv block of ``csrc/hybrid_ecgcnn.cu``, ``mode="direct"`` K2's bf16 FMA
conv block (15 shifted products); both compute conv k=15 with bf16 operands
and f32 sums, + bias, ReLU and the floor pool, ``[B, T//2, Cout]`` f32.

``conv_layer_cf`` (P4) replaces ``tools/probe_sublane_conv.py::make_layer``
(:51): the same layer on a channel-major input ``[B, Cpad, T+14]`` f32 with
weights ``[15*Cpad, Cout]`` (row ``k*Cpad + c``), contracting over all
``Cpad`` channels (the probe's padded channels hold data too), and an output
``[B, Cout, T//2]`` (``transpose_out``) or ``[B, T//2, Cout]``.  Its kernel
(``ptbxl_conv_layer_cf``) runs P3's tap loop on a tile staged transposed.
The probe's ``b_tile`` (records per TPU grid step) has no counterpart and is
not taken.

A CPU tensor takes the plain versions (``hybrid_ecgcnn_logits_plain``, the
JAX function step by step; ``wgmma_conv_block_plain``, which emulates the
kernel's tiling; ``sums_tail_plain``; ``conv_layer_plain``,
``conv_layer_cf_plain``); a CUDA tensor launches the kernels or raises.
``card_route_logits`` on CPU tensors runs the card's launch sequence with
every launch's plain version.  ``launches`` counts K4 forwards on the card,
``launches_layer`` P3 layers, ``launches_layer_cf`` P4 layers.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ptbxl_torch.ops.kernels import _build
from ptbxl_torch.ops.kernels import fused_ecgcnn as k2
from ptbxl_torch.ops.kernels.fused_ecgcnn import MAX_LABELS, Folded, _dot1, _round
from ptbxl_torch.ops.kernels.zscore import zscore_stats
from ptbxl_torch.ops.preprocess import zscore_per_lead_batch
from ptbxl_torch.utils.device import highest_precision

K = 15
PAD = K // 2
launches = 0
launches_layer = 0
launches_layer_cf = 0
MODES = ("im2col", "direct")
WG_SOURCE = _build.CSRC / "hybrid_wgmma.cu"
_WG_ROW = re.compile(r"^\s*X\(" + r",\s*".join([r"(\d+)"] * 6) + r"\)", re.M)


def read_wg_tiles(text: str) -> Dict[int, Tuple[int, ...]]:
    """The rows of ``PTBXL_WG_TILES`` in a ``hybrid_wgmma.cu`` source: CinP ->
    (Cout, BN output channels a tile, RM m64 tiles a consumer warpgroup, CTAs
    an SM, k16 steps a weight stage); a tile is BM = 128 * RM conv rows."""
    rows = [tuple(int(v) for v in m) for m in _WG_ROW.findall(text)]
    if not rows:
        raise ValueError("no PTBXL_WG_TILES rows in the source")
    return {r[0]: r[1:] for r in rows}


# the wgmma conv block's tiles, as the kernel's source fixes them
WG_TILES = read_wg_tiles(WG_SOURCE.read_text())

_I, _P = _build.INT, _build.VOIDP
_SIGNATURES = {
    # device, x, w, b, y, B, Tx, T, off, Cin, CinP, Cout, stream
    "ptbxl_tc_conv_block": [_I, _P, _P, _P, _P] + [_I] * 7 + [_P],
    # device, x, w, b, y, B, Tx, CinP, Cout, transpose_out, stream
    "ptbxl_conv_layer_cf": [_I, _P, _P, _P, _P] + [_I] * 5 + [_P],
}
_WG_SIGNATURES = {
    # device, x, stats, w, b, y, B, T, Cin, CinP, Cout, in_f32, sums, stream
    "ptbxl_wgmma_conv_block": [_I] + [_P] * 5 + [_I] * 7 + [_P],
    # device, part, pw, pb, hw, hb, logits, B, n_tiles, T, C, F, L, stream
    "ptbxl_sums_tail": [_I] + [_P] * 6 + [_I] * 6 + [_P],
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
    """[15, Cin, Cout] f32 -> [15, CinP, Cout] bf16, channels zero-padded to a
    multiple of 16 (P3's im2col layer, ``ptbxl_tc_conv_block``)."""
    k, cin, cout = w.shape
    cin_p = -(-cin // 16) * 16
    out = torch.zeros((k, cin_p, cout), dtype=torch.bfloat16, device=w.device)
    out[:, :cin] = w
    return out


# -- K4: the wgmma conv block ------------------------------------------------------

def wg_tile(cin_p: int, cout: int) -> Tuple[int, int]:
    """(BN, BM) of the ``wgmma`` conv block for CinP -> Cout (``WG_TILES``);
    raises for a shape it has no tile for (the ECGCNN's 16 -> 32 -> 64 -> 128
    -> 256)."""
    tile = WG_TILES.get(cin_p)
    if tile is None or tile[0] != cout:
        raise ValueError(f"the wgmma conv block takes CinP -> Cout of "
                         f"{[(c, t[0]) for c, t in WG_TILES.items()]}, got {cin_p} -> {cout}")
    return tile[1], 128 * tile[2]


def wg_weight(w: torch.Tensor, bn: Optional[int] = None) -> torch.Tensor:
    """[15, Cin, Cout] f32 -> the ``wgmma`` block's B operand, bf16
    ``[Cout/BN, 15*CinP/16, 2, BN/8, 8, 8]``.

    Channels are zero-padded to ``CinP`` (a multiple of 16).  Entry ``[s, g]``
    is k16 step ``g = tap * CinP/16 + kk`` of output slice ``s``: the 16 x BN
    tile ``w[tap, 16*kk + k, s*BN + n]`` in wgmma's K-major core order without
    swizzle, element (k, n) at ``[k // 8, n // 8, n % 8, k % 8]``: 8 x 8 cores
    of 128 contiguous bytes, the two K halves ``16*BN`` bytes apart, 8-column
    groups 128 bytes apart.  The kernel copies a stage of steps at a time, as
    they lie.  ``bn`` is the tile's (``wg_tile``) unless given.
    """
    _, cin, cout = w.shape
    cin_p = -(-cin // 16) * 16
    bn = wg_tile(cin_p, cout)[0] if bn is None else bn
    wb = F.pad(w.float(), (0, 0, 0, cin_p - cin)).to(torch.bfloat16)   # [15, CinP, Cout]
    wb = wb.reshape(K, cin_p // 16, 2, 8, cout // bn, bn // 8, 8)     # tap kk kh kl s nh nl
    wb = wb.permute(4, 0, 1, 2, 5, 6, 3)                              # s tap kk kh nh nl kl
    return wb.reshape(cout // bn, K * cin_p // 16, 2, bn // 8, 8, 8).contiguous()


def wg_weight_unpack(wp: torch.Tensor) -> torch.Tensor:
    """``wg_weight``'s inverse: -> [15, CinP, Cout] bf16 (channels >= Cin are 0)."""
    n_sl, steps, _, nh, _, _ = wp.shape
    cin_p = steps * 16 // K
    w = wp.reshape(n_sl, K, cin_p // 16, 2, nh, 8, 8)                # s tap kk kh nh nl kl
    return w.permute(1, 2, 3, 6, 0, 4, 5).reshape(K, cin_p, n_sl * nh * 8)


def _wg_geometry(wp: torch.Tensor) -> Tuple[int, int, int, int]:
    """(CinP, Cout, BN, BM) of a ``wg_weight``."""
    if wp.dim() != 6 or wp.dtype != torch.bfloat16 or wp.shape[1] * 16 % K:
        raise ValueError(f"expected a wg_weight [Cout/BN, 15*CinP/16, 2, BN/8, 8, 8] bf16, "
                         f"got {wp.dtype} {tuple(wp.shape)}")
    cin_p, bn = wp.shape[1] * 16 // K, wp.shape[3] * 8
    cout = wp.shape[0] * bn
    bn_t, bm = wg_tile(cin_p, cout)
    if bn != bn_t:
        raise ValueError(f"wg_weight slice of {bn} channels, the tile takes {bn_t}")
    return cin_p, cout, bn, bm


def _check_wg_block(x: torch.Tensor, wp: torch.Tensor, b: torch.Tensor,
                    stats: Optional[torch.Tensor]) -> Tuple[int, int, int, int]:
    cin_p, cout, bn, bm = _wg_geometry(wp)
    if x.dim() != 3 or x.shape[1] < 2:
        raise ValueError(f"expected x [B, T, Cin] with T >= 2, got {tuple(x.shape)}")
    bsz, _, cin = x.shape
    if x.dtype == torch.float32:
        if cin_p != 16 or cin % 4:
            raise ValueError(f"an f32 input is block 0's raw record: CinP 16 and Cin % 4 == 0, "
                             f"got Cin={cin}, CinP={cin_p}")
    elif x.dtype != torch.bfloat16 or cin != cin_p or stats is not None:
        raise ValueError(f"a bf16 input takes Cin == CinP ({cin_p}) and no stats, got "
                         f"{x.dtype} Cin={cin}")
    if tuple(b.shape) != (cout,) or b.dtype != torch.float32:
        raise ValueError(f"b must be f32 [{cout}], got {b.dtype} {tuple(b.shape)}")
    if stats is not None and (tuple(stats.shape) != (bsz, cin, 2) or stats.dtype != torch.float32):
        raise ValueError(f"stats must be f32 [{bsz}, {cin}, 2], got {tuple(stats.shape)}")
    return cin_p, cout, bn, bm


def wgmma_conv_block_plain(x: torch.Tensor, wp: torch.Tensor, b: torch.Tensor,
                           stats: Optional[torch.Tensor] = None,
                           sums: bool = False) -> torch.Tensor:
    """Plain version of ``wgmma_conv_block``, emulating the kernel's tiling.

    Per record, tiles of BM conv rows: the tile's BM + 14 input rows with
    their halo (zero outside [0, T); block 0 z-scored from ``stats`` first,
    then rounded to bf16), the 15 * CinP/16 k16 steps added in the kernel's
    order with the weights read back from ``wp``, + bias, ReLU, the floor
    pool; bf16 out, or with ``sums`` each tile's f32 sums over its pooled rows.
    """
    cin_p, cout, _, bm = _check_wg_block(x, wp, b, stats)
    bsz, t, cin = x.shape
    w = wg_weight_unpack(wp).float()
    h = x.float()
    if stats is not None:
        h = (h - stats[:, None, :, 0]) / stats[:, None, :, 1]
    half = t // 2
    row_tiles = -(-2 * half // bm)
    xp = h.new_zeros((bsz, row_tiles * bm + K - 1, cin_p))
    xp[:, PAD:PAD + t, :cin] = h.to(torch.bfloat16).float()
    outs = []
    with highest_precision():
        for tile in range(row_tiles):
            xt = xp[:, tile * bm:tile * bm + bm + K - 1]          # the staged tile
            acc = xt.new_zeros((bsz, bm, cout))
            for step in range(K * cin_p // 16):
                tap, kk = divmod(step, cin_p // 16)
                acc += xt[:, tap:tap + bm, 16 * kk:16 * kk + 16] @ w[tap, 16 * kk:16 * kk + 16]
            y = torch.relu(acc + b)
            p = torch.maximum(y[:, 0::2], y[:, 1::2])[:, :half - tile * bm // 2]
            outs.append(p.sum(1) if sums else p)
    if sums:
        return torch.stack(outs, 1)                      # [B, row_tiles, Cout] f32
    return torch.cat(outs, 1).to(torch.bfloat16)         # [B, T//2, Cout]


def wgmma_conv_block(x: torch.Tensor, wp: torch.Tensor, b: torch.Tensor,
                     stats: Optional[torch.Tensor] = None, sums: bool = False) -> torch.Tensor:
    """One conv block on ``wgmma``: x [B, T, Cin] (block 0: the raw f32
    record, z-scored on load with ``stats`` [B, Cin, 2] from ``zscore_stats``,
    or none; later blocks: bf16 with Cin == CinP), ``wp`` from ``wg_weight``,
    b [Cout] f32 -> pool(relu(conv_SAME + b)) [B, T//2, Cout] bf16, or with
    ``sums`` the f32 sums over each tile's pooled rows [B, tiles, Cout].  A
    CPU tensor takes ``wgmma_conv_block_plain``."""
    cin_p, cout, _, bm = _check_wg_block(x, wp, b, stats)
    if x.device.type == "cpu":
        return wgmma_conv_block_plain(x, wp, b, stats, sums)
    bsz, t, cin = x.shape
    for name, v in (("x", x), ("w", wp), ("b", b), ("stats", stats)):
        if v is not None and (v.device != x.device or not v.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if sums:
        y = torch.empty((bsz, -(-2 * (t // 2) // bm), cout), dtype=torch.float32,
                        device=x.device)
    else:
        y = torch.empty((bsz, t // 2, cout), dtype=torch.bfloat16, device=x.device)
    lib = _build.load_library("hybrid_wgmma", _WG_SIGNATURES)
    err = lib.ptbxl_wgmma_conv_block(
        x.get_device(), x.data_ptr(), None if stats is None else stats.data_ptr(), wp.data_ptr(),
        b.data_ptr(), y.data_ptr(), bsz, t, cin, cin_p, cout, int(x.dtype == torch.float32),
        int(sums), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "wgmma conv block launch")
    return y


def sums_tail_plain(part: torch.Tensor, t: int, folded: Folded) -> torch.Tensor:
    """Plain version of ``sums_tail``: the tiles' sums added in tile order, each
    times 1/T (the ones-mean), then proj and head with bf16 operands."""
    inv_t = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(t), dtype=torch.float32)
    g = torch.zeros_like(part[:, 0])
    for k in range(part.shape[1]):
        g = g + inv_t.to(part.device) * part[:, k]
    with highest_precision():
        z = _dot1(g, folded["proj_w"], torch.bfloat16) + folded["proj_b"]
        return _dot1(z, folded["head_w"], torch.bfloat16) + folded["head_b"]


def sums_tail(part: torch.Tensor, t: int, folded: Folded) -> torch.Tensor:
    """K4's bf16 tail: part [B, tiles, C] f32 (the last block's per-tile
    channel sums), ``t`` its pooled length -> logits [B, L] f32."""
    if part.device.type == "cpu":
        return sums_tail_plain(part, t, folded)
    bsz, n_tiles, c = part.shape
    pw, hw = folded["proj_w"], folded["head_w"]
    if pw.shape[0] != c:
        raise ValueError(f"proj_w must be [{c}, F], got {tuple(pw.shape)}")
    num_labels = hw.shape[1]
    logits = torch.empty((bsz, num_labels), dtype=torch.float32, device=part.device)
    lib = _build.load_library("hybrid_wgmma", _WG_SIGNATURES)
    err = lib.ptbxl_sums_tail(
        part.get_device(), part.data_ptr(), pw.data_ptr(), folded["proj_b"].data_ptr(),
        hw.data_ptr(), folded["head_b"].data_ptr(), logits.data_ptr(), bsz, n_tiles, t, c,
        pw.shape[1], num_labels, torch.cuda.current_stream(part.device).cuda_stream)
    _build.check(lib, err, "sums tail launch")
    return logits


def prepare_weights(folded: Folded, compute_dtype: torch.dtype = torch.bfloat16) -> dict:
    """The card's weight layouts for ``compute_dtype``, built once, the same for
    every split: one a block, ``wg_weight`` in bf16, K2's split
    ``tf32x3_weight`` in f32."""
    if compute_dtype == torch.bfloat16:
        blocks = [wg_weight(folded[f"w{i}"]) for i in range(int(folded["n_blocks"]))]
    else:
        blocks = k2.prepare_weights(folded)
    return {"dtype": compute_dtype, "blocks": blocks}


def _check_weights(weights: Optional[dict], compute_dtype: torch.dtype) -> None:
    if weights is not None and weights["dtype"] != compute_dtype:
        raise ValueError(f"weights were prepared for {weights['dtype']}, not {compute_dtype}")


def card_route_logits(x: torch.Tensor, folded: Folded, split: int = 2,
                      compute_dtype: torch.dtype = torch.bfloat16, normalize: bool = True,
                      weights: Optional[dict] = None) -> torch.Tensor:
    """K4's launch sequence: x [B, T, 12] raw f32 -> logits [B, L].

    bf16: ``zscore_stats`` (when ``normalize``), one ``wgmma_conv_block`` a
    block (the last with ``sums``), ``sums_tail``.  f32: K2's launch sequence
    (``fused_ecgcnn.card_logits``).  With CPU tensors each launch takes its
    plain version: the card's tiling and orders, emulated.
    """
    _check_args(folded, split)
    _check_weights(weights, compute_dtype)
    if weights is None:
        weights = prepare_weights(folded, compute_dtype)
    if compute_dtype == torch.float32:
        return k2.card_logits(x, folded, compute_dtype, normalize, weights["blocks"])
    n_blocks = int(folded["n_blocks"])
    stats = zscore_stats(x) if normalize else None
    h = x
    for i in range(n_blocks):
        t = h.shape[1]
        h = wgmma_conv_block(h, weights["blocks"][i], folded[f"b{i}"], stats if i == 0 else None,
                             sums=i == n_blocks - 1)
    return sums_tail(h, t // 2, folded)


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

    ``folded`` from ``fold_bn_into_conv`` on x's device; ``split`` as in the
    JAX function (0 < split < n_blocks; the same function for each).
    ``weights`` from ``prepare_weights(folded, compute_dtype)``, or None to
    build them.  On the card: ``card_route_logits``.
    """
    global launches
    if x.device.type == "cpu":
        return hybrid_ecgcnn_logits_plain(x, folded, split, compute_dtype, normalize)
    _check_args(folded, split)
    _check_weights(weights, compute_dtype)
    _check_cuda(x, folded, compute_dtype)
    if x.shape[0] == 0:
        return torch.empty((0, folded["head_b"].shape[0]), dtype=torch.float32, device=x.device)
    logits = card_route_logits(x.contiguous(), folded, split, compute_dtype, normalize, weights)
    launches += 1
    return logits


def hybrid_ecgcnn_probs(x: torch.Tensor, folded: Folded,
                        compute_dtype: torch.dtype = torch.bfloat16, normalize: bool = True,
                        split: int = 2, weights: Optional[dict] = None) -> torch.Tensor:
    """x [B, T, 12] raw -> probs; ``n_blocks`` is read from ``folded``."""
    return torch.sigmoid(hybrid_ecgcnn_logits(x, folded, split, compute_dtype, normalize,
                                              weights))


def _tc_conv(x: torch.Tensor, wt: torch.Tensor, b: torch.Tensor, t: int, off: int) -> torch.Tensor:
    """One launch of P3's tensor-core conv block: x [B, Tx, Cin] f32, conv rows
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
