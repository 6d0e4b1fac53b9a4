"""P1 and P2: the capability probes as CUDA kernels + plain PyTorch versions.

P1 replaces ``tools/probe_mosaic.py::_call`` (:44) with its probes p1-p8
(:54-175), P2 ``tools/probe_mosaic2.py::_call`` (:35) with p3b, p5b, p5b2,
p5c and p9 (:45-116).  Kernels: ``ptbxl_torch/csrc/probes.cu``, one small
kernel per operation; the source says what bounds each.  The data-movement
probes move at most ~3 MB and are bound by the launch.  p1 (TN, :54) and p2
(NT, :71), TF32 dots of 134 MFLOP, are bound by each CTA's first read of its
operands (96 KB a CTA out of L2): their kernel gives each CTA a 64 x 32 tile
of the output with all of K resident (128 CTAs at the probes' shapes, one an
SM), issues every operand copy before it waits, rounds each element once
(``cvt.rna``) on its way to ``wgmma`` and runs the k8 steps in chunks of 16,
each one commit group; ``dot_plan`` is its launch plan.  p7 (:153) copies
each output row, one contiguous window of the input, in float4s.

Operations (f32 throughout):

* ``tn_dot(a, b)``: ``a.T @ b`` for a ``[K, M]``, b ``[K, N]`` (p1, p9);
  ``nt_dot(a, b)``: ``a @ b.T`` for a ``[M, K]``, b ``[N, K]`` (p2).
  ``precision="tf32"`` runs on the tensor cores with operands rounded to TF32
  (``cvt.rna``: nearest, ties away from zero) and f32 sums, the card's
  counterpart of the TPU's default product precision; ``"fp32"`` (p9,
  HIGHEST) is full FP32 FMA.  TF32: the rules of ``dot_plan`` (M % 64, N %
  32, K % 8, both operands' slices in shared memory) and 16-byte aligned
  operands; FP32: M and N multiples of 64, K of 32.
* ``roll_add(x, lane_shift, sublane_shift)``: ``roll(x, lane_shift, 1) +
  roll(x, sublane_shift, 0)`` (p3, p3b).
* ``subblock_rolls(x, ks)``: block k of ``[ks*C, T]`` is ``roll(x, -k, 1)`` (p4).
* ``pool_slices(x, axis)``: ``max(x[0::2], x[1::2])`` on rows (axis 0) or
  columns (axis 1) by two strided reads (p5, p5b2); ``pool_reshape(x,
  axis)``: the max over the pair axis of ``x.reshape(R/2, 2, W)`` (axis 0,
  the pair staged as one contiguous slab) or ``x.reshape(R, W/2, 2)`` (axis
  1, the pair read as one float2) (p5b, p5c).
* ``window_sum(x, width, ks)``: ``sum_{k<ks} x[:, k:k+width]`` in k order (p6).
* ``shifted_concat(x, ks)``: ``concat_k x[k:k+T]`` along columns for x
  ``[T+ks-1, C]`` (p7).
* ``transpose(x)``: ``x.T`` through shared memory (p8).

A CPU tensor takes the plain version (``*_plain``); a CUDA tensor launches
the kernel or raises.  ``launches`` counts kernel launches on the card.

The launch path (``_launch``) is most of a probe call's time, so it is kept
short: the inputs' dtype, layout and device are checked in one pass, and
``_build.Library`` binds each C entry once per process and passes the current
stream's raw handle; the C side sets the device only when it differs.
``tools/probe_dispatch.py`` times the parts.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ptbxl_torch.ops.kernels import _build
from ptbxl_torch.utils.device import highest_precision

launches = 0
PRECISIONS = ("tf32", "fp32")

_I, _P, _L = _build.INT, _build.VOIDP, ctypes.c_longlong
# every entry: (device, ..., stream)
LIB = _build.Library("probes", {
    # a, b, c, M, N, K, sam, sak, sbk, sbn, tf32, grid_m, grid_n, smem
    "ptbxl_probe_dot": [_P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _I, _I, _I, _L],
    # x, out, C, T, lane shift, sublane shift
    "ptbxl_probe_roll_add": [_P, _P, _I, _I, _I, _I],
    # x, out, C, T, KS
    "ptbxl_probe_subblock": [_P, _P, _I, _I, _I],
    # x, y, R, W, lane
    "ptbxl_probe_pool_slices": [_P, _P, _I, _I, _I],
    # x, y, R, W
    "ptbxl_probe_pool_rows_reshape": [_P, _P, _I, _I],
    "ptbxl_probe_pool_lanes_reshape": [_P, _P, _I, _I],
    # x, out, C, T, Wo, KS
    "ptbxl_probe_window_sum": [_P, _P, _I, _I, _I, _I],
    # x, out, To, C, KS
    "ptbxl_probe_concat": [_P, _P, _I, _I, _I],
    # x, out, R, W
    "ptbxl_probe_transpose": [_P, _P, _I, _I],
})


def _launch(entry: str, out_shape, tensors, ints) -> torch.Tensor:
    """Launch ``entry`` on the first tensor's device as ``(device, tensors...,
    out, ints..., stream)``.  The tensors must be contiguous f32 on one CUDA
    device, checked in one pass: a wrong dtype or layout raises ``TypeError``,
    a CPU tensor ``RuntimeError``."""
    global launches
    dev = tensors[0].device
    for v in tensors:
        if v.dtype != torch.float32 or not v.is_contiguous() or v.device != dev:
            raise TypeError(f"probe inputs must be contiguous f32 on {dev}, "
                            f"got {v.dtype} {tuple(v.shape)} on {v.device}")
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    LIB.launch(entry, *tensors, out, *ints)
    launches += 1
    return out


# -- dots (p1, p2, p9) ------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32`` does:
    to nearest, ties away from zero; an f32 tensor of TF32 values."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def _dot_plain(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a [M, K] @ b [K, N] (views), operands TF32-rounded for ``tf32``; f32 sums."""
    _check_precision(precision)
    if precision == "tf32":
        a, b = tf32_round(a), tf32_round(b)
    with highest_precision():
        return a.float() @ b.float()


def tn_dot_plain(a: torch.Tensor, b: torch.Tensor, precision: str = "tf32") -> torch.Tensor:
    """``a.T @ b``: a [K, M], b [K, N] -> [M, N] (contract dim 0 x dim 0)."""
    return _dot_plain(a.t(), b, precision)


def nt_dot_plain(a: torch.Tensor, b: torch.Tensor, precision: str = "tf32") -> torch.Tensor:
    """``a @ b.T``: a [M, K], b [N, K] -> [M, N] (contract dim 1 x dim 1)."""
    return _dot_plain(a, b.t(), precision)


# the TF32 dot's tile (one warpgroup's wgmma M, and N), the K of one commit
# group of its products (16 k8 steps; K is padded with zeros to it), and the
# card's shared memory a CTA (H100: 227 KB)
TF32_TILE_M, TF32_TILE_N, TF32_CHUNK_K = 64, 32, 128
SMEM_MAX = 232_448


class DotPlan(NamedTuple):
    """Launch plan of the TF32 dot: a ``tile`` of C a CTA with all of K
    resident, ``grid`` CTAs (M / 64, N / 32), and ``smem_bytes`` of dynamic
    shared memory a CTA (B in ``wgmma``'s core-matrix order and A's landing
    rows, their K padded with zeros to a multiple of 128; B's landing rows;
    two mbarriers; ``csrc/probes.cu``'s ``wgmma_dot_smem`` is the same
    sum)."""

    tile: Tuple[int, int]
    grid: Tuple[int, int]
    smem_bytes: int

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]


def dot_plan(m: int, n: int, k: int, a_kmajor: bool, b_kmajor: bool) -> DotPlan:
    """The TF32 dot's plan for C [m, n] = A [m, k] @ B [k, n], A's rows
    contiguous along K (``a_kmajor``: p2) or along M (p1), B's along K
    (``b_kmajor``: p2) or along N (p1).  Raises ``ValueError`` naming the rule
    a shape breaks: m % 64, n % 32, k % 8, or both slices too large for one
    CTA's shared memory."""
    tm, tn = TF32_TILE_M, TF32_TILE_N
    if m <= 0 or n <= 0 or k <= 0:
        raise ValueError(f"TF32 dot: empty shape M={m}, N={n}, K={k}")
    if m % tm:
        raise ValueError(f"TF32 dot: M % {tm} == 0 (one wgmma M a CTA), got M={m}")
    if n % tn:
        raise ValueError(f"TF32 dot: N % {tn} == 0 (the CTA's N), got N={n}")
    if k % 8:
        raise ValueError(f"TF32 dot: K % 8 == 0 (wgmma's TF32 k-step), got K={k}")
    k_pad = -(-k // TF32_CHUNK_K) * TF32_CHUNK_K
    a_land = tm * (k_pad + 4) if a_kmajor else k_pad * (tm + 8)
    b_land = tn * (k + 4) if b_kmajor else k * tn
    smem = 4 * (k_pad * tn + a_land + b_land) + 16
    if smem > SMEM_MAX:
        raise ValueError(f"TF32 dot: K={k} needs {smem} bytes of shared memory a CTA "
                         f"(both slices resident), more than {SMEM_MAX}")
    return DotPlan((tm, tn), (m // tm, n // tn), smem)


def _dot(a: torch.Tensor, b: torch.Tensor, m: int, n: int, k: int, strides, precision: str):
    _check_precision(precision)
    if precision == "fp32":
        if m % 64 or n % 64 or k % 32:
            raise ValueError(f"probe dot needs M, N % 64 == 0 and K % 32 == 0, got {m}, {n}, {k}")
        return _launch("ptbxl_probe_dot", (m, n), (a, b), (m, n, k, *strides, 0, 0, 0, 0))
    sam, sak, sbk, sbn = strides
    plan = dot_plan(m, n, k, sak == 1, sbk == 1)
    if (a.data_ptr() | b.data_ptr()) % 16:
        raise ValueError("TF32 dot: operands must start on 16-byte boundaries (16-byte copies)")
    return _launch("ptbxl_probe_dot", (m, n), (a, b),
                   (m, n, k, *strides, 1, *plan.grid, plan.smem_bytes))


def tn_dot(a: torch.Tensor, b: torch.Tensor, precision: str = "tf32") -> torch.Tensor:
    """p1 / p9 on the card; see ``tn_dot_plain``."""
    if a.device.type == "cpu":
        return tn_dot_plain(a, b, precision)
    (k, m), n = a.shape, b.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"contracted dims differ: {tuple(a.shape)} x {tuple(b.shape)}")
    return _dot(a, b, m, n, k, (1, m, n, 1), precision)


def nt_dot(a: torch.Tensor, b: torch.Tensor, precision: str = "tf32") -> torch.Tensor:
    """p2 on the card; see ``nt_dot_plain``."""
    if a.device.type == "cpu":
        return nt_dot_plain(a, b, precision)
    (m, k), n = a.shape, b.shape[0]
    if b.shape[1] != k:
        raise ValueError(f"contracted dims differ: {tuple(a.shape)} x {tuple(b.shape)}")
    return _dot(a, b, m, n, k, (k, 1, 1, k), precision)


# -- data movement (p3-p8, p3b, p5b, p5b2, p5c) -------------------------------------

def roll_add_plain(x: torch.Tensor, lane_shift: int, sublane_shift: int) -> torch.Tensor:
    return torch.roll(x, lane_shift, 1) + torch.roll(x, sublane_shift, 0)


def roll_add(x: torch.Tensor, lane_shift: int, sublane_shift: int) -> torch.Tensor:
    """p3 / p3b: ``roll(x, lane_shift, 1) + roll(x, sublane_shift, 0)``, x [C, T]."""
    if x.device.type == "cpu":
        return roll_add_plain(x, lane_shift, sublane_shift)
    c, t = x.shape
    return _launch("ptbxl_probe_roll_add", (c, t), (x,), (c, t, lane_shift, sublane_shift))


def subblock_rolls_plain(x: torch.Tensor, ks: int = 15) -> torch.Tensor:
    return torch.cat([torch.roll(x, -k, 1) for k in range(ks)], 0)


def subblock_rolls(x: torch.Tensor, ks: int = 15) -> torch.Tensor:
    """p4: rows ``[k*C, (k+1)*C)`` of the ``[ks*C, T]`` output are ``roll(x, -k, 1)``."""
    if x.device.type == "cpu":
        return subblock_rolls_plain(x, ks)
    c, t = x.shape
    return _launch("ptbxl_probe_subblock", (ks * c, t), (x,), (c, t, ks))


def _check_pair_axis(x: torch.Tensor, axis: int) -> None:
    if axis not in (0, 1) or x.dim() != 2 or x.shape[axis] % 2:
        raise ValueError(f"pooling needs a 2-D input even along axis {axis}, got {tuple(x.shape)}")


def pool_slices_plain(x: torch.Tensor, axis: int) -> torch.Tensor:
    _check_pair_axis(x, axis)
    if axis == 0:
        return torch.maximum(x[0::2], x[1::2])
    return torch.maximum(x[:, 0::2], x[:, 1::2])


def pool_slices(x: torch.Tensor, axis: int) -> torch.Tensor:
    """p5 / p5b2: ``max(x[0::2], x[1::2])`` along ``axis`` by strided reads."""
    if x.device.type == "cpu":
        return pool_slices_plain(x, axis)
    _check_pair_axis(x, axis)
    r, w = x.shape
    shape = (r // 2, w) if axis == 0 else (r, w // 2)
    return _launch("ptbxl_probe_pool_slices", shape, (x,), (r, w, axis))


def pool_reshape_plain(x: torch.Tensor, axis: int) -> torch.Tensor:
    _check_pair_axis(x, axis)
    r, w = x.shape
    if axis == 0:
        return x.reshape(r // 2, 2, w).amax(1)
    return x.reshape(r, w // 2, 2).amax(2)


def pool_reshape(x: torch.Tensor, axis: int) -> torch.Tensor:
    """p5b (axis 0, ``[R/2, 2, W]``) / p5c (axis 1, ``[R, W/2, 2]``): the max
    over the pair axis of the reshape."""
    if x.device.type == "cpu":
        return pool_reshape_plain(x, axis)
    _check_pair_axis(x, axis)
    r, w = x.shape
    if axis == 0:
        return _launch("ptbxl_probe_pool_rows_reshape", (r // 2, w), (x,), (r, w))
    return _launch("ptbxl_probe_pool_lanes_reshape", (r, w // 2), (x,), (r, w))


def window_sum_plain(x: torch.Tensor, width: int, ks: int = 15) -> torch.Tensor:
    acc = torch.zeros((x.shape[0], width), dtype=torch.float32, device=x.device)
    for k in range(ks):
        acc = acc + x[:, k:k + width]
    return acc


def window_sum(x: torch.Tensor, width: int, ks: int = 15) -> torch.Tensor:
    """p6: ``sum_{k<ks} x[:, k:k+width]`` (unaligned static slices), sums in k order."""
    if x.device.type == "cpu":
        return window_sum_plain(x, width, ks)
    c, t = x.shape
    if width + ks - 1 > t:
        raise ValueError(f"window_sum: width {width} + {ks - 1} > T {t}")
    return _launch("ptbxl_probe_window_sum", (c, width), (x,), (c, t, width, ks))


def shifted_concat_plain(x: torch.Tensor, ks: int = 15) -> torch.Tensor:
    t = x.shape[0] - ks + 1
    return torch.cat([x[k:k + t] for k in range(ks)], 1)


def shifted_concat(x: torch.Tensor, ks: int = 15) -> torch.Tensor:
    """p7: x [T+ks-1, C] -> [T, ks*C], column block k = ``x[k:k+T]`` (an
    unaligned concat at multiples of C).  Row t is the window ``x[t:t+ks]``
    flattened: float4 copies where C % 4 == 0 and x starts on a 16-byte
    boundary, 4-byte copies otherwise."""
    if x.device.type == "cpu":
        return shifted_concat_plain(x, ks)
    rows, c = x.shape
    t = rows - ks + 1
    if t <= 0:
        raise ValueError(f"shifted_concat: {rows} rows < ks = {ks}")
    return _launch("ptbxl_probe_concat", (t, ks * c), (x,), (t, c, ks))


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


def transpose(x: torch.Tensor) -> torch.Tensor:
    """p8: ``x.T`` of a 2-D x through shared-memory tiles."""
    if x.device.type == "cpu":
        return transpose_plain(x)
    r, w = x.shape
    return _launch("ptbxl_probe_transpose", (w, r), (x,), (r, w))
