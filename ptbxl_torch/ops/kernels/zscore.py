"""K1 and K5: per-lead z-score, CUDA kernels + plain PyTorch versions.

K1 replaces ``ptbxl_tpu/ops/pallas/zscore.py``: ``zscore_tile`` (:44),
``_zscore_kernel`` (:59) and ``zscore_pallas`` (:64, pallas_call :72).
K5 replaces ``_zscore_wide_kernel`` (:82) and ``zscore_pallas_wide`` (:107,
pallas_call :130): the same function on a ``[T*C/W, W]`` view of each
record.  Kernels: ``ptbxl_torch/csrc/zscore.cu``.

What bounds it on the H100: bytes (one read of the input, one write of the
output, a few operations an element).  The design (one block per record,
threads strided by a multiple of C so each keeps one lead's partial, added
in f64 so a large DC offset costs no bits) is described in the source.

``zscore`` maps ``[B, T, C]`` to the same shape, f32 sums, output dtype =
input dtype unless ``out_dtype`` says otherwise (f32 and bf16).
``zscore_stats`` writes only ``[B, C, 2]`` = (mean, std + 1e-6); the fused
ECGCNN forward applies it while loading block 0.

``zscore_wide`` (K5) computes what ``zscore`` computes, with the argument
checks of the JAX function (``width`` divides T*C and is a multiple of C),
``width`` (default 480) and ``block_b`` (default 8).  On the card ``width``
is the row a block reads with coalesced loads and ``block_b`` the records a
block takes in turn; the ragged last group is masked, so B is not padded.
``zscore_wide_plain`` follows the JAX kernel's arithmetic on the view: B
padded to a multiple of ``block_b``, per-slot sums folded by lead.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  ``launches`` counts K1 launches (both entries), ``launches_wide``
K5 launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from ptbxl_torch.ops.kernels import _build
from ptbxl_torch.ops.preprocess import EPS

launches = 0
launches_wide = 0

_SIGNATURES = {
    "ptbxl_zscore": [_build.INT, _build.VOIDP, _build.VOIDP, _build.INT, _build.INT,
                     _build.INT, _build.INT, _build.INT, _build.VOIDP],
    "ptbxl_zscore_stats": [_build.INT, _build.VOIDP, _build.VOIDP, _build.INT, _build.INT,
                           _build.INT, _build.INT, _build.VOIDP],
    # device, x, out, B, T, C, W, block_b, in_bf16, out_bf16, stream
    "ptbxl_zscore_wide": [_build.INT, _build.VOIDP, _build.VOIDP] + [_build.INT] * 7
                         + [_build.VOIDP],
}
_DTYPES = (torch.float32, torch.bfloat16)


def _moments(xf: torch.Tensor):
    """Two-pass per-lead mean and ``sqrt(var) + eps`` of an f32 [B, T, C].

    The f32 form of ``zscore_tile``: f32 addends (x, and the f32 square of
    x - mean), totals rounded to f32 before the division by T.  The totals
    are accumulated in f64, as the kernel does, so neither side loses bits
    to its summation order when a lead's DC offset is large beside its std.
    T is a tensor on the data's device: PyTorch's CUDA division by a host
    scalar multiplies by its reciprocal, which can be 1 ulp off the kernel's
    IEEE division.
    """
    t = xf.new_tensor(float(xf.shape[1]))
    mean = xf.sum(dim=1, keepdim=True, dtype=torch.float64).float() / t
    cen = xf - mean
    sq = (cen * cen).sum(dim=1, keepdim=True, dtype=torch.float64).float()
    sd = torch.sqrt(sq / t) + EPS
    return mean, sd


def zscore_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """[B, T, C] -> [B, C, 2] f32: (mean, std + eps)."""
    mean, sd = _moments(x.float())
    return torch.stack([mean[:, 0], sd[:, 0]], dim=-1)


def zscore_plain(x: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain form of the kernel: ``zscore_tile`` on each record, f32 inside."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    xf = x.float()
    mean, sd = _moments(xf)
    return ((xf - mean) / sd).to(out_dtype)


def _check_input(x: torch.Tensor) -> None:
    if x.dim() != 3:
        raise ValueError(f"expected [B, T, C], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"zscore kernel takes float32 or bfloat16, got {x.dtype}")
    if x.device.type != "cuda":
        raise RuntimeError(f"zscore kernel needs a CUDA tensor, got {x.device}")


def _lib():
    return _build.load_library("zscore", _SIGNATURES)


def zscore(x: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: [B, T, C] -> per-lead z-scored, f32 accumulation."""
    global launches
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return zscore_plain(x, out_dtype)
    _check_input(x)
    if out_dtype not in _DTYPES:
        raise TypeError(f"zscore kernel writes float32 or bfloat16, got {out_dtype}")
    x = x.contiguous()
    b, t, c = x.shape
    out = torch.empty((b, t, c), dtype=out_dtype, device=x.device)
    if b == 0:
        return out
    lib = _lib()
    err = lib.ptbxl_zscore(
        x.get_device(), x.data_ptr(), out.data_ptr(), b, t, c,
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "zscore launch")
    launches += 1
    return out


def zscore_stats(x: torch.Tensor) -> torch.Tensor:
    """x: [B, T, C] -> [B, C, 2] f32 (mean, std + 1e-6) per record and lead."""
    global launches
    if x.device.type == "cpu":
        return zscore_stats_plain(x)
    _check_input(x)
    x = x.contiguous()
    b, t, c = x.shape
    stats = torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
    if b == 0:
        return stats
    lib = _lib()
    err = lib.ptbxl_zscore_stats(
        x.get_device(), x.data_ptr(), stats.data_ptr(), b, t, c,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "zscore_stats launch")
    launches += 1
    return stats


def _check_wide(x: torch.Tensor, width: int, block_b: int) -> None:
    """The JAX function's argument checks (zscore.py:123-124), and ``block_b`` >= 1."""
    if x.dim() != 3:
        raise ValueError(f"expected [B, T, C], got shape {tuple(x.shape)}")
    _, t, c = x.shape
    if width <= 0 or (t * c) % width or width % c:
        raise ValueError(f"width {width} must divide T*C={t * c} and be a multiple of C={c}")
    if block_b < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")


def _fold_leads(slot_sums: torch.Tensor, c: int) -> torch.Tensor:
    """[B, W] per-slot totals -> [B, W]: each slot gets its lead's total (slot l is lead l % C)."""
    b, w = slot_sums.shape
    lead = slot_sums.view(b, w // c, c).sum(dim=1)  # [B, C]
    return lead.repeat(1, w // c)


def zscore_wide_plain(x: torch.Tensor, out_dtype: Optional[torch.dtype] = None,
                      width: int = 480, block_b: int = 8) -> torch.Tensor:
    """Plain form of K5: ``_zscore_wide_kernel`` on the ``[B, T*C/W, W]`` view.

    f32 addends, per-slot sums over the rows, folded by lead (the TPU kernel's
    ``[W, W]`` 0/1 product), totals in f64 and rounded to f32 before the
    division by T, as ``zscore_plain``.
    """
    _check_wide(x, width, block_b)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    b, t, c = x.shape
    bp = -(-b // block_b) * block_b
    xw = x.float().reshape(b, (t * c) // width, width)
    if bp != b:
        xw = torch.cat([xw, xw.new_zeros((bp - b,) + xw.shape[1:])])
    tt = xw.new_tensor(float(t))
    mean = _fold_leads(xw.sum(dim=1, dtype=torch.float64), c).float() / tt
    cen = xw - mean[:, None, :]
    sq = _fold_leads((cen * cen).sum(dim=1, dtype=torch.float64), c).float()
    sd = torch.sqrt(sq / tt) + EPS
    return (cen / sd[:, None, :]).to(out_dtype)[:b].reshape(b, t, c)


def zscore_wide(x: torch.Tensor, out_dtype: Optional[torch.dtype] = None, width: int = 480,
                block_b: int = 8) -> torch.Tensor:
    """x: [B, T, C] -> per-lead z-scored (K5), f32 accumulation; out dtype = x's unless given."""
    global launches_wide
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return zscore_wide_plain(x, out_dtype, width, block_b)
    _check_input(x)
    _check_wide(x, width, block_b)
    if out_dtype not in _DTYPES:
        raise TypeError(f"zscore kernel writes float32 or bfloat16, got {out_dtype}")
    x = x.contiguous()
    b, t, c = x.shape
    out = torch.empty((b, t, c), dtype=out_dtype, device=x.device)
    if b == 0:
        return out
    lib = _lib()
    err = lib.ptbxl_zscore_wide(
        x.get_device(), x.data_ptr(), out.data_ptr(), b, t, c, width, block_b,
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "zscore_wide launch")
    launches_wide += 1
    return out
