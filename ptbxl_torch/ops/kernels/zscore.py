"""K1: per-lead z-score, CUDA kernel + plain PyTorch version.

Replaces ``ptbxl_tpu/ops/pallas/zscore.py``: ``zscore_tile`` (:44),
``_zscore_kernel`` (:59) and ``zscore_pallas`` (:64, pallas_call :72).
Kernel: ``ptbxl_torch/csrc/zscore.cu``.

What bounds it on the H100: bytes (one read of the input, one write of the
output, a few operations an element).  The design (one block per record,
threads strided by a multiple of C so each keeps one lead's partial, added
in f64 so a large DC offset costs no bits) is described in the source.

``zscore`` maps ``[B, T, C]`` to the same shape, f32 sums, output dtype =
input dtype unless ``out_dtype`` says otherwise (f32 and bf16).
``zscore_stats`` writes only ``[B, C, 2]`` = (mean, std + 1e-6); the fused
ECGCNN forward applies it while loading block 0.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  ``launches`` counts kernel launches (both entries).
"""

from __future__ import annotations

from typing import Optional

import torch

from ptbxl_torch.ops.kernels import _build
from ptbxl_torch.ops.preprocess import EPS

launches = 0

_SIGNATURES = {
    "ptbxl_zscore": [_build.INT, _build.VOIDP, _build.VOIDP, _build.INT, _build.INT,
                     _build.INT, _build.INT, _build.INT, _build.VOIDP],
    "ptbxl_zscore_stats": [_build.INT, _build.VOIDP, _build.VOIDP, _build.INT, _build.INT,
                           _build.INT, _build.INT, _build.VOIDP],
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
