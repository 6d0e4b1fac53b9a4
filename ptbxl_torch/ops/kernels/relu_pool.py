"""K6: the backward of relu -> MaxPool1d(2), CUDA kernel + plain PyTorch version.

Replaces ``ptbxl_tpu/ops/relu_pool.py``: ``_bwd_kernel`` (:65), launched by
``_pallas_bwd`` (:94, pallas_call :115); the plain version is ``_jnp_bwd``
(:125).  Kernel: ``ptbxl_torch/csrc/relu_pool.cu``.

``relu_pool_bwd(h, g)``: ``h`` the pre-activation ``[B, C, T]``, ``g`` the
cotangent of ``relu(max_pool1d(h, 2))`` ``[B, C, T // 2]``, both f32 or both
bf16 -> ``dh [B, C, T]`` in that dtype: ``g / cnt`` where ``relu(h)`` equals
its window's max and ``h > 0``, else 0; ``cnt`` counts the window's ties,
so a tie splits the cotangent evenly; the odd tail element gets 0.  Math
in f32.  The port keeps JAX's ``[B, T, C]`` at its public functions but
its activations are ``[B, C, T]``, so a window is two neighbouring floats.

What bounds it on the H100: bytes (h and g read once, dh written once).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from ptbxl_torch.ops.kernels import _build

launches = 0

_SIGNATURES = {
    # device, h, g, dh, rows, T, bf16, stream
    "ptbxl_relu_pool_bwd": [_build.INT, _build.VOIDP, _build.VOIDP, _build.VOIDP,
                            _build.INT, _build.INT, _build.INT, _build.VOIDP],
}
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_WINDOWS = 2 ** 31 - 1  # the kernel's flat window index is 32-bit


def relu_pool_bwd_plain(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``_jnp_bwd`` on ``[B, C, T]``: the same tie math, f32 inside, g's dtype out."""
    b, c, t = h.shape
    u_len = g.shape[-1]
    u = torch.relu(h[..., :2 * u_len].float()).reshape(b, c, u_len, 2)
    y = u.amax(dim=-1, keepdim=True)
    eq = u == y
    cnt = eq.sum(dim=-1, keepdim=True, dtype=torch.float32)
    scale = g.float()[..., None] / torch.clamp(cnt, min=1.0)
    dh = torch.where(eq & (u > 0), scale, torch.zeros((), device=h.device))
    dh = dh.reshape(b, c, 2 * u_len)
    if t > 2 * u_len:  # the odd tail element never pools
        dh = torch.cat([dh, dh.new_zeros(b, c, t - 2 * u_len)], dim=-1)
    return dh.to(g.dtype)


def _check(h: torch.Tensor, g: torch.Tensor) -> None:
    if h.dim() != 3:
        raise ValueError(f"expected h [B, C, T], got shape {tuple(h.shape)}")
    b, c, t = h.shape
    if tuple(g.shape) != (b, c, t // 2):
        raise ValueError(f"g must be [B, C, T // 2] = {(b, c, t // 2)}, got {tuple(g.shape)}")
    if h.dtype not in _DTYPES or g.dtype != h.dtype:
        raise TypeError(f"relu_pool_bwd takes h and g both float32 or both bfloat16, "
                        f"got {h.dtype}, {g.dtype}")
    if h.device.type != "cuda" or g.device != h.device:
        raise RuntimeError(f"relu_pool_bwd kernel needs CUDA tensors on one device, "
                           f"got {h.device}, {g.device}")
    if b * c * ((t + 1) // 2) > _MAX_WINDOWS:
        raise ValueError(f"relu_pool_bwd: {b * c * ((t + 1) // 2)} windows exceed 2^31 - 1")


def relu_pool_bwd(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dh of ``relu(max_pool1d(h, 2))`` for the cotangent ``g`` (see the module docstring)."""
    global launches
    if h.device.type == "cpu" and g.device.type == "cpu":
        return relu_pool_bwd_plain(h, g)
    _check(h, g)
    h, g = h.contiguous(), g.contiguous()
    dh = torch.empty(h.shape, dtype=g.dtype, device=h.device)
    if h.numel() == 0:
        return dh
    b, c, t = h.shape
    lib = _build.load_library("relu_pool", _SIGNATURES)
    err = lib.ptbxl_relu_pool_bwd(
        h.get_device(), h.data_ptr(), g.data_ptr(), dh.data_ptr(), b * c, t,
        int(h.dtype == torch.bfloat16), torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(lib, err, "relu_pool_bwd launch")
    launches += 1
    return dh
