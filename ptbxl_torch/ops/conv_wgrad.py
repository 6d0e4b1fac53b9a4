"""The train-mode conv of ``ConvBlock`` whose f32 weight gradient is the
hand-written kernel (``ops/kernels/conv_wgrad.py``).

``conv1d_same(x, w, padding, training)`` on ``x [B, Cin, T]``, ``w [Cout, Cin,
k]`` is ``F.conv1d(x, w, padding=padding)``.  Where the card's weight
gradient takes it (``takes_wgrad_kernel``: a CUDA tensor, f32 operands, TF32
off, as ``precision='highest'`` sets it, no autocast, k=15 with SAME padding 7,
Cout a multiple of 32, autograd recording the weight's gradient, a block in
training mode), it is a ``torch.autograd.Function`` whose

* forward is the same ``F.conv1d`` call, so the primal and cuDNN's fprop are
  unchanged;
* backward returns dx from ``torch.nn.grad.conv1d_input``, the cuDNN dgrad
  autograd calls (none where the input needs no gradient: block 0), and dW
  from the kernel: deterministic, like the pinned cuDNN algorithm it
  replaces, and captured by the train step's CUDA graph.

Everything else keeps autograd through ``F.conv1d``: bf16 operands, TF32
(``precision='default'``), eval mode (Grad-CAM, serving), the CPU.  The phase
path (``ConvBlock._phase_forward``) never comes here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ptbxl_torch.ops.kernels.conv_wgrad import CO_TILE, K, PAD, conv_wgrad


class _KernelWgradConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv1d(x, w, padding=PAD)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv1d_input(x.shape, w, dy, padding=PAD)
        if ctx.needs_input_grad[1]:
            dw = conv_wgrad(x, dy)
        return dx, dw


def takes_wgrad_kernel(x: torch.Tensor, w: torch.Tensor, padding) -> bool:
    """Whether the kernel computes this conv's weight gradient (see the module docstring)."""
    return (x.is_cuda and x.dtype == torch.float32 and w.dtype == torch.float32
            and w.shape[2] == K and padding in (PAD, (PAD,)) and w.shape[0] % CO_TILE == 0
            and w.requires_grad and torch.is_grad_enabled()
            and not torch.backends.cudnn.allow_tf32 and not torch.is_autocast_enabled("cuda"))


def conv1d_same(x: torch.Tensor, w: torch.Tensor, padding, training: bool) -> torch.Tensor:
    """``F.conv1d(x, w, padding=padding)``, its weight gradient the kernel's
    in a training block where ``takes_wgrad_kernel`` holds."""
    if training and takes_wgrad_kernel(x, w, padding):
        return _KernelWgradConv.apply(x, w)
    return F.conv1d(x, w, padding=padding)
