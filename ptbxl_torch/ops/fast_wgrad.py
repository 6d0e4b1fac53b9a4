"""1-D convolution whose weight gradient is one phase-packed matmul (port of
``ptbxl_tpu/ops/fast_wgrad.py``).

The first conv's backward (12 -> 32, k=15, T=5000) is all weight gradient:
its input is the network's input.  A conv lowers that gradient as a conv
with batch and feature roles swapped, at Cin=12 / Cout=32 a poor shape for
a matrix unit.  The same sum folds P time-phases into the free dimensions
of one product:

    t = P*u + p                      dy -> [B*U, P*Cout]            (a view)
    xpad[P*u + (p+kk)], p+kk = P*q + r
                                     x  -> [B*U, (qmax+1)*P*Cin]    (q-shifted views)
    out[(q,r,ci),(p,co)] = sum_{b,u} xph[b, u+q, r, ci] * dy[b, u, p, co]
    wgrad[kk,ci,co]      = sum_p out[(p+kk)//P, (p+kk)%P, ci, p, co]

At block 0 (P=8): M=288, N=256, K=B*625, reading x and dy once.

``conv1d_fast_wgrad(x, kernel, padding, precision, phases)`` takes JAX's
layouts (``x [B, T, Cin]``, ``kernel [k, Cin, Cout]``, ``padding (pl, pr)``)
and is a ``torch.autograd.Function``:

* forward: the port's plain conv, ``F.conv1d`` on the channels-first views,
  so the primal is bit-identical to autograd's;
* dx: ``torch.nn.grad.conv1d_input``, the call autograd makes, bit-identical;
* dw: one ``torch.matmul`` in the operands' dtype (a bf16 product rounds its
  sums once to bf16, as a bf16 conv's wgrad does) and the tap sum in f32.
  JAX computes this product as a plain ``lax.dot_general``, outside any
  Pallas kernel.

``precision='highest'`` runs all three with TF32 off.  With no phase count
dividing T the weight gradient is the conv form (``_wgrad_conv_fallback``).
It is not wired into the model, as in JAX; ``tools/probe_bwd_breakdown.py``
prices it in the train step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ptbxl_torch.utils.device import precision_scope


def _pick_phases(t: int, max_phases: int = 8) -> int:
    """Largest power of two <= max_phases dividing T (1 disables packing)."""
    p = 1
    while p * 2 <= max_phases and t % (p * 2) == 0:
        p *= 2
    return p


def _pad_cf(x_cf: torch.Tensor, padding: Tuple[int, int]) -> Tuple[torch.Tensor, int]:
    """(input, conv padding): symmetric padding goes to ``F.conv1d`` as autograd's
    call would; an asymmetric one pads the input first."""
    pl, pr = padding
    if pl == pr:
        return x_cf, pl
    return F.pad(x_cf, (pl, pr)), 0


def _wgrad_conv_fallback(x: torch.Tensor, dy: torch.Tensor, k: int,
                         padding: Tuple[int, int]) -> torch.Tensor:
    """The wgrad as a conv with the batch as the contraction feature (JAX's
    ``CWN``/``IWO`` form): ``x [B, T, Cin]``, ``dy [B, T', Cout]`` -> ``[k, Cin, Cout]``."""
    xin, pad = _pad_cf(x.permute(2, 0, 1), padding)          # [Cin, B, T]
    out = F.conv1d(xin, dy.permute(2, 0, 1), padding=pad)    # [Cin, Cout, k]
    return out.permute(2, 0, 1)


def _phase_packed_wgrad(x: torch.Tensor, dy: torch.Tensor, k: int, padding: Tuple[int, int],
                        phases: int) -> torch.Tensor:
    """``wgrad[kk, ci, co] = sum_{b,t} xpad[b, t+kk, ci] * dy[b, t, co]`` as one
    matmul (f32 out)."""
    bsz, t, ci = x.shape
    co = dy.shape[-1]
    p = phases
    if p <= 1 or t % p:
        return _wgrad_conv_fallback(x, dy, k, padding).float()
    pl, pr = padding
    u = t // p
    qmax = (p - 1 + k - 1) // p
    need = p * (u + qmax)
    extra = need - (t + pl + pr)
    xpad = F.pad(x, (0, 0, pl, pr + max(extra, 0)))
    if extra < 0:  # more conv padding than the phase grid needs
        xpad = xpad[:, :need]
    xph = xpad.reshape(bsz, u + qmax, p, ci)
    lhs = torch.stack([xph[:, q:q + u] for q in range(qmax + 1)], dim=2)
    lhs = lhs.reshape(bsz * u, (qmax + 1) * p * ci)
    rhs = dy.reshape(bsz * u, p * co)
    out = torch.matmul(lhs.t(), rhs).float().view((qmax + 1) * p, ci, p, co)
    # tap kk takes row s = ph + kk (= q*P + r) at phase ph, summed over the phases:
    # one gather and one sum, not k*P slices
    ph = torch.arange(p, device=x.device)
    rows = torch.arange(k, device=x.device)[:, None] + ph
    return out[rows, :, ph].sum(dim=1)  # [k, P, Cin, Cout] -> [k, Cin, Cout]


def _forward_cf(x: torch.Tensor, kernel: torch.Tensor,
                padding: Tuple[int, int]) -> torch.Tensor:
    xin, pad = _pad_cf(x.transpose(1, 2), padding)
    return F.conv1d(xin, kernel.permute(2, 1, 0), padding=pad)


class _FastWgrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, padding, precision, phases):
        ctx.save_for_backward(x, kernel)
        ctx.conf = (padding, precision, phases)
        with precision_scope(precision):
            return _forward_cf(x, kernel, padding).transpose(1, 2)

    @staticmethod
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        padding, precision, phases = ctx.conf
        k = kernel.shape[0]
        dx = dw = None
        with precision_scope(precision):
            if ctx.needs_input_grad[0]:
                xin, pad = _pad_cf(x.transpose(1, 2), padding)
                dx = torch.nn.grad.conv1d_input(xin.shape, kernel.permute(2, 1, 0),
                                                dy.transpose(1, 2), padding=pad)
                if xin.shape[2] != x.shape[1]:
                    dx = dx[:, :, padding[0]:padding[0] + x.shape[1]]
                dx = dx.transpose(1, 2)
            if ctx.needs_input_grad[1]:
                t = x.shape[1]
                p = phases if t % max(phases, 1) == 0 else _pick_phases(t, phases)
                dw = _phase_packed_wgrad(x, dy, k, padding, p).to(kernel.dtype)
        return dx, dw, None, None, None


def conv1d_fast_wgrad(x: torch.Tensor, kernel: torch.Tensor, padding: Tuple[int, int],
                      precision: Optional[str] = None, phases: int = 8) -> torch.Tensor:
    """Stride-1 conv1d in JAX's layouts (``x [B, T, Cin]``, ``kernel [k, Cin,
    Cout]`` -> ``[B, T', Cout]``) whose weight gradient is phase-packed (see the
    module docstring)."""
    return _FastWgrad.apply(x, kernel, tuple(padding), precision, phases)
