"""Optional ECG signal-conditioning ops (port of ``ptbxl_tpu/ops/signal.py``).

The reference filters and resamples nothing (its only preprocessing is the
per-lead z-score); these composable ops are off by default, as in the JAX
package:

* ``fir_bandpass``: a Hamming-windowed sinc bandpass as a depthwise
  ``F.conv1d`` (``groups=C``) with symmetric zero padding
* ``remove_baseline_wander``: subtract a moving-average trend, the same way
* ``resample_linear``: fixed-ratio linear resampling on the f32 positions
  that JAX's ``jnp.linspace(0, stop, n)`` yields (XLA folds its division
  into ``i * (stop * (1 / (n - 1)))``; the last is ``stop``), with floor /
  clamp indices.  A position one ulp away moves the weight by ~1e-4 at
  T = 1000, so the rounding is kept

All take and return channels-last ``[B, T, C]`` on the input's device.  The
convolutions run with TF32 off, as JAX runs them at ``precision="highest"``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ptbxl_torch.utils.device import highest_precision


def _sinc_kernel(lo_hz: float, hi_hz: float, fs: float, num_taps: int) -> np.ndarray:
    """Hamming-windowed sinc bandpass kernel (host-side, static)."""
    if num_taps % 2 == 0:
        num_taps += 1
    t = np.arange(num_taps) - (num_taps - 1) / 2
    nyq = fs / 2.0
    if not 0 <= lo_hz < hi_hz <= nyq:
        raise ValueError(
            f"band edges must satisfy 0 <= lo ({lo_hz}) < hi ({hi_hz}) <= "
            f"Nyquist ({nyq})"
        )

    def lowpass(cut):
        return np.sinc(2 * cut / fs * t) * (2 * cut / fs)

    h = lowpass(hi_hz) - (lowpass(lo_hz) if lo_hz > 0 else 0.0)
    h *= np.hamming(num_taps)
    if lo_hz <= 0:  # pure lowpass: normalize DC gain
        h /= h.sum()
    return h.astype(np.float32)


def _depthwise(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``h`` [k] (k odd) over every lead of ``x`` [B, T, C], padded k // 2 each side."""
    c, k = x.shape[-1], h.shape[0]
    w = h.to(device=x.device, dtype=x.dtype).view(1, 1, k).expand(c, 1, k)
    with highest_precision():
        y = F.conv1d(x.transpose(1, 2), w, padding=k // 2, groups=c)
    return y.transpose(1, 2)


def fir_bandpass(x: torch.Tensor, lo_hz: float = 0.5, hi_hz: float = 40.0, fs: float = 500.0,
                 num_taps: int = 101) -> torch.Tensor:
    """Zero-phase-ish FIR bandpass applied per lead. x: [B, T, C]."""
    return _depthwise(x, torch.from_numpy(_sinc_kernel(lo_hz, hi_hz, fs, num_taps)))


def remove_baseline_wander(x: torch.Tensor, fs: float = 500.0,
                           window_s: float = 0.6) -> torch.Tensor:
    """Subtract a moving-average trend (classic baseline-wander removal)."""
    w = int(round(window_s * fs))
    if w % 2 == 0:
        w += 1
    return x - _depthwise(x, torch.full((w,), 1.0 / w))


def _linspace(stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(0, stop, num)`` in f32, rounded as JAX rounds it."""
    if num <= 1:
        return torch.zeros(num, device=device)
    f32 = np.float32
    delta = float(f32(stop) * (f32(1) / f32(num - 1)))  # one f32 product, exact in f64
    i = torch.arange(num - 1, dtype=torch.float32, device=device)
    return torch.cat([i * delta, torch.full((1,), stop, device=device)])


def resample_linear(x: torch.Tensor, fs_in: float, fs_out: float) -> torch.Tensor:
    """Linear resampling along the time axis. x: [B, T, C] -> [B, T', C]."""
    t_in = x.shape[1]
    t_out = int(round(t_in * fs_out / fs_in))
    pos = _linspace(t_in - 1.0, t_out, x.device)
    i0 = torch.floor(pos).long()
    i1 = torch.clamp(i0 + 1, max=t_in - 1)
    w = (pos - i0).to(x.dtype)[None, :, None]
    return x[:, i0, :] * (1 - w) + x[:, i1, :] * w
