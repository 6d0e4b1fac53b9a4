"""ADC -> physical conversion on the device (port of ``ptbxl_tpu/ops/adc_convert.py``).

The ADC cache stores lossless int16 samples; shipping those and converting
on the device halves the host-to-device bytes of the f32 path.
``phys = (adc - baseline) / gain``, with the WFDB missing-sample sentinel
(-32768) mapped to NaN.
"""

from __future__ import annotations

import torch

_SENTINEL = -32768


def adc_to_physical_batch(adc: torch.Tensor, gain: torch.Tensor,
                          baseline: torch.Tensor) -> torch.Tensor:
    """adc [B, T, C] int16; gain / baseline [B, C] -> physical f32 [B, T, C]."""
    phys = (adc.float() - baseline[:, None, :]) / gain[:, None, :]
    return torch.where(adc == _SENTINEL, torch.full_like(phys, float("nan")), phys)


def adc_lt_to_physical_batch(adc_lt: torch.Tensor, gain: torch.Tensor,
                             baseline: torch.Tensor) -> torch.Tensor:
    """adc [B, C, T] int16 (the cache's own layout, shipped untransposed) ->
    physical f32 [B, T, C]."""
    return adc_to_physical_batch(adc_lt.transpose(1, 2), gain, baseline).contiguous()
