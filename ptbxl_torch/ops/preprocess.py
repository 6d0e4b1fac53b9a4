"""Per-lead z-score of a channels-last batch (framework path).

Port of ``ptbxl_tpu/ops/preprocess.py:17-46``: per-(record, lead) mean and
population std over time, ``(x - mean) / (std + 1e-6)``.

* ``zscore_per_lead_batch`` is the exact two-pass form (mean, then centred
  variance).  The ``precision='highest'`` path uses it.
* ``zscore_per_lead_batch_onepass`` takes both moments from one read,
  ``var = E[x^2] - E[x]^2`` in f32 clamped at 0.  The perf precisions use it.
  For a near-constant lead with a large DC offset it loses precision exactly
  as the JAX form does; that is reference behaviour.

The hand-written CUDA kernel of the two-pass form is ``ops/kernels/zscore.py``.
"""

from __future__ import annotations

import torch

EPS = 1e-6


def zscore_per_lead_batch(x: torch.Tensor) -> torch.Tensor:
    """x: [B, T, C] -> [B, T, C] normalized, same dtype."""
    mean = x.mean(dim=1, keepdim=True)
    var = torch.square(x - mean).mean(dim=1, keepdim=True)
    return (x - mean) / (torch.sqrt(var) + EPS)


def zscore_per_lead_batch_onepass(x: torch.Tensor) -> torch.Tensor:
    """One-reduction-pass form: var = E[x^2] - E[x]^2 in f32, clamped at 0."""
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    m2 = (xf * xf).mean(dim=1, keepdim=True)
    var = torch.clamp(m2 - mean * mean, min=0.0)
    return (xf - mean) / (torch.sqrt(var) + EPS)
