"""Inputs and weights made from ``--seed``, in bulk on the device.

* ``records``: synthetic 12-lead ECGs, the waveform of
  ``ptbxl_torch/tools/synthetic_ptbxl.py::_ecg_waveform`` drawn for every
  record and lead at once (beat impulses ``sin(2 pi hr/60 t)^63`` with hr
  U[50, 100) a record, amplitude U[0.5, 2) and baseline wander
  ``0.1 sin(2 pi 0.3 t + phase)`` a lead, noise 0.02 N(0, 1)), returned
  channels-last ``[N, T, 12]`` f32 in pageable host memory, as WFDB's
  ``p_signal`` arrives.
* ``demographics``: ``[N, 5]`` laid out as the port's ``build_demo_vector``.
* ``labels``: multi-hot ``[N, L]``.
* ``weights``: every entry of the configuration's ``params`` list, drawn in
  two calls (one normal, one uniform) and cut into leaves: lecun-scaled conv
  and dense kernels, small biases, BatchNorm scale near 1, running mean near
  0 and running variance in [0.5, 1.5).

The same seed gives the same inputs and weights on the same card and torch
build.  Both the program and the reference are handed what these return.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

_SEED_MOD = 2 ** 63


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one of the run's independent draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % _SEED_MOD)
    return g


def records(n: int, t: int, seed: int, device, fs: float = 500.0) -> np.ndarray:
    """``[n, t, 12]`` f32 raw records in host memory, drawn on ``device``."""
    g = generator(seed, device, 1)
    f = dict(device=device, dtype=torch.float32)
    time_s = torch.arange(t, **f) / fs
    hr = 50.0 + 50.0 * torch.rand(n, 1, 1, generator=g, **f)
    amp = 0.5 + 1.5 * torch.rand(n, 1, 12, generator=g, **f)
    phase = 6.0 * torch.rand(n, 1, 12, generator=g, **f)
    x = torch.randn(n, t, 12, generator=g, **f).mul_(0.02)
    x.add_(amp * torch.sin((2 * math.pi / 60.0) * hr * time_s[None, :, None]).pow_(63))
    x.add_(0.1 * torch.sin(2 * math.pi * 0.3 * time_s[None, :, None] + phase))
    out = x.cpu().numpy()
    del x
    return out


def demographics(n: int, seed: int, device) -> np.ndarray:
    """``[n, 5]`` f32: age/100, sex, height/250 (0 when missing), weight/200
    (0 when missing), pacemaker."""
    g = generator(seed, device, 2)
    u = torch.rand(n, 7, generator=g, device=device)
    age = (20.0 + 70.0 * u[:, 0]) / 100.0
    sex = (u[:, 1] < 0.5).float()
    height = torch.where(u[:, 2] < 0.3, 0.0, (150.0 + 50.0 * u[:, 3]) / 250.0)
    weight = torch.where(u[:, 4] < 0.3, 0.0, (45.0 + 75.0 * u[:, 5]) / 200.0)
    pacemaker = (u[:, 6] < 0.1).float()
    return torch.stack([age, sex, height, weight, pacemaker], 1).cpu().numpy()


def labels(n: int, num_labels: int, rate: float, seed: int, device) -> np.ndarray:
    """``[n, num_labels]`` f32 multi-hot targets, each label on with ``rate``."""
    g = generator(seed, device, 3)
    return (torch.rand(n, num_labels, generator=g, device=device) < rate).float().cpu().numpy()


def _scale(key: str, shape: Sequence[int]) -> Tuple[float, float, str]:
    """(offset, scale, draw) of one leaf, by its role in the model."""
    if key.endswith("running_var"):
        return 0.5, 1.0, "uniform"
    if key.endswith("running_mean"):
        return 0.0, 0.1, "normal"
    is_bn = ".net.1." in key
    if key.endswith("weight") and is_bn:
        return 1.0, 0.1, "normal"
    if key.endswith("bias"):
        return 0.0, 0.05 if not is_bn else 0.1, "normal"
    fan_in = int(np.prod(shape[1:]))
    return 0.0, fan_in ** -0.5, "normal"


def weights(params: List[Tuple[str, Sequence[int]]], seed: int, device
            ) -> Dict[str, torch.Tensor]:
    """Every leaf of ``params`` (``[key, shape]`` pairs) as f32 on ``device``."""
    g = generator(seed, device, 4)
    sizes = [int(np.prod(s)) for _, s in params]
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    out, i = {}, 0
    for (key, shape), size in zip(params, sizes):
        off, scale, draw = _scale(key, shape)
        src = normal if draw == "normal" else uniform
        out[key] = (off + scale * src[i:i + size]).view(*shape).contiguous()
        i += size
    return out
