"""Capability probes, second round, on the card (port of ``tools/probe_mosaic2.py``, P2).

    python -m ptbxl_torch.tools.probe_mosaic2 [--iters 20] [--device cpu]

p3b (the rolls with a positive lane shift, T-5), p5b / p5b2 (MaxPool(2) over
rows by a reshape or by strided slices), p5c (over columns by a reshape) and
p9 (p1's TN dot at full FP32, the TPU's HIGHEST).  On the card p9 beside p1
says what the exact product costs and how much error the TF32 one carries.
Output and gates as ``ptbxl_torch.tools.probe_mosaic``.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np
import torch

from ptbxl_torch.ops.kernels import probes as kp
from ptbxl_torch.tools.probe_mosaic import Probe, dot_probe, main, normal

T = 2560

PROBES: List[Probe] = [
    Probe("p3b", "P3b roll positive shifts", lambda d: (normal((64, T), 0, d),),
          lambda x: kp.roll_add(x, T - 5, 3), lambda x: kp.roll_add_plain(x, T - 5, 3),
          lambda x: torch.roll(x, T - 5, 1) + torch.roll(x, 3, 0),
          lambda x: np.roll(x, -5, axis=1) + np.roll(x, 3, axis=0), "torch.roll x2 + add"),
    Probe("p5b", "P5b pool via sublane reshape [T/2,2,C]", lambda d: (normal((2048, 64), 0, d),),
          lambda x: kp.pool_reshape(x, 0), lambda x: kp.pool_reshape_plain(x, 0),
          lambda x: x.reshape(1024, 2, 64).amax(1),
          lambda x: x.reshape(1024, 2, 64).max(axis=1), "reshape + amax"),
    Probe("p5b2", "P5b2 pool via sublane strided slices", lambda d: (normal((2048, 64), 0, d),),
          lambda x: kp.pool_slices(x, 0), lambda x: kp.pool_slices_plain(x, 0),
          lambda x: torch.maximum(x[0::2], x[1::2]),
          lambda x: np.maximum(x[0::2], x[1::2]), "torch.maximum of strided slices"),
    Probe("p5c", "P5c pool via lane reshape [C,T/2,2]", lambda d: (normal((64, 2048), 0, d),),
          lambda x: kp.pool_reshape(x, 1), lambda x: kp.pool_reshape_plain(x, 1),
          lambda x: x.reshape(64, 1024, 2).amax(2),
          lambda x: x.reshape(64, 1024, 2).max(axis=2), "reshape + amax"),
    dot_probe("p9", "P9 TN dot HIGHEST precision", "tn", "fp32"),
]


if __name__ == "__main__":
    sys.exit(main(probes=PROBES))
