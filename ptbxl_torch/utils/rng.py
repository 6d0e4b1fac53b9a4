"""Seeding (port of ``ptbxl_tpu/utils/rng.py``).

The reference seeds ``random``, numpy and torch and pins cuDNN determinism
(src/utils/seed.py:7-14); the JAX package seeds the host generators and
returns a PRNGKey (XLA's programs are deterministic).  The port seeds all
three, pins cuDNN to deterministic algorithms with autotuning off, and
returns a ``torch.Generator`` for explicit draws.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int = 42) -> torch.Generator:
    """Seed ``random``, numpy and torch (every device), set
    ``cudnn.deterministic`` and clear ``cudnn.benchmark``; return a CPU generator."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.Generator().manual_seed(seed)
