"""Seeding (port of ``ptbxl_tpu/utils/rng.py``).

The reference seeds ``random``, numpy and torch (src/utils/seed.py:7-14);
the JAX package seeds the host generators and returns a PRNGKey.  The port
seeds all three and returns a ``torch.Generator`` for explicit draws.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int = 42) -> torch.Generator:
    """Seed ``random``, numpy and torch (every device); return a CPU generator."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
