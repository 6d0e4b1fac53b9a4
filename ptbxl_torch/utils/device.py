"""Device selection and numeric-precision scopes.

Counterpart of ``ptbxl_tpu/utils/platform.py``: JAX picks its backend from
the environment, the port takes an explicit ``device``.  ``None`` means the
GPU; with no GPU that raises instead of falling back to the CPU, so a run
that was meant for the card never silently measures the host.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ptbxl_torch runs on a CUDA GPU by default and none is available; "
            "pass device='cpu' to run on the host explicitly"
        )
    return dev


@contextlib.contextmanager
def highest_precision() -> Iterator[None]:
    """Full-f32 convolutions and matmuls for the scope (TF32 off), restored after.

    cuDNN convolutions run in TF32 by default (``cudnn.allow_tf32`` is True),
    which keeps ~3 decimal digits.  The parity paths (``precision='highest'``
    and every plain reference on the card) enter this scope; nothing is
    changed globally.
    """
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, mm.allow_tf32)
    cudnn.allow_tf32 = False
    mm.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved


@contextlib.contextmanager
def deterministic_algorithms() -> Iterator[None]:
    """cuDNN held to deterministic algorithms, autotuning off, for the scope;
    both flags restored after.

    cuDNN's heuristics may pick a convolution backward whose sums land in a
    different order on each call, so two runs from one seed drift apart and
    AdamW carries the drift to the end of training.  The train and eval steps
    enter this scope (the JAX package's identical-seeds contract,
    tests/test_determinism.py); ``utils.rng.set_seed`` pins the same flags for
    the process, as the reference's ``set_seed`` does.
    """
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def precision_scope(precision: Optional[str]):
    """``highest_precision()`` for ``precision='highest'``, else no change."""
    return highest_precision() if precision == "highest" else contextlib.nullcontext()
