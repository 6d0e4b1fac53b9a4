"""Tracing and profiling (port of ``ptbxl_tpu/utils/profiling.py``).

* ``StepTimer``: wall-clock time and records per second over the steps of
  an epoch; the train loop runs it under ``PTBXL_TORCH_PERF=1`` (the default
  output stays the reference's).
* ``trace``: a ``torch.profiler`` session around a block that writes a
  TensorBoard-loadable trace (``tensorboard_trace_handler``) into
  ``log_dir`` or ``PTBXL_TORCH_TRACE``; a no-op when neither is set.  It
  records the CPU and, when there is one, the GPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def perf_enabled() -> bool:
    return os.environ.get("PTBXL_TORCH_PERF", "") not in ("", "0")


class StepTimer:
    """Accumulates (records, seconds) across steps of one epoch."""

    def __init__(self):
        self.records = 0.0
        self.seconds = 0.0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_records: float):
        if self._t0 is None:
            return
        self.seconds += time.perf_counter() - self._t0
        self.records += n_records
        self._t0 = None

    @property
    def records_per_sec(self) -> float:
        return self.records / self.seconds if self.seconds > 0 else 0.0

    def report(self, label: str) -> str:
        return (f"[PERF] {label}: {self.records:.0f} records in {self.seconds:.2f}s "
                f"-> {self.records_per_sec:.1f} rec/s")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler trace context; no-op when neither ``log_dir`` nor
    ``PTBXL_TORCH_TRACE`` is set."""
    log_dir = log_dir or os.environ.get("PTBXL_TORCH_TRACE")
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
