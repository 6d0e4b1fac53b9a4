"""Tracing and profiling (port of ``ptbxl_tpu/utils/profiling.py``).

* ``span(name, **counts)``: a span of the port's own layers (the serving
  API's chunk path, the train step, the feed's threads), recorded in memory
  while a ``torch.profiler`` session records and nowhere else.  Each record
  (``Span``) holds its name, its start and end on ``time.perf_counter_ns()``
  (the clock the benchmark's host spans use, mapped onto the profiler's by
  their offset), its id, its parent's and its root's (so every span of one
  ``Predictor`` call or one train step shares its root's id), its thread and
  the integer counts given (``bytes``, ``rows``, ``pad_rows``).  A recorded
  span also opens a ``record_function`` range of its name, so the trace
  shows it: the fast form that torch's own compiled code uses
  (``torch._C._profiler._RecordFunctionFast``; a whole span cost ~5 us on
  an H100 machine's host with it, ~14 us with
  ``torch.profiler.record_function``).  ``spans()``
  reads the records and ``clear()`` empties them.  Off, a span is one read
  of the profiler's flag and a shared no-op context; on or off it never
  synchronises and never reads a device tensor.
* ``StepTimer``: wall-clock time and records per second over an epoch; the
  train loop runs it under ``PTBXL_TORCH_PERF=1`` (the default output stays
  the reference's), from the epoch's first step to its last loss read, so it
  waits for the card once an epoch and times the loop it does not change.
* ``trace``: a ``torch.profiler`` session around a block that writes a
  TensorBoard-loadable trace (``tensorboard_trace_handler``) into
  ``log_dir`` or ``PTBXL_TORCH_TRACE``; a no-op when neither is set.  It
  records the CPU and, when there is one, the GPU, and the spans above.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import List, Mapping, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    id: int
    parent: int  # 0 for a root
    root: int  # the root's id (its own for a root)
    thread: int  # threading.get_ident()
    counts: Mapping[str, int]


# the newest records; a session longer than this keeps its last ones
_records: "collections.deque[Span]" = collections.deque(maxlen=1 << 20)
_ids = itertools.count(1)
_open = threading.local()  # each thread's stack of open spans
_OFF = contextlib.nullcontext()


class _Recording:
    __slots__ = ("name", "counts", "id", "parent", "root", "start_ns", "_rf")

    def __init__(self, name: str, counts: Mapping[str, int]):
        self.name, self.counts = name, counts

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer else 0
        self.root = outer.root if outer else self.id
        stack.append(self)
        self._rf = torch._C._profiler._RecordFunctionFast(self.name)
        self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        _open.stack.pop()
        _records.append(Span(self.name, self.start_ns, end, self.id, self.parent, self.root,
                             threading.get_ident(), self.counts))
        return False


def span(name: str, **counts: int):
    """A context that records the span ``name`` with ``counts`` while a
    ``torch.profiler`` session records; otherwise a no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, counts)


def spans() -> List[Span]:
    """The spans recorded so far, in the order they ended."""
    return list(_records)


def clear() -> None:
    _records.clear()


def perf_enabled() -> bool:
    return os.environ.get("PTBXL_TORCH_PERF", "") not in ("", "0")


class StepTimer:
    """Accumulates (records, seconds) across ``start`` / ``stop`` pairs."""

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
