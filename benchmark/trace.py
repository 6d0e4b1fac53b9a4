"""Host spans and the device trace of one measured window.

* ``Spans`` keeps the harness's own spans around its calls into the program
  (``call`` of ``Predictor``, ``feed``: waiting for the trainer's next
  prefetched batch, ``step`` of the train step) in memory, on the host's monotonic
  clock, with the offset to ``time.time_ns()``, the clock that the profiler
  stamps its events with.
* ``Profiler`` runs ``torch.profiler`` (CPU and CUDA activities) with one
  discarded warm-up step before the window (CUPTI can drop a window's first
  launches), and returns the device's kernels, copies and sets of the window
  as ``DeviceEvent`` tuples read from the raw kineto events.
* ``reduce`` turns them into the window's device figures: busy seconds (the
  union of every device interval), copy seconds, time by kernel, and idle
  gaps labelled by the host span open at each gap's midpoint.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Sequence, Tuple


class DeviceEvent(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    copy: bool


class Spans:
    """Named host intervals on ``time.perf_counter_ns()``; ``offset`` takes
    them to ``time.time_ns()``, the profiler's clock.  The harness's spans
    follow one another and do not nest."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []
        self.offset = time.time_ns() - time.perf_counter_ns()

    def add(self, name: str, t0: int, t1: int) -> None:
        self.items.append((name, t0, t1))

    def durations_s(self, name: str) -> List[float]:
        return [(t1 - t0) / 1e9 for n, t0, t1 in self.items if n == name]


_IDENT = re.compile(r"([A-Za-z_][\w:]*)\s*[<(]")


def kernel_name(name: str) -> str:
    """The function identifier of a demangled kernel name, without
    namespaces or template arguments; copies keep their profiler name."""
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    m = _IDENT.search(name)
    ident = m.group(1) if m else name
    return ident.split("::")[-1][:80]


class Profiler:
    """``torch.profiler`` around a window: ``start`` during set-up, then
    ``window_start`` just before the window and ``stop`` just after it."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        self._results = []
        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: self._results.append(p.profiler.kineto_results))
        self.process_s = 0.0

    def start(self) -> None:
        self._prof.start()

    def window_start(self) -> None:
        self._prof.step()

    def stop(self) -> List[DeviceEvent]:
        t = time.perf_counter()
        self._prof.step()
        self._prof.stop()
        if not self._results:
            raise RuntimeError("the profiler returned no trace for the window")
        out = []
        for e in self._results[0].events():
            if str(e.device_type()).split(".")[-1] != "CUDA" or e.is_user_annotation():
                continue
            name = e.name()
            kind = e.activity_type() if hasattr(e, "activity_type") else ""
            out.append(DeviceEvent(name, e.start_ns(), e.start_ns() + e.duration_ns(),
                                   name.startswith("Memcpy") or "memcpy" in str(kind)))
        out.sort(key=lambda d: d.start_ns)
        self.process_s = time.perf_counter() - t
        return out


def _union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _clip(events: Sequence[DeviceEvent], t0: int, t1: int) -> List[Tuple[int, int]]:
    return [(max(e.start_ns, t0), min(e.end_ns, t1)) for e in events
            if e.end_ns > t0 and e.start_ns < t1]


class Reduced(NamedTuple):
    busy_s: float
    copy_s: float
    by_kernel: Dict[str, Tuple[int, float]]  # name -> (launches, device seconds)
    idle_by_label: Dict[str, float]
    events: List[DeviceEvent]


def reduce(events: Sequence[DeviceEvent], spans: Spans, t0: int, t1: int,
           outside: str = "outside_spans") -> Reduced:
    """The device figures of the window ``[t0, t1)`` (``perf_counter_ns``)."""
    t0, t1 = t0 + spans.offset, t1 + spans.offset
    inside = [e for e in events if e.end_ns > t0 and e.start_ns < t1]
    busy = _union(_clip(inside, t0, t1))
    copies = _union(_clip([e for e in inside if e.copy], t0, t1))
    by_kernel: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in inside:
        row = by_kernel[kernel_name(e.name)]
        row[0] += 1
        row[1] += (min(e.end_ns, t1) - max(e.start_ns, t0)) / 1e9
    # idle gaps: between busy intervals and at the window's two ends
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    idle: Dict[str, float] = defaultdict(float)
    o = spans.offset
    items = sorted(((n, s + o, e + o) for n, s, e in spans.items), key=lambda sp: sp[1])
    starts = [sp[1] for sp in items]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        # the harness's spans do not nest: the last one started before the
        # gap's midpoint holds it, if it is still open there
        mid = (a + b) // 2
        k = bisect.bisect_right(starts, mid) - 1
        label = items[k][0] if k >= 0 and items[k][2] > mid else outside
        idle[label] += (b - a) / 1e9
    return Reduced(sum(e - s for s, e in busy) / 1e9, sum(e - s for s, e in copies) / 1e9,
                   {k: (int(v[0]), v[1]) for k, v in by_kernel.items()}, dict(idle), inside)


def breakdown(r: Reduced, top: int = 10) -> Dict[str, list]:
    """The contract's ``breakdown``: the device operations that took most
    time and the idle time by what the host was doing, in seconds."""
    ops = sorted(((k, v[1]) for k, v in r.by_kernel.items()), key=lambda kv: -kv[1])
    gaps = sorted(r.idle_by_label.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k, s] for k, s in ops[:top]],
            "idle_gaps": [[k, s] for k, s in gaps[:top]]}
