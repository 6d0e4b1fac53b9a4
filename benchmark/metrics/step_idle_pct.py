"""Share of the window (%) in which the device is idle while the training
thread is inside the program's ``train.step`` span or one of its children:
the host's part of the train step that leaves the card waiting.

The program records its spans (``ptbxl_torch/utils/profiling.py``) while the
traced run's profiler records, on ``perf_counter_ns``; the window's
``Spans.offset`` takes them to the device events' clock.  Each idle gap of
the window is put down to the innermost program span open at its midpoint
on the thread that ran the train steps.  A program that records no spans
reads nothing.  ``idle_under`` serves ``feed_idle_pct`` too."""

from __future__ import annotations

import bisect
from collections import Counter

from benchmark.trace import _clip, _union


def program_spans(ctx):
    """The program's spans that overlap the window, or ``None`` without a
    trace or where the program records no spans."""
    if ctx.trace is None:
        return None
    from ptbxl_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    w = ctx.window
    return [s for s in read() if s.end_ns > w.t0 and s.start_ns < w.t1]


def idle_under(ctx, name: str):
    """Share of the window (%) idle on the device while the innermost span
    open on the training thread is ``name`` or lies inside one."""
    spans = program_spans(ctx)
    steps = [s.thread for s in spans or () if s.name == "train.step"]
    if not steps or not ctx.trace.busy_s:
        return None
    thread = Counter(steps).most_common(1)[0][0]
    o = ctx.window.spans.offset
    t0, t1 = ctx.window.t0 + o, ctx.window.t1 + o
    mine = sorted((s for s in spans if s.thread == thread), key=lambda s: s.start_ns)
    by_id = {s.id: s for s in mine}
    starts = [s.start_ns + o for s in mine]
    busy = _union(_clip(ctx.trace.events, t0, t1))
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    held = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        k = bisect.bisect_right(starts, mid) - 1
        sp = mine[k] if k >= 0 else None
        # spans on one thread nest: if the last one started has closed, the
        # innermost open one is among its ancestors
        while sp is not None and sp.end_ns + o <= mid:
            sp = by_id.get(sp.parent)
        while sp is not None and sp.name != name:
            sp = by_id.get(sp.parent)
        if sp is not None:
            held += b - a
    return 100.0 * held / (t1 - t0)


def read(ctx):
    return idle_under(ctx, "train.step")
