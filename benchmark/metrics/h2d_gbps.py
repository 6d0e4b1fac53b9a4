"""Rate of the serving API's host->device copies (GB/s): the bytes the
program's ``predictor.h2d`` spans count in the window, over the seconds of
the union of the window's host->device copies on the device.  A program
that records no spans reads nothing."""

from benchmark.metrics.step_idle_pct import program_spans
from benchmark.trace import _clip, _union


def read(ctx):
    spans = program_spans(ctx)
    if not spans:
        return None
    nbytes = sum(s.counts.get("bytes", 0) for s in spans if s.name == "predictor.h2d")
    o = ctx.window.spans.offset
    copies = _union(_clip([e for e in ctx.trace.events if e.copy and "HtoD" in e.name],
                          ctx.window.t0 + o, ctx.window.t1 + o))
    seconds = sum(e - s for s, e in copies) / 1e9
    if not nbytes or not seconds:
        return None
    return nbytes / seconds / 1e9
