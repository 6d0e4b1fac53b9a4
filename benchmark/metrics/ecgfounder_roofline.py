"""Net1D's share of its roofline (%): the summed bound of each of the
window's ``ecgfounder.encoder`` spans, one a chunk
(``roofline_ecgfounder.bound_s`` at the span's ``rows``: the larger of the
forward's operations at 989 TFLOP/s and its bytes at 3.35 TB/s, activations
at the cell's precision, 2 bytes an element, 4 at ``highest``), over the
summed device time of every kernel of the window that is not a copy or a
set.  A program that records no such span reads nothing."""

from benchmark import roofline_ecgfounder
from benchmark.metrics.step_idle_pct import program_spans


def read(ctx):
    spans = [s for s in program_spans(ctx) or () if s.name == "ecgfounder.encoder"]
    if not spans:
        return None
    t = sum(s for k, (_, s) in ctx.trace.by_kernel.items()
            if not k.startswith(("Memcpy", "Memset")))
    if not t:
        return None
    itemsize = 4 if ctx.traffic["predictor"]["precision"] == "highest" else 2
    bound = sum(roofline_ecgfounder.bound_s(ctx.cfg, s.counts["rows"], itemsize) for s in spans)
    return 100.0 * bound / t
