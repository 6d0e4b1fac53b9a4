"""ST-MEM's attention kernels' share of their roofline (%): the summed bound
of one block's attention (``roofline_st_mem.attention_bound_s``) at the
``rows`` of each of the window's ``st_mem.attention`` spans, one span a
block a chunk, over the summed device time of the attention kernels, whose
names are data (``benchmark/kernels/*.json`` with ``"engine":
"attention"``).  q, k, v and the output count at the cell's precision: 2
bytes an element, 4 at ``highest``.  A program that records no such span
reads nothing."""

from benchmark import roofline_st_mem
from benchmark.metrics.attn_us import attention_spans, attention_s


def read(ctx):
    spans = attention_spans(ctx)
    t = attention_s(ctx) if spans else 0.0
    if not t:
        return None
    itemsize = 4 if ctx.traffic["predictor"]["precision"] == "highest" else 2
    bound = sum(roofline_st_mem.attention_bound_s(ctx.cfg, s.counts["rows"], itemsize)
                for s in spans)
    return 100.0 * bound / t
