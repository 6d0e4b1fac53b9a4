"""Share of the window (%) in which the device is idle while the training
thread waits in the program's ``prefetch.wait`` span for the feed's next
batch (``data/pipeline.py::device_prefetch``); read as ``step_idle_pct``."""

from benchmark.metrics.step_idle_pct import idle_under


def read(ctx):
    return idle_under(ctx, "prefetch.wait")
