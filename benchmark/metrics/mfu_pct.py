"""Model operations of the real records scored or trained in the window
(padding left out), over the window's seconds at the chip's dense bf16 peak (%)."""

from benchmark.roofline import PEAK_FLOPS


def read(ctx):
    if not ctx.window.flops:
        return None
    return 100.0 * ctx.window.flops / (ctx.window.seconds * PEAK_FLOPS)
