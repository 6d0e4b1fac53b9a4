"""The kernel engine's share of its roofline (%): the summed bound of the
forward chunks it ran, at the rows each launch was given, over the summed
device time of its kernels.

Which kernels are the engine's is data (``benchmark/kernels/*.json``).  The
engine runs one of its ``chunk_end`` kernels a chunk, so their count is the
number of chunks it took; ``Predictor`` gives it the smaller chunks of a
call (it takes chunks up to a crossover size), so those are the chunks it
is given."""

from benchmark import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    t = sum(s for k, (_, s) in ctx.trace.by_kernel.items() if k in ctx.engine_kernels)
    chunks = sum(n for k, (n, _) in ctx.trace.by_kernel.items() if k in ctx.chunk_end)
    if not chunks or not t:
        return None
    rows = sorted(ctx.window.launched)[:chunks]
    return 100.0 * roofline.bound_s(ctx.cfg, rows) / t
