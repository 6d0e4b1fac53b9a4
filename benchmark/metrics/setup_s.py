"""From the process's first work to the first timed request (s): imports,
CUDA initialisation, loading (or on a checkout's first run, building) the
kernel libraries, inputs, weights and warm-up."""


def read(ctx):
    return ctx.setup_s
