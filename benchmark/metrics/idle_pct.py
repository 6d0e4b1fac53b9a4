"""Share of the window with no kernel and no copy on the device (%)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.busy_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.window.seconds)
