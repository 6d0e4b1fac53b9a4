"""Share of the window with a host<->device copy on the device (%)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.copy_s:
        return None
    return 100.0 * ctx.trace.copy_s / ctx.window.seconds
