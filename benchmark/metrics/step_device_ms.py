"""The device's busy time over the train steps of the window (ms a step)."""


def read(ctx):
    if ctx.trace is None or not ctx.window.steps or not ctx.trace.busy_s:
        return None
    return 1e3 * ctx.trace.busy_s / ctx.window.steps
