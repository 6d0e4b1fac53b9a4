"""Real records trained in the window over the window's seconds (records/s)."""


def read(ctx):
    if not ctx.window.steps or not ctx.window.records:
        return None
    return ctx.window.records / ctx.window.seconds
