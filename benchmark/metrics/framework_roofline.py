"""The framework engine's share of its roofline (%): the summed bound of the
forward chunks that did not go to the kernel engine over the device time of
every kernel that is neither the kernel engine's nor a copy or a set (cuDNN's
convolutions, the z-score, BatchNorm, pooling and the elementwise ops)."""

from benchmark import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    by = ctx.trace.by_kernel
    chunks = sum(n for k, (n, _) in by.items() if k in ctx.chunk_end)
    rows = sorted(ctx.window.launched)[chunks:]
    t = sum(s for k, (_, s) in by.items()
            if k not in ctx.engine_kernels and not k.startswith(("Memcpy", "Memset")))
    if not rows or not t:
        return None
    return 100.0 * roofline.bound_s(ctx.cfg, rows) / t
