"""device.idle_share: 1 - the union of the device's intervals over the
traced call's span (``tracing.summarize``: kernels, copies and sets)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 1.0 - ctx.trace.busy_s / ctx.trace.window_s
