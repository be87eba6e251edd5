"""bitonic_topk_roofline: the bitonic top-k kernel's share of the
bandwidth roofline over the traced call, in percent: the bytes that call's
beam and pool merges need (``roofline.topk_bytes``) over the peak
bandwidth times the device seconds of ``topk_kernel``."""

import roofline

KERNELS = ("topk_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    need = roofline.topk_bytes(ctx.traced_stats, ctx.config["beam"])
    secs = roofline.kernel_seconds(ctx.trace.kernel_s, KERNELS)
    return roofline.share(need, secs, ctx.device_name)
