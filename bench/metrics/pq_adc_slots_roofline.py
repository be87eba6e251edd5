"""pq_adc_slots_roofline: the slot-ADC kernel's share of the bandwidth
roofline over the traced call, in percent: the bytes that call's
PQ-scored neighbours need (``roofline.adc_slots_bytes``) over the peak
bandwidth times the device seconds of ``adc_slots_direct`` and
``adc_slots_staged``."""

import roofline

KERNELS = ("adc_slots_direct", "adc_slots_staged")


def read(ctx):
    if ctx.trace is None:
        return None
    need = roofline.adc_slots_bytes(ctx.traced_stats, ctx.config["pq_m"])
    secs = roofline.kernel_seconds(ctx.trace.kernel_s, KERNELS)
    return roofline.share(need, secs, ctx.device_name)
