"""engine.host_sync_share: the share of the window's host seconds spent
blocked in device-to-host syncs (``SearchResult.stats["host_sync_s"]``,
the engines' ``SyncMeter``), summed over the window's calls."""


def read(ctx):
    if not ctx.calls or "host_sync_s" not in ctx.calls[0]:
        return None
    return sum(c["host_sync_s"] for c in ctx.calls) / ctx.window_s
