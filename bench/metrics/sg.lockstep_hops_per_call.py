"""sg.lockstep_hops_per_call: the scatter-gather baseline's lock-step hops
a call, averaged over the window's calls.  Each hop is one sync and one
``step_disk_batched`` over every (partition, query) branch row; a live
branch gains one hop a hop, so a call's hops are its largest branch hop
count (``branch_hops``, the engine's (B, P) ``part_hops``)."""


def read(ctx):
    if not ctx.calls:
        return None
    return sum(float(c["branch_hops"].max()) for c in ctx.calls) / len(
        ctx.calls)
