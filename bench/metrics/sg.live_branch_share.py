"""sg.live_branch_share: the share of the rows each lock-step hop of the
scatter-gather baseline launches that advance a live branch, over the
window: summed branch hops over (a call's hops x its branches), both
summed over the calls.  A call's hops are its largest branch hop count
(``branch_hops``, the engine's (B, P) ``part_hops``); a hop steps all B·P
branch rows, finished ones included."""


def read(ctx):
    if not ctx.calls:
        return None
    live = sum(float(c["branch_hops"].sum()) for c in ctx.calls)
    launched = sum(float(c["branch_hops"].max()) * c["branch_hops"].size
                   for c in ctx.calls)
    return live / launched if launched else None
