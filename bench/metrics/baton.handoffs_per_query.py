"""baton.handoffs_per_query: hand-offs of a query between partitions
(``stats["inter_hops"]``), averaged over every query of the window."""


def read(ctx):
    if not ctx.calls or "n_supersteps" not in ctx.calls[0]:
        return None
    total = sum(float(c["inter_hops"].sum()) for c in ctx.calls)
    return total / sum(len(c["inter_hops"]) for c in ctx.calls)
