"""search.reads_per_query: sector reads of a query (``stats["reads"]``;
the scatter-gather baseline sums its partitions'), averaged over every
query of the window."""


def read(ctx):
    if not ctx.calls:
        return None
    total = sum(float(c["reads"].sum()) for c in ctx.calls)
    return total / sum(len(c["reads"]) for c in ctx.calls)
