"""baton.supersteps_per_call: the baton engine's super-steps a call
(``stats["n_supersteps"]``), averaged over the window's calls."""


def read(ctx):
    if not ctx.calls or "n_supersteps" not in ctx.calls[0]:
        return None
    return sum(c["n_supersteps"] for c in ctx.calls) / len(ctx.calls)
