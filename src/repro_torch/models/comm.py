"""Collectives for the model's mesh paths, over ``torch.distributed``.

The functional collectives (``torch.distributed._functional_collectives``),
so a dispatch mode such as ``CommDebugMode`` sees each one, and fake tensors
on a ``fake`` process group pass through them (the dry run).  Over gloo a
CUDA tensor is staged through the host, as the SPMD baton driver does.
The autograd wrappers make the gradients of a TP product right: the tiled
all_to_all is its own transpose; a psum into a replicated result passes
its cotangent through, and the input its partial products share gets the
psum of their gradients (Megatron's "g" and "f": one all-reduce each way,
as the reference's psum and its transpose).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _staged(fn, x, group):
    from torch.distributed import _functional_collectives as funcol

    dev = x.device
    if dev.type == "cuda" and dist.get_backend(group) == "gloo":
        x = x.cpu()
    return funcol.wait_tensor(fn(x.contiguous(), group)).to(dev)


def all_to_all(x, group):
    """Tiled all_to_all on axis 0: chunk j of ``x`` goes to group rank j,
    which receives one chunk from every rank, in rank order."""
    from torch.distributed import _functional_collectives as funcol

    return _staged(lambda t, g: funcol.all_to_all_single(t, None, None, g),
                   x, group)


def all_reduce(x, group, op: str = "sum"):
    from torch.distributed import _functional_collectives as funcol

    return _staged(lambda t, g: funcol.all_reduce(t, op, g), x, group)


class AllToAll(torch.autograd.Function):
    """:func:`all_to_all`, its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


class AllReduce(torch.autograd.Function):
    """The psum of TP partials into a result every rank of the group holds
    whole: its cotangent is already whole on each rank, so the backward is
    the identity (Megatron's "g")."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class ReduceGrad(torch.autograd.Function):
    """The identity on an input that the group's ranks each use for their
    part of a TP product: the backward sums those parts' gradients
    (Megatron's "f")."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None
