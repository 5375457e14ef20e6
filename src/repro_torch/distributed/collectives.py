"""The collectives of the distributed layer, over one axis of a mesh.

Each rank holds plain local tensors; these stand where the reference's
``shard_map`` bodies call ``psum``, ``pmean``, ``all_gather`` and
``all_to_all``. They run on any ``torch.distributed`` backend: NCCL on the
card, gloo on the CPU. The sums that must not depend on the backend's
reduction order (the data-parallel grads, the tensor-parallel step's sums
over 'model') are all-gathers or all-to-alls followed by a sum in rank
order, in one code path for both backends; the tensor-parallel step's
boundaries are autograd Functions over them (the end of the file). At
world size 1 each plain collective is a collective over a one-rank group,
and a sum in rank order of one term is that term; the autograd Functions
are skipped there (their input is their output, bit for bit).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .sharding import mesh_shape


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh)[axis]


def all_gather_cat(x, dim: int, group):
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _sum_in_order(parts: list):
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def ordered_sum(x, group):
    """The sum over the group's ranks of ``x``, added in rank order 0, 1,
    ...: the same bits on every rank and every backend."""
    flat = x.reshape(1) if x.dim() == 0 else x.contiguous()
    parts = [torch.empty_like(flat)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    return _sum_in_order(parts).reshape(x.shape)


def all_to_all(x, group):
    """Dim 0 of ``x`` cut into one equal chunk per rank, chunk j sent to
    rank j; returns the chunks received, stacked in source-rank order
    (dim 0: ranks x chunk)."""
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def sum_scatter(x, dim: int, group):
    """Reduce-scatter in rank order: ``x`` cut along ``dim`` into one equal
    block per rank; rank r gets the sum over ranks of their block r, added
    in rank order 0, 1, ... (an all-to-all, then a local sum)."""
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0)
    recv = all_to_all(moved, group)
    parts = list(recv.chunk(n, dim=0))
    return _sum_in_order(parts).movedim(0, dim).contiguous()


def max_over(x, group):
    """The elementwise max over the group's ranks (exact on any backend)."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def mean_over(x, mesh, axes):
    """``x`` averaged over each of ``axes`` that the mesh has, one axis
    after another (the reference's ``pmean``)."""
    sizes = mesh_shape(mesh)
    for a in axes:
        if a in sizes:
            x = x.clone()
            dist.all_reduce(x, group=mesh.get_group(a))
            x = x / sizes[a]
    return x



# ---------------------------------------------------------------------------
# Differentiable collectives: the tensor-parallel step's boundaries
# ---------------------------------------------------------------------------
#
# A rank's tensors in the split step are of two kinds: replicated (the
# same bits on every rank of the axis, e.g. the residual stream) and
# split (a rank's share: its heads, its FFN columns, its vocab rows, or a
# partial sum). A replicated tensor's grad is whole on every rank; a
# split computation's grads are partial. ``copy_to_ranks`` (Megatron's f)
# stands where a replicated tensor enters split work, ``sum_from_ranks``
# (g) where partial sums leave it. Sums are in rank order (the same bits
# on every rank and backend), a low-precision tensor's in fp32 rounded
# once, so at one rank each of these is an identity, bit for bit, and
# returns its input without a collective or a copy. Each call over more
# than one rank adds one to the ``obs`` counter "tp.collectives".

def _wide_sum(x, group):
    """``ordered_sum``, a bf16/fp16 tensor's taken in fp32 and rounded
    once."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return ordered_sum(x.float(), group).to(x.dtype)
    return ordered_sum(x, group)


def _count() -> None:
    from repro_torch import obs

    obs.incr("tp.collectives")


class _CopyToRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        _count()
        return _wide_sum(g, ctx.group), None


class _SumFromRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        _count()
        return _wide_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, grad):
        ctx.dim, ctx.group, ctx.grad = dim, group, grad
        ctx.size = x.shape[dim]
        _count()
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        _count()
        if ctx.grad == "own":
            rank = dist.get_rank(ctx.group)
            return (g.narrow(ctx.dim, rank * ctx.size, ctx.size).contiguous(),
                    None, None, None)
        if g.dtype in (torch.bfloat16, torch.float16):
            out = sum_scatter(g.float(), ctx.dim, ctx.group).to(g.dtype)
        else:
            out = sum_scatter(g, ctx.dim, ctx.group)
        return out, None, None, None


class _SumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        _count()
        if x.dtype in (torch.bfloat16, torch.float16):
            return sum_scatter(x.float(), dim, group).to(x.dtype)
        return sum_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        _count()
        return all_gather_cat(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _count()
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        _count()
        # chunk j went to rank j and came back as chunk r: its own inverse
        return all_to_all(g, ctx.group), None


def _alone(group) -> bool:
    return dist.get_world_size(group) == 1


def copy_to_ranks(x, group):
    """Identity forward; the backward sums the ranks' (partial) grads in
    rank order: a replicated tensor entering work split over ``group``."""
    return x if _alone(group) else _CopyToRanks.apply(x, group)


def sum_from_ranks(x, group):
    """The sum over the ranks in rank order forward; identity backward:
    the ranks' partial sums leaving split work as one replicated tensor."""
    return x if _alone(group) else _SumFromRanks.apply(x, group)


def gather_cat(x, dim: int, group, grad: str = "sum"):
    """:func:`all_gather_cat` under autograd. ``grad="sum"``: the gathered
    tensor feeds split work (each rank's grad of it is a partial), so the
    backward is the rank-order :func:`sum_scatter`; ``grad="own"``: it
    feeds replicated work (every rank holds the whole grad), so the
    backward takes the rank's own block."""
    if grad not in ("sum", "own"):
        raise ValueError(f"gather_cat: grad {grad!r} is 'sum' or 'own'")
    return x if _alone(group) else _GatherCat.apply(x, dim, group, grad)


def scatter_sum(x, dim: int, group):
    """:func:`sum_scatter` under autograd (a low-precision ``x`` summed in
    fp32, rounded once): the ranks' partial sums leaving split work as the
    rank's own block along ``dim``; the backward all-gathers the blocks'
    grads, which every rank's partial needs whole."""
    return x if _alone(group) else _SumScatter.apply(x, dim, group)


def all_to_all_grad(x, group):
    """:func:`all_to_all` under autograd; its backward is the inverse
    all-to-all (the same exchange)."""
    return x if _alone(group) else _AllToAll.apply(x, group)
