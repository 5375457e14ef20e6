"""The collectives of the distributed layer, over one axis of a mesh.

Each rank holds plain local tensors; these stand where the reference's
``shard_map`` bodies call ``psum``, ``pmean``, ``all_gather`` and
``all_to_all``. They run on any ``torch.distributed`` backend: NCCL on the
card, gloo on the CPU. The sums that must not depend on the backend's
reduction order (the data-parallel grads) are all-gathers or all-to-alls
followed by a sum in rank order, in one code path for both backends. At
world size 1 each is a collective over a one-rank group, and a sum in rank
order of one term is that term.
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


def sum_over(x, mesh, axis: str):
    """The all-reduce SUM of ``x`` over one axis (the reference's
    ``psum``)."""
    out = x.contiguous().clone()
    dist.all_reduce(out, group=mesh.get_group(axis))
    return out
