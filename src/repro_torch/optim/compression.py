"""int8 error-feedback gradient compression, the reference's numerics.

Each grad leaf, plus the residual its last quantisation left, is quantised
to int8 with one fp32 scale (``max|g| / 127``), dequantised, and handed to
the optimizer; what the quantisation lost is kept in fp32 for the next
step (error feedback, Seide et al. / EF-SGD). This is what the receiving
end of a compressed all-reduce sees, so one process exercises the
convergence behaviour. :func:`compressed_psum` is the collective itself:
int8 payloads summed over a mesh axis.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import tree_map
from .optimizer import leaves


def _quant(g):
    """(q int8, scale): ``scale = max|g| / 127 + 1e-12`` in fp32 and
    ``q = clip(round(g / scale), -127, 127)``, rounding half to even as
    ``jnp.round`` does."""
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def ef_compress(grads, ef_state, *, amax=None):
    """Quantise and dequantise each grad leaf with error feedback.

    ``grads`` is a tree or a list in the order of ``optimizer.leaves``;
    ``ef_state`` the tree of fp32 residuals (``ef_init``). Returns (the
    dequantised grads as a list in the leaves' order, each in its grad's
    type; ``ef_state``). The residuals are updated in place, where the
    reference returns a new tree: ``e <- (g + e) - deq``, the same roundings
    in fp32. ``amax(i, m)``: leaf i's max |gf| where each rank holds a slice
    of the leaf (the data-parallel trainer's ZeRO-1 slices: the max over
    the slices' maxes), so the scale is the whole leaf's."""
    out = []
    for i, (g, e) in enumerate(zip(leaves(grads), leaves(ef_state))):
        e.add_(g.float())                  # gf = g + e
        if amax is None:
            q, scale = _quant(e)
        else:
            scale = amax(i, e.abs().max()) / 127.0 + 1e-12
            q = torch.clamp(torch.round(e / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        e.sub_(deq)                        # the residual gf - deq
        out.append(deq.to(g.dtype))
    return out, ef_state


def ef_init(grads_or_params) -> dict:
    """fp32 zeros shaped like each leaf."""
    return tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                          device=t.device), grads_or_params)


@torch.no_grad()
def compressed_psum(x, mesh, axis: str = "data"):
    """The sum over ``axis`` of every rank's ``x`` with int8 payloads on
    the wire: each rank quantises its contribution with the common scale
    (the max of the ranks' scales, an all-reduce MAX), the int8 values are
    summed exactly in int32 (an all-reduce SUM) and dequantised with that
    scale, as the reference's ``shard_map`` body does. Returns fp32."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    v = x.float()
    _, scale = _quant(v)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    return total.float() * scale
