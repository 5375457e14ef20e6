"""int8 error-feedback gradient compression, the reference's numerics.

Each grad leaf, plus the residual its last quantisation left, is quantised
to int8 with one fp32 scale (``max|g| / 127``), dequantised, and handed to
the optimizer; what the quantisation lost is kept in fp32 for the next
step (error feedback, Seide et al. / EF-SGD). This is what the receiving
end of a compressed all-reduce sees, so one process exercises the
convergence behaviour. The collective itself (the reference's
``compressed_psum``, a ``shard_map`` psum of int8 payloads) goes with the
distributed item of ROADMAP Queue A and is not defined here.
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
def ef_compress(grads, ef_state):
    """Quantise and dequantise each grad leaf with error feedback.

    ``grads`` is a tree or a list in the order of ``optimizer.leaves``;
    ``ef_state`` the tree of fp32 residuals (``ef_init``). Returns (the
    dequantised grads as a list in the leaves' order, each in its grad's
    type; ``ef_state``). The residuals are updated in place, where the
    reference returns a new tree: ``e <- (g + e) - deq``, the same roundings
    in fp32."""
    out = []
    for g, e in zip(leaves(grads), leaves(ef_state)):
        e.add_(g.float())                  # gf = g + e
        q, scale = _quant(e)
        deq = q.float() * scale
        e.sub_(deq)                        # the residual gf - deq
        out.append(deq.to(g.dtype))
    return out, ef_state


def ef_init(grads_or_params) -> dict:
    """fp32 zeros shaped like each leaf."""
    return tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                          device=t.device), grads_or_params)
