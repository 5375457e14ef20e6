"""Attention-side chain stages shared by the flash kernels' plain versions
and the oracles: the tanh logit soft cap and the online-softmax store, and
the chain's tag in the launch journal (the reference's
``AttnEpilogue.describe``)."""
from __future__ import annotations

import torch


def cap_logits(s, softcap):
    """``cap * tanh(s / cap)`` on the scaled logits (identity when the cap is
    0/None); applied before masking, so the mask value never meets tanh."""
    if not softcap:
        return s
    return softcap * torch.tanh(s / softcap)


def softmax_finalize(acc, m, l, sink=None):
    """(out, lse) from online-softmax state. With a ``sink`` logit the running
    max is re-anchored at max(m, sink) before the denominator is formed, so an
    all-masked row gives out = 0 and lse = sink; without one, ``acc / l`` with
    the l == 0 guard."""
    if sink is not None:
        m_tot = torch.maximum(m, sink)
        alpha = torch.exp(m - m_tot)
        l_tot = l * alpha + torch.exp(sink - m_tot)
        return acc * (alpha / l_tot), m_tot + torch.log(l_tot)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return acc / l_safe, m + torch.log(l_safe)


def describe_chain(softcap=None, sinks=None) -> str:
    """The attention chain's journal tag, as the reference's
    ``AttnEpilogue.describe()``: 'none', 'softcap30', 'sink' or
    'softcap30+sink'."""
    parts = []
    if softcap:
        parts.append(f"softcap{float(softcap):g}")
    if sinks is not None:
        parts.append("sink")
    return "+".join(parts) or "none"
