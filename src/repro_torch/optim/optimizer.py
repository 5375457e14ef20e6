"""AdamW, the learning-rate schedules and global-norm clipping.

The reference's optimizer (plain arrays, no optax) on trees of torch
tensors. State layout: {'m': tree, 'v': tree, 'count': int}. The schedules
return Python floats. ``adamw_update`` updates the parameters, the moments
and the fp32 grads in place, with torch's ``_foreach_*`` ops over the
leaves, and returns the same trees: the reference's update is functional,
but in place the fp32 masters and moments of llama-1b are not held twice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.models.common import tree_map


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------

def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> Callable:
    def lr(step):
        step = float(step)
        if step < warmup:
            return peak_lr * step / max(1, warmup)
        frac = min(max((step - warmup) / max(1, total - warmup), 0.0), 1.0)
        return peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                          * (1 + math.cos(math.pi * frac)))
    return lr


def wsd_schedule(peak_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1, min_ratio: float = 0.01) -> Callable:
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): linear warmup, a
    long constant plateau, an exponential decay to ``min_ratio`` over the
    last ``decay_frac`` of training."""
    decay_steps = max(1, int(total * decay_frac))
    stable_end = total - decay_steps

    def lr(step):
        step = float(step)
        if step < warmup:
            return peak_lr * step / max(1, warmup)
        if step < stable_end:
            return peak_lr
        frac = min(max((step - stable_end) / decay_steps, 0.0), 1.0)
        return peak_lr * min_ratio ** frac
    return lr


def constant_schedule(lr_value: float) -> Callable:
    return lambda step: float(lr_value)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    schedule: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def named_leaves(tree, prefix: str = "") -> list:
    """[(path, tensor)] of a nested dict, depth first in sorted-key order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def leaves(tree) -> list:
    """The tensors of a nested dict in the order of :func:`named_leaves` (a
    list or tuple is taken as leaves already in that order)."""
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return [x for _, x in named_leaves(tree)]


def adamw_init(params) -> dict:
    zeros = lambda t: tree_map(  # noqa: E731
        lambda x: torch.zeros_like(x, dtype=torch.float32), t)
    return {"m": zeros(params), "v": zeros(params), "count": 0}


def global_norm(tree):
    """sqrt of the sum of every leaf's squares, fp32 (a 0-d tensor)."""
    norms = torch._foreach_norm([g.float() for g in leaves(tree)])
    return torch.linalg.vector_norm(torch.stack(norms))


def _clip_(grads: list, max_norm: float, norm=None):
    """Scale the fp32 ``grads`` in place to a global norm of at most
    ``max_norm`` (``norm``: the global norm where the caller computed it,
    e.g. over the slices every rank holds); returns the norm before
    clipping."""
    if norm is None:
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    torch._foreach_mul_(grads, scale)
    return norm


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, the norm)."""
    out = tree_map(lambda g: g.float().clone(), tree)
    return out, _clip_(leaves(out), max_norm)


def adamw_update(cfg: AdamWConfig, grads, state, params, *, norm=None):
    """Returns (params, state, metrics), updated in place: clip the grads
    by their global norm in fp32 (fp32 grads are scaled in place), then
    AdamW with bias correction and decoupled weight decay, as the reference
    computes it. Elementwise but for the norm: ``params``, the moments and
    ``grads`` may be matching slices of the leaves (ZeRO-1), with ``norm``
    the whole leaves' global norm."""
    with torch.no_grad():
        g = [x.float() for x in leaves(grads)]
        gnorm = _clip_(g, cfg.clip_norm, norm)
        count = state["count"] + 1
        lr = cfg.schedule(count)
        m, v = leaves(state["m"]), leaves(state["v"])
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, g, alpha=1 - cfg.b1)
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_addcmul_(v, g, g, value=1 - cfg.b2)
        bc1 = 1 - cfg.b1 ** count
        bc2 = 1 - cfg.b2 ** count
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        step = torch._foreach_div(m, bc1)
        torch._foreach_div_(step, denom)
        del denom
        p = leaves(params)
        p32 = [x if x.dtype == torch.float32 else x.float() for x in p]
        torch._foreach_add_(step, p32, alpha=cfg.weight_decay)
        torch._foreach_add_(p32, step, alpha=-lr)
        for dst, src in zip(p, p32):
            if dst is not src:
                dst.copy_(src)
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}
