"""``rope``: the rotate-half rotary embedding op.

A CPU tensor runs the plain version (:func:`rope_ref`); a CUDA tensor
launches the hand-written kernel (``csrc/rope.cu``) or raises. Under
autograd the op is a ``torch.autograd.Function`` whose backward is the same
kernel with the sine negated: the rotation is orthogonal, so its transpose
is the rotation by -theta (the reference's custom VJP). No gradient flows to
the tables.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core import autotune
from .._build import entry_clock, journal
from .kernel import rope_launch
from .ref import rope_ref


def _rotate(x, sin, cos, sin_sign: float = 1.0, policy=None):
    """One rotation, journaled as ``obs`` op "rope" (variant "bwd" for the
    backward's rotation by -theta) with its policy: the caller's, else the
    autotuner's, the kernel's one layout (its launch takes no other)."""
    t0 = entry_clock()
    if x.device.type == "cpu":
        out = rope_ref(x, sin if sin_sign > 0 else -sin, cos)
    elif x.device.type == "cuda":
        out = rope_launch(x, sin, cos, sin_sign=sin_sign)
    else:
        raise ValueError(f"rope: unsupported device {x.device}")
    if obs.enabled():
        journal("rope", x.device, t0, variant="" if sin_sign > 0 else "bwd",
                flops=6 * x.numel(),
                policy=policy or autotune.select_policy("rope", x.shape,
                                                        x.dtype))
    return out


def rope(x, sin, cos, *, policy=None):
    """Apply rotary embedding. x: (B, H, S, D); sin/cos: (S, D) fp32 with
    duplicated halves (``rope_tables``). Returns x's type. ``policy``: the
    journal's (the launch is the kernel's one layout)."""
    if x.dim() != 4 or x.shape[-1] % 2:
        raise ValueError(f"rope: x must be (B, H, S, D) with D even, got "
                         f"{tuple(x.shape)}")
    if sin.shape != x.shape[2:] or cos.shape != x.shape[2:]:
        raise ValueError(f"rope: tables {tuple(sin.shape)}/{tuple(cos.shape)}"
                         f" do not match x {tuple(x.shape)}")
    if torch.is_grad_enabled() and x.requires_grad:
        return _RopeFn.apply(x, sin, cos)
    return _rotate(x, sin, cos, policy=policy)


class _RopeFn(torch.autograd.Function):
    """rope under autograd: the backward rotates the cotangent by -theta."""

    @staticmethod
    def forward(ctx, x, sin, cos):
        ctx.save_for_backward(sin, cos)
        return _rotate(x, sin, cos)

    @staticmethod
    def backward(ctx, g):
        sin, cos = ctx.saved_tensors
        if g.stride(-1) != 1:
            g = g.contiguous()
        return _rotate(g, sin, cos, sin_sign=-1.0), None, None
