"""``dropout_residual_layernorm``: the fused prenorm-transformer glue op,
``(dropout(x) + residual) -> layernorm``.

A CPU tensor runs the plain version
(:func:`fused_dropout_residual_layernorm_ref`); a CUDA tensor launches the
hand-written kernel (``csrc/fused_norm.cu``) or raises. The op has no
backward, as the reference's has none.
"""
from __future__ import annotations

from repro_torch import obs
from repro_torch.core import autotune
from .._build import entry_clock, journal
from .kernel import fused_norm_launch
from .ref import fused_dropout_residual_layernorm_ref


def dropout_residual_layernorm(x, residual, weight, bias, seed=0, *,
                               dropout_p: float = 0.0, eps: float = 1e-5,
                               policy=None):
    """x, residual: (rows, d); weight/bias: (d,); ``seed`` an int32 (a
    negative one wraps to uint32, as in the reference's kernel). Returns
    (normed, new_residual) in x's type. Journaled as ``obs`` op
    "fused_norm" with its policy (the caller's, else the autotuner's: the
    kernel's one layout a width, which the launch takes)."""
    if x.dim() != 2 or residual.shape != x.shape \
            or weight.shape != x.shape[1:] or bias.shape != x.shape[1:]:
        raise ValueError(f"dropout_residual_layernorm: x {tuple(x.shape)}, "
                         f"residual {tuple(residual.shape)}, weight "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_residual_layernorm: dropout_p {dropout_p} "
                         "not in [0, 1)")
    t0 = entry_clock()
    if x.device.type == "cpu":
        out = fused_dropout_residual_layernorm_ref(
            x, residual, weight, bias, seed, dropout_p=dropout_p, eps=eps)
    elif x.device.type == "cuda":
        out = fused_norm_launch(x, residual, weight, bias, seed,
                                dropout_p=dropout_p, eps=eps)
    else:
        raise ValueError(f"dropout_residual_layernorm: unsupported device "
                         f"{x.device}")
    if obs.enabled():
        journal("fused_norm", x.device, t0, flops=10 * x.numel(),
                policy=policy or autotune.select_policy(
                    "fused_norm", x.shape, x.dtype))
    return out
