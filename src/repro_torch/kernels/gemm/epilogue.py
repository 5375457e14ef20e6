"""Declarative store-side chains for the fused GEMM.

The port of the reference's :class:`Epilogue` spec: a frozen description of
the short elementwise chain the GEMM applies to its fp32 accumulator before
the store. Canonical chain order (each stage optional):

    acc --[x scale]--> --[+bias]--> --[rope]--> --[act | act*acc2]--> --[+residual]--> store

:meth:`Epilogue.apply` is the plain torch version of that chain, on full
arrays; the CUDA kernel runs the same stages on its staged output tile.
The validation rules are the reference's, so a chain the reference refuses
is refused here too.
"""
from __future__ import annotations

import dataclasses

import torch

ACTIVATIONS = ("none", "silu", "gelu", "relu")
SCALE_KINDS = ("scalar", "row", "col")

_ACT_FNS = {
    "silu": torch.nn.functional.silu,
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "relu": torch.relu,
}


def rope_rotate(x, sin, cos, head_dim: int):
    """Rotate-half RoPE on a (rows, cols) array whose columns are whole heads;
    sin/cos: (rows, head_dim) duplicated-halves tables."""
    rows, cols = x.shape
    half = head_dim // 2
    xh = x.reshape(rows, cols // head_dim, head_dim)
    rotated = torch.cat([-xh[..., half:], xh[..., :half]], dim=-1)
    out = xh * cos[:, None, :] + rotated * sin[:, None, :]
    return out.reshape(rows, cols)


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """A frozen, hashable epilogue chain spec."""

    bias: bool = False
    activation: str = "none"     # 'none' | 'silu' | 'gelu' | 'relu'
    gate: bool = False           # dual-output GEMM: store act(acc) * acc2
    residual: bool = False
    scale: bool = False          # runtime scale (residual scale, dequant)
    scale_kind: str = "scalar"   # 'scalar' | 'row' (M,1) | 'col' (1,N)
    rope: bool = False           # per-head rotary rotation (QKV projection)
    head_dim: int = 0            # required (> 0, even) when rope=True

    def __post_init__(self):
        if self.activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}; "
                             f"have {ACTIVATIONS}")
        if self.scale_kind not in SCALE_KINDS:
            raise ValueError(f"unknown scale_kind {self.scale_kind!r}; "
                             f"have {SCALE_KINDS}")
        if self.scale_kind != "scalar" and not self.scale:
            raise ValueError("scale_kind is only meaningful with scale=True")
        if self.gate and self.activation == "none":
            raise ValueError("gate=True needs an activation")
        if self.gate and self.bias:
            raise ValueError("gate=True excludes bias")
        if self.rope:
            if self.gate or self.residual or self.activation != "none":
                raise ValueError("rope composes only with bias/scale")
            if self.head_dim <= 0 or self.head_dim % 2:
                raise ValueError(f"rope=True needs an even head_dim > 0, "
                                 f"got {self.head_dim}")
        elif self.head_dim:
            raise ValueError("head_dim is only meaningful with rope=True")

    @property
    def is_identity(self) -> bool:
        return not (self.bias or self.gate or self.residual or self.scale
                    or self.rope or self.activation != "none")

    def operand_names(self) -> tuple:
        """Runtime extra operands, in the canonical order."""
        names = []
        if self.gate:
            names.append("b2")
        if self.bias:
            names.append("bias")
        if self.residual:
            names.append("residual")
        if self.scale:
            names.append("scale")
        if self.rope:
            names += ["sin", "cos"]
        return tuple(names)

    def apply(self, acc, acc2=None, *, bias=None, residual=None, scale=None,
              sin=None, cos=None):
        """Run the chain on an fp32 accumulator; every operand fp32 and
        broadcastable (bias (1, N), scale scalar/(M, 1)/(1, N))."""
        out = acc
        if self.scale:
            out = out * scale
        if self.bias:
            out = out + bias
        if self.rope:
            out = rope_rotate(out, sin, cos, self.head_dim)
        if self.gate:
            g2 = acc2 * scale if self.scale else acc2
            out = _ACT_FNS[self.activation](out) * g2
        elif self.activation != "none":
            out = _ACT_FNS[self.activation](out)
        if self.residual:
            out = out + residual
        return out

    def describe(self) -> str:
        """Short tag, e.g. 'bias+rope64' or 'silu*gate'."""
        if self.is_identity:
            return "none"
        parts = []
        if self.scale:
            parts.append("scale" if self.scale_kind == "scalar"
                         else f"scale:{self.scale_kind}")
        if self.bias:
            parts.append("bias")
        if self.rope:
            parts.append(f"rope{self.head_dim}")
        if self.gate:
            parts.append(f"{self.activation}*gate")
        elif self.activation != "none":
            parts.append(self.activation)
        if self.residual:
            parts.append("res")
        return "+".join(parts)


EPILOGUE_NONE = Epilogue()
