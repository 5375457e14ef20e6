"""Declarative store-side chains for the fused GEMM.

The port of the reference's :class:`Epilogue` spec: a frozen description of
the short elementwise chain the GEMM applies to its fp32 accumulator before
the store. Canonical chain order (each stage optional):

    acc --[x scale]--> --[+bias]--> --[rope]--> --[act | act*acc2]--> --[+residual]--> store

:meth:`Epilogue.apply` is the plain torch version of that chain, on full
arrays; the CUDA kernel runs the same stages on its staged output tile.
The validation rules are the reference's, so a chain the reference refuses
is refused here too. The transpose half (:meth:`Epilogue.transpose_tile`,
:meth:`Epilogue.operand_grads`) is the plain torch version of the chain's
backward: the GEMM backward kernels run it on each g tile as it loads.
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


def _act_grad(name: str, x, g):
    """Cotangent of ``_ACT_FNS[name]`` at ``x`` for the incoming ``g``,
    derived by hand (the reference derives it with ``jax.vjp``; a CPU test
    holds the two against each other)."""
    if name == "silu":
        s = torch.sigmoid(x)
        return g * (s * (1 + x * (1 - s)))
    if name == "relu":
        return g * (x > 0).to(x.dtype)
    if name == "gelu":
        c = 0.7978845608028654            # sqrt(2 / pi)
        # tanh(u) as 2 sigmoid(2u) - 1 (within 4e-6 of the float64 gelu'):
        # on the CPU torch.tanh runs MKL's vector tanh in 2048-element
        # chunks across threads, and a worker's chunk has come out of its
        # low-accuracy mode, 1.5e-3 off (ROADMAP C6)
        t = 2 * torch.sigmoid(2 * c * (x + 0.044715 * x ** 3)) - 1
        return g * (0.5 * (1 + t)
                    + 0.5 * x * (1 - t * t) * c * (1 + 3 * 0.044715 * x * x))
    raise ValueError(f"unknown activation {name!r}")


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

    @property
    def n_accumulators(self) -> int:
        return 2 if self.gate else 1

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

    # -- the chain transpose -------------------------------------------------
    @property
    def needs_saved_preact(self) -> bool:
        """True when the reference's transpose needs the raw fp32
        accumulator(s) the forward store consumed: act'(preact) for an
        activation (and preact2 for the gate), and dscale, a <g, preact>
        reduction. rope alone does not: the rotation is invertible. (The
        port's kernel saves preacts for the activation only: its scale is a
        Python float that takes no gradient; see ``ops.kernel_saves``.)"""
        return self.gate or self.activation != "none" or self.scale

    @property
    def saved_accumulators(self) -> int:
        """How many accumulators the reference's forward launch stores."""
        return self.n_accumulators if self.needs_saved_preact else 0

    @property
    def preact_keeps_f32(self) -> bool:
        """Scale chains keep fp32 preactivations in the reference: dscale is
        a reduction, so it inherits the operand's precision."""
        return self.scale

    def _transpose_core(self, g, preact=None, preact2=None, *, bias=None,
                        scale=None, sin=None, cos=None) -> dict:
        """The forward stages walked backwards, on fp32 arrays (tile or full
        array alike): 'g_acc'/'g_acc2' (the raw-accumulator cotangents the
        backward GEMMs contract), 'g_bias' (column-summed into dbias) and
        'g_scaled'/'g_scaled2' (the dscale reduction operands)."""
        out = {}
        gy = g  # the residual add transposes to identity on the main path
        if self.gate:
            u = preact * scale if self.scale else preact
            v2 = preact2 * scale if self.scale else preact2
            du = _act_grad(self.activation, u, gy * v2)
            dv2 = _ACT_FNS[self.activation](u) * gy
            out["g_scaled"], out["g_scaled2"] = du, dv2
            out["g_acc"] = du * scale if self.scale else du
            out["g_acc2"] = dv2 * scale if self.scale else dv2
            return out
        if self.activation != "none":
            u = preact
            if self.scale:
                u = u * scale
            if self.bias:
                u = u + bias
            du = _act_grad(self.activation, u, gy)
        elif self.rope:
            du = rope_rotate(gy, -sin, cos, self.head_dim)  # rotation by -theta
        else:
            du = gy
        out["g_bias"] = du
        out["g_scaled"] = du
        out["g_acc"] = du * scale if self.scale else du
        return out

    def transpose_tile(self, g, preact=None, preact2=None, *, bias=None,
                       scale=None, sin=None, cos=None) -> dict:
        """g tile -> the cotangent streams of the backward GEMMs: 'g_acc'
        (and 'g_acc2' for the gate) feed dA = g_acc @ Bᵀ and dB = Aᵀ @ g_acc;
        'g_bias' (bias chains) is column-summed into dbias. The forward
        epilogue run as a prologue on g."""
        core = self._transpose_core(g, preact, preact2, bias=bias,
                                    scale=scale, sin=sin, cos=cos)
        keep = {"g_acc"}
        if self.gate:
            keep.add("g_acc2")
        if self.bias:
            keep.add("g_bias")
        return {k: v for k, v in core.items() if k in keep}

    def operand_grads(self, g, preact=None, preact2=None, out=None, *,
                      bias=None, residual=None, scale=None, sin=None,
                      cos=None) -> dict:
        """Cotangents of the chain's extra operands, on full fp32 arrays:
        residual (identity), bias (column sum), scale (a <g, preact>
        reduction shaped per scale_kind) and the rope tables (from the
        pre-rope value: the saved preact when there is one, else the output
        rotated back)."""
        core = self._transpose_core(g, preact, preact2, bias=bias,
                                    scale=scale, sin=sin, cos=cos)
        grads = {}
        if self.residual:
            grads["residual"] = g
        if self.bias:
            grads["bias"] = torch.sum(core["g_bias"], dim=0, keepdim=True)
        if self.scale:
            ds = core["g_scaled"] * preact
            if self.gate:
                ds = ds + core["g_scaled2"] * preact2
            dims = {"scalar": (0, 1), "row": (1,), "col": (0,)}[self.scale_kind]
            grads["scale"] = torch.sum(ds, dim=dims, keepdim=True)
        if self.rope:
            if preact is not None:
                u = preact * scale if self.scale else preact
                if self.bias:
                    u = u + bias
            else:
                u = rope_rotate(out, -sin, cos, self.head_dim)
            rows, cols = u.shape
            hd, half = self.head_dim, self.head_dim // 2
            uh = u.reshape(rows, cols // hd, hd)
            gh = g.reshape(rows, cols // hd, hd)
            rot = torch.cat([-uh[..., half:], uh[..., :half]], dim=-1)
            grads["sin"] = torch.sum(gh * rot, dim=1)
            grads["cos"] = torch.sum(gh * uh, dim=1)
        return grads

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
