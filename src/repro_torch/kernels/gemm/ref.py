"""Plain torch version of the fused GEMM and its prologue/epilogue chains."""
from __future__ import annotations

import torch

from .epilogue import EPILOGUE_NONE, Epilogue
from .prologue import PROLOGUE_NONE, Prologue


def gemm_fused_ref(a, b, *, epilogue: Epilogue = EPILOGUE_NONE,
                   prologue: Prologue = PROLOGUE_NONE, b2=None,
                   bias=None, residual=None, scale=None, sin=None, cos=None,
                   gamma=None, beta=None, mean=None, rstd=None,
                   out_dtype=torch.bfloat16):
    """C = epilogue(prologue(A) @ B [, A @ B2]) unfused, on full arrays.

    The prologue normalises A in fp32 and rounds it back to A's type before
    the product (the kernel's rounding point); the products accumulate in
    fp32; the epilogue runs in fp32 and the result is cast to ``out_dtype``.
    Operand shapes: gamma/beta (K,); mean/rstd (M,) or (M, 1); bias (N,);
    residual (M, N); scale scalar, (M, 1) or (1, N) per ``scale_kind``;
    sin/cos (M, head_dim) duplicated-halves tables.
    """
    f32 = torch.float32
    if not prologue.is_identity:
        pkw = {"gamma": gamma.to(f32).reshape(1, -1)}
        if prologue.beta:
            pkw["beta"] = beta.to(f32).reshape(1, -1)
        if prologue.precomputed_stats:
            if prologue.norm == "layernorm":
                pkw["mean"] = mean.to(f32).reshape(-1, 1)
            pkw["rstd"] = rstd.to(f32).reshape(-1, 1)
        a = prologue.apply(a.to(f32), **pkw).to(a.dtype)
    acc = a.to(f32) @ b.to(f32)
    acc2 = a.to(f32) @ b2.to(f32) if epilogue.gate else None
    kw = {}
    if epilogue.bias:
        kw["bias"] = bias.to(f32).reshape(1, -1)
    if epilogue.residual:
        kw["residual"] = residual.to(f32)
    if epilogue.scale:
        if not torch.is_tensor(scale):
            # a Python number stays one: no host-to-device copy, so the plain
            # version can be captured in a CUDA graph
            s = float(scale)
        else:
            s = scale.to(device=acc.device, dtype=f32)
            if epilogue.scale_kind == "row":
                s = s.reshape(-1, 1)
            elif epilogue.scale_kind == "col":
                s = s.reshape(1, -1)
            else:
                s = s.reshape(())
        kw["scale"] = s
    if epilogue.rope:
        kw["sin"] = sin.to(f32)
        kw["cos"] = cos.to(f32)
    return epilogue.apply(acc, acc2, **kw).to(out_dtype)
