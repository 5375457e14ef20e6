"""The fused dropout + residual + layernorm kernel (``csrc/fused_norm.cu``)
and its launch: the keep-mask hashed in the kernel, each row held in the
registers of a group of threads of a persistent grid (past 8192 columns, a
block a row, in shared memory)."""
from __future__ import annotations

import ctypes

import torch

from .._build import CudaKernel
from .ref import seed_bits

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("fused_norm", "fused_norm.cu", "fused_norm_launch",
                    [_P] * 6 + [_I] * 3 + [_F] * 3 + [_I, _I, _P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# rows wider than the kernel's register rows (8192) hold their fp32 sum in
# shared memory (227 KB a block, less the reduction scratch)
MAX_D = 56 * 1024


def fused_norm_launch(x, residual, weight, bias, seed, *, dropout_p: float,
                      eps: float):
    """x, residual: (rows, d) contiguous, one type (fp32 or bf16); weight,
    bias: (d,) contiguous, one type. Returns (normed, new_residual)."""
    rows, d = x.shape
    if x.dtype not in _DTYPES or residual.dtype != x.dtype:
        raise TypeError("fused_norm kernel: x and residual must share a type, "
                        f"float32 or bfloat16; got {x.dtype}, {residual.dtype}")
    if weight.dtype not in _DTYPES or bias.dtype != weight.dtype:
        raise TypeError("fused_norm kernel: weight and bias must share a "
                        "type, float32 or bfloat16; got "
                        f"{weight.dtype}, {bias.dtype}")
    if d > MAX_D:
        raise ValueError(f"fused_norm kernel: d {d} exceeds {MAX_D}")
    for name, t in (("x", x), ("residual", residual), ("weight", weight),
                    ("bias", bias)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"fused_norm kernel: {name} must be contiguous "
                             f"on {x.device}")
    out = torch.empty_like(x)
    new_residual = torch.empty_like(x)
    if x.numel() == 0:
        return out, new_residual
    seed_bits(seed)      # refuses a seed outside int32; the kernel casts
                         # the int32 to uint32, as the reference's does
    # 1/(1-p) in double, rounded to fp32 by ctypes, as JAX rounds the
    # Python constant
    scale = 1.0 / (1.0 - dropout_p) if dropout_p > 0.0 else 1.0
    fn = KERNEL.fn()
    stream = KERNEL.stream(x.device)
    KERNEL.launches += 1
    code = fn(x.data_ptr(), residual.data_ptr(), weight.data_ptr(),
              bias.data_ptr(), out.data_ptr(), new_residual.data_ptr(), rows,
              d, int(seed), float(dropout_p), scale, float(eps),
              _DTYPES[x.dtype], _DTYPES[weight.dtype], stream)
    KERNEL.check(code)
    return out, new_residual
