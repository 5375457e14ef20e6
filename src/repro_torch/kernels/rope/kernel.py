"""The RoPE kernel (``csrc/rope.cu``) and its launch.

:func:`rope_launch` rotates a (B, H, S, D) tensor on the card by the (S, D)
tables, reading x through its strides (the q/k views of the projection
output need no copy) and writing a contiguous output; ``sin_sign = -1``
rotates by -theta, the op's backward.

:func:`rope_plan` restates how the kernel's launch cuts the work
(``csrc/rope.cu`` ``launch``): a thread owns ``vec`` elements of each half
of a row, a block is ``rp`` row lanes of ``nv`` threads, a unit is one
position and up to ``UNROLL * rp`` of its B x H rows, and block i of a grid
of g takes units i, i + g, i + 2g, ... The wrapper uses it to refuse a head
too wide for one block.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import CudaKernel

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
KERNEL = CudaKernel("rope", "rope.cu", "rope_launch",
                    [_P] * 4 + [_I] * 4 + [_L] * 3 + [_F, _I, _P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# rows a thread loads before it uses one, and the most threads a block
# (csrc/rope.cu UNROLL, THREADS)
UNROLL, THREADS = 4, 256


def rope_plan(rows: int, seq: int, head_dim: int, elem_size: int) -> dict:
    """The kernel's partition of ``rows`` (B x H) rows of ``seq`` positions:
    ``vec`` elements a thread takes of each half (16 bytes), ``nv`` threads
    a row, ``rp`` row lanes a block, ``chunks`` units a position, ``units``
    in all and ``threads`` a block."""
    vec = 16 // elem_size
    nv = -(-(head_dim // 2) // vec)
    if nv > THREADS:
        raise ValueError(f"rope kernel: head_dim {head_dim} needs {nv} "
                         f"threads a row, more than a block's {THREADS}")
    rp = min(-(-rows // UNROLL), THREADS // nv)
    chunks = -(-rows // (rp * UNROLL))
    return dict(vec=vec, nv=nv, rp=rp, chunks=chunks, units=seq * chunks,
                threads=nv * rp)


def rope_launch(x, sin, cos, *, sin_sign: float = 1.0):
    """x: (B, H, S, D) bf16 or fp32 on the card, last dim contiguous;
    sin/cos: (S, D) fp32. Returns the rotated x, contiguous, in x's type."""
    b, h, s, d = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"rope kernel: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if d % 2 or x.stride(3) != 1:
        raise ValueError("rope kernel: x needs an even, contiguous last dim; "
                         f"got shape {tuple(x.shape)}, strides {x.stride()}")
    for name, t in (("sin", sin), ("cos", cos)):
        if t.dtype != torch.float32 or t.shape != (s, d) \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"rope kernel: {name} must be a contiguous "
                             f"({s}, {d}) float32 table on {x.device}")
    out = torch.empty((b, h, s, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    rope_plan(b * h, s, d, x.element_size())   # refuses a too-wide head
    fn = KERNEL.fn()
    stream = KERNEL.stream(x.device)
    KERNEL.launches += 1
    code = fn(x.data_ptr(), sin.data_ptr(), cos.data_ptr(), out.data_ptr(),
              b, h, s, d, *x.stride()[:3], float(sin_sign), _DTYPES[x.dtype],
              stream)
    KERNEL.check(code)
    return out
