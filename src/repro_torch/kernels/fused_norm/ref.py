"""Plain torch version of the fused dropout + residual + layernorm op.

The keep-mask is the reference's counter-based hash, bit for bit: uint32
arithmetic (here on int64 tensors masked to 32 bits, since torch has no
wrapping uint32 multiply), the seed taken as int32 and cast to uint32 (-1
is 0xFFFFFFFF), the element index ``row * d + col`` wrapping mod 2^32.
Rounding points as the reference's: the input upcast to fp32, dropout as
``where(keep, x * fp32(1 / (1 - p)), 0)``, the residual add in fp32, the
mean and then the mean of the centred squares, ``rsqrt(var + eps)``, both
outputs cast to x's type.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) (an int or an int64 tensor) and a
    constant c < 2^32: two 16-bit halves of c, so no product leaves int64."""
    lo = (x * (c & 0xFFFF)) & MASK32
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def lowbias32(x):
    """The lowbias32 integer mix of values in [0, 2^32): an int, or an int64
    tensor holding uint32 values. Returns the same kind."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def seed_bits(seed) -> int:
    """The seed as the kernel takes it: an int32, reinterpreted as uint32."""
    seed = int(seed)
    if not INT32_MIN <= seed <= INT32_MAX:
        raise ValueError(f"fused_norm: seed {seed} does not fit int32")
    return seed & MASK32


def dropout_keep_mask_ref(seed, shape, p: float, device=None, row0: int = 0):
    """(rows, d) bool: True where uniform(hash(row * d + col, seed)) >= p,
    for the rows row0 .. row0 + rows - 1 of a d-wide array."""
    rows, d = shape
    idx = (torch.arange(row0, row0 + rows, dtype=torch.int64,
                        device=device)[:, None] * d
           + torch.arange(d, dtype=torch.int64, device=device)[None, :]) \
        & MASK32
    bits = lowbias32(idx ^ lowbias32(seed_bits(seed)))
    uniform = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return uniform >= p


def fused_dropout_residual_layernorm_ref(x, residual, weight, bias, seed=0, *,
                                         dropout_p: float = 0.0,
                                         eps: float = 1e-5):
    """x, residual: (rows, d); weight/bias: (d,). Returns (normed,
    new_residual), both in x's type."""
    xf = x.float()
    if dropout_p > 0.0:
        keep = dropout_keep_mask_ref(seed, x.shape, dropout_p, x.device)
        xf = torch.where(keep, xf * (1.0 / (1.0 - dropout_p)), 0.0)
    resid = residual.float() + xf
    mean = torch.mean(resid, dim=1, keepdim=True)
    centered = resid - mean
    var = torch.mean(centered * centered, dim=1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    out = centered * inv * weight.float() + bias.float()
    return out.to(x.dtype), resid.to(x.dtype)
