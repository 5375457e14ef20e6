"""Plain torch RoPE: table construction and the rotate-half rotation."""
from __future__ import annotations

import torch


def rope_tables(positions, dim: int, theta: float = 10000.0):
    """(sin, cos), each (len(positions), dim) with duplicated halves, fp32."""
    half = dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    angles = positions.float()[:, None] * freqs[None, :]
    sin = torch.cat([torch.sin(angles), torch.sin(angles)], dim=-1)
    cos = torch.cat([torch.cos(angles), torch.cos(angles)], dim=-1)
    return sin, cos


def rope_ref(x, sin, cos):
    """x: (..., S, D); sin/cos: (S, D). Rotated in fp32, returned in x's type."""
    xf = x.float()
    d = x.shape[-1]
    rotated = torch.cat([-xf[..., d // 2:], xf[..., : d // 2]], dim=-1)
    return (xf * cos + rotated * sin).to(x.dtype)
