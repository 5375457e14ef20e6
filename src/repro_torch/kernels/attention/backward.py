"""``flash_attention_bwd``: the flash-attention backward, two passes of one
kernel source (``csrc/flash_bwd.cu``).

Pass 0 writes dq, pass 1 dk and dv. p is recomputed from the forward's
saved fp32 lse; ``delta = rowsum(dO · O)`` is a plain torch preprocess, as
in the reference. The reference computes dk/dv per query head and sums each
GQA group in its caller; here the dk/dv pass sums the group in fp32 inside
the kernel, so dk and dv come out per key head, rounded once. A CPU tensor
runs the plain version (:func:`flash_attention_bwd_ref`, the same rounding
points); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import CudaKernel
from .epilogue import cap_logits
from .ops import HEAD_DIMS
from .ref import MASK_VALUE

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
KERNEL = CudaKernel(
    "flash_attention_bwd", "flash_bwd.cu", "flash_bwd_launch",
    [_P] * 9 + [_I] * 7 + [_L] * 12 + [_F, _F, _I, _I, _P])


def attention_delta(out, do):
    """delta = rowsum(dO · O) in fp32, (B, H, Sq)."""
    return torch.sum(do.float() * out.float(), dim=-1)


def flash_attention_bwd_ref(q, k, v, out, lse, do, *, causal: bool = False,
                            window: int | None = None,
                            logit_scale: float | None = None, softcap=None):
    """Plain version of the two passes: (dq, dk, dv), dk/dv per key head.
    The same arithmetic as the kernel: scores and p in fp32 from the saved
    lse, p and ds rounded to q's type before their products (the tensor
    cores' operands), every sum in fp32, the GQA group summed in fp32."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    f32 = torch.float32
    kf = k.to(f32).repeat_interleave(group, dim=1)
    vf = v.to(f32).repeat_interleave(group, dim=1)
    scale = logit_scale if logit_scale is not None else d ** -0.5
    s_raw = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), kf) * scale
    s = cap_logits(s_raw, softcap)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, MASK_VALUE)
    p = torch.where(mask, torch.exp(s - lse.to(f32)[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(f32), vf)
    ds = p * (dp - attention_delta(out, do)[..., None])
    if softcap:
        th = torch.tanh(s_raw / softcap)
        ds = ds * (1 - th * th)
    ds = ds * scale
    rt = q.dtype
    p_r, ds_r = p.to(rt).to(f32), ds.to(rt).to(f32)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds_r, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds_r, q.to(f32))
    dv = torch.einsum("bhqk,bhqd->bhkd", p_r, do.to(f32))
    dk = dk.reshape(b, hkv, group, skv, d).sum(dim=2)
    dv = dv.reshape(b, hkv, group, skv, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = False,
                        window: int | None = None,
                        logit_scale: float | None = None, softcap=None):
    """(dq (B, H, Sq, D), dk and dv (B, Hkv, Skv, D)) from the forward's
    q, k, v, out and lse and the output's cotangent ``do``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                       window=window, logit_scale=logit_scale,
                                       softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"attention backward: unsupported device {q.device}")
    return _launch(q, k, v, out, lse, do, causal=causal, window=window,
                   logit_scale=logit_scale, softcap=softcap)


def _launch(q, k, v, out, lse, do, *, causal, window, logit_scale, softcap,
            passes=(0, 1)):
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"attention backward kernel: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"attention backward kernel: {name} must be "
                            f"bfloat16, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"attention backward: {name} on {t.device}, q "
                             f"on {q.device}")
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"attention backward kernel: {name} needs a "
                             "contiguous last dim, strides that are multiples "
                             "of 8 and a 16-byte aligned start")
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"attention backward: do {tuple(do.shape)} is not "
                         f"q's shape {tuple(q.shape)}")
    lse = lse.to(torch.float32).contiguous()
    delta = attention_delta(out, do).contiguous()
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, hkv, skv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, hkv, skv, d), dtype=v.dtype, device=q.device)
    scale = logit_scale if logit_scale is not None else d ** -0.5
    fn = KERNEL.fn()
    stream = KERNEL.stream(q.device)
    for which in passes:   # 0: the dq pass, 1: the dk/dv pass
        KERNEL.launches += 1
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), which, b, h, hkv, sq, skv, d,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *do.stride()[:3], float(scale), float(softcap or 0.0),
                  int(causal), int(window or 0), stream)
        KERNEL.check(code)
    return dq, dk, dv
