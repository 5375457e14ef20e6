"""``attention``: causal / windowed MHA-GQA flash attention.

A CPU tensor runs the plain version (:func:`flash_attention_fwd_ref`); a
CUDA tensor launches the hand-written kernel (``csrc/flash_fwd.cu``) or
raises. The kernel takes the logit soft cap but not sinks, on either device.
On the card q, k and v are bf16 with a contiguous last dim of 64 or 128;
their other strides are passed to the kernel, so views need no copy. Under
autograd the op is a ``torch.autograd.Function`` whose forward keeps (q, k,
v, out, lse) and whose backward is the flash backward (``backward.py``).
"""
from __future__ import annotations

import ctypes

import torch

from .._build import CudaKernel
from .epilogue import cap_logits
from .ref import MASK_VALUE

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
KERNEL = CudaKernel(
    "flash_attention_fwd", "flash_fwd.cu", "flash_fwd_launch",
    [_P] * 5 + [_I] * 6 + [_L] * 9 + [_F, _F, _I, _I, _P])
HEAD_DIMS = (64, 128)


def flash_attention_fwd_ref(q, k, v, *, causal: bool = False,
                            window: int | None = None,
                            logit_scale: float | None = None, softcap=None):
    """Plain version of the flash kernel: (out, lse). Same rounding points
    as the kernel: scores and softmax in fp32, p rounded to v's type before
    p @ v, out = acc / l (l == 0 guarded), lse = m + log(l)."""
    b, h, sq, d = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    scale = logit_scale if logit_scale is not None else d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = cap_logits(s, softcap)
    skv = k.shape[2]
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, MASK_VALUE)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe).to(q.dtype), (m + torch.log(l_safe))[..., 0]


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        window: int | None = None,
                        logit_scale: float | None = None, softcap=None):
    """Returns (out (B, H, Sq, D) in q's type, lse (B, H, Sq) fp32)."""
    if q.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3] or q.shape[1] % k.shape[1]:
        raise ValueError(f"attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} do not match")
    if window is not None and window <= 0:
        raise ValueError(f"attention: window must be positive, got {window}")
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                       logit_scale=logit_scale,
                                       softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    return _launch(q, k, v, causal=causal, window=window,
                   logit_scale=logit_scale, softcap=softcap)


def attention(q, k, v, *, causal: bool = False, window: int | None = None,
              logit_scale: float | None = None, softcap=None, sinks=None):
    """Multi-/grouped-query flash attention. q: (B, H, S, D); k/v:
    (B, Hkv, S, D). Returns the output in q's type."""
    if sinks is not None:
        # and so no dsinks (the reference's ops.py:81-82) either
        raise NotImplementedError("attention kernel: sinks are not supported")
    args = (causal, window, logit_scale, softcap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashFn.apply(q, k, v, args)
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               logit_scale=logit_scale, softcap=softcap)[0]


class _FlashFn(torch.autograd.Function):
    """attention under autograd: the forward keeps (q, k, v, out, lse), the
    backward runs the dq and dk/dv passes."""

    @staticmethod
    def forward(ctx, q, k, v, args):
        causal, window, logit_scale, softcap = args
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       logit_scale=logit_scale,
                                       softcap=softcap)
        ctx.args = args
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        from .backward import flash_attention_bwd
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, logit_scale, softcap = ctx.args
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, do, causal=causal, window=window,
            logit_scale=logit_scale, softcap=softcap)
        return dq, dk, dv, None


def _launch(q, k, v, *, causal, window, logit_scale, softcap):
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"attention kernel: head_dim {d} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"attention kernel: {name} must be bfloat16, "
                            f"got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"attention: {name} on {t.device}, q on {q.device}")
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"attention kernel: {name} needs a contiguous "
                             "last dim, strides that are multiples of 8 and a "
                             "16-byte aligned start")
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    scale = logit_scale if logit_scale is not None else d ** -0.5
    fn = KERNEL.fn()
    stream = KERNEL.stream(q.device)
    KERNEL.launches += 1
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              lse.data_ptr(), b, h, hkv, sq, skv, d,
              *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
              float(scale), float(softcap or 0.0), int(causal),
              int(window or 0), stream)
    KERNEL.check(code)
    return out, lse
