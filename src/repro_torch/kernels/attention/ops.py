"""``attention``: causal / windowed MHA-GQA flash attention.

A CPU tensor runs the plain version (:func:`flash_attention_fwd_ref`); a
CUDA tensor launches the hand-written kernel (``csrc/flash_fwd.cu``) or
raises. The kernel takes the logit soft cap but not sinks, on either device.
On the card q, k and v are bf16 with a last dim of 64, 128 or 256 (the
backward kernel takes 64 and 128), read through
TMA maps of their strided views (:func:`check_tma_view`), so the packed q|k
projection and the v view need no copy. A work item of the kernel is one
q tile of ``FWD_Q_TILE`` rows of one query head and batch, which walks the
key tiles of :func:`fwd_key_range`, masking only the tiles
:func:`fwd_tile_needs_mask` names; persistent blocks take the items in the
order of :func:`plan_fwd_blocks` (longest first under the causal mask),
and the CPU tests hold it. Under autograd the op is a
``torch.autograd.Function`` whose forward keeps (q, k, v, out, lse) and
whose backward is the flash backward (``backward.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.core import autotune
from .._build import CudaKernel, entry_clock, journal
from .epilogue import cap_logits, describe_chain
from .ref import MASK_VALUE

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
KERNEL = CudaKernel(
    "flash_attention_fwd", "flash_fwd.cu", "flash_fwd_launch",
    [_P] * 5 + [_I] * 6 + [_L] * 9 + [_F, _F, _I, _I, _P])
HEAD_DIMS = (64, 128, 256)

# q rows of one work item of the forward kernel: two consumer warpgroups of
# 64 (BQ in csrc/flash_fwd.cu)
FWD_Q_TILE = 128


def fwd_key_tile(head_dim: int) -> int:
    """Key rows of one K/V tile of the forward kernel (its BKV): 128 at
    head_dim 64, 64 at 128 and 256, so that its ring and q tiles fit in
    shared memory."""
    return 128 if head_dim == 64 else 64


def fwd_stages(head_dim: int) -> int:
    """K/V tiles in the forward kernel's shared-memory ring (its STAGES):
    four below head_dim 256, two at 256."""
    return 2 if head_dim == 256 else 4


def fwd_q_buffers(head_dim: int) -> int:
    """q tiles the forward kernel keeps (its QBUFS): two below head_dim
    256, so the next item's q loads while this one runs; one at 256."""
    return 1 if head_dim == 256 else 2


def fwd_key_range(q0: int, sq: int, skv: int, bkv: int, *, causal: bool,
                  window: int | None) -> tuple:
    """The key tiles [lo, hi) of ``bkv`` rows that hold a visible pair with
    the q tile starting at ``q0``: from the window's edge (or the first key)
    to the diagonal (causal) or the last key; (0, 0) when none."""
    q_last = min(q0 + FWD_Q_TILE, sq) - 1
    k_hi = min(skv, q_last + 1) if causal else skv
    k_lo = max(0, q0 - window + 1) if window else 0
    if k_lo >= k_hi:
        return 0, 0
    return k_lo // bkv, -(-k_hi // bkv)


def fwd_tile_needs_mask(q0: int, k0: int, sq: int, skv: int, bkv: int, *,
                        causal: bool, window: int | None) -> bool:
    """Whether the (q tile at q0, key tile at k0) has a masked pair among
    the q tile's rows below ``sq``: it crosses the key length, the diagonal
    or the window's edge. The kernel masks only those tiles."""
    q_last = min(q0 + FWD_Q_TILE, sq) - 1
    return (k0 + bkv > skv or (causal and k0 + bkv - 1 > q0)
            or bool(window and q_last - k0 >= window))


def plan_fwd_blocks(sq: int, skv: int, head_dim: int, *, causal: bool,
                    window: int | None) -> list:
    """The forward kernel's q tiles in dispatch order, each with its key-tile
    range: [(q tile, lo, hi)]. Every (batch, head) runs the same list;
    work item ``rank * B * H + b * H + h`` takes entry ``rank`` (the query
    heads of one key head are adjacent, so their K/V tiles come from L2).
    Under the causal mask the last q tile first: longest first, except in
    causal cross attention with a window that leaves late rows without a
    key (sq > skv + window), whose empty tiles come first and cost
    nothing."""
    bkv = fwd_key_tile(head_dim)
    n_qt = -(-sq // FWD_Q_TILE)
    order = range(n_qt - 1, -1, -1) if causal else range(n_qt)
    return [(t, *fwd_key_range(t * FWD_Q_TILE, sq, skv, bkv, causal=causal,
                               window=window)) for t in order]


def fwd_item(item: int, batch: int, heads: int) -> tuple:
    """(rank in :func:`plan_fwd_blocks`, batch, head) of one work item, as
    the kernel's blocks decode it."""
    rank, rest = divmod(item, batch * heads)
    return rank, rest // heads, rest % heads


def visible_pairs(sq: int, skv: int, *, causal: bool,
                  window: int | None) -> int:
    """Visible (q, k) pairs of one head under the mask."""
    total = 0
    for qpos in range(sq):
        lo = max(0, qpos - window + 1) if window else 0
        hi = min(qpos, skv - 1) if causal else skv - 1
        total += max(0, hi - lo + 1)
    return total


def forward_work(b: int, h: int, hkv: int, sq: int, skv: int, d: int, *,
                 causal: bool, window: int | None = None) -> dict:
    """What the forward must do, for its bounds: ``flops`` of its two
    products per visible pair (s and p @ v: 2 d each), ``bytes`` of q, k, v
    (bf16) read once and out (bf16) and lse (fp32) written once."""
    pairs = b * h * visible_pairs(sq, skv, causal=causal, window=window)
    q_b = b * h * sq * d * 2
    kv_b = b * hkv * skv * d * 2
    return {"pairs": pairs, "flops": 4 * d * pairs,
            "bytes": 2 * q_b + 2 * kv_b + b * h * sq * 4}


def check_tma_view(t, name: str) -> None:
    """Raise ValueError unless a 4-D bf16 view can be read by a TMA map:
    a contiguous last dim, a 16-byte aligned start and every other stride
    a multiple of 16 bytes (the TMA's rules). Both attention kernels read
    their operands so."""
    if t.dim() != 4 or t.stride(3) != 1:
        raise ValueError(f"attention kernel: {name} must be a 4-D view with "
                         f"a contiguous last dim, got shape "
                         f"{tuple(t.shape)}, strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"attention kernel: {name} starts at an address "
                         "that is not 16-byte aligned")
    bad = [s for s in t.stride()[:3] if (s * t.element_size()) % 16]
    if bad:
        raise ValueError(f"attention kernel: {name} has strides "
                         f"{t.stride()[:3]} (elements), not all multiples "
                         "of 16 bytes")


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


def flash_policy(op: str, q, k, causal: bool, policy=None):
    """The flash kernels' policy (``op`` "attention_fwd" or
    "attention_bwd") for the journal: the caller's, else the autotuner's,
    whose one candidate a head_dim is the layout the kernel compiles for
    it. The launch takes no other, so it is resolved only while ``obs``
    records."""
    if policy is not None:
        return policy
    b, h, sq, d = q.shape
    return autotune.select_policy(op, (b, h, sq, k.shape[2], d), q.dtype,
                                  causal=causal)


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        window: int | None = None,
                        logit_scale: float | None = None, softcap=None,
                        policy=None):
    """Returns (out (B, H, Sq, D) in q's type, lse (B, H, Sq) fp32).
    Journaled as ``obs`` op "attention_fwd" with its policy
    (:func:`flash_policy`)."""
    if q.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3] or q.shape[1] % k.shape[1]:
        raise ValueError(f"attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} do not match")
    if window is not None and window <= 0:
        raise ValueError(f"attention: window must be positive, got {window}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: unsupported device {q.device}")
    t0 = entry_clock()
    if obs.enabled():
        policy = flash_policy("attention_fwd", q, k, causal, policy)
    run = flash_attention_fwd_ref if q.device.type == "cpu" else _launch
    out = run(q, k, v, causal=causal, window=window, logit_scale=logit_scale,
              softcap=softcap)
    if obs.enabled():
        b, h, sq, d = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        journal("attention_fwd", q.device, t0,
                variant="windowed" if window else ("causal" if causal
                                                   else ""),
                chain=describe_chain(softcap),
                dma_bytes=forward_work(b, h, hkv, sq, skv, d, causal=causal,
                                       window=window)["bytes"],
                flops=int(4 * b * h * sq * skv * d
                          * (0.5 if causal else 1.0)), policy=policy)
    return out


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
        check_tma_view(t, name)
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
