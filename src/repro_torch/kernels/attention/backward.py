"""``flash_attention_bwd``: the flash-attention backward, one key-stationary
kernel and a dq convert pass (``csrc/flash_bwd.cu``).

A block of the main kernel owns one key tile of :func:`key_tile_rows` rows
of one key head and batch: it keeps K and V in shared memory, walks every
query head of its GQA group and, for each, the q tiles of
:func:`q_tile_range`, and computes the five products of each (q, k) pair
(s, dp, dv, dk, dq). dk and
dv are summed over the group in fp32 inside the kernel and written once per
key head; dq is reduce-added in fp32 into a zeroed workspace, which the
second launch rounds to bf16. p is recomputed from the forward's saved fp32
lse; ``delta = rowsum(dO · O)`` is a plain torch preprocess, as in the
reference. :func:`plan_blocks` is the order in which the kernel dispatches
its blocks (longest first) with each block's q tiles; the CPU tests hold
it. A CPU tensor runs the plain version (:func:`flash_attention_bwd_ref`,
the same rounding points); a CUDA tensor launches the kernels or raises.
q, k, v and dO are read through TMA maps of their strided views
(``ops.check_tma_view``), so the packed q|k projection and the cotangent
autograd hands over need no copy.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch import obs
from .._build import CudaKernel, entry_clock, journal
from .epilogue import cap_logits, describe_chain
from .ops import HEAD_DIMS, check_tma_view, visible_pairs
from .ref import MASK_VALUE

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
KERNEL = CudaKernel(
    "flash_attention_bwd", "flash_bwd.cu", "flash_bwd_launch",
    [_P] * 10 + [_I] * 7 + [_L] * 12 + [_F, _F, _I, _I, _P])

# head dims of the backward kernel: the forward's
BWD_HEAD_DIMS = HEAD_DIMS
# rows and columns of one sub-tile of the fp32 dq workspace
DQ_SUB = 64


def key_tile_rows(head_dim: int) -> int:
    """Key rows a block of the main kernel owns (its BKT): 128 at head_dim
    64 and 128, a warpgroup's 64 rows each; 64 at 256, where the two
    warpgroups split the head dim of the same 64 rows."""
    return 64 if head_dim == 256 else 128


def q_tile_rows(head_dim: int) -> int:
    """q rows of one stage of the main kernel (its BQ): 128 at head_dim 64,
    64 at 128 and 256, so that each consumer warpgroup owns one 64 x 64 dq
    sub-tile (at 256: two, one of each of its 64-column halves)."""
    return 128 if head_dim == 64 else 64


def q_tile_range(k0: int, sq: int, skv: int, bq: int, bkt: int, *,
                 causal: bool, window: int | None) -> tuple:
    """The q tiles [lo, hi) of ``bq`` rows that hold a visible pair with the
    key tile of ``bkt`` rows starting at ``k0``: from the diagonal (causal)
    or the first row, to the window's edge or the last row; (lo, lo) when
    none."""
    k1 = min(k0 + bkt, skv) - 1
    first = k0 if causal else 0
    last = sq - 1
    if window:
        last = min(last, k1 + window - 1)
    lo = min(first, sq) // bq
    return lo, (last // bq + 1 if first <= last else lo)


def tile_needs_mask(k0: int, q0: int, skv: int, bq: int, bkt: int, *,
                    causal: bool, window: int | None) -> bool:
    """Whether the (q tile of ``bq`` rows at q0, key tile of ``bkt`` rows at
    k0) has a masked pair: it crosses the diagonal, the window's edge or the
    key length. The kernel masks only those tiles; q rows past the length
    read lse = +inf."""
    return (k0 + bkt > skv or (causal and q0 < k0 + bkt - 1)
            or bool(window and q0 + bq - 1 - k0 >= window))


def plan_blocks(sq: int, skv: int, head_dim: int, *, causal: bool,
                window: int | None) -> list:
    """The main kernel's key tiles in dispatch order, each with its q-tile
    range: [(key tile, lo, hi)]. Every (batch, key head) runs the same
    list; block ``rank * B * Hkv + b * Hkv + hk`` takes entry ``rank``.
    Longest first: ascending key tiles (their q ranges shrink from the
    diagonal on), descending under a window without the causal mask (later
    key tiles see more rows)."""
    bq, bkt = q_tile_rows(head_dim), key_tile_rows(head_dim)
    n_kt = -(-skv // bkt)
    order = range(n_kt - 1, -1, -1) if window and not causal else range(n_kt)
    return [(kt, *q_tile_range(kt * bkt, sq, skv, bq, bkt, causal=causal,
                               window=window)) for kt in order]


def backward_work(b: int, h: int, hkv: int, sq: int, skv: int, d: int, *,
                  causal: bool, window: int | None = None) -> dict:
    """What the backward must do, for its bounds: ``flops`` of the five
    products per visible pair (s, dp, dv, dk, dq: 2 d each), ``bytes``
    of q, k, v, dO (bf16), lse and delta (fp32) read once and dq, dk, dv
    (bf16) written once; ``convert_bytes`` the convert pass's fp32
    workspace read and bf16 dq written (its workspace padded to whole q
    tiles); ``main_bytes`` the main kernel's inputs and dk, dv and the
    workspace written once."""
    pairs = b * h * visible_pairs(sq, skv, causal=causal, window=window)
    q_b = b * h * sq * d * 2
    kv_b = b * hkv * skv * d * 2
    vec_b = 2 * b * h * sq * 4
    bq = q_tile_rows(d)
    acc_b = b * h * (-(-sq // bq) * bq) * d * 4
    return {"pairs": pairs, "flops": 5 * 2 * pairs * d,
            "bytes": 3 * q_b + 4 * kv_b + vec_b,
            "main_bytes": 2 * q_b + 4 * kv_b + vec_b + acc_b,
            "convert_bytes": acc_b + q_b}


def attention_delta(out, do):
    """delta = rowsum(dO · O) in fp32, (B, H, Sq). The fp32 products come
    from one ``addcmul`` onto a one-element fp32 zero, which makes the op
    compute in fp32 with dO and O widened exactly (a product of two bf16
    values is exact in fp32), into a contiguous buffer whose rows are then
    summed by one fp32 matrix-vector product (on an H100 a third faster
    than ``torch.sum`` over rows of 64)."""
    d = do.shape[-1]
    prod = torch.empty(do.shape, dtype=torch.float32, device=do.device)
    zero = torch.zeros(1, dtype=torch.float32, device=do.device)
    torch.addcmul(zero, do, out, out=prod)
    ones = torch.ones(d, dtype=torch.float32, device=do.device)
    return torch.mv(prod.view(-1, d), ones).view(do.shape[:-1])


def flash_attention_bwd_ref(q, k, v, out, lse, do, *, causal: bool = False,
                            window: int | None = None,
                            logit_scale: float | None = None, softcap=None):
    """Plain version of the kernel: (dq, dk, dv), dk/dv per key head. The
    same arithmetic: scores and p in fp32 from the saved lse, p and ds
    rounded to q's type before their products (the tensor cores'
    operands), every sum in fp32, the GQA group summed in fp32."""
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
                        logit_scale: float | None = None, softcap=None,
                        policy=None):
    """(dq (B, H, Sq, D), dk and dv (B, Hkv, Skv, D)) from the forward's
    q, k, v, out and lse and the output's cotangent ``do``. Journaled as
    ``obs`` op "attention_bwd" (the main kernel) and, as the reference has
    no event for it, "flash_attention_bwd" variant "dq_convert" (the dq
    conversion) with its policy (``ops.flash_policy``); the CPU's plain
    version journals both."""
    from .ops import flash_policy

    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"attention backward: unsupported device {dev}")
    args = dict(causal=causal, window=window, logit_scale=logit_scale,
                softcap=softcap)
    work = None
    if obs.enabled():
        b, h, sq, d = q.shape
        work = backward_work(b, h, k.shape[1], sq, k.shape[2], d,
                             causal=causal, window=window)
    if obs.enabled():
        policy = flash_policy("attention_bwd", q, k, causal, policy)
    t0 = entry_clock()
    if dev.type == "cuda":
        run = FlashBwdLaunch(q, k, v, out, lse, do, **args)
        run.main()
        grads = run.dq, run.dk, run.dv
    else:
        grads = flash_attention_bwd_ref(q, k, v, out, lse, do, **args)
    if obs.enabled():
        journal("attention_bwd", dev, t0, variant="causal" if causal else "",
                chain=describe_chain(softcap), dma_bytes=work["main_bytes"],
                flops=int(10 * b * h * sq * k.shape[2] * d
                          * (0.5 if causal else 1.0)), policy=policy)
    t0 = entry_clock()
    if dev.type == "cuda":
        run.convert()
    if obs.enabled():
        journal("flash_attention_bwd", dev, t0, variant="dq_convert",
                dma_bytes=work["convert_bytes"])
    return grads


class FlashBwdLaunch:
    """The two launches of one backward on the card. The constructor checks
    every operand (the TMA views included), computes delta and allocates
    the zeroed fp32 dq workspace and the outputs, so nothing is launched
    for a call the kernel would refuse; :meth:`main` launches the main
    kernel (dk, dv, and dq reduce-added into the workspace), :meth:`convert`
    the workspace's conversion to dq."""

    def __init__(self, q, k, v, out, lse, do, *, causal, window, logit_scale,
                 softcap):
        b, h, sq, d = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        if d not in BWD_HEAD_DIMS:
            raise ValueError(f"attention backward kernel: head_dim {d} not "
                             f"in {BWD_HEAD_DIMS}")
        if k.shape[0] != b or k.shape[3] != d or tuple(v.shape) != tuple(
                k.shape) or h % hkv:
            raise ValueError(f"attention backward: q {tuple(q.shape)} and "
                             f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                             "match")
        if tuple(do.shape) != tuple(q.shape):
            raise ValueError(f"attention backward: do {tuple(do.shape)} is "
                             f"not q's shape {tuple(q.shape)}")
        if tuple(lse.shape) != (b, h, sq):
            raise ValueError(f"attention backward: lse {tuple(lse.shape)}, "
                             f"want {(b, h, sq)}")
        for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
            if t.dtype != torch.bfloat16:
                raise TypeError(f"attention backward kernel: {name} must be "
                                f"bfloat16, got {t.dtype}")
            if t.device != q.device:
                raise ValueError(f"attention backward: {name} on {t.device}, "
                                 f"q on {q.device}")
            check_tma_view(t, name)
        self.q, self.k, self.v, self.do = q, k, v, do
        self.shape = (b, h, hkv, sq, skv, d)
        # lse and delta padded to whole q tiles: +inf (p = 0) and 0
        bq = q_tile_rows(d)
        pad = -sq % bq
        lse = lse.to(torch.float32)
        delta = attention_delta(out, do)
        if pad:
            lse = F.pad(lse, (0, pad), value=float("inf"))
            delta = F.pad(delta, (0, pad))
        self.lse, self.delta = lse.contiguous(), delta.contiguous()
        dev = q.device
        self.dq_acc = torch.zeros(
            (b, h, (sq + pad) // DQ_SUB, d // DQ_SUB, DQ_SUB * DQ_SUB),
            dtype=torch.float32, device=dev)
        self.dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=dev)
        self.dk = torch.empty((b, hkv, skv, d), dtype=k.dtype, device=dev)
        self.dv = torch.empty((b, hkv, skv, d), dtype=v.dtype, device=dev)
        self.scale = float(logit_scale if logit_scale is not None
                           else d ** -0.5)
        self.softcap = float(softcap or 0.0)
        self.causal, self.window = int(causal), int(window or 0)
        self.fn = KERNEL.fn()

    def _run(self, which: int) -> None:
        b, h, hkv, sq, skv, d = self.shape
        stream = KERNEL.stream(self.q.device)
        KERNEL.launches += 1
        KERNEL.check(self.fn(
            self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
            self.do.data_ptr(), self.lse.data_ptr(), self.delta.data_ptr(),
            self.dq_acc.data_ptr(), self.dq.data_ptr(), self.dk.data_ptr(),
            self.dv.data_ptr(), which, b, h, hkv, sq, skv, d,
            *self.q.stride()[:3], *self.k.stride()[:3], *self.v.stride()[:3],
            *self.do.stride()[:3], self.scale, self.softcap, self.causal,
            self.window, stream))

    def main(self) -> None:
        self._run(0)

    def convert(self) -> None:
        self._run(1)
