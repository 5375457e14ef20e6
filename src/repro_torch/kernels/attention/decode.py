"""Split-KV decode attention: ``attention_decode`` over a contiguous (ring)
KV cache, one query token per sequence, and ``attention_decode_paged`` over
a paged KV pool, 1 or T query tokens per sequence.

A CUDA tensor launches a hand-written kernel (``csrc/flash_decode.cu``,
``csrc/flash_decode_paged.cu``, one body in ``csrc/decode_split.cuh``) that
computes the output in one launch over ``KEY_TILE``-key tiles: a unit's
tiles in one split, whose block writes the output, or in several, whose
partials the last block of the unit merges in the same launch, so no
plain-torch combine runs on the card. A CPU tensor runs the plain versions
(:func:`decode_partials_ref`, :func:`decode_partials_paged_ref`: a split of
``BLOCK_KV`` slots, or one page) and :func:`combine_splits`, as the
reference merges its partials in jnp. The launch's key splits come from
its ``KernelPolicy`` (the caller's, or :func:`decode_policy`: with no
pretuned table installed ``core.autotune.plan_decode``'s plan, a function
of the sizes and the SM count, never of the lengths); the kernel's live
key tiles (:func:`live_key_tiles`) are mirrored here so the CPU tests can
hold them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.core import autotune
from repro_torch.core.autotune import (  # noqa: F401
    BLOCKS_PER_SM, FEW_ROWS, KEY_TILE, MIN_SPLIT_TILES, ROW_TILE,
    decode_units, plan_decode, rows_per_unit)
from .._build import CudaKernel, entry_clock, journal
from ..gemm.ops import sm_count
from .epilogue import cap_logits, describe_chain
from .ref import MASK_VALUE, decode_ref, ring_positions

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel(
    "flash_decode", "flash_decode.cu", "flash_decode_launch",
    [_P] * 10 + [_I] * 7 + [_F, _F, _I, _P])
PAGED_KERNEL = CudaKernel(
    "flash_decode_paged", "flash_decode_paged.cu", "flash_decode_paged_launch",
    [_P] * 11 + [_I] * 10 + [_F, _F, _I, _P])
BLOCK_KV = 64
HEAD_DIMS = (64, 128, 256)
MAX_PAGE_SIZE = 128

# the ring's stages by head_dim (csrc/decode_split.cuh)
STAGES = autotune.DECODE_STAGES


def decode_policy(b: int, hkv: int, rows: int, slots: int, d: int, device,
                  dtype="bfloat16", q_tokens: int = 1):
    """The policy of one decode launch over ``slots`` key positions: the
    autotuner's ``attention_decode`` policy (its ``splits`` the key
    splits) for the card's SM count."""
    return autotune.select_policy(
        "attention_decode", (b, hkv, rows, slots, d), dtype,
        q_tokens=q_tokens,
        sms=sm_count(device) if device.type == "cuda" else None)


def live_key_tiles(length: int, keys: int, *, r0: int = 0, nr: int = 1,
                   q_tokens: int = 1, window: int | None = None,
                   paged: bool = True) -> tuple:
    """The kernel's live tiles [lo, hi) of a unit with rows r0 .. r0 + nr - 1
    (row r is token r mod T): the key tiles holding a key some row sees.
    Paged: row t sees positions <= length - T + t (and within the window);
    contiguous ring (T = 1): slot k < length until the cache wraps, every
    slot after. A split's tiles outside this range are not loaded."""
    if paged:
        t0 = r0 % q_tokens
        wraps = nr >= q_tokens or t0 + nr - 1 >= q_tokens
        t_min, t_max = (0, q_tokens - 1) if wraps else (t0, t0 + nr - 1)
        hz0 = length - q_tokens
        k_hi = min(keys, hz0 + t_max + 1)
        k_lo = max(0, hz0 + t_min - window + 1) if window else 0
    else:
        k_hi = 0 if length <= 0 else min(length, keys)
        k_lo = max(0, length - window) if window and length <= keys else 0
    if k_lo >= k_hi:
        return 0, 0
    return k_lo // KEY_TILE, -(-k_hi // KEY_TILE)


# The units' tickets (int32, zero between calls: the last block of a unit
# resets its own). One buffer per device, grown, never freed: a CUDA graph
# that captured a launch keeps its address.
_TICKETS: dict = {}
_ALL_TICKETS: list = []


def _tickets(device, units: int):
    buf = _TICKETS.get(device.index)
    if buf is None or buf.numel() < units:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "decode kernel: its ticket workspace is allocated at the "
                "first call of a size; make one call before a CUDA graph "
                "capture")
        buf = torch.zeros(max(units, 4096), dtype=torch.int32, device=device)
        _ALL_TICKETS.append(buf)
        _TICKETS[device.index] = buf
    return buf


def _check_sinks(sinks, n: int, device, op: str):
    """(pointer, is bf16) of per-row sinks for the kernel: n values, fp32
    or bf16, contiguous, on the device."""
    if sinks is None:
        return None, 0
    if sinks.numel() != n or sinks.device != device \
            or not sinks.is_contiguous() \
            or sinks.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{op} kernel: sinks must be {n} contiguous fp32 or "
                        f"bf16 values on {device}, got {tuple(sinks.shape)} "
                        f"{sinks.dtype} on {sinks.device}")
    return sinks.data_ptr(), int(sinks.dtype == torch.bfloat16)


def _workspaces(device, units: int, ns: int, rw: int, d: int):
    """Pointers of the partials (o, m, l) of every (unit, split), fp32, and
    of the units' tickets; allocated, not cleared (a split that loads
    nothing writes only m and l). None for a one-split plan, which writes
    the output from registers. The tensors are returned to keep them alive
    until the launch is enqueued."""
    if ns == 1:
        return [None] * 4, ()
    o = torch.empty((units, ns, rw, d), dtype=torch.float32, device=device)
    m = torch.empty((units, ns, rw), dtype=torch.float32, device=device)
    l = torch.empty_like(m)
    t = _tickets(device, units)
    return [x.data_ptr() for x in (o, m, l, t)], (o, m, l)


def combine_splits(o, m, l, sinks=None):
    """Log-sum-exp merge of per-split partials. o: (..., NS, G, D) fp32
    unnormalised; m, l: (..., NS, G). Exact for any split count; rows whose
    every split was masked come out as zeros. ``sinks`` broadcasts against
    the (..., 1, G) cross-split max and joins the denominator once."""
    m_max = torch.amax(m, dim=-2, keepdim=True)
    if sinks is not None:
        m_tot = torch.maximum(m_max, sinks)
        alpha = torch.exp(m - m_tot)
        den = torch.sum(l * alpha, dim=-2) + torch.exp(sinks - m_tot)[..., 0, :]
        num = torch.sum(o * alpha[..., None], dim=-3)
        return num / den[..., None]
    alpha = torch.exp(m - m_max)
    den = torch.sum(l * alpha, dim=-2)
    num = torch.sum(o * alpha[..., None], dim=-3)
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return torch.where((den > 0.0)[..., None], out, 0.0)


def decode_partials_ref(q, k, v, lengths, *, block_kv: int = BLOCK_KV,
                        window: int | None = None, scale: float,
                        softcap=None):
    """Plain version of the decode kernel: per-split (o, m, l) in fp32.

    q: (B, Hkv, G, D); k, v: (B, Hkv, S, D); lengths: (B,). Returns
    o (B, Hkv, NS, G, D), m and l (B, Hkv, NS, G), NS = ceil(S / block_kv).
    """
    b, hkv, g, d = q.shape
    slots = k.shape[2]
    ns = -(-slots // block_kv)
    pad = ns * block_kv - slots
    actual, valid = ring_positions(lengths, slots)
    if window is not None:
        valid &= (lengths.long()[:, None] - 1 - actual) < window
    s = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) * scale
    s = cap_logits(s, softcap)
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, MASK_VALUE)
    s = torch.nn.functional.pad(s, (0, pad), value=MASK_VALUE)
    vmask = torch.nn.functional.pad(vmask, (0, pad), value=False)
    s = s.reshape(b, hkv, g, ns, block_kv).transpose(2, 3)
    vmask = vmask.reshape(b, 1, 1, ns, block_kv).transpose(2, 3)
    m = torch.amax(s, dim=-1)
    p = torch.where(vmask, torch.exp(s - m[..., None]), 0.0)
    l = torch.sum(p, dim=-1)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    o = torch.einsum("bhngk,bhnkd->bhngd", p,
                     vf.reshape(b, hkv, ns, block_kv, d))
    return o, m, l


def flash_decode(q, k, v, lengths, *, window: int | None = None,
                 logit_scale: float | None = None, softcap=None, sinks=None,
                 policy=None):
    """Split-KV decode: q (B, Hkv, G, D) group-packed queries; k/v
    (B, Hkv, S, D); lengths (B,) int32 tokens written so far (ring semantics
    when lengths > S). ``policy``: the launch's (its key splits; None:
    :func:`decode_policy`). Returns (B, Hkv, G, D) in q's type. Journaled
    as ``obs`` op "attention_decode" with its policy."""
    b, hkv, g, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, hkv) or k.shape[3] != d:
        raise ValueError(f"attention_decode: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} do not match")
    if lengths.shape != (b,):
        raise ValueError(f"attention_decode: lengths must be ({b},), "
                         f"got {tuple(lengths.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"attention_decode: window must be positive, "
                         f"got {window}")
    scale = logit_scale if logit_scale is not None else d ** -0.5
    t0 = entry_clock()
    if policy is None and (q.is_cuda or obs.enabled()):
        policy = decode_policy(b, hkv, g, k.shape[2], d, q.device, q.dtype)
    if q.device.type == "cuda":
        out = _launch(q, k, v, lengths, window=window, scale=scale,
                      softcap=softcap, sinks=sinks, ns=policy.splits)
    elif q.device.type == "cpu":
        o, m, l = decode_partials_ref(q, k, v, lengths, window=window,
                                      scale=scale, softcap=softcap)
        out = combine_splits(o, m, l, sinks=None if sinks is None else
                             sinks.float().reshape(hkv, 1, g)).to(q.dtype)
    else:
        raise ValueError(f"attention_decode: unsupported device {q.device}")
    if obs.enabled():
        journal("attention_decode", q.device, t0,
                chain=describe_chain(softcap, sinks),
                flops=4 * b * hkv * g * k.shape[2] * d, policy=policy)
    return out


def attention_decode(q, k, v, lengths, *, window: int | None = None,
                     logit_scale: float | None = None, softcap=None,
                     sinks=None, policy=None):
    """Single-token decode attention. q: (B, H, 1, D) with H % Hkv == 0;
    k/v: (B, Hkv, S, D); lengths: (B,) int32. Returns (B, H, 1, D)."""
    b, h, _, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, d).contiguous()   # (B, H) rows: tiny
    out = flash_decode(qg, k, v, lengths, window=window,
                       logit_scale=logit_scale, softcap=softcap, sinks=sinks,
                       policy=policy)
    return out.reshape(b, h, 1, d)


def _launch(q, k, v, lengths, *, window, scale, softcap, sinks, ns=None,
            kernel: CudaKernel = KERNEL):
    """One launch on the card in ``ns`` key splits (None: the resolved
    policy's); ``kernel``: another build of the same entry point (the
    smoke's A/B against an earlier tree)."""
    b, hkv, g, d = q.shape
    slots = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"attention_decode kernel: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    # contiguous, 16-byte aligned and head_dim 64, 128 or 256: every stride a
    # multiple of 16 bytes, a view the kernel's TMA maps read
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"attention_decode kernel: {name} must be "
                            f"bfloat16, got {t.dtype}")
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"attention_decode kernel: {name} must be a "
                             f"contiguous, 16-byte aligned tensor on {q.device}")
    if lengths.dtype != torch.int32 or lengths.device != q.device \
            or not lengths.is_contiguous():
        raise TypeError("attention_decode kernel: lengths must be a "
                        f"contiguous int32 tensor on {q.device}")
    sink_ptr, sinks_bf16 = _check_sinks(sinks, hkv * g, q.device,
                                        "attention_decode")
    units = decode_units(b, hkv, g)
    if ns is None:
        ns = decode_policy(b, hkv, g, slots, d, q.device).splits
    ws, _keep = _workspaces(q.device, units, ns,
                            min(g, rows_per_unit(g)), d)
    out = torch.empty_like(q)
    fn = kernel.fn()
    stream = kernel.stream(q.device)
    kernel.launches += 1
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
              sink_ptr, out.data_ptr(), *ws, b, hkv, g, slots, d, ns,
              sinks_bf16, float(scale), float(softcap or 0.0),
              int(window or 0), stream)
    kernel.check(code)
    return out


# ---------------------------------------------------------------------------
# Paged KV pool
# ---------------------------------------------------------------------------

def decode_partials_paged_ref(q, k_pages, v_pages, page_table, lengths, *,
                              window: int | None = None, scale: float,
                              softcap=None, q_tokens: int = 1):
    """Plain version of the paged kernel: per-page (o, m, l) in fp32.

    q: (B, Hkv, R, D) with R = G * T rows (row = g*T + t); k_pages/v_pages:
    (P, Hkv, page, D); page_table: (B, MP); lengths: (B,). Returns
    o (B, Hkv, MP, R, D), m and l (B, Hkv, MP, R). A fully masked page gives
    (0, -1e30, 0).
    """
    b, hkv, rows, d = q.shape
    page_size = k_pages.shape[2]
    mp = page_table.shape[1]
    pt = page_table.long()
    kg = k_pages[pt].transpose(1, 2).float()           # (B, Hkv, MP, page, D)
    vg = v_pages[pt].transpose(1, 2).float()
    # (B, MP, R, page) validity: position idx is seen by row r (token
    # t = r mod T) when idx <= length - T + t, and within the window of it
    idx = torch.arange(mp * page_size, device=q.device).reshape(mp, 1,
                                                                page_size)
    row_t = (torch.arange(rows, device=q.device) % q_tokens).reshape(rows, 1)
    horizon = lengths.long().reshape(b, 1, 1, 1) - q_tokens + row_t
    valid = idx <= horizon
    if window is not None:
        valid &= (horizon - idx) < window
    valid = valid[:, None]                              # (B, 1, MP, R, page)
    s = torch.einsum("bhrd,bhnpd->bhnrp", q.float(), kg) * scale
    s = cap_logits(s, softcap)
    s = torch.where(valid, s, MASK_VALUE)
    m = torch.amax(s, dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhnrp,bhnpd->bhnrd", p, vg)
    return o, m, l


def flash_decode_paged(q, k_pages, v_pages, page_table, lengths, *,
                       window: int | None = None,
                       logit_scale: float | None = None, softcap=None,
                       sinks=None, q_tokens: int = 1, policy=None):
    """Split-KV decode over a paged KV pool (one split == one page on the
    CPU; on the card the policy's key splits over the table's slots).

    q: (B, Hkv, R, D) group-packed queries, R = G * q_tokens (row = g*T +
    t); k_pages/v_pages: (P, Hkv, page_size, D); page_table: (B, MP) int32
    physical page ids (0 = the null page); lengths: (B,) int32 tokens
    written so far, the T query tokens included: row t attends through
    position ``lengths - T + t``. ``sinks`` (Hkv * R,) per row. Returns
    (B, Hkv, R, D) in q's type. ``policy``: as :func:`flash_decode`'s.
    Journaled as ``obs`` op "attention_decode", variant "paged".
    """
    b, hkv, rows, d = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[1] != hkv \
            or k_pages.shape[3] != d:
        raise ValueError(f"attention_decode_paged: q {tuple(q.shape)} and "
                         f"pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not match")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError(f"attention_decode_paged: page_table "
                         f"{tuple(page_table.shape)} and lengths "
                         f"{tuple(lengths.shape)} must be ({b}, MP) and ({b},)")
    if q_tokens < 1 or rows % q_tokens:
        raise ValueError(f"attention_decode_paged: {rows} q rows are not a "
                         f"whole number of groups of {q_tokens} tokens")
    if window is not None and window <= 0:
        raise ValueError(f"attention_decode_paged: window must be positive, "
                         f"got {window}")
    scale = logit_scale if logit_scale is not None else d ** -0.5
    t0 = entry_clock()
    if policy is None and (q.is_cuda or obs.enabled()):
        policy = decode_policy(b, hkv, rows,
                               page_table.shape[1] * k_pages.shape[2], d,
                               q.device, q.dtype, q_tokens)
    if q.device.type == "cuda":
        out = _launch_paged(q, k_pages, v_pages, page_table, lengths,
                            window=window, scale=scale, softcap=softcap,
                            q_tokens=q_tokens, sinks=sinks,
                            ns=policy.splits)
    elif q.device.type == "cpu":
        o, m, l = decode_partials_paged_ref(
            q, k_pages, v_pages, page_table, lengths, window=window,
            scale=scale, softcap=softcap, q_tokens=q_tokens)
        out = combine_splits(o, m, l, sinks=None if sinks is None else
                             sinks.float().reshape(hkv, 1, rows)).to(q.dtype)
    else:
        raise ValueError(f"attention_decode_paged: unsupported device "
                         f"{q.device}")
    if obs.enabled():
        journal("attention_decode", q.device, t0, variant="paged",
                chain=describe_chain(softcap, sinks),
                flops=4 * b * hkv * rows * page_table.shape[1]
                * k_pages.shape[2] * d, policy=policy)
    return out


def attention_decode_paged(q, k_pages, v_pages, page_table, lengths, *,
                           window: int | None = None,
                           logit_scale: float | None = None, softcap=None,
                           sinks=None, mode: str = "kernel", policy=None):
    """Decode attention (1 or T query tokens) over a paged KV pool.

    q: (B, H, T, D); token t of sequence b sits at position
    ``lengths[b] - T + t`` (``lengths`` counts the KV including the T
    tokens already appended). k_pages/v_pages: (P, Hkv, page_size, D);
    page_table: (B, MP) physical page ids; lengths: (B,). ``sinks``: (H,).
    Returns (B, H, T, D) in q's type. mode="reference" gathers the pages
    into a contiguous copy and runs the oracle; "kernel" runs
    :func:`flash_decode_paged`.
    """
    b, h, t, d = q.shape
    hkv = k_pages.shape[1]
    group = h // hkv
    # pack tokens group-major: row = g*T + t
    qg = q.reshape(b, hkv, group * t, d)
    if sinks is not None and t > 1:
        sinks = sinks.reshape(hkv, group).repeat_interleave(t, dim=1)
    if mode == "reference":
        from repro_torch.serve.kv_cache import gather_pages
        out = decode_ref(qg, gather_pages(k_pages, page_table),
                         gather_pages(v_pages, page_table), lengths,
                         window=window, logit_scale=logit_scale,
                         softcap=softcap, sinks=sinks, q_tokens=t)
    else:
        out = flash_decode_paged(qg.contiguous(), k_pages, v_pages,
                                 page_table, lengths, window=window,
                                 logit_scale=logit_scale, softcap=softcap,
                                 sinks=sinks, q_tokens=t, policy=policy)
    return out.reshape(b, h, t, d)


def _launch_paged(q, k_pages, v_pages, page_table, lengths, *, window, scale,
                  softcap, q_tokens, sinks, ns=None,
                  kernel: CudaKernel = PAGED_KERNEL):
    """One launch on the card; ``ns`` and ``kernel`` as :func:`_launch`'s."""
    b, hkv, rows, d = q.shape
    n_pages, _, page_size, _ = k_pages.shape
    mp = page_table.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"attention_decode_paged kernel: head_dim {d} not "
                         f"in {HEAD_DIMS}")
    if page_size % 8 or not 8 <= page_size <= MAX_PAGE_SIZE:
        raise ValueError(f"attention_decode_paged kernel: page size "
                         f"{page_size} is not a multiple of 8 in "
                         f"[8, {MAX_PAGE_SIZE}]")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"attention_decode_paged kernel: {name} must be "
                            f"bfloat16, got {t.dtype}")
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"attention_decode_paged kernel: {name} must be "
                             f"a contiguous, 16-byte aligned tensor on "
                             f"{q.device}")
    for name, t in (("page_table", page_table), ("lengths", lengths)):
        if t.dtype != torch.int32 or t.device != q.device \
                or not t.is_contiguous():
            raise TypeError(f"attention_decode_paged kernel: {name} must be "
                            f"a contiguous int32 tensor on {q.device}")
    sink_ptr, sinks_bf16 = _check_sinks(sinks, hkv * rows, q.device,
                                        "attention_decode_paged")
    units = decode_units(b, hkv, rows, q_tokens)
    if ns is None:
        ns = decode_policy(b, hkv, rows, mp * page_size, d, q.device,
                           q_tokens=q_tokens).splits
    ws, _keep = _workspaces(q.device, units, ns,
                            min(rows, rows_per_unit(rows, q_tokens)), d)
    out = torch.empty_like(q)
    fn = kernel.fn()
    stream = kernel.stream(q.device)
    kernel.launches += 1
    code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
              page_table.data_ptr(), lengths.data_ptr(), sink_ptr,
              out.data_ptr(), *ws, b, hkv, rows, page_size, mp, n_pages, d,
              q_tokens, ns, sinks_bf16, float(scale), float(softcap or 0.0),
              int(window or 0), stream)
    kernel.check(code)
    return out
