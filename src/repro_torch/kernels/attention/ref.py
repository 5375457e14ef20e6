"""Plain torch oracles for MHA/GQA attention: full-sequence and decode."""
from __future__ import annotations

import torch

from .epilogue import cap_logits, softmax_finalize

MASK_VALUE = -1e30


def attention_ref(q, k, v, *, causal: bool = False, window: int | None = None,
                  logit_scale: float | None = None, softcap=None, sinks=None):
    """q: (B, H, Sq, D); k, v: (B, Hkv, Skv, D) with H % Hkv == 0.

    ``window``: position i attends to j iff i - j < window. ``softcap``: tanh
    cap on the scaled logits. ``sinks``: optional (H,) per-head logits that
    join the softmax denominator only. Returns (B, H, Sq, D) in q's type.
    """
    b, h, sq, d = q.shape
    group = h // k.shape[1]
    if group > 1:
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
    s = torch.where(mask, s, float("-inf"))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    if sinks is not None:
        sb = sinks.float()[None, :, None, None]
        acc = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
        out, _ = softmax_finalize(acc, m, l, sink=sb)
        return out.to(q.dtype)
    p = p / torch.clamp(l, min=1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def ring_positions(lengths, slots: int):
    """Per-slot absolute positions and validity of a ring-buffer KV cache.

    ``lengths``: (B,) tokens written so far (the cache holds the last
    ``slots`` of them at slot = pos % slots). Returns (actual, valid), both
    (B, slots); ``valid`` is False for never-written slots, including the
    whole row when lengths[b] == 0.
    """
    pos = lengths.long()[:, None] - 1
    cur = torch.remainder(pos, slots)
    i = torch.arange(slots, device=lengths.device)[None, :]
    actual = torch.where(i <= cur, pos - cur + i, pos - cur - slots + i)
    valid = (actual >= 0) & (actual <= pos)
    return actual, valid


def decode_ref(q, k, v, lengths, *, window: int | None = None,
               logit_scale: float | None = None, softcap=None, sinks=None,
               q_tokens: int = 1):
    """Decode oracle (1 or T query tokens) over a (possibly ring) KV cache.

    q: (B, Hkv, G, D), the GQA group packed into the q rows; k, v:
    (B, Hkv, S, D); ``lengths``: (B,) tokens written so far. Returns
    (B, Hkv, G, D) in q's type; empty rows (lengths == 0) give zeros.

    ``q_tokens`` > 1: G packs group * T rows group-major (row = g*T + t),
    and row t's causal horizon is position ``lengths - T + t``.
    """
    b, hkv, g, d = q.shape
    slots = k.shape[2]
    actual, valid = ring_positions(lengths, slots)
    if q_tokens == 1:
        if window is not None:
            pos = lengths.long()[:, None] - 1
            valid &= (pos - actual) < window
        vmask = valid[:, None, None, :]
    else:
        row_t = torch.arange(g, device=q.device) % q_tokens          # (X,)
        pos_row = lengths.long()[:, None] - q_tokens + row_t[None, :]  # (B, X)
        vmask = valid[:, None, None, :] & (
            actual[:, None, None, :] <= pos_row[:, None, :, None])
        if window is not None:
            vmask &= (pos_row[:, None, :, None]
                      - actual[:, None, None, :]) < window
    scale = logit_scale if logit_scale is not None else d ** -0.5
    s = torch.einsum("bgxd,bgkd->bgxk", q.float(), k.float()) * scale
    s = cap_logits(s, softcap)
    s = torch.where(vmask, s, MASK_VALUE)
    pmax = torch.amax(s, dim=-1, keepdim=True)
    if sinks is not None:
        sb = sinks.float().reshape(hkv, g)[None, :, :, None]
        pmax = torch.maximum(pmax, sb)
    pexp = torch.where(vmask, torch.exp(s - pmax), 0.0)
    den = torch.sum(pexp, dim=-1, keepdim=True)
    if sinks is not None:
        den = den + torch.exp(sb - pmax)
    out = torch.einsum("bgxk,bgkd->bgxd", pexp / torch.clamp(den, min=1e-30),
                       v.float())
    return out.to(q.dtype)
