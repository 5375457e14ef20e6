"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Gated linear recurrence: h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t) with
a_t = sigmoid(Λ)^(c r_t), in fp32. The full sequence runs a log-depth scan
(:func:`rglru_scan`); decode carries a (B, W) fp32 state and the causal
convolution's last ``conv_width - 1`` inputs. Plain torch, as the
reference's block is plain ``jnp``: its products are library matmuls, and
no TPU kernel runs here. A cache is updated in place (``copy_``), so a
decode step captured in a CUDA graph advances it on every replay.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ParamDef


def rg_width(cfg) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def rglru_defs(cfg, prefix: str, *, stack: int | None = None) -> dict:
    d, w = cfg.d_model, rg_width(cfg)
    kw = cfg.rglru.conv_width
    lead = (stack,) if stack else ()
    lx = ("layers",) if stack else ()
    vec = lx + (None,)
    dt = cfg.param_dtype
    return {
        f"{prefix}/proj_x": ParamDef(lead + (d, w), lx + ("embed", "ffn"),
                                     dtype=dt),
        f"{prefix}/proj_gate": ParamDef(lead + (d, w), lx + ("embed", "ffn"),
                                        dtype=dt),
        f"{prefix}/conv_w": ParamDef(lead + (w, kw), lx + (None, None),
                                     dtype=dt),
        f"{prefix}/conv_b": ParamDef(lead + (w,), vec, init="zeros",
                                     dtype=dt),
        f"{prefix}/w_a": ParamDef(lead + (w, w), lx + ("ffn", None),
                                  dtype=dt),
        f"{prefix}/b_a": ParamDef(lead + (w,), vec, init="zeros", dtype=dt),
        f"{prefix}/w_i": ParamDef(lead + (w, w), lx + ("ffn", None),
                                  dtype=dt),
        f"{prefix}/b_i": ParamDef(lead + (w,), vec, init="zeros", dtype=dt),
        f"{prefix}/lambda": ParamDef(lead + (w,), vec, init="lru_a",
                                     dtype=dt),
        f"{prefix}/proj_out": ParamDef(lead + (w, d), lx + ("ffn", "embed"),
                                       dtype=dt),
    }


def _conv_taps(xp, w, b, n: int):
    """The depthwise convolution of the left-padded fp32 ``xp`` (B, n + K -
    1, W) with ``w`` (W, K): sum_j xp[:, t + j] w[:, j], taps in order, in
    fp32 (elementwise, so no TF32 product on the card), plus ``b``."""
    w = w.float()
    out = b.float().expand(xp.shape[0], n, w.shape[0])
    for j in range(w.shape[1]):
        out = out + xp[:, j:j + n] * w[:, j]
    return out


def _causal_conv(x, w, b):
    """Causal depthwise conv over time: x (B, L, W), left-padded by
    ``conv_width - 1`` zeros, in fp32, cast back to x's type."""
    k = w.shape[-1]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    return _conv_taps(xp, w, b, x.shape[1]).to(x.dtype)


def _gates(cfg, p, u, tp=None):
    """u: (B, L, W) conv output. Returns (log_a, gated input), both fp32.
    ``cfg.rglru_f32_gates=False`` runs the two (W, W) gate products in u's
    type (the recurrence stays fp32 either way). On a tensor-parallel rank
    (``tp``) ``u`` is the rank's channels and ``w_a``/``w_i`` its rows: the
    products are partial sums over the ranks, summed in rank order (in
    fp32) and cut to the rank's channels (``tp.scatter``)."""
    gd = torch.float32 if cfg.rglru_f32_gates else u.dtype
    ug = u.to(gd)
    pre_a, pre_i = ug @ p["w_a"].to(gd), ug @ p["w_i"].to(gd)
    if tp is not None:
        pre_a, pre_i = tp.scatter(pre_a, -1), tp.scatter(pre_i, -1)
    r = torch.sigmoid((pre_a + p["b_a"].to(gd)).float())
    i = torch.sigmoid((pre_i + p["b_i"].to(gd)).float())
    # log a_t = c r_t log sigmoid(Λ) = -c r_t softplus(-Λ)
    log_a = -cfg.rglru.c_exponent * r * F.softplus(-p["lambda"].float())
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * u.float())
    return log_a, gated


def _scan(log_a, x, dim: int):
    """Inclusive scan of h_t = exp(log_a_t) h_{t-1} + x_t along ``dim`` by
    doubling (Hillis-Steele): ceil(log2 L) rounds, each combining every
    element with the one ``d`` before it under the reference's ``_combine``
    ((a1, b1), (a2, b2)) -> (a1 + a2, exp(a2) b1 + b2). Returns (the
    cumulative log_a, h)."""
    a, h = log_a, x
    n, d = x.shape[dim], 1
    while d < n:
        lo, hi = a.narrow(dim, 0, n - d), a.narrow(dim, d, n - d)
        h = torch.cat([h.narrow(dim, 0, d),
                       torch.exp(hi) * h.narrow(dim, 0, n - d)
                       + h.narrow(dim, d, n - d)], dim)
        a = torch.cat([a.narrow(dim, 0, d), lo + hi], dim)
        d *= 2
    return a, h


def rglru_scan(log_a, x, chunk: int = 0):
    """Scan of h_t = a_t h_{t-1} + x_t over axis 1 (time), from h_{-1} = 0.

    ``chunk=0`` (or a length that ``chunk`` does not divide, or does not
    exceed): one log-depth scan over the whole sequence. ``chunk>0``: the
    reference's two-level form, a log-depth scan within each chunk, then
    the chunk-boundary states carried chunk by chunk (L / chunk steps), the
    same recurrence.
    """
    b, l, w = x.shape
    if not chunk or l % chunk or l <= chunk:
        return _scan(log_a, x, 1)[1]
    nc = l // chunk
    cum_a, h_local = _scan(log_a.reshape(b, nc, chunk, w),
                           x.reshape(b, nc, chunk, w), 2)
    # H_c = exp(a_end_c) H_{c-1} + h_end_c; chunk c starts from H_{c-1}
    a_end, h_end = cum_a[:, :, -1], h_local[:, :, -1]
    carry = torch.zeros((b, w), dtype=x.dtype, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(carry)
        carry = torch.exp(a_end[:, c]) * carry + h_end[:, c]
    h_prev = torch.stack(h_prev, dim=1)
    h = h_local + torch.exp(cum_a) * h_prev[:, :, None, :]
    return h.reshape(b, l, w)


def _gate_branch(p, x):
    return F.gelu(x @ p["proj_gate"], approximate="tanh")


def rglru_forward(cfg, p, x, tp=None):
    """The full recurrent block. x: (B, L, D) -> (B, L, D). ``tp``: the
    rank's channels of the block (``p`` from ``tp.rglru_params``, ``x``
    through f); the output is the rank's partial of ``proj_out``."""
    gate = _gate_branch(p, x)
    u = _causal_conv(x @ p["proj_x"], p["conv_w"], p["conv_b"])
    log_a, gated = _gates(cfg, p, u, tp)
    h = rglru_scan(log_a, gated, chunk=cfg.rglru_chunk).to(x.dtype)
    return (h * gate) @ p["proj_out"]


def split_rglru_forward(cfg, p, x, tp):
    """The block on a tensor-parallel rank (``tp``) on the replicated
    normed stream ``x``: the rank's ``w / n`` channels (the scan is per
    channel), the ranks' ``proj_out`` partials summed (g); where the rules
    do not split the width, the block whole on every rank."""
    local = tp.rglru_params(p)
    if local is None:
        return rglru_forward(cfg, p, x)
    return tp.g(rglru_forward(cfg, local, tp.f(x), tp))


def init_rglru_cache(cfg, batch: int, dtype, device, *,
                     stack: int | None = None) -> dict:
    """{"conv": (B, conv_width - 1, W) in ``dtype``, "h": (B, W) fp32},
    zeroed, with a leading ``stack`` dim when given."""
    w = rg_width(cfg)
    lead = (stack,) if stack else ()
    return {"conv": torch.zeros(lead + (batch, cfg.rglru.conv_width - 1, w),
                                dtype=dtype, device=device),
            "h": torch.zeros(lead + (batch, w), dtype=torch.float32,
                             device=device)}


def rglru_decode_step(cfg, p, x, cache):
    """x: (B, 1, D). Advances ``cache`` {"conv", "h"} in place by one token;
    returns the block's output (B, 1, D)."""
    gate = _gate_branch(p, x[:, 0])
    ux = x[:, 0] @ p["proj_x"]
    window = torch.cat([cache["conv"], ux[:, None, :]], dim=1)
    u = _conv_taps(window.float(), p["conv_w"], p["conv_b"], 1).to(x.dtype)
    log_a, gated = _gates(cfg, p, u)
    h = torch.exp(log_a[:, 0]) * cache["h"] + gated[:, 0]
    cache["conv"].copy_(window[:, 1:])
    cache["h"].copy_(h)
    return ((h.to(x.dtype) * gate) @ p["proj_out"])[:, None, :]


def rglru_prefill(cfg, p, x):
    """The full block that also returns the decode state after x: (out,
    {"conv": the last conv_width - 1 inputs of the convolution (zeros
    before the first token), "h": the last state}). The scan takes no
    chunk, as the reference's prefill."""
    k = cfg.rglru.conv_width
    gate = _gate_branch(p, x)
    ux = x @ p["proj_x"]
    conv_tail = F.pad(ux, (0, 0, max(0, k - 1 - ux.shape[1]), 0))
    u = _causal_conv(ux, p["conv_w"], p["conv_b"])
    log_a, gated = _gates(cfg, p, u)
    h_seq = rglru_scan(log_a, gated)
    out = (h_seq.to(x.dtype) * gate) @ p["proj_out"]
    return out, {"conv": conv_tail[:, -(k - 1):], "h": h_seq[:, -1]}
