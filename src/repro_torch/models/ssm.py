"""Mamba2's SSD (state-space duality) block, chunked and sub-quadratic
(Dao & Gu 2024, arXiv:2405.21060): within each chunk a quadratic,
attention-like term; across chunks a linear recurrence of the (H, P, N)
state, one chunk at a time. Decode carries that fp32 state and the causal
convolution's last ``d_conv - 1`` inputs, a constant size at any prompt
length.

Plain torch, as the reference's block is plain ``jnp``: its products are
library matmuls and no TPU kernel runs here. Its rounding points are the
reference's, and they differ between the paths: the full sequence rounds
dt to x's type before ``x * dt``, adds the skip term in the compute type
and gates ``y * silu(z)`` in it; decode keeps these in fp32 and rounds y
to x's type before the gate. softplus is ``logaddexp(x, 0)`` (JAX's, with
no threshold). A cache is updated in place (``copy_``), so a decode step
captured in a CUDA graph advances it on every replay.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .common import ParamDef, rmsnorm
from .rglru import _causal_conv, _conv_taps


def ssm_dims(cfg):
    """(d_inner, n_heads, conv_dim, d_in_proj) of the config's block."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads
    return d_inner, n_heads, conv_dim, d_in_proj


def in_proj_segments(cfg, n: int = 1, r: int = 0) -> tuple:
    """The packed ``in_proj`` columns (z | x | B|C | dt) that rank ``r`` of
    ``n`` holds when the block is split by heads, in the packed layout:
    (its z heads, its x heads, its ``2GN / n`` B|C columns, its dt heads),
    four ranges; at ``n`` 1 the four parts whole."""
    d_inner, h, conv_dim, _ = ssm_dims(cfg)
    bc = conv_dim - d_inner
    di, hl, bl = d_inner // n, h // n, bc // n
    return (range(r * di, (r + 1) * di),
            range(d_inner + r * di, d_inner + (r + 1) * di),
            range(2 * d_inner + r * bl, 2 * d_inner + (r + 1) * bl),
            range(2 * d_inner + bc + r * hl, 2 * d_inner + bc + (r + 1) * hl))


def ssm_defs(cfg, prefix: str, *, stack: int | None = None) -> dict:
    s = cfg.ssm
    d_inner, n_heads, conv_dim, d_in_proj = ssm_dims(cfg)
    lead = (stack,) if stack else ()
    lx = ("layers",) if stack else ()
    vec = lx + (None,)
    dt = cfg.param_dtype
    return {
        f"{prefix}/in_proj": ParamDef(lead + (cfg.d_model, d_in_proj),
                                      lx + ("embed", "ffn"), dtype=dt),
        f"{prefix}/conv_w": ParamDef(lead + (conv_dim, s.d_conv),
                                     lx + (None, None), scale=1.0, dtype=dt),
        f"{prefix}/conv_b": ParamDef(lead + (conv_dim,), vec, init="zeros",
                                     dtype=dt),
        f"{prefix}/a_log": ParamDef(lead + (n_heads,), vec, init="ones",
                                    dtype=dt),
        f"{prefix}/d_skip": ParamDef(lead + (n_heads,), vec, init="ones",
                                     dtype=dt),
        f"{prefix}/dt_bias": ParamDef(lead + (n_heads,), vec, init="zeros",
                                      dtype=dt),
        f"{prefix}/norm_scale": ParamDef(lead + (d_inner,), vec, init="ones",
                                         dtype=dt),
        f"{prefix}/out_proj": ParamDef(lead + (d_inner, cfg.d_model),
                                       lx + ("ffn", "embed"), dtype=dt),
    }


def _softplus(x):
    """log(1 + exp(x)) with no threshold, as ``jax.nn.softplus``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _segsum(x):
    """x: (..., T) -> (..., T, T): entry (i, j) the sum of x[j + 1 .. i]
    for j <= i, -inf above the diagonal (so that exp gives 0 there)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, a, b_mat, c_mat, chunk: int, initial_state=None):
    """The SSD scan. x: (B, L, H, P); a: (B, L, H) log-decay; b, c: (B, L,
    G, N), each group's shared by H / G consecutive heads. In fp32 (in
    float64 for float64 inputs).

    The chunk is cut to L where L is shorter; a tail that the chunk does
    not divide is zero-padded (a = 0 decays by exp(0) = 1 and x = 0 adds
    nothing, so the final state is exact; the padded rows of y are
    dropped). Returns (y (B, L, H, P) in x's type, the final state (B, H,
    P, N) in the accumulation type)."""
    bsz, l_orig, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    chunk = min(chunk, l_orig)
    pad = (-l_orig) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    nc = (l_orig + pad) // chunk
    acc = torch.promote_types(x.dtype, torch.float32)

    def chunks(t):  # (B, L, ...) -> (B, C, Q, ...) in the accumulation type
        return t.reshape(bsz, nc, chunk, *t.shape[2:]).to(acc)

    # heads split as (G, R): a group's b and c serve its R heads by
    # broadcasting, never copied per head
    xc = chunks(x).reshape(bsz, nc, chunk, g, rep, p)     # (B,C,Q,G,R,P)
    ac = chunks(a).permute(0, 3, 1, 2)                    # (B,H,C,Q)
    bc, cc = chunks(b_mat), chunks(c_mat)                 # (B,C,Q,G,N)
    a_cum = torch.cumsum(ac, dim=-1)                      # (B,H,C,Q)

    def by_group(t):  # (B, H, C, Q, ...) -> (B, C, G, R, Q, ...), a view
        t = t.transpose(1, 2)
        return t.reshape(bsz, nc, g, rep, *t.shape[3:])

    # 1. the within-chunk (attention-like) term
    scores = torch.einsum("bclgn,bcsgn->bcgls", cc, bc)[:, :, :, None]
    scores = by_group(torch.exp(_segsum(ac))) * scores    # (B,C,G,R,Q,Q)
    y_diag = torch.einsum("bcgrls,bcsgrp->bclgrp", scores, xc)
    del scores  # (B, C, H, Q, Q) fp32: 6.4 GB at 524,288 tokens

    # 2. each chunk's state, from its own inputs
    decay_states = by_group(torch.exp(a_cum[..., -1:] - a_cum))
    xd = xc * decay_states.permute(0, 1, 4, 2, 3)[..., None]
    states = torch.einsum("bcsgrp,bcsgn->bcgrpn", xd, bc).reshape(
        bsz, nc, h, p, n)                                 # (B,C,H,P,N)

    # 3. the recurrence across chunks: chunk c reads the state before it
    chunk_decay = torch.exp(a_cum[..., -1])               # (B,H,C)
    carry = (torch.zeros((bsz, h, p, n), dtype=acc, device=x.device)
             if initial_state is None else initial_state.to(acc))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1).reshape(bsz, nc, g, rep, p, n)

    # 4. the state's contribution within each chunk
    state_decay = by_group(torch.exp(a_cum)).permute(0, 1, 4, 2, 3)
    y_off = (torch.einsum("bclgn,bcgrpn->bclgrp", cc, prev_states)
             * state_decay[..., None])

    y = (y_diag + y_off).reshape(bsz, nc * chunk, h, p)[:, :l_orig]
    return y.to(x.dtype), carry


def _split_proj(cfg, zxbcdt, n: int = 1):
    """(z, x | B|C, dt) of a projection through ``in_proj``, or through a
    rank's block of it over ``n`` ranks (:func:`in_proj_segments`)."""
    z, xs, bc, dt = (len(s) for s in in_proj_segments(cfg, n))
    return torch.split(zxbcdt, [z, xs + bc, dt], dim=-1)


def _decay(p, dt):
    """(softplus(dt + dt_bias), -exp(a_log)), both fp32."""
    dt_f = _softplus(dt.float() + p["dt_bias"].float())
    return dt_f, -torch.exp(p["a_log"].float())


def _mixer(cfg, p, z, xbc_in, dt, *, groups=None, norm=rmsnorm):
    """The SSD mixer from the projection's parts: z (B, L, d), the
    convolution's input xbc_in (B, L, d + 2GN: x then the whole B|C) and dt
    (B, L, heads), where d is the d_inner of the heads ``p``'s leaves hold
    (a tensor-parallel rank's, or all of them). ``groups``: (first, count)
    of the B|C groups those heads read (by default all); ``norm``: the
    gated RMSNorm. Returns (the normed y (B, L, d), the final state)."""
    s = cfg.ssm
    bsz, l, d = z.shape
    n_heads = dt.shape[-1]
    xbc = F.silu(_causal_conv(xbc_in, p["conv_w"], p["conv_b"]))
    gn = s.n_groups * s.d_state
    xs, b_mat, c_mat = torch.split(xbc, [d, gn, gn], dim=-1)
    xs = xs.reshape(bsz, l, n_heads, s.head_dim)
    b_mat = b_mat.reshape(bsz, l, s.n_groups, s.d_state)
    c_mat = c_mat.reshape(bsz, l, s.n_groups, s.d_state)
    if groups is not None:
        b_mat, c_mat = (t.narrow(2, *groups) for t in (b_mat, c_mat))
    dt_f, a = _decay(p, dt)
    y, final = ssd_chunked(xs * dt_f[..., None].to(xs.dtype), dt_f * a,
                           b_mat, c_mat, s.chunk)
    y = y + p["d_skip"].to(y.dtype)[None, None, :, None] * xs
    y = y.reshape(bsz, l, d)
    return norm(y * F.silu(z.float()).to(y.dtype), p["norm_scale"]), final


def _full(cfg, p, x):
    """The block over the whole sequence x (B, L, D): (out (B, L, D), the
    convolution's input (B, L, conv_dim), the final SSD state)."""
    z, xbc_in, dt = _split_proj(cfg, x @ p["in_proj"])
    y, final = _mixer(cfg, p, z, xbc_in, dt)
    return y @ p["out_proj"], xbc_in, final


def split_ssm_forward(cfg, p, x, tp):
    """The block on a tensor-parallel rank (``tp``) on the replicated
    normed stream ``x``: the rank's heads through its head-aligned
    ``in_proj`` block (``tp.ssm_params``), its B|C columns all-gathered
    (every head reads its group's B and C whole; the grad summed back),
    the gated RMSNorm's mean square summed over the ranks (fp32, rank
    order) and divided by the extent, the ranks' ``out_proj`` partials
    summed (g). Where the extent does not divide the heads and 2GN the
    block runs whole, its split leaves gathered."""
    local = tp.ssm_params(p)
    if local is None:
        return ssm_forward(cfg, {k: tp.whole(v, f"ssm/{k}")
                                 for k, v in p.items()}, x)
    z, xbc_in, dt = _split_proj(cfg, tp.f(x) @ local["in_proj"], tp.n)
    norm = rmsnorm
    if tp.n > 1:
        xs, bc = torch.split(xbc_in, [z.shape[-1],
                                      xbc_in.shape[-1] - z.shape[-1]], -1)
        xbc_in = torch.cat([xs, tp.gather(bc, -1, "sum")], dim=-1)
        norm = functools.partial(rmsnorm,
                                 reduce=lambda v: tp.f(tp.g(v) / tp.n))
    first, count, _ = tp.ssm_groups
    y, _ = _mixer(cfg, local, z, xbc_in, dt, groups=(first, count),
                  norm=norm)
    return tp.g(y @ local["out_proj"])


def ssm_forward(cfg, p, x):
    """The full Mamba2 block. x: (B, L, D) -> (B, L, D)."""
    return _full(cfg, p, x)[0]


def init_ssm_cache(cfg, batch: int, dtype, device, *,
                   stack: int | None = None) -> dict:
    """{"conv": (B, d_conv - 1, conv_dim) in ``dtype``, "state": (B, H,
    head_dim, d_state) fp32}, zeroed, with a leading ``stack`` dim when
    given."""
    s = cfg.ssm
    _, n_heads, conv_dim, _ = ssm_dims(cfg)
    lead = (stack,) if stack else ()
    return {"conv": torch.zeros(lead + (batch, s.d_conv - 1, conv_dim),
                                dtype=dtype, device=device),
            "state": torch.zeros(lead + (batch, n_heads, s.head_dim,
                                         s.d_state),
                                 dtype=torch.float32, device=device)}


def ssm_decode_step(cfg, p, x, cache):
    """x: (B, 1, D). Advances ``cache`` {"conv", "state"} in place by one
    token; returns the block's output (B, 1, D)."""
    s = cfg.ssm
    d_inner, n_heads, _, _ = ssm_dims(cfg)
    bsz = x.shape[0]
    z, xbc, dt = _split_proj(cfg, x[:, 0] @ p["in_proj"])
    window = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)  # (B,K,C)
    conv = _conv_taps(window.float(), p["conv_w"], p["conv_b"], 1)[:, 0]
    xbc_t = F.silu(conv).to(x.dtype)
    gn = s.n_groups * s.d_state
    xs, b_mat, c_mat = torch.split(xbc_t, [d_inner, gn, gn], dim=-1)
    xs = xs.reshape(bsz, n_heads, s.head_dim).float()
    rep = n_heads // s.n_groups
    bh = b_mat.reshape(bsz, s.n_groups, s.d_state).repeat_interleave(
        rep, dim=1).float()                                      # (B,H,N)
    ch = c_mat.reshape(bsz, s.n_groups, s.d_state).repeat_interleave(
        rep, dim=1).float()
    dt_f, a = _decay(p, dt)                                      # (B,H)
    state = (cache["state"] * torch.exp(dt_f * a)[:, :, None, None]
             + dt_f[:, :, None, None] * xs[..., None] * bh[:, :, None, :])
    y = (state @ ch[..., None])[..., 0]                          # (B,H,P)
    y = y + p["d_skip"].float()[None, :, None] * xs
    y = y.reshape(bsz, d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z.float()).to(x.dtype), p["norm_scale"])
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(state)
    return (y @ p["out_proj"])[:, None, :]


def ssm_prefill(cfg, p, x):
    """The full block that also returns the decode state after x: (out,
    {"conv": the convolution's last d_conv - 1 inputs (zeros before the
    first token), "state": the final SSD state})."""
    k = cfg.ssm.d_conv
    out, xbc, final = _full(cfg, p, x)
    tail = F.pad(xbc, (0, 0, max(0, k - 1 - xbc.shape[1]), 0))
    return out, {"conv": tail[:, -(k - 1):], "state": final}
