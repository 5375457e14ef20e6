"""The flash forward's work plan, TMA checks and bounds, on the CPU.

The kernel (``csrc/flash_fwd.cu``) walks work items of (q tile, query head,
batch) in the order of ``plan_fwd_blocks``; each item runs the key tiles of
``fwd_key_range`` and masks only the tiles ``fwd_tile_needs_mask`` names.
Here: the plan covers every visible (q, k) pair exactly once and each q
tile's key range is exactly the key tiles it sees, under causal, window,
cross and ragged lengths at head_dim 64, 128 and 256; causal items come longest
first and the query heads of one key head are adjacent; the tile sizes and
the ring depth are the kernel's; the TMA view check accepts the views the
model hands over and refuses a bad start, stride or layout; the bound
arithmetic matches hand counts. And an emulation of the kernel's tiling in
plain torch fp32 (the planner's items and tiles, zero-filled edges, the mask
only where the planner says, the online softmax in log2 units with lse
converted back) equals the plain version and the reference's Pallas kernel
in interpret mode, which holds the mask-skip rule and the lse units here.
"""
import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.attention.epilogue import AttnEpilogue
from repro.kernels.attention.kernel_fwd import \
    flash_attention_fwd as j_flash_fwd

from repro_torch.kernels import _build
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.ref import MASK_VALUE

LENGTHS = [1, 64, 150, 256, 1024]
# cross lengths (sq, skv, causal, window): sq < skv, sq > skv, causal cross,
# and causal cross with a window that leaves late rows without a key
CROSS = [(70, 130, False, None), (300, 130, False, None),
         (200, 330, True, None), (300, 130, True, 40)]


def _mask(sq, skv, causal, window):
    q = np.arange(sq)[:, None]
    k = np.arange(skv)[None, :]
    m = np.ones((sq, skv), dtype=bool)
    if causal:
        m &= q >= k
    if window:
        m &= (q - k) < window
    return m


def _check_plan(sq, skv, causal, window, d):
    bq, bkv = ops.FWD_Q_TILE, ops.fwd_key_tile(d)
    mask = _mask(sq, skv, causal, window)
    plan = ops.plan_fwd_blocks(sq, skv, d, causal=causal, window=window)
    assert sorted(t for t, _, _ in plan) == list(range(-(-sq // bq)))
    hits = np.zeros((sq, skv), dtype=int)
    for t, lo, hi in plan:
        q0 = t * bq
        rows = mask[q0:q0 + bq]
        seen = {kt for kt in range(-(-skv // bkv))
                if rows[:, kt * bkv:(kt + 1) * bkv].any()}
        assert set(range(lo, hi)) == seen, f"q tile {t}: {lo}..{hi}"
        for kt in range(lo, hi):
            k0 = kt * bkv
            tile = rows[:, k0:k0 + bkv]
            hits[q0:q0 + bq, k0:k0 + bkv] += 1
            # a tile the kernel leaves unmasked has every pair visible
            full = tile.shape[1] == bkv and tile.all()
            needs = ops.fwd_tile_needs_mask(q0, k0, sq, skv, bkv,
                                            causal=causal, window=window)
            assert needs or full, f"tile ({t}, {kt}) has a masked pair"
    assert (hits[mask] == 1).all() and hits.max() <= 1
    assert int(hits[mask].sum()) == ops.visible_pairs(
        sq, skv, causal=causal, window=window)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", LENGTHS)
def test_fwd_plan_covers_every_visible_pair_once(s, causal, window, d):
    _check_plan(s, s, causal, window, d)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("sq,skv,causal,window", CROSS)
def test_fwd_plan_covers_cross_lengths(sq, skv, causal, window, d):
    _check_plan(sq, skv, causal, window, d)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("s", LENGTHS)
def test_fwd_plan_orders_causal_items_longest_first(s, window, d):
    counts = [hi - lo for _, lo, hi in
              ops.plan_fwd_blocks(s, s, d, causal=True, window=window)]
    assert counts == sorted(counts, reverse=True)


def test_fwd_training_plan_by_hand():
    """S 1024, causal, d 64: q tiles 7..0, q tile t sees key tiles 0..t;
    d 128 (64-key tiles): 0..2t + 1."""
    plan = ops.plan_fwd_blocks(1024, 1024, 64, causal=True, window=None)
    assert plan == [(t, 0, t + 1) for t in range(7, -1, -1)]
    plan = ops.plan_fwd_blocks(1024, 1024, 128, causal=True, window=None)
    assert plan == [(t, 0, 2 * t + 2) for t in range(7, -1, -1)]


def test_fwd_items_keep_a_key_heads_queries_adjacent():
    """Work item rank * B * H + b * H + h: every (rank, batch, head) once,
    and the query heads of one key head on consecutive items."""
    b, h, group, ranks = 2, 8, 4, 3
    items = [ops.fwd_item(w, b, h) for w in range(ranks * b * h)]
    assert sorted(items) == [(r, bb, hh) for r in range(ranks)
                             for bb in range(b) for hh in range(h)]
    for w in range(0, len(items), group):
        same = {(r, bb, hh // group) for r, bb, hh in items[w:w + group]}
        assert len(same) == 1


def test_fwd_tile_sizes_match_the_kernel():
    """The wrapper's q tile, key tiles and ring depth are the ones the
    kernel is compiled with."""
    source = (_build.CSRC / "flash_fwd.cu").read_text()
    assert int(re.search(r"constexpr int BQ = (\d+);", source).group(1)) \
        == ops.FWD_Q_TILE
    bkv = re.search(r"int BKV = D == 64 \? (\d+) : (\d+);", source)
    stages = re.search(r"int STAGES = D == 256 \? (\d+) : (\d+);", source)
    qbufs = re.search(r"int QBUFS = D == 256 \? (\d+) : (\d+);", source)
    tiles = {}
    for d in ops.HEAD_DIMS:
        assert int(bkv.group(1 if d == 64 else 2)) == ops.fwd_key_tile(d)
        assert int(stages.group(1 if d == 256 else 2)) == ops.fwd_stages(d)
        assert int(qbufs.group(1 if d == 256 else 2)) == ops.fwd_q_buffers(d)
        # the q tiles and the ring's K and V tiles, bf16: within the 227 KB
        # a block may take, the barriers aside
        tiles[d] = 2 * d * (ops.fwd_q_buffers(d) * ops.FWD_Q_TILE
                            + 2 * ops.fwd_stages(d) * ops.fwd_key_tile(d))
        assert tiles[d] <= 232448 - 2048
    assert tiles[256] == 192 * 1024


def test_forward_work_by_hand():
    """The training shape: B 4, H 32, Hkv 8, S 1024, d 64, causal."""
    w = ops.forward_work(4, 32, 8, 1024, 1024, 64, causal=True)
    assert w["pairs"] == 67_174_400 == 4 * 32 * 1024 * 1025 // 2
    assert w["flops"] == 17_196_646_400 == 4 * 64 * w["pairs"]
    # q and out (bf16), k and v (bf16), lse (fp32)
    assert w["bytes"] == 42_467_328 == (2 * 4 * 32 * 1024 * 64 * 2
                                        + 2 * 4 * 8 * 1024 * 64 * 2
                                        + 4 * 32 * 1024 * 4)
    # at 989 TFLOP/s the products take 17.39 us, the bytes 12.68 us at
    # 3.35 TB/s
    assert round(w["flops"] / 989e12 * 1e6, 2) == 17.39
    assert round(w["bytes"] / 3.35e12 * 1e6, 2) == 12.68
    # a window: each row sees at most 40 keys
    w = ops.forward_work(1, 1, 1, 100, 100, 64, causal=True, window=40)
    assert w["pairs"] == sum(min(q + 1, 40) for q in range(100))


def _model_views(b=2, s=96, h=32, hkv=8, d=64):
    """q and k as views of the packed q|k projection, v of its own, at
    llama-1b's head counts."""
    qk = torch.zeros((b, s, (h + hkv) * d), dtype=torch.bfloat16)
    q = qk[..., :h * d].reshape(b, s, h, d).transpose(1, 2)
    k = qk[..., h * d:].reshape(b, s, hkv, d).transpose(1, 2)
    v = torch.zeros((b, s, hkv * d), dtype=torch.bfloat16).reshape(
        b, s, hkv, d).transpose(1, 2)
    return q, k, v


@pytest.mark.parametrize("d", [64, 128, 256])
def test_tma_check_accepts_the_model_views(d):
    for name, t in zip("qkv", _model_views(d=d)):
        ops.check_tma_view(t, name)


@pytest.mark.parametrize("bad", ["start", "stride", "last_dim"])
def test_tma_check_refuses_bad_views(bad):
    base = torch.zeros((2, 4, 96, 72), dtype=torch.bfloat16)
    if bad == "start":          # a view one element in: 2 bytes off
        t, match = base[..., 1:65], "16-byte aligned"
    elif bad == "stride":       # rows of 68 elements: 136 bytes
        t, match = torch.zeros((2, 4, 96, 68),
                               dtype=torch.bfloat16)[..., :64], "multiples"
    else:
        t, match = base[..., :64].transpose(2, 3), "contiguous last dim"
    with pytest.raises(ValueError, match=f"attention kernel: q .*{match}"):
        ops.check_tma_view(t, "q")


def _emulate(q, k, v, *, causal=False, window=None, softcap=None):
    """The kernel's tiling in plain torch: work items in the planner's
    order, q and K/V tiles zero-filled past the lengths (as the TMA fills
    them), the mask only on the tiles the planner names, the online softmax
    in log2 units (exp2 of s * scale * log2 e - m, m tracked before the
    scale without a cap), p in v's type before p @ v, out = acc / l (0
    where l == 0) and lse converted to natural-log units at the store."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    bq, bkv = ops.FWD_Q_TILE, ops.fwd_key_tile(d)
    scale = d ** -0.5
    c = math.log2(math.e) * (1.0 if softcap else scale)
    out = torch.full_like(q, float("nan"))
    lse = torch.full((b, h, sq), float("nan"))
    plan = ops.plan_fwd_blocks(sq, skv, d, causal=causal, window=window)

    def tile(x, start, rows):
        x = x[start:start + rows]
        return torch.cat([x, x.new_zeros((rows - x.shape[0], d))])

    for w in range(len(plan) * b * h):
        rank, bb, hh = ops.fwd_item(w, b, h)
        t, lo, hi = plan[rank]
        q0 = t * bq
        qt = tile(q[bb, hh].float(), q0, bq)
        m = torch.full((bq,), MASK_VALUE)
        l = torch.zeros(bq)
        acc = torch.zeros(bq, d)
        qpos = torch.arange(q0, q0 + bq)[:, None]
        for kt in range(lo, hi):
            k0 = kt * bkv
            s = qt @ tile(k[bb, hh // group].float(), k0, bkv).T
            if softcap:
                s = softcap * torch.tanh(s * (scale / softcap))
            if ops.fwd_tile_needs_mask(q0, k0, sq, skv, bkv, causal=causal,
                                       window=window):
                kpos = torch.arange(k0, k0 + bkv)[None, :]
                vis = kpos < skv
                if causal:
                    vis = vis & (qpos >= kpos)
                if window:
                    vis = vis & (qpos - kpos < window)
                s = torch.where(vis, s, MASK_VALUE)
            mx = torch.maximum(m, s.amax(dim=1))
            mu = torch.where(mx == MASK_VALUE, 0.0, mx * c)
            alpha = torch.exp2(m * c - mu)
            p = torch.exp2(s * c - mu[:, None])
            l = l * alpha + p.sum(dim=1)
            vt = tile(v[bb, hh // group].float(), k0, bkv)
            acc = acc * alpha[:, None] + p.to(v.dtype).float() @ vt
            m = mx
        rows = min(bq, sq - q0)
        inv = torch.where(l == 0, 0.0, 1.0 / l)
        out[bb, hh, q0:q0 + rows] = (acc * inv[:, None])[:rows].to(q.dtype)
        lse[bb, hh, q0:q0 + rows] = torch.where(
            l == 0, MASK_VALUE,
            m * (1.0 if softcap else scale) + torch.log(l))[:rows]
    return out, lse


# (b, h, hkv, sq, skv, d, kwargs)
EMULATED = {
    "causal_gqa": (2, 4, 2, 150, 150, 64, dict(causal=True)),
    "window": (1, 4, 2, 300, 300, 64, dict(causal=True, window=40)),
    "softcap": (1, 4, 1, 200, 200, 64, dict(causal=True, softcap=5.0)),
    "noncausal_cross": (1, 2, 2, 70, 130, 64, dict(causal=False)),
    "d128_window": (1, 2, 1, 140, 140, 128, dict(causal=True, window=40)),
    "d256_window_mqa": (1, 10, 1, 300, 300, 256,
                        dict(causal=True, window=200)),
    "d256_noncausal": (1, 2, 1, 70, 130, 256, dict(causal=False)),
    "empty_rows": (1, 2, 1, 300, 130, 64, dict(causal=True, window=40)),
}


def _inputs(b, h, hkv, sq, skv, d, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_emulated_tiling_matches_the_plain_version(case):
    """fp32 inputs (so p stays fp32 in both): the emulation within 1e-5
    relative of flash_attention_fwd_ref, out and lse; rows without a
    visible key give out 0 and lse -1e30 in both."""
    b, h, hkv, sq, skv, d, kw = EMULATED[case]
    q, k, v = (torch.from_numpy(x) for x in _inputs(b, h, hkv, sq, skv, d))
    out, lse = _emulate(q, k, v, **kw)
    want, want_lse = ops.flash_attention_fwd_ref(q, k, v, **kw)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    if case == "empty_rows":    # causal rows past skv + window see nothing
        assert (lse[:, :, skv + 40:] == MASK_VALUE).all()
        assert (out[:, :, skv + 40:] == 0).all()


@pytest.mark.parametrize("case", ["causal_gqa", "window", "softcap",
                                  "d256_window_mqa"])
def test_emulated_tiling_matches_the_jax_kernel(case):
    """The emulation against the reference's _fwd_kernel in interpret mode
    (fp32, the tolerance of tests/test_torch_attention.py), out and lse,
    at lengths the Pallas blocks divide."""
    b, h, hkv, _, _, d, kw = EMULATED[case]
    s = 256
    q, k, v = _inputs(b, h, hkv, s, s, d)
    kw = dict(kw)
    cap = kw.pop("softcap", None)
    epilogue = AttnEpilogue(softcap=cap) if cap else None
    j_out, j_lse = j_flash_fwd(*map(jnp.asarray, (q, k, v)), epilogue=epilogue,
                               interpret=True, **kw)
    out, lse = _emulate(*map(torch.from_numpy, (q, k, v)), softcap=cap, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), rtol=1e-5,
                               atol=1e-5)
