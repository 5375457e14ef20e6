"""The flash backward's work plan, TMA checks and bounds, on the CPU.

The main kernel (``csrc/flash_bwd.cu``) runs one block per (key tile, key
head, batch); each walks the q tiles of ``q_tile_range`` for every query head
of its group, and masks only the tiles ``tile_needs_mask`` names. Here: the
plan covers every visible (q, k) pair exactly once, visits no wholly masked
tile, masks every tile that has a masked pair, and orders its blocks longest
first, under causal, window, cross (``sq != skv``) and ragged lengths at
head_dim 64, 128 and 256; the tile sizes are the kernel's and its shared
memory fits; the TMA view checks accept the views the model hands over and
refuse a bad stride or start; the bound arithmetic matches hand counts; and
an fp32 emulation of the head_dim 256 body's tiling (the head dim split
between the warpgroups, P^T and dS^T exchanged per tile, dq summed per key
tile) equals the plain version.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention import backward as bwd
from repro_torch.kernels.attention.ops import \
    flash_attention_fwd_ref as fwd_ref

# (sq, skv, causal, window)
MASKS = [
    (1024, 1024, True, None),     # the training shape's mask
    (150, 150, True, None),       # ragged
    (130, 130, True, 40),         # ragged, window narrower than a tile
    (192, 192, True, 40),
    (640, 640, True, 300),        # window wider than a key tile
    (70, 130, False, None),       # cross, sq < skv
    (300, 130, False, None),      # cross, sq > skv
    (200, 330, True, None),       # causal cross: key tiles past sq are empty
    (257, 257, False, 100),       # window without the causal mask
    (64, 64, True, 1),            # the diagonal only
]


def _mask(sq, skv, causal, window):
    q = np.arange(sq)[:, None]
    k = np.arange(skv)[None, :]
    m = np.ones((sq, skv), dtype=bool)
    if causal:
        m &= q >= k
    if window:
        m &= (q - k) < window
    return m


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("sq,skv,causal,window", MASKS)
def test_plan_covers_every_visible_pair_once(sq, skv, causal, window, d):
    bq, kt_rows = bwd.q_tile_rows(d), bwd.key_tile_rows(d)
    mask = _mask(sq, skv, causal, window)
    plan = bwd.plan_blocks(sq, skv, d, causal=causal, window=window)
    assert sorted(kt for kt, _, _ in plan) == list(range(-(-skv // kt_rows)))
    hits = np.zeros((sq, skv), dtype=int)
    for kt, lo, hi in plan:
        k0 = kt * kt_rows
        assert 0 <= lo <= hi <= -(-sq // bq)
        for t in range(lo, hi):
            q0 = t * bq
            tile = mask[q0:q0 + bq, k0:k0 + kt_rows]
            assert tile.any(), f"tile ({t}, {kt}) is wholly masked"
            hits[q0:q0 + bq, k0:k0 + kt_rows] += 1
            # a tile the kernel leaves unmasked has every pair visible
            full = tile.shape == (min(bq, sq - q0), kt_rows) and tile.all()
            needs = bwd.tile_needs_mask(k0, q0, skv, bq, kt_rows,
                                        causal=causal, window=window)
            assert needs or full, f"tile ({t}, {kt}) has a masked pair"
    assert (hits[mask] == 1).all()
    assert hits.max() <= 1


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("sq,skv,causal,window", MASKS)
def test_plan_orders_blocks_longest_first(sq, skv, causal, window, d):
    counts = [hi - lo for _, lo, hi in
              bwd.plan_blocks(sq, skv, d, causal=causal, window=window)]
    assert counts == sorted(counts, reverse=True)


def test_training_plan_by_hand():
    """S 1024, causal, d 64: 8 key tiles of 128 rows and q tiles of 128;
    key tile j runs q tiles j..7."""
    plan = bwd.plan_blocks(1024, 1024, 64, causal=True, window=None)
    assert plan == [(j, j, 8) for j in range(8)]
    # d 128: q tiles of 64, key tile j from q tile 2j
    plan = bwd.plan_blocks(1024, 1024, 128, causal=True, window=None)
    assert plan == [(j, 2 * j, 16) for j in range(8)]
    # a window without the causal mask: the last key tile first
    plan = bwd.plan_blocks(257, 257, 64, causal=False, window=100)
    assert [kt for kt, _, _ in plan] == [2, 1, 0]
    # d 256, recurrentgemma-2b's S 4096 in the 2048 window: 64 key tiles
    # of 64 rows; key tile j runs q tiles j to j + 32 (its last key sees
    # 2047 rows on), the last 32 cut at the end
    plan = bwd.plan_blocks(4096, 4096, 256, causal=True, window=2048)
    assert plan == [(j, j, min(j + 33, 64)) for j in range(64)]


def _const(source, name):
    return re.search(rf"static constexpr \w+ {name} = ([^;]+);",
                     source).group(1)


def test_tile_sizes_match_the_kernel():
    """The wrapper's key tile, q tile and workspace sub-tile are the ones
    the kernel is compiled with, at each head dim."""
    source = (_build.CSRC / "flash_bwd.cu").read_text()
    assert _const(source, "SPLIT") == "D == 256"
    bkt = re.fullmatch(r"SPLIT \? (\d+) : (\d+)", _const(source, "BKT"))
    assert (int(bkt.group(1)), int(bkt.group(2))) \
        == (bwd.key_tile_rows(256), bwd.key_tile_rows(64)) \
        == (bwd.key_tile_rows(256), bwd.key_tile_rows(128))
    bq = re.fullmatch(r"D == 64 \? (\d+) : (\d+)", _const(source, "BQ"))
    assert (int(bq.group(1)), int(bq.group(2))) \
        == (bwd.q_tile_rows(64), bwd.q_tile_rows(128)) \
        == (bwd.q_tile_rows(64), bwd.q_tile_rows(256))
    sub = re.search(r"constexpr int SUB = (\d+) \* (\d+);", source)
    assert (int(sub.group(1)), int(sub.group(2))) == (bwd.DQ_SUB, bwd.DQ_SUB)


def _smem_bytes(d):
    """Layout<D>::SMEM by the .cu's own formulas: K and V, the dS^T (and at
    d 256 P^T) double buffers, the stages of q and dO, their lse and delta
    rows, the barriers and the alignment slack."""
    source = (_build.CSRC / "flash_bwd.cu").read_text()
    split = d == 256
    stages = re.fullmatch(r"SPLIT \? (\d+) : (\d+)",
                          _const(source, "STAGES"))
    stages = int(stages.group(1 if split else 2))
    bkt, bq = bwd.key_tile_rows(d), bwd.q_tile_rows(d)
    boxes = d // 64
    kv = boxes * bkt * 128
    tiles = 2 if split else 1
    ds = (bq // 64) * bkt * 128
    stage = 2 * boxes * bq * 128
    return (2 * kv + 2 * tiles * ds + stages * stage + stages * 2 * bq * 4
            + (2 * stages + 1) * 8 + 1024)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_shared_memory_fits_an_sm(d):
    """Each instantiation's shared memory under the 232,448 bytes a block
    may take; at d 256: K + V 64 KB, two stages 128 KB, P^T and dS^T
    32 KB, lse and delta 1 KB, barriers and slack."""
    assert _smem_bytes(d) <= 232_448
    if d == 256:
        assert _smem_bytes(d) == (65_536 + 131_072 + 32_768 + 1_024 + 40
                                  + 1_024) == 231_464


def _packed_views(b=2, s=96, h=8, hkv=2, d=64):
    qk = torch.zeros((b, s, (h + hkv) * d), dtype=torch.bfloat16)
    q = qk[..., :h * d].reshape(b, s, h, d).transpose(1, 2)
    k = qk[..., h * d:].reshape(b, s, hkv, d).transpose(1, 2)
    do = torch.zeros((b, s, h, d), dtype=torch.bfloat16).transpose(1, 2)
    return q, k, do


@pytest.mark.parametrize("d", [64, 128, 256])
def test_tma_check_accepts_the_model_views(d):
    q, k, do = _packed_views(d=d)
    for name, t in (("q", q), ("k", k), ("do", do),
                    ("contiguous", q.contiguous())):
        bwd.check_tma_view(t, name)


@pytest.mark.parametrize("bad", ["start", "stride", "last_dim", "rank"])
def test_tma_check_refuses_bad_views(bad):
    base = torch.zeros((2, 4, 96, 72), dtype=torch.bfloat16)
    if bad == "start":          # a view one element in: 2 bytes off
        t, match = base[..., 1:65], "16-byte aligned"
    elif bad == "stride":       # rows of 68 elements: 136 bytes
        t, match = torch.zeros((2, 4, 96, 68),
                               dtype=torch.bfloat16)[..., :64], "multiples"
    elif bad == "last_dim":
        t, match = base[..., :64].transpose(2, 3), "contiguous last dim"
    else:
        t, match = base[0], "4-D"
    with pytest.raises(ValueError, match=match):
        bwd.check_tma_view(t, "q")


@pytest.mark.parametrize("sq,skv,causal,window", MASKS)
def test_visible_pairs_match_the_mask(sq, skv, causal, window):
    assert bwd.visible_pairs(sq, skv, causal=causal, window=window) \
        == int(_mask(sq, skv, causal, window).sum())


def test_bound_arithmetic_by_hand():
    """The training shape: B 4, H 32, Hkv 8, S 1024, d 64, causal."""
    b, h, hkv, s, d = 4, 32, 8, 1024, 64
    w = bwd.backward_work(b, h, hkv, s, s, d, causal=True)
    pairs = b * h * s * (s + 1) // 2
    assert w["pairs"] == pairs
    assert w["flops"] == 5 * 2 * pairs * d            # s, dp, dv, dk, dq
    q_bytes = b * h * s * d * 2                       # q, dO, dq (bf16)
    kv_bytes = b * hkv * s * d * 2                    # k, v, dk, dv
    vec_bytes = 2 * b * h * s * 4                     # lse, delta (fp32)
    assert w["bytes"] == 3 * q_bytes + 4 * kv_bytes + vec_bytes
    assert w["convert_bytes"] == b * h * s * d * 4 + q_bytes
    assert w["convert_bytes"] == 33_554_432 + 16_777_216
    assert w["main_bytes"] == (2 * q_bytes + 4 * kv_bytes + vec_bytes
                               + b * h * s * d * 4)
    # at 989 TFLOP/s the products take 43.47 us
    assert round(w["flops"] / 989e12 * 1e6, 2) == 43.47
    # a ragged S pads the workspace to whole q tiles (128 rows at d 64)
    w = bwd.backward_work(1, 1, 1, 150, 150, 64, causal=True)
    assert w["convert_bytes"] == 256 * 64 * 4 + 150 * 64 * 2


def test_bound_arithmetic_at_recurrentgemma_training_shape():
    """B 2, H 10, Hkv 1, S 4096, d 256, causal in the 2048-token window:
    125,849,600 visible pairs, 322.2 GFLOP (325.8 us at 989 TFLOP/s)
    against 143.26 MB (42.8 us at 3.35 TB/s): bound by operations."""
    b, h, hkv, s, d = 2, 10, 1, 4096, 256
    w = bwd.backward_work(b, h, hkv, s, s, d, causal=True, window=2048)
    per_head = 2048 * 2049 // 2 + (s - 2048) * 2048
    assert w["pairs"] == b * h * per_head == 125_849_600
    assert w["flops"] == 322_174_976_000
    assert round(w["flops"] / 989e12 * 1e6, 1) == 325.8
    q_bytes, kv_bytes = b * h * s * d * 2, b * hkv * s * d * 2
    vec_bytes = 2 * b * h * s * 4
    assert w["bytes"] == 3 * q_bytes + 4 * kv_bytes + vec_bytes \
        == 143_261_696
    assert round(w["bytes"] / 3.35e12 * 1e6, 1) == 42.8


def _emulate_split(q, k, v, lse, do, delta, *, causal, window=None):
    """The d 256 body's tiling in fp32 torch: blocks in the planner's order
    over 64-row key tiles, each walking its key head's query heads and
    q tiles of 64 rows; per tile, warpgroup c's scores of q rows
    [32 c, 32 c + 32) (P^T and dS^T, masked only where the planner says),
    both halves read back for dV += P^T dO and dK += dS^T q over warpgroup
    c's 128 columns, and dq = dS K over its two 64-column sub-tiles added
    into the workspace. Inputs zero-filled past the lengths, lse +inf and
    delta 0 past sq, as the kernel reads them."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group, half = h // hkv, d // 2
    bq, bkt = bwd.q_tile_rows(d), bwd.key_tile_rows(d)
    scale = d ** -0.5
    plan = bwd.plan_blocks(sq, skv, d, causal=causal, window=window)
    sp = -(-sq // bq) * bq
    dq_acc = torch.zeros(b, h, sp, d)
    dk = torch.zeros(b, hkv, skv, d)
    dv = torch.zeros(b, hkv, skv, d)

    def rows(x, start, n, fill=0.0):
        x = x[start:start + n]
        pad = x.new_full((n - x.shape[0],) + x.shape[1:], fill)
        return torch.cat([x, pad])

    for bb in range(b):
        for hk in range(hkv):
            for kt, lo, hi in plan:
                k0 = kt * bkt
                kt_, vt = rows(k[bb, hk], k0, bkt), rows(v[bb, hk], k0, bkt)
                acc_k, acc_v = torch.zeros(bkt, d), torch.zeros(bkt, d)
                for hh in range(hk * group, (hk + 1) * group):
                    for t in range(lo, hi):
                        q0 = t * bq
                        qt = rows(q[bb, hh], q0, bq)
                        dot = rows(do[bb, hh], q0, bq)
                        l_t = rows(lse[bb, hh], q0, bq, float("inf"))
                        d_t = rows(delta[bb, hh], q0, bq)
                        pt, dst = torch.zeros(bkt, bq), torch.zeros(bkt, bq)
                        for c in range(2):
                            cols = slice(32 * c, 32 * c + 32)
                            s_t = kt_ @ qt[cols].T
                            dp_t = vt @ dot[cols].T
                            p_ = torch.exp(s_t * scale - l_t[cols])
                            if bwd.tile_needs_mask(k0, q0, skv, bq, bkt,
                                                   causal=causal,
                                                   window=window):
                                qpos = torch.arange(q0, q0 + bq)[cols][None]
                                kpos = torch.arange(k0, k0 + bkt)[:, None]
                                vis = kpos < skv
                                if causal:
                                    vis = vis & (qpos >= kpos)
                                if window:
                                    vis = vis & (qpos - kpos < window)
                                p_ = torch.where(vis, p_, 0.0)
                            pt[:, cols] = p_
                            dst[:, cols] = p_ * (dp_t - d_t[cols]) * scale
                        for c in range(2):
                            cols = slice(half * c, half * c + half)
                            acc_v[:, cols] += pt @ dot[:, cols]
                            acc_k[:, cols] += dst @ qt[:, cols]
                            for x in range(2):
                                sub = slice(half * c + 64 * x,
                                            half * c + 64 * x + 64)
                                dq_acc[bb, hh, q0:q0 + bq, sub] += \
                                    dst.T @ kt_[:, sub]
                n = min(bkt, skv - k0)
                dk[bb, hk, k0:k0 + n] = acc_k[:n]
                dv[bb, hk, k0:k0 + n] = acc_v[:n]
    return dq_acc[:, :, :sq], dk, dv


# (b, h, hkv, sq, skv, kwargs)
SPLIT_CASES = {
    "mqa_window": (1, 10, 1, 200, 200, dict(causal=True, window=70)),
    "gqa_causal_ragged": (2, 4, 2, 131, 131, dict(causal=True)),
    "noncausal_cross": (1, 2, 1, 70, 150, dict(causal=False)),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_emulated_d256_tiling_matches_the_plain_version(case):
    """fp32 inputs (p and ds stay fp32 in the plain version too): the
    emulation's dq, dk and dv within 1e-5 of flash_attention_bwd_ref."""
    b, h, hkv, sq, skv, kw = SPLIT_CASES[case]
    d = 256
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((b, h, sq, d), (b, hkv, skv, d),
                             (b, hkv, skv, d), (b, h, sq, d)))
    out, lse = fwd_ref(q, k, v, **kw)
    delta = bwd.attention_delta(out, do)
    got = _emulate_split(q, k, v, lse, do, delta, **kw)
    want = bwd.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-5)
