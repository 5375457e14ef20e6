"""The flash backward's work plan, TMA checks and bounds, on the CPU.

The main kernel (``csrc/flash_bwd.cu``) runs one block per (key tile, key
head, batch); each walks the q tiles of ``q_tile_range`` for every query head
of its group, and masks only the tiles ``tile_needs_mask`` names. Here: the
plan covers every visible (q, k) pair exactly once, visits no wholly masked
tile, masks every tile that has a masked pair, and orders its blocks longest
first, under causal, window, cross (``sq != skv``) and ragged lengths at
head_dim 64 and 128; the tile sizes are the kernel's; the TMA view checks
accept the views the model hands over and refuse a bad stride or start; and
the bound arithmetic matches hand counts.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention import backward as bwd

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


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv,causal,window", MASKS)
def test_plan_covers_every_visible_pair_once(sq, skv, causal, window, d):
    bq, kt_rows = bwd.q_tile_rows(d), bwd.KEY_TILE
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
            needs = bwd.tile_needs_mask(k0, q0, skv, bq, causal=causal,
                                        window=window)
            assert needs or full, f"tile ({t}, {kt}) has a masked pair"
    assert (hits[mask] == 1).all()
    assert hits.max() <= 1


@pytest.mark.parametrize("d", [64, 128])
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


def test_tile_sizes_match_the_kernel():
    """The wrapper's key tile, q tile and workspace sub-tile are the ones
    the kernel is compiled with."""
    source = (_build.CSRC / "flash_bwd.cu").read_text()
    assert int(re.search(r"constexpr int BKT = (\d+);", source).group(1)) \
        == bwd.KEY_TILE
    bq = re.search(r"int BQ = D == 64 \? (\d+) : (\d+);", source)
    assert (int(bq.group(1)), int(bq.group(2))) \
        == (bwd.q_tile_rows(64), bwd.q_tile_rows(128))
    sub = re.search(r"constexpr int SUB = (\d+) \* (\d+);", source)
    assert (int(sub.group(1)), int(sub.group(2))) == (bwd.DQ_SUB, bwd.DQ_SUB)


def _packed_views(b=2, s=96, h=8, hkv=2, d=64):
    qk = torch.zeros((b, s, (h + hkv) * d), dtype=torch.bfloat16)
    q = qk[..., :h * d].reshape(b, s, h, d).transpose(1, 2)
    k = qk[..., h * d:].reshape(b, s, hkv, d).transpose(1, 2)
    do = torch.zeros((b, s, h, d), dtype=torch.bfloat16).transpose(1, 2)
    return q, k, do


@pytest.mark.parametrize("d", [64, 128])
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
