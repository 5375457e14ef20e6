"""The split-KV decode kernels' plan, live tiles and arithmetic, on the CPU.

The kernels (``csrc/flash_decode.cu``, ``csrc/flash_decode_paged.cu``, one
body in ``csrc/decode_split.cuh``) cut each unit's (batch row, kv head, row
tile) key tiles into the splits of ``plan_decode``, clip each split to the
tiles of ``live_key_tiles`` and merge the splits' partials in index order.
Here: the plan covers every key tile of every unit exactly once and sees
no length; the live range skips only tiles that no row sees, and no tile
that one does, under windows, ragged lengths, empty rows, ring wrap-around,
T = 1, 4, 20 and 128 and pages 16-128; the constants are the kernel's. And
an emulation of the kernel in plain torch fp32 (the same plan and clipping,
64-key tiles, the online softmax in log2 units, P rounded to bf16 before
P V, the index-order merge with sinks) equals the plain versions and the
reference's Pallas kernels in interpret mode, also at head_dim 256 with a
GQA group of 10 and at llama4-maverick's group of 5 (head_dim 128). The
emulation leaves out the few-row body's four 16-key warp slices, whose
merge is the same log-sum-exp merge within a split.
"""
import inspect
import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.policy import make_policy
from repro.kernels.attention import attention_decode as j_attention_decode
from repro.kernels.attention import (
    attention_decode_paged as j_attention_decode_paged)

from repro_torch.kernels import _build
from repro_torch.kernels.attention import decode
from repro_torch.kernels.attention.decode import (
    combine_splits, decode_partials_paged_ref, decode_partials_ref)
from repro_torch.kernels.attention.epilogue import cap_logits
from repro_torch.kernels.attention.ref import MASK_VALUE, ring_positions

LOG2E = 1.4426950408889634
TILE = decode.KEY_TILE


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sms", [8, 132])
@pytest.mark.parametrize("units", [1, 6, 32, 64, 300])
@pytest.mark.parametrize("n_tiles", [1, 5, 8, 9, 24, 64, 257])
def test_plan_covers_every_key_tile_once(n_tiles, units, sms):
    """Split s takes tiles [s tps, (s + 1) tps): together every tile once,
    none empty, none under MIN_SPLIT_TILES tiles unless the unit has fewer,
    and no more blocks than the target needs."""
    ns, tps = decode.plan_decode(units, n_tiles, sms)
    hits = np.zeros(n_tiles, int)
    for s in range(ns):
        tiles = range(s * tps, min(n_tiles, (s + 1) * tps))
        assert len(tiles) > 0
        hits[list(tiles)] += 1
    assert (hits == 1).all()
    assert ns == 1 or tps >= decode.MIN_SPLIT_TILES
    assert ns <= max(1, -(-decode.BLOCKS_PER_SM * sms // units))


@pytest.mark.parametrize("rows,per_unit", [(1, 16), (4, 16), (16, 16),
                                           (17, 32), (80, 32), (512, 32)])
def test_units_by_rows(rows, per_unit):
    """Up to FEW_ROWS rows a kv head are one unit of the few-row body; more
    go in ROW_TILE-row units."""
    assert decode.rows_per_unit(rows) == per_unit
    assert decode.decode_units(2, 8, rows) == 2 * 8 * -(-rows // per_unit)


@pytest.mark.parametrize("rows,t,per_unit", [
    (20, 4, 16), (25, 5, 16), (640, 128, 16), (512, 128, 16), (40, 4, 16),
    (80, 4, 32), (20, 1, 32)])
def test_units_by_group(rows, t, per_unit):
    """The body goes by the rows of one query token (the GQA group, R / T):
    a T-token call takes its T = 1 calls' body (at G 5, T 4 gives 20 rows
    in 16-row units, as a 5-row serial step), so verify rows keep the
    serial step's bits; only a group over FEW_ROWS takes ROW_TILE-row
    units."""
    assert decode.rows_per_unit(rows, t) == per_unit
    assert decode.decode_units(2, 8, rows, t) == 2 * 8 * -(-rows // per_unit)
    assert decode.rows_per_unit(rows // t) == per_unit


def test_plan_sees_no_length():
    """The plan's inputs are the units, the tile count and the SM count:
    the lengths stay on the device, so a call never synchronises. At the
    llama-1b main-path shapes (132 SMs) every plan has one split."""
    assert list(inspect.signature(decode.plan_decode).parameters) \
        == ["units", "n_tiles", "sms"]
    shapes = {"decode_step": (decode.decode_units(4, 8, 4), -(-296 // TILE)),
              "paged_decode": (decode.decode_units(8, 8, 4), 8),
              "chunk": (decode.decode_units(1, 8, 512, 128), 8),
              "verify": (decode.decode_units(8, 8, 16, 4), 8)}
    for units, n_tiles in shapes.values():
        assert decode.plan_decode(units, n_tiles, 132) == (1, n_tiles)
    # a long context splits: 8 kv heads of one sequence over 64 tiles
    assert decode.plan_decode(8, 64, 132) == (8, 8)


def test_constants_match_the_kernel():
    """The wrapper's tile, ring and row constants are the ones the kernels
    are compiled with (the split plan is core.autotune's alone)."""
    src = (_build.CSRC / "decode_split.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("KEY_TILE") == decode.KEY_TILE == decode.BLOCK_KV
    assert const("FEW_ROWS") == decode.FEW_ROWS
    assert const("ROW_TILE") == decode.ROW_TILE
    stages = re.search(r"int STAGES = D == 64 \? (\d+) : (\d+);", src)
    assert {d: int(stages.group(1 if d == 64 else 2))
            for d in decode.HEAD_DIMS} == decode.STAGES
    assert min(decode.STAGES.values()) >= 3
    # head_dim 256 keeps q in shared memory, rows padded by 16 bytes
    assert re.search(r"bool QSMEM = D > 128;", src)
    assert re.search(r"int QROW = 2 \* D \+ 16;", src)


# ---------------------------------------------------------------------------
# the live tiles
# ---------------------------------------------------------------------------

def _paged_valid(length, keys, rows, t, window):
    """(rows, keys): row r (token r mod T) sees positions <= length - T + t
    and within the window of it."""
    idx = np.arange(keys)[None, :]
    hz = length - t + (np.arange(rows) % t)[:, None]
    ok = idx <= hz
    if window:
        ok &= (hz - idx) < window
    return ok


def _ring_valid(length, slots, window):
    lens = torch.tensor([length], dtype=torch.int32)
    actual, valid = ring_positions(lens, slots)
    if window:
        valid &= (lens.long()[:, None] - 1 - actual) < window
    return valid.numpy()[0]


def _check_live(seen_tiles, lo, hi):
    """Every tile a row sees lies in [lo, hi); lo and hi - 1 are seen."""
    seen = sorted(seen_tiles)
    if not seen:
        assert lo >= hi
        return
    assert lo <= seen[0] and seen[-1] < hi
    assert seen[0] == lo and seen[-1] == hi - 1


@pytest.mark.parametrize("window", [None, 1, 40, 100])
@pytest.mark.parametrize("t", [1, 4, 20, 128])
@pytest.mark.parametrize("page", [16, 24, 64, 128])
def test_paged_live_tiles_skip_only_unseen_tiles(page, t, window):
    """Each unit of rows (the few-row tiles of G = 4 groups of T tokens)
    loads exactly the key tiles its rows see, over ragged lengths, an empty
    row and a full table."""
    _check_paged_live(page, t, window, 4)


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("t", [1, 4, 5, 24])
@pytest.mark.parametrize("g", [5, 20])
def test_paged_live_tiles_at_other_groups(g, t, window):
    """The same at llama4-maverick's G 5 (16-row units that start inside a
    group) and at G 20 (the many-row body's 32-row units)."""
    _check_paged_live(64, t, window, g)


def _check_paged_live(page, t, window, g):
    mp = 6
    keys = mp * page
    rows = g * t
    rb = decode.rows_per_unit(rows, t)
    for length in [0, t, t + 1, 63, 64, 65, 200, keys - 1, keys]:
        if length < t and length != 0:
            continue
        ok = _paged_valid(length, keys, rows, t, window)
        if length == 0:
            ok[:] = False
        for r0 in range(0, rows, rb):
            nr = min(rb, rows - r0)
            unit = ok[r0:r0 + nr]
            seen = {k // TILE for k in np.nonzero(unit.any(0))[0]}
            lo, hi = decode.live_key_tiles(length, keys, r0=r0, nr=nr,
                                           q_tokens=t, window=window)
            if length == 0:
                assert lo >= hi
                continue
            _check_live(seen, lo, hi)


@pytest.mark.parametrize("window", [None, 1, 50, 300])
@pytest.mark.parametrize("slots", [64, 100, 296, 512])
def test_ring_live_tiles_skip_only_unseen_slots(slots, window):
    """The contiguous ring: the live range holds every seen slot; before the
    cache wraps it is exactly the seen tiles, after it every tile (the
    window's two arcs are not clipped)."""
    for length in [0, 1, 37, 64, 65, slots - 1, slots, slots + 1,
                   2 * slots + 5]:
        ok = _ring_valid(length, slots, window)
        seen = {k // TILE for k in np.nonzero(ok)[0]}
        lo, hi = decode.live_key_tiles(length, slots, window=window,
                                       paged=False)
        if length <= slots:
            _check_live(seen, lo, hi)
        else:
            assert (lo, hi) == (0, -(-slots // TILE))
            assert seen <= set(range(lo, hi))


# ---------------------------------------------------------------------------
# the arithmetic: an fp32 emulation of the kernel
# ---------------------------------------------------------------------------

def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float()


def _emulate(q, k, v, valid, live, *, sms, scale, softcap, sinks, round_p,
             q_tokens=1):
    """The kernel's output in plain torch fp32. q (B, Hkv, R, D) of
    ``q_tokens`` tokens a group; k, v (B, Hkv, KEYS, D) in key order;
    valid (B, R, KEYS); live(b, r0, nr) the unit's live tiles; sinks
    (Hkv, R) or None."""
    b, hkv, rows, d = q.shape
    keys = k.shape[2]
    n_tiles = -(-keys // TILE)
    pad = n_tiles * TILE - keys
    k = torch.nn.functional.pad(k, (0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    valid = torch.nn.functional.pad(valid, (0, pad), value=False)
    rb = decode.rows_per_unit(rows, q_tokens)
    ns, tps = decode.plan_decode(decode.decode_units(b, hkv, rows, q_tokens),
                                 n_tiles, sms)
    out = torch.zeros_like(q)
    for bi in range(b):
        for h in range(hkv):
            for r0 in range(0, rows, rb):
                nr = min(rb, rows - r0)
                lo, hi = live(bi, r0, nr)
                qs = q[bi, h, r0:r0 + nr]
                parts = []
                for s in range(ns):
                    t0 = max(s * tps, lo)
                    t1 = min(n_tiles, (s + 1) * tps, hi)
                    if t0 >= t1:
                        parts.append(None)
                        continue
                    m = torch.full((nr,), MASK_VALUE)
                    l = torch.zeros(nr)
                    o = torch.zeros(nr, d)
                    for t in range(t0, t1):
                        sl = slice(t * TILE, (t + 1) * TILE)
                        x = cap_logits((qs @ k[bi, h, sl].T) * scale,
                                       softcap)
                        x = torch.where(valid[bi, r0:r0 + nr, sl], x,
                                        MASK_VALUE)
                        mnew = torch.maximum(m, x.amax(1))
                        mu = torch.where(mnew == MASK_VALUE, 0.0,
                                         mnew * LOG2E)
                        # exactly 1 where the row's max is unchanged
                        alpha = torch.where(mnew == m, 1.0,
                                            torch.exp2(m * LOG2E - mu))
                        p = torch.exp2(x * LOG2E - mu[:, None])
                        l = l * alpha + p.sum(1)
                        pv = p.to(torch.bfloat16).float() if round_p else p
                        o = o * alpha[:, None] + pv @ v[bi, h, sl]
                        m = mnew
                    parts.append((o, m, l))
                # the merge, splits in index order
                mt = torch.full((nr,), MASK_VALUE)
                for part in parts:
                    if part is not None:
                        mt = torch.maximum(mt, part[1])
                sink = None if sinks is None else sinks[h, r0:r0 + nr]
                if sink is not None:
                    mt = torch.maximum(mt, sink)
                den = torch.zeros(nr)
                num = torch.zeros(nr, d)
                for part in parts:
                    if part is None:
                        continue
                    o, m, l = part
                    a = torch.where(m == MASK_VALUE, 0.0,
                                    torch.exp2((m - mt) * LOG2E))
                    den = den + l * a
                    num = num + o * a[:, None]
                if sink is not None:
                    den = den + torch.exp2((sink - mt) * LOG2E)
                    res = num / den[:, None]
                else:
                    res = torch.where((den > 0)[:, None],
                                      num / torch.clamp(den, min=1e-30)[:, None],
                                      0.0)
                out[bi, h, r0:r0 + nr] = res
    return out


# B, Hkv, G, D; 16 SMs give the plan several splits at these lengths
B, HKV, G, D, SMS = 2, 2, 4, 64, 16
DECODE_CASES = {
    # slots, lengths, window, softcap, sinks
    "dense": (1088, [1000, 300], None, None, False),
    "ring": (1088, [1200, 2500], None, None, False),
    "window": (1088, [1000, 500], 130, None, False),
    "ring_window": (1088, [1500, 1089], 200, None, False),
    "empty_row": (1088, [0, 900], None, None, False),
    "softcap_sinks": (1088, [1050, 0], None, 5.0, True),
    "ragged_last_tile": (1080, [1080, 1070], None, None, True),
}


def _decode_inputs(case):
    slots, lengths, window, softcap, sinks = DECODE_CASES[case]
    rng = np.random.default_rng(21)
    q = _bf16(rng.standard_normal((B, HKV, G, D)).astype(np.float32))
    k = _bf16(rng.standard_normal((B, HKV, slots, D)).astype(np.float32))
    v = _bf16(rng.standard_normal((B, HKV, slots, D)).astype(np.float32))
    sk = (torch.from_numpy(rng.standard_normal(HKV * G).astype(np.float32))
          if sinks else None)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32), window, \
        softcap, sk


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_emulation_matches_contiguous_plain_and_reference(case):
    """The emulated contiguous kernel against decode_partials_ref +
    combine_splits and the reference's _decode_kernel in interpret mode:
    fp32 P within 1e-5 (the same sums in another order); P rounded to
    bf16 (2^-9 of each weight, so within 2^-9 max |v| of the fp32 result)
    within 1e-2."""
    q, k, v, lens, window, softcap, sinks = _decode_inputs(case)
    slots = k.shape[2]
    scale = D ** -0.5
    ok = _ring_valid_batch(lens, slots, window)
    valid = ok[:, None, :].expand(B, G, slots)

    def live(bi, r0, nr):
        return decode.live_key_tiles(int(lens[bi]), slots, window=window,
                                     paged=False)
    emu = {rp: _emulate(q, k, v, valid, live, sms=SMS, scale=scale,
                        softcap=softcap,
                        sinks=None if sinks is None else sinks.reshape(HKV, G),
                        round_p=rp) for rp in (False, True)}
    o, m, l = decode_partials_ref(q, k, v, lens, window=window, scale=scale,
                                  softcap=softcap)
    plain = combine_splits(o, m, l, sinks=None if sinks is None
                           else sinks.reshape(HKV, 1, G))
    pol = make_policy("attention_decode", block_m=G,
                      block_n=40 if slots % 64 else 64, block_k=D,
                      in_dtype="float32")
    ref = np.asarray(j_attention_decode(
        jnp.asarray(q.reshape(B, HKV * G, 1, D).numpy()),
        jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        jnp.asarray(lens.numpy()), window=window, softcap=softcap,
        sinks=None if sinks is None else jnp.asarray(sinks.numpy()),
        policy=pol, mode="pallas_interpret")).reshape(B, HKV, G, D)
    for want in (plain.numpy(), ref):
        np.testing.assert_allclose(emu[False].numpy(), want, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(emu[True].numpy(), want, rtol=0,
                                   atol=1e-2)
    if case == "empty_row":
        assert float(emu[True][0].abs().max()) == 0.0


def _ring_valid_batch(lens, slots, window):
    actual, valid = ring_positions(lens, slots)
    if window:
        valid &= (lens.long()[:, None] - 1 - actual) < window
    return valid


PAGED_CASES = {
    # page, T, lengths, window, softcap, sinks
    "page64_t1": (64, 1, [1000, 0], None, None, False),
    "page16_t1_window": (16, 1, [500, 1050], 70, None, True),
    "page128_t1": (128, 1, [1100, 129], None, 5.0, False),
    "page32_t4": (32, 4, [4, 900], None, None, True),
    "page64_t20_window": (64, 20, [20, 1050], 45, 5.0, False),
    "page24_t4": (24, 4, [100, 1100], None, None, False),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_emulation_matches_paged_plain_and_reference(case):
    """The emulated paged kernel (the pages gathered into key order, each
    row's own horizon) against decode_partials_paged_ref + combine_splits
    and the reference's _decode_kernel_paged in interpret mode, at the
    contiguous case's tolerances."""
    page, t, lengths, window, softcap, sinks = PAGED_CASES[case]
    mp = -(-1088 // page)
    keys = mp * page
    rows = G * t
    rng = np.random.default_rng(22)
    n_pages = B * mp + 1
    kp = _bf16(rng.standard_normal((n_pages, HKV, page, D)).astype(np.float32))
    vp = _bf16(rng.standard_normal((n_pages, HKV, page, D)).astype(np.float32))
    q4 = _bf16(rng.standard_normal((B, HKV * G, t, D)).astype(np.float32))
    q = q4.reshape(B, HKV, rows, D)
    table = np.zeros((B, mp), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    for i, n in enumerate(lengths):
        need = -(-n // page)
        table[i, :need] = perm[i * mp:i * mp + need]
    pt = torch.from_numpy(table)
    lens = torch.tensor(lengths, dtype=torch.int32)
    sk = (torch.from_numpy(rng.standard_normal(HKV * G).astype(np.float32))
          if sinks else None)
    row_sinks = (None if sk is None
                 else sk.reshape(HKV, G).repeat_interleave(t, dim=1))
    scale = D ** -0.5
    kg = kp[pt.long()].transpose(1, 2).reshape(B, HKV, keys, D)
    vg = vp[pt.long()].transpose(1, 2).reshape(B, HKV, keys, D)
    valid = torch.from_numpy(np.stack([_paged_valid(n, keys, rows, t, window)
                                       for n in lengths]))

    def live(bi, r0, nr):
        return decode.live_key_tiles(int(lens[bi]), keys, r0=r0, nr=nr,
                                     q_tokens=t, window=window)
    emu = {rp: _emulate(q, kg, vg, valid, live, sms=SMS, scale=scale,
                        softcap=softcap, sinks=row_sinks, round_p=rp,
                        q_tokens=t)
           for rp in (False, True)}
    o, m, l = decode_partials_paged_ref(q, kp, vp, pt, lens, window=window,
                                        scale=scale, softcap=softcap,
                                        q_tokens=t)
    plain = combine_splits(o, m, l, sinks=None if row_sinks is None
                           else row_sinks.reshape(HKV, 1, rows))
    ref = np.asarray(j_attention_decode_paged(
        jnp.asarray(q4.numpy()), jnp.asarray(kp.numpy()),
        jnp.asarray(vp.numpy()), jnp.asarray(table), jnp.asarray(lengths),
        window=window, softcap=softcap,
        sinks=None if sk is None else jnp.asarray(sk.numpy()),
        mode="pallas_interpret")).reshape(B, HKV, rows, D)
    for want in (plain.numpy(), ref):
        np.testing.assert_allclose(emu[False].numpy(), want, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(emu[True].numpy(), want, rtol=0,
                                   atol=1e-2)
    for i, n in enumerate(lengths):
        if n == 0:
            assert float(emu[True][i].abs().max()) == 0.0


def test_emulation_splits_at_these_shapes():
    """The emulated shapes do reach the merge: several splits a unit."""
    for t, n_tiles in ((1, 17), (4, 17), (20, 17), (1, 18)):
        units = decode.decode_units(B, HKV, G * t, t)
        assert decode.plan_decode(units, n_tiles, SMS)[0] > 1
    assert math.isclose(LOG2E, 1 / math.log(2))


# recurrentgemma-2b's decode: one kv head, G 10 query rows, head_dim 256;
# the ring wraps past its slots, a window; paged at T 1 (the few-row body)
# and T 4 (40 rows: the many-row body)
D256_CASES = {
    # paged, page, T, slots or keys, lengths, window
    "ring_wrap_window": (False, None, 1, 576, [700, 300], 200),
    "ring_dense": (False, None, 1, 576, [576, 65], None),
    "paged_t1_window": (True, 64, 1, 576, [530, 97], 200),
    "paged_page16_t4": (True, 16, 4, 576, [300, 41], None),
}


@pytest.mark.parametrize("case", sorted(D256_CASES))
def test_emulation_at_head_dim_256(case):
    """The emulated kernel at head_dim 256 and G 10 (MQA) against the plain
    versions and the reference's decode kernels in interpret mode, at the
    tolerances of the head_dim 64 cases."""
    _emulation_case(*D256_CASES[case], hkv=1, g=10, d=256, seed=23)


# llama4-maverick's decode: a GQA group of 5 (40 query heads over 8) at
# head_dim 128, two kv heads here; paged at T 1 (5 rows: the few-row
# body), T 4 and T 5 (20 and 25 rows, a verify step of k and k + 1
# tokens) and T 24 (120 rows: row tiles that start inside a group)
G5_CASES = {
    # paged, page, T, slots or keys, lengths, window
    "ring_wrap": (False, None, 1, 576, [700, 300], None),
    "paged_t1": (True, 64, 1, 576, [530, 0], None),
    "paged_t4_window": (True, 64, 4, 576, [300, 41], 100),
    "paged_page32_t5": (True, 32, 5, 576, [576, 97], None),
    "paged_t24": (True, 64, 24, 576, [500, 24], None),
}


@pytest.mark.parametrize("case", sorted(G5_CASES))
def test_emulation_at_gqa_group_5(case):
    """The emulated kernel at G 5, head_dim 128, against the plain versions
    and the reference's decode kernels in interpret mode, at the tolerances
    of the head_dim 64 cases."""
    _emulation_case(*G5_CASES[case], hkv=2, g=5, d=128, seed=31)


def _emulation_case(paged, page, t, keys, lengths, window, *, hkv, g, d,
                    seed):
    """One case of the emulated kernel over B 2 sequences of ``hkv`` kv
    heads, ``g`` q rows each (times T for a paged call), head_dim ``d``."""
    b = 2
    rows = g * t
    rng = np.random.default_rng(seed)
    scale = d ** -0.5
    lens = torch.tensor(lengths, dtype=torch.int32)
    if paged:
        mp = keys // page
        n_pages = b * mp + 1
        kp = _bf16(rng.standard_normal((n_pages, hkv, page, d))
                   .astype(np.float32))
        vp = _bf16(rng.standard_normal((n_pages, hkv, page, d))
                   .astype(np.float32))
        q4 = _bf16(rng.standard_normal((b, hkv * g, t, d)).astype(np.float32))
        q = q4.reshape(b, hkv, rows, d)
        table = np.zeros((b, mp), np.int32)
        perm = rng.permutation(np.arange(1, n_pages))
        for i, n in enumerate(lengths):
            table[i, :-(-n // page)] = perm[i * mp:i * mp - (-n // page)]
        pt = torch.from_numpy(table)
        kg = kp[pt.long()].transpose(1, 2).reshape(b, hkv, keys, d)
        vg = vp[pt.long()].transpose(1, 2).reshape(b, hkv, keys, d)
        valid = torch.from_numpy(np.stack(
            [_paged_valid(n, keys, rows, t, window) for n in lengths]))

        def live(bi, r0, nr):
            return decode.live_key_tiles(int(lens[bi]), keys, r0=r0, nr=nr,
                                         q_tokens=t, window=window)
        o, m, l = decode_partials_paged_ref(q, kp, vp, pt, lens,
                                            window=window, scale=scale,
                                            q_tokens=t)
        ref = j_attention_decode_paged(
            jnp.asarray(q4.numpy()), jnp.asarray(kp.numpy()),
            jnp.asarray(vp.numpy()), jnp.asarray(table),
            jnp.asarray(lengths), window=window, mode="pallas_interpret")
    else:
        q = _bf16(rng.standard_normal((b, hkv, g, d)).astype(np.float32))
        kg = _bf16(rng.standard_normal((b, hkv, keys, d)).astype(np.float32))
        vg = _bf16(rng.standard_normal((b, hkv, keys, d)).astype(np.float32))
        valid = _ring_valid_batch(lens, keys, window)[:, None, :].expand(
            b, g, keys)

        def live(bi, r0, nr):
            return decode.live_key_tiles(int(lens[bi]), keys, window=window,
                                         paged=False)
        o, m, l = decode_partials_ref(q, kg, vg, lens, window=window,
                                      scale=scale)
        pol = make_policy("attention_decode", block_m=g, block_n=64,
                          block_k=d, in_dtype="float32")
        ref = j_attention_decode(
            jnp.asarray(q.reshape(b, hkv * g, 1, d).numpy()),
            jnp.asarray(kg.numpy()), jnp.asarray(vg.numpy()),
            jnp.asarray(lens.numpy()), window=window, policy=pol,
            mode="pallas_interpret")
    assert decode.rows_per_unit(rows, t) == decode.FEW_ROWS
    emu = {rp: _emulate(q, kg, vg, valid, live, sms=SMS, scale=scale,
                        softcap=None, sinks=None, round_p=rp, q_tokens=t)
           for rp in (False, True)}
    plain = combine_splits(o, m, l)
    for want in (plain.numpy(), np.asarray(ref).reshape(b, hkv, rows, d)):
        np.testing.assert_allclose(emu[False].numpy(), want, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(emu[True].numpy(), want, rtol=0,
                                   atol=1e-2)
