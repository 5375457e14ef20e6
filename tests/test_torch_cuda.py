"""The hand-written CUDA kernels against their plain versions, on the card,
at small shapes that reach the edges the model's main path does not: ragged
M, N and K tiles, a K that is no multiple of the K tile, head_dim 128,
for the forward GEMM every tile width and split of its mainloop, its
MN-major weight tiles bit for bit through a permutation matrix, the decode
shapes (M 1-64 at K 8192) bitwise reproducible and row-independent,
windows, soft caps, ring wrap-around, empty rows and a ragged last split;
for the paged kernel, page sizes 16-128, null-page entries, a ragged row
tile of T > 1 query tokens, and bitwise equality with the contiguous kernel
over the gathered pages; for the backward kernels, every chain the GEMM
takes at ragged M, N and K, each tile width of the GEMM backward's
mainloop, its operand pass against the plain version, the llama-1b
training shapes, the forward's saved preacts against the rounded
accumulator, the flash backward at head_dim 128 with windows, soft caps,
strided views, groups 1-8 and the training shape (dk and dv bitwise across
two calls, a view the TMA cannot read refused), and autograd through both
ops.

Marked ``cuda``: skipped on a machine without a CUDA card. On the card:

  python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.attention import (attention, combine_splits,
                                           decode_partials_paged_ref,
                                           decode_partials_ref,
                                           flash_attention_bwd,
                                           flash_attention_bwd_ref,
                                           flash_attention_fwd,
                                           flash_attention_fwd_ref,
                                           flash_decode, flash_decode_paged)
from repro_torch.serve.kv_cache import gather_pages
from repro_torch.kernels.gemm import (Epilogue, Prologue, gemm_bwd_da_ref,
                                      gemm_bwd_db_ref, gemm_bwd_g_ref,
                                      gemm_fused,
                                      gemm_fused_bwd, gemm_fused_ref)
from repro_torch.kernels.gemm import backward as gemm_backward
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.gemm.ops import _forward as gemm_forward

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(rng, shape, dev, std=1.0, dtype=torch.bfloat16):
    x = rng.standard_normal(shape).astype(np.float32) * std
    return torch.from_numpy(x).to(device=dev, dtype=dtype)


def _close(got, want, rtol, rms_frac):
    """|got - want| <= rtol |want| + rms_frac * rms(want): bf16 outputs are
    2^-8 relative apart at one rounding, and entries near zero are held to a
    fraction of the output's scale instead."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    atol = rms_frac * want.pow(2).mean().sqrt().item()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


GEMM_CHAINS = {
    "rope_bias": (dict(rope=True, head_dim=64, bias=True), True),
    "rope_128": (dict(rope=True, head_dim=128), True),
    "identity_norm": (dict(), True),
    "identity": (dict(), False),
    "silu_gate_norm": (dict(activation="silu", gate=True), True),
    "residual_scale": (dict(residual=True, scale=True), False),
    "silu_gate": (dict(activation="silu", gate=True), False),
}
# the backward also takes a bias without rope (dbias from the plain g)
BWD_CHAINS = dict(GEMM_CHAINS, bias=(dict(bias=True), False))
# the forward also takes a rope head_dim under 16 (through its workspace)
FWD_CHAINS = dict(GEMM_CHAINS, rope_8=(dict(rope=True, head_dim=8), True))
_ALL_CHAINS = dict(BWD_CHAINS, **FWD_CHAINS)


def _gemm_operands(dev, chain, m, k, n):
    ep_kw, norm = _ALL_CHAINS[chain]
    rng = np.random.default_rng(m * 7 + k)
    kw = {"epilogue": Epilogue(**ep_kw)}
    if ep_kw.get("gate"):
        kw["b2"] = _rand(rng, (k, n), dev, k ** -0.5)
    if ep_kw.get("bias"):
        kw["bias"] = _rand(rng, (n,), dev)
    if ep_kw.get("residual"):
        kw["residual"] = _rand(rng, (m, n), dev)
    if ep_kw.get("scale"):
        kw["scale"] = 0.5
    if ep_kw.get("rope"):
        hd = ep_kw["head_dim"]
        ang = torch.from_numpy(rng.uniform(0, 6.3, (m, hd // 2))
                               .astype(np.float32)).to(dev)
        kw["sin"] = torch.cat([ang.sin()] * 2, dim=1)
        kw["cos"] = torch.cat([ang.cos()] * 2, dim=1)
    if norm:
        kw["prologue"] = Prologue(norm="rmsnorm")
        kw["gamma"] = (1 + 0.1 * _rand(rng, (k,), dev)).to(torch.bfloat16)
    a, b = _rand(rng, (m, k), dev), _rand(rng, (k, n), dev, k ** -0.5)
    return rng, a, b, kw


@pytest.mark.parametrize("m,k,n", [(4, 136, 256), (200, 264, 384),
                                   (1, 64, 128), (130, 8192, 640)])
@pytest.mark.parametrize("chain", sorted(FWD_CHAINS))
def test_gemm_fused_kernel_matches_plain(dev, chain, m, k, n):
    _, a, b, kw = _gemm_operands(dev, chain, m, k, n)
    before = kernels.launch_counts()["gemm_fused"]
    got = gemm_fused(a, b, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gemm_fused"] == before + 1
    _close(got, gemm_fused_ref(a, b, **kw), 2 ** -6, 2e-2)


def _close_to_rounded_product(got, an, w):
    """A saved preact (bf16) against the fp32 product an @ w rounded to
    bf16: two bf16 roundings apart (2^-7 relative) of two fp32 sums that
    differ by their order, which the reassociation bound of a K-term sum
    limits to 2 K 2^-24 (|an| @ |w|) per entry (near zero, where that is
    more than the rounding, the two bf16 values may be several ulps
    apart)."""
    an, w = an.float(), w.float()
    want = an @ w
    slack = 2 * an.shape[1] * 2 ** -24 * (an.abs() @ w.abs())
    err = (got.float() - want.to(torch.bfloat16).float()).abs()
    assert torch.isfinite(got.float()).all()
    assert bool((err <= 2 ** -7 * want.abs() + slack).all()), \
        f"max err {err.max().item():.3g}"


def _normed(a, kw, rstd):
    """A as the kernel's product reads it: normalised with the kernel's row
    statistics, x rstd gamma in fp32 rounded to bf16."""
    if "gamma" not in kw:
        return a
    return (a.float() * rstd[:, None] * kw["gamma"].float()).to(a.dtype)


def _fwd_launch(a, b, kw, plan=None, save_preact=False):
    """One launch of the forward kernel: (out, rstd, preacts)."""
    ep = kw["epilogue"]
    pro = kw.get("prologue", Prologue())
    extra = {k: kw.get(k) for k in ("b2", "bias", "residual", "sin", "cos",
                                    "gamma")}
    return gemm_ops._launch(a, b, ep, scale=kw.get("scale"), eps=pro.eps,
                            out_dtype=torch.bfloat16, save_preact=save_preact,
                            plan=plan, **extra)


# every (tile width, split count) of the mainloop each chain can take
_PLANS = [(chain, w, s) for chain in sorted(FWD_CHAINS)
          for w in gemm_ops.tile_widths(
              FWD_CHAINS[chain][0].get("gate", False),
              FWD_CHAINS[chain][0].get("head_dim", 0))
          for s in (1, 3)]


@pytest.mark.parametrize("chain,tile_n,splits", _PLANS)
def test_gemm_fused_every_plan(dev, chain, tile_n, splits):
    """The forward kernel at each tile width and split count its chain
    takes, with M, N and K across the tile and stage edges (N = 136 where
    whole heads allow, else 384; K = 264: five 64-deep stages, the last
    ragged, split 2 + 2 + 1; M = 200), against the plain version; the
    gated chain's saved preacts too."""
    n = 384 if FWD_CHAINS[chain][0].get("rope") else 136
    _, a, b, kw = _gemm_operands(dev, chain, 200, 264, n)
    gate = kw["epilogue"].gate
    got, rstd, preacts = _fwd_launch(a, b, kw, (tile_n, splits), gate)
    torch.cuda.synchronize()
    _close(got, gemm_fused_ref(a, b, **kw), 2 ** -6, 2e-2)
    for p, w in zip(preacts, (b, kw.get("b2"))):
        _close_to_rounded_product(p, _normed(a, kw, rstd), w)
    if "gamma" in kw:
        _, want_rstd = gemm_ops.rms_rows_ref(a, kw["gamma"],
                                             kw["prologue"].eps)
        torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=0)


def _permutation(rng, k, n, dev):
    """(K, N) bf16 with one 1 per column, in a random row: A @ B picks A's
    columns, exactly in bf16 (each sum has one non-zero term)."""
    rows = rng.permutation(k)[:n]
    b = torch.zeros(k, n, dtype=torch.bfloat16)
    b[torch.from_numpy(rows), torch.arange(n)] = 1
    return b.to(dev), torch.from_numpy(rows).to(dev)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("gate,tile_n", [(False, 64), (False, 128),
                                         (False, 256), (True, 128),
                                         (True, 256)])
def test_gemm_fused_mn_major_tiles_are_exact(dev, gate, tile_n, splits):
    """The weight tiles are read MN-major (as stored, N contiguous) through
    64-column TMA boxes: with B a column selection of K at ragged N (not a
    multiple of 64), the output is A's selected columns bit for bit at every
    tile width and split, so a wrong descriptor, swizzle or box offset
    cannot hide in a tolerance. The gated chain's two halves through its
    saved preacts, which are A @ B and A @ B2 rounded once."""
    m, k, n = 200, 264, 136
    rng = np.random.default_rng(tile_n + splits)
    a = _rand(rng, (m, k), dev)
    b, cols = _permutation(rng, k, n, dev)
    kw = {"epilogue": Epilogue()}
    if gate:
        kw = {"epilogue": Epilogue(activation="silu", gate=True)}
        kw["b2"], cols2 = _permutation(rng, k, n, dev)
    out, _, preacts = _fwd_launch(a, b, kw, (tile_n, splits), gate)
    torch.cuda.synchronize()
    if gate:
        assert torch.equal(preacts[0], a[:, cols])
        assert torch.equal(preacts[1], a[:, cols2])
    else:
        assert torch.equal(out, a[:, cols])


@pytest.mark.parametrize("m", [1, 4, 8, 16, 64])
@pytest.mark.parametrize("chain", sorted(GEMM_CHAINS))
def test_gemm_fused_small_m_is_reproducible(dev, chain, m):
    """Decode's shapes (K 8192, N 2048, M up to 64: split over K by the
    planner) against the plain version, with the gated chain's saved
    preacts; two calls give the same bits (the splits are summed in a fixed
    order)."""
    _, a, b, kw = _gemm_operands(dev, chain, m, 8192, 2048)
    gate = kw["epilogue"].gate
    first = _fwd_launch(a, b, kw, save_preact=gate)
    second = _fwd_launch(a, b, kw, save_preact=gate)
    torch.cuda.synchronize()
    assert gemm_ops.plan_gemm(m, 2048, 8192, gemm_ops.sm_count(dev),
                              gate=gate,
                              head_dim=kw["epilogue"].head_dim)[1] > 1
    _close(first[0], gemm_fused_ref(a, b, **kw), 2 ** -6, 2e-2)
    assert torch.equal(first[0], second[0])
    for p, q in zip(first[2], second[2]):
        assert torch.equal(p, q)
    for p, w in zip(first[2], (b, kw.get("b2"))):
        _close_to_rounded_product(p, _normed(a, kw, first[1]), w)


@pytest.mark.parametrize("m", [4, 64, 200])
@pytest.mark.parametrize("chain", sorted(GEMM_CHAINS))
def test_gemm_fused_rows_are_independent(dev, chain, m):
    """A row's output does not change when the batch's other rows (of A and
    the residual) do: what lets a lone-slot replay give the served tokens."""
    rng, a, b, kw = _gemm_operands(dev, chain, m, 2048, 512)
    keep = [0, m - 1]
    other = _rand(rng, (m, 2048), dev)
    other[keep] = a[keep]
    kw2 = dict(kw)
    if "residual" in kw:
        kw2["residual"] = _rand(rng, (m, 512), dev)
        kw2["residual"][keep] = kw["residual"][keep]
    first = gemm_fused(a, b, **kw)
    second = gemm_fused(other, b, **kw2)
    torch.cuda.synchronize()
    assert torch.equal(first[keep], second[keep])


@pytest.mark.parametrize("case", ["causal_gqa", "ragged", "d128", "window",
                                  "softcap", "noncausal_cross"])
def test_flash_attention_fwd_kernel_matches_plain(dev, case):
    b, h, hkv, sq, skv, d = 2, 8, 2, 192, 192, 64
    kw = {"causal": True}
    if case == "ragged":
        sq = skv = 150
    elif case == "d128":
        d, sq, skv = 128, 130, 130
    elif case == "window":
        kw["window"] = 40
    elif case == "softcap":
        kw["softcap"] = 5.0
    elif case == "noncausal_cross":
        kw, sq, skv = {"causal": False}, 70, 130
    rng = np.random.default_rng(5)
    q = _rand(rng, (b, h, sq, d), dev)
    k = _rand(rng, (b, hkv, skv, d), dev)
    v = _rand(rng, (b, hkv, skv, d), dev)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    want, want_lse = flash_attention_fwd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    _close(out, want, 2e-2, 2e-2)
    _close(lse, want_lse, 1e-4, 1e-4)


@pytest.mark.parametrize("case", ["dense", "ring", "window", "ring_window",
                                  "empty_rows", "ragged_split", "d128"])
def test_flash_decode_kernel_matches_plain(dev, case):
    b, hkv, g, slots, d = 3, 2, 4, 296, 64
    lengths, window = [40, 296, 7], None
    if case == "ring":
        lengths = [400, 296, 597]
    elif case == "window":
        window, lengths = 50, [140, 296, 70]
    elif case == "ring_window":
        window, lengths = 100, [400, 296, 597]
    elif case == "empty_rows":
        lengths = [0, 33, 0]
    elif case == "ragged_split":
        slots, lengths = 100, [100, 65, 64]
    elif case == "d128":
        d = 128
    rng = np.random.default_rng(6)
    q = _rand(rng, (b, hkv, g, d), dev)
    k = _rand(rng, (b, hkv, slots, d), dev)
    v = _rand(rng, (b, hkv, slots, d), dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = flash_decode(q, k, v, lens, window=window)
    o, m, l = decode_partials_ref(q, k, v, lens, window=window,
                                  scale=d ** -0.5)
    want = combine_splits(o, m, l).to(q.dtype)
    torch.cuda.synchronize()
    _close(got, want, 2e-2, 2e-2)
    if case == "empty_rows":
        assert float(got[0].abs().max()) == 0.0
        assert float(got[2].abs().max()) == 0.0


PAGED_CASES = {
    # name: (page_size, head_dim, q_tokens, window, softcap, lengths)
    "page16": (16, 64, 1, None, None, [40, 128, 7]),
    "page32": (32, 64, 1, None, None, [33, 100, 128]),
    "page64": (64, 64, 1, None, None, [65, 256, 1]),
    "page128": (128, 64, 1, None, None, [129, 300, 512]),
    "d128": (64, 128, 1, None, None, [70, 256, 5]),
    "window": (32, 64, 1, 50, None, [140, 96, 33]),
    "softcap": (64, 64, 1, None, 5.0, [100, 200, 64]),
    "empty_rows_null_pages": (32, 64, 1, None, None, [0, 40, 0]),
    "verify_t4": (64, 64, 4, None, None, [68, 200, 4]),
    "ragged_row_tile_t20": (32, 64, 20, 45, 5.0, [60, 130, 20]),
    "chunk_t128": (64, 64, 128, None, None, [320, 128, 256]),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_flash_decode_paged_kernel_matches_plain(dev, case):
    page, d, t, window, softcap, lengths = PAGED_CASES[case]
    b, hkv, g, mp = 3, 2, 4, 8
    n_pages = b * mp + 1
    rng = np.random.default_rng(7)
    kp = _rand(rng, (n_pages, hkv, page, d), dev)
    vp = _rand(rng, (n_pages, hkv, page, d), dev)
    q = _rand(rng, (b, hkv, g * t, d), dev)
    # each row holds the pages its length needs, in a seeded order; the
    # rest of the row points at the null page 0
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, mp), np.int32)
    for i, n in enumerate(lengths):
        need = -(-n // page)
        table[i, :need] = perm[i * mp:i * mp + need]
    pt = torch.from_numpy(table).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = kernels.launch_counts()["flash_decode_paged"]
    got = flash_decode_paged(q, kp, vp, pt, lens, window=window,
                             softcap=softcap, q_tokens=t)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_decode_paged"] == before + 1
    o, m, l = decode_partials_paged_ref(q, kp, vp, pt, lens, window=window,
                                        scale=d ** -0.5, softcap=softcap,
                                        q_tokens=t)
    want = combine_splits(o, m, l).to(q.dtype)
    _close(got, want, 2e-2, 2e-2)
    for i, n in enumerate(lengths):
        if n == 0:
            assert float(got[i].abs().max()) == 0.0


def test_flash_decode_paged_equals_contiguous_bitwise(dev):
    """Page 64 == BLOCK_KV and one query token: the paged kernel and the
    contiguous kernel over the gathered pages share the split body, so they
    agree bit for bit (the guard against a paging bug)."""
    b, hkv, g, d, page, mp = 4, 8, 4, 64, 64, 8
    n_pages = b * mp + 1
    rng = np.random.default_rng(8)
    kp = _rand(rng, (n_pages, hkv, page, d), dev)
    vp = _rand(rng, (n_pages, hkv, page, d), dev)
    q = _rand(rng, (b, hkv, g, d), dev)
    table = rng.permutation(np.arange(1, n_pages)).reshape(b, mp)
    pt = torch.from_numpy(table.astype(np.int32)).to(dev)
    lens = torch.tensor([0, 64, 65, 500], dtype=torch.int32, device=dev)
    for window in (None, 100):
        paged = flash_decode_paged(q, kp, vp, pt, lens, window=window)
        dense = flash_decode(q, gather_pages(kp, pt).contiguous(),
                             gather_pages(vp, pt).contiguous(), lens,
                             window=window)
        torch.cuda.synchronize()
        assert torch.equal(paged, dense)


@pytest.mark.parametrize("page", [12, 256])
def test_flash_decode_paged_rejects_unsupported_page_size(dev, page):
    kernels.reset_launch_counts()
    kp = torch.zeros((3, 2, page, 64), dtype=torch.bfloat16, device=dev)
    q = torch.zeros((1, 2, 4, 64), dtype=torch.bfloat16, device=dev)
    pt = torch.ones((1, 2), dtype=torch.int32, device=dev)
    lens = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="page size"):
        flash_decode_paged(q, kp, kp, pt, lens)
    assert kernels.launch_counts()["flash_decode_paged"] == 0


# ---------------------------------------------------------------------------
# The backward kernels
# ---------------------------------------------------------------------------

def _saved(a, b, kw):
    """The differentiated forward's launch: (out, rstd, preacts)."""
    ep = kw["epilogue"]
    pro = kw.get("prologue", Prologue())
    extra = {k: kw.get(k) for k in ("b2", "bias", "residual", "sin", "cos",
                                    "gamma")}
    return gemm_forward(a, b, ep, pro, scale=kw.get("scale"),
                        out_dtype=torch.bfloat16, save_preact=ep.gate, **extra)


@pytest.mark.parametrize("m,k,n", [(200, 264, 384), (4, 136, 256),
                                   (130, 64, 128)])
@pytest.mark.parametrize("chain", sorted(BWD_CHAINS))
def test_gemm_bwd_kernels_match_plain(dev, chain, m, k, n):
    """dA (with the norm transpose and dgamma) and dB (with dB2 and dbias)
    against their plain versions on the same g, preacts and rstd: bf16
    outputs within 2^-6 relative + 2% of their RMS; the fp32 dgamma within
    1e-3 relative + 1e-3 of its RMS (sums of the same products in another
    order); dbias, the same fp32 values summed, within 1e-4."""
    rng, a, b, kw = _gemm_operands(dev, chain, m, k, n)
    ep = kw["epilogue"]
    pro = kw.get("prologue", Prologue())
    _, rstd, preacts = _saved(a, b, kw)
    g = _rand(rng, (m, n), dev)
    ops = dict(epilogue=ep, prologue=pro, b2=kw.get("b2"),
               bias=kw.get("bias"), scale=kw.get("scale"), sin=kw.get("sin"),
               cos=kw.get("cos"), gamma=kw.get("gamma"), preacts=preacts)
    before = kernels.launch_counts()
    da, db, grads = gemm_fused_bwd(a, b, g, rstd=rstd, **ops)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["gemm_bwd_g"] == before["gemm_bwd_g"] + 1
    assert after["gemm_bwd_da"] == before["gemm_bwd_da"] + 1
    assert after["gemm_bwd_db"] == before["gemm_bwd_db"] + 1
    want_da, want_dgamma = gemm_bwd_da_ref(a, b, g, **ops)
    want_db, want_db2, want_dbias = gemm_bwd_db_ref(a, b, g, rstd=rstd, **ops)
    _close(da, want_da, 2 ** -6, 2e-2)
    _close(db, want_db, 2 ** -6, 2e-2)
    if ep.gate:
        _close(grads["b2"], want_db2, 2 ** -6, 2e-2)
    if ep.bias:
        _close(grads["bias"], want_dbias, 1e-4, 1e-4)
    if pro.norm != "none":
        _close(grads["gamma"], want_dgamma, 1e-3, 1e-3)
    assert torch.equal(grads["residual"], g)


def _bwd_ops(dev, chain, m, k, n):
    rng, a, b, kw = _gemm_operands(dev, chain, m, k, n)
    _, rstd, preacts = _saved(a, b, kw)
    ops = dict(epilogue=kw["epilogue"],
               prologue=kw.get("prologue", Prologue()), b2=kw.get("b2"),
               bias=kw.get("bias"), scale=kw.get("scale"), sin=kw.get("sin"),
               cos=kw.get("cos"), gamma=kw.get("gamma"), preacts=preacts)
    return a, b, _rand(rng, (m, n), dev), rstd, ops


def _check_bwd(run, a, b, g, rstd, ops):
    """One BwdLaunch's outputs against the plain versions, at the
    tolerances of test_gemm_bwd_kernels_match_plain."""
    run.operand_pass()
    da, dgamma = run.da()
    db, db2 = run.db()
    dbias = run.dbias()
    torch.cuda.synchronize()
    want_da, want_dgamma = gemm_bwd_da_ref(a, b, g, **ops)
    want_db, want_db2, want_dbias = gemm_bwd_db_ref(a, b, g, rstd=rstd, **ops)
    _close(da, want_da, 2 ** -6, 2e-2)
    _close(db, want_db, 2 ** -6, 2e-2)
    if db2 is not None:
        _close(db2, want_db2, 2 ** -6, 2e-2)
    if dbias is not None:
        _close(dbias, want_dbias, 1e-4, 1e-4)
    if dgamma is not None:
        _close(dgamma, want_dgamma, 1e-3, 1e-3)


@pytest.mark.parametrize("tile_n", [64, 128, 256])
@pytest.mark.parametrize("m,k", [(200, 264), (4, 136)])
@pytest.mark.parametrize("chain", sorted(BWD_CHAINS))
def test_gemm_bwd_every_tile_width(dev, chain, m, k, tile_n):
    """The mainloop at each tile width, with M, N and K across its tile
    and stage edges (N = 136 where the chain allows, else 384; K = 264
    crosses the 256-wide tile and the 64-deep stage; M = 4 and 200 leave
    most of a 128-row tile empty), against the plain versions."""
    n = 384 if BWD_CHAINS[chain][0].get("rope") else 136
    a, b, g, rstd, ops = _bwd_ops(dev, chain, m, k, n)
    run = gemm_backward.BwdLaunch(a, b, g, rstd=rstd, tile_n=tile_n, **ops)
    _check_bwd(run, a, b, g, rstd, ops)


@pytest.mark.parametrize("chain", sorted(BWD_CHAINS))
def test_gemm_bwd_operand_pass_matches_plain(dev, chain):
    """The operand pass against gemm_bwd_g_ref: gbar within one bf16 ulp
    (the same fp32 value, rounded once; exp and the rope products may
    differ in the last fp32 bit), gbar_t bit for bit gbar's transpose, a_t
    bit for bit the plain normalised A (the same fp32 products), the dbias
    partials within 1e-4."""
    m, k, n = 200, 264, 384
    a, b, g, rstd, ops = _bwd_ops(dev, chain, m, k, n)
    run = gemm_backward.BwdLaunch(a, b, g, rstd=rstd, **ops)
    run.operand_pass()
    torch.cuda.synchronize()
    want = gemm_bwd_g_ref(a, g, rstd=rstd,
                          **{x: v for x, v in ops.items() if x != "b2"})
    _close(run.gbar, want["gbar"], 2 ** -7, 1e-6)
    assert torch.equal(run.gbar_t[:, :m], run.gbar.T)
    assert torch.equal(run.a_t[:, :m].float(), want["a_t"])
    if want["dbias_part"] is not None:
        _close(run.dbias_part, want["dbias_part"], 1e-4, 1e-4)


@pytest.mark.parametrize("case", ["qk_rope", "v", "swiglu_up", "down"])
def test_gemm_bwd_at_the_training_shapes(dev, case):
    """The whole backward at llama-1b's training shapes (M = 4 x 1024
    tokens, d_model 2048, d_ff 8192, q|k 2560 wide, v 512), where the tile
    width is picked per launch, against the plain versions."""
    chain, k, n = {"qk_rope": ("rope_bias", 2048, 2560),
                   "v": ("identity_norm", 2048, 512),
                   "swiglu_up": ("silu_gate_norm", 2048, 8192),
                   "down": ("residual_scale", 8192, 2048)}[case]
    a, b, g, rstd, ops = _bwd_ops(dev, chain, 4096, k, n)
    run = gemm_backward.BwdLaunch(a, b, g, rstd=rstd, **ops)
    _check_bwd(run, a, b, g, rstd, ops)


@pytest.mark.parametrize("m,k,n", [(200, 264, 384), (4, 8192, 2048),
                                   (4096, 2048, 8192)])
@pytest.mark.parametrize("norm", [True, False])
def test_saved_preacts_are_the_rounded_accumulators(dev, norm, m, k, n):
    """The gated forward's saved preacts equal the raw fp32 products of the
    normed A, rounded to bf16: at most one bf16 rounding apart (one unit in
    the last place, up to 2^-7 relative), the products summed in another
    order; at ragged edges, at decode's split shape and at the training
    shape (M 4096), where K 2048-8192 terms summed in two orders may differ
    by more than a rounding near zero (_close_to_rounded_product)."""
    rng, a, b, kw = _gemm_operands(dev, "silu_gate_norm", m, k, n)
    if not norm:
        kw.pop("prologue"), kw.pop("gamma")
    _, rstd, (p1, p2) = _saved(a, b, kw)
    an = a
    if norm:
        an = (a.float() * rstd[:, None] * kw["gamma"].float()).to(a.dtype)
    for got, w in ((p1, b), (p2, kw["b2"])):
        if k > 264:
            _close_to_rounded_product(got, an, w)
            continue
        want = an.float() @ w.float()
        torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(),
                                   rtol=2 ** -7, atol=1e-6)


def test_gemm_autograd_launches_the_backward_kernels(dev):
    """On a CUDA tensor the backward of gemm_fused launches dA and dB once
    each; bwd_mode='reference' launches neither, and both give the same
    grads within the bf16 tolerance."""
    rng, a, b, kw = _gemm_operands(dev, "silu_gate_norm", 200, 264, 384)
    g = _rand(rng, (200, 384), dev)
    grads = {}
    for mode in ("kernel", "reference"):
        leaves = [t.detach().requires_grad_() for t in (a, b, kw["b2"],
                                                        kw["gamma"])]
        kw2 = dict(kw, b2=leaves[2], gamma=leaves[3])
        before = kernels.launch_counts()
        gemm_fused(leaves[0], leaves[1], bwd_mode=mode, **kw2).backward(g)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        n_bwd = tuple(after[x] - before[x] for x in ("gemm_bwd_g",
                                                       "gemm_bwd_da",
                                                       "gemm_bwd_db"))
        assert n_bwd == ((1, 1, 1) if mode == "kernel" else (0, 0, 0))
        grads[mode] = [t.grad for t in leaves]
    for k_, r_ in zip(grads["kernel"], grads["reference"]):
        _close(k_, r_, 5e-2, 5e-2)


def _attn_case(case):
    b, h, hkv, sq, skv, d = 2, 8, 2, 192, 192, 64
    kw = {"causal": True}
    if case == "ragged":
        sq = skv = 150
    elif case == "d128":
        d, sq, skv = 128, 130, 130
    elif case == "d128_window":
        d, kw["window"] = 128, 40
    elif case == "window":
        kw["window"] = 40
    elif case == "softcap":
        kw["softcap"] = 5.0
    elif case == "noncausal_cross":
        kw, sq, skv = {"causal": False}, 70, 130
    elif case == "mha":            # group 1
        h = hkv = 4
    elif case == "group8":
        h, hkv = 8, 1
    elif case == "train":          # llama-1b's training shape
        b, h, hkv, sq, skv = 4, 32, 8, 1024, 1024
    return b, h, hkv, sq, skv, d, kw


def _attn_bwd_inputs(case, dev, seed=6):
    """q, k, v, out, lse, dO of a case: q and k strided views of one packed
    q|k buffer where sq == skv, v a view of its own projection, dO the
    strided cotangent autograd hands over."""
    b, h, hkv, sq, skv, d, kw = _attn_case(case)
    rng = np.random.default_rng(seed)
    if sq == skv:
        qk = _rand(rng, (b, sq, (h + hkv) * d), dev)
        q = qk[..., :h * d].reshape(b, sq, h, d).transpose(1, 2)
        k = qk[..., h * d:].reshape(b, sq, hkv, d).transpose(1, 2)
    else:
        q = _rand(rng, (b, h, sq, d), dev)
        k = _rand(rng, (b, hkv, skv, d), dev)
    v = _rand(rng, (b, skv, hkv * d), dev).reshape(b, skv, hkv, d
                                                    ).transpose(1, 2)
    do = _rand(rng, (b, sq, h, d), dev).transpose(1, 2)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    return (q, k, v, out, lse, do), kw


@pytest.mark.parametrize("case", ["causal_gqa", "ragged", "d128",
                                  "d128_window", "window", "softcap",
                                  "noncausal_cross", "mha", "group8",
                                  "train"])
def test_flash_attention_bwd_kernel_matches_plain(dev, case):
    """The main kernel and the dq conversion against the plain version on
    the same q, k, v, out, lse and dO, q and k as strided views of one
    packed buffer and dO as the strided cotangent autograd hands over:
    within 2e-2 relative + 2% of each gradient's RMS (bf16 outputs, sums in
    another order). Groups 1, 4 and 8; "train" is llama-1b's training
    shape (B 4, H 32, Hkv 8, S 1024, d 64, causal)."""
    args, kw = _attn_bwd_inputs(case, dev)
    before = kernels.launch_counts()["flash_attention_bwd"]
    got = flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_bwd"] == before + 2
    want = flash_attention_bwd_ref(*args, **kw)
    for g_, w_ in zip(got, want):
        _close(g_, w_, 2e-2, 2e-2)


@pytest.mark.parametrize("case", ["causal_gqa", "d128_window"])
def test_flash_attention_bwd_dk_dv_are_reproducible(dev, case):
    """Two calls on the same inputs: dk and dv bit for bit (each block sums
    its key tile's pairs in a fixed order); dq, summed over key tiles by
    fp32 reduce-adds in an order that changes from run to run, within one
    bf16 rounding (2^-7 relative) + 0.1% of its RMS."""
    args, kw = _attn_bwd_inputs(case, dev)
    first = flash_attention_bwd(*args, **kw)
    second = flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[2], second[2])
    _close(first[0], second[0], 2 ** -7, 1e-3)


def test_flash_attention_bwd_refuses_a_view_tma_cannot_read(dev):
    """A q view that starts 2 bytes into its buffer is refused before any
    launch (the TMA needs a 16-byte aligned start)."""
    args, kw = _attn_bwd_inputs("causal_gqa", dev)
    q = args[0]
    b, h, sq, d = q.shape
    buf = torch.zeros((b, h, sq, d + 8), dtype=q.dtype, device=dev)
    shifted = buf[..., 1:d + 1]
    shifted.copy_(q)
    before = kernels.launch_counts()["flash_attention_bwd"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bwd(shifted, *args[1:], **kw)
    assert kernels.launch_counts()["flash_attention_bwd"] == before


def test_attention_autograd_launches_both_passes(dev):
    b, h, hkv, sq, skv, d, kw = _attn_case("causal_gqa")
    rng = np.random.default_rng(7)
    q, k, v = (_rand(rng, s, dev).requires_grad_() for s in
               ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    before = kernels.launch_counts()
    attention(q, k, v, **kw).backward(_rand(rng, (b, h, sq, d), dev))
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 2
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


# ---------------------------------------------------------------------------
# RoPE and the fused dropout + residual + layernorm
# ---------------------------------------------------------------------------

def _bf16_ulp(x):
    """One bf16 ulp of each entry of x (8 significant bits), as a tensor."""
    _, e = torch.frexp(x.abs().double())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64), e - 8)


def _rope_close(got, want):
    """fp32: within 1e-6 of the output's scale; bf16: one ulp."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.double(), want.double()
    if got.dtype == torch.float32:
        assert (g - w).abs().max() <= 1e-6 * w.abs().max()
    else:
        ulp = torch.maximum(_bf16_ulp(w), _bf16_ulp(g))
        assert ((g - w).abs() <= ulp).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("d,s", [(64, 256), (128, 200), (64, 131)])
def test_rope_kernel_matches_plain_on_strided_views(dev, d, s, dtype):
    """q and k as transposed views of a packed (B, S, (H + Hkv) x D)
    projection output, at S that are not multiples of the kernel's
    256-pair tile; the output is contiguous and counts one launch."""
    from repro_torch.kernels.rope import rope, rope_ref, rope_tables
    b, h, hkv = 2, 4, 2
    rng = np.random.default_rng(d + s)
    qk = _rand(rng, (b, s, (h + hkv) * d), dev, dtype=dtype)
    sin, cos = rope_tables(torch.arange(s, device=dev), d)
    for view, heads in ((qk[..., : h * d], h), (qk[..., h * d:], hkv)):
        x = view.reshape(b, s, heads, d).transpose(1, 2)
        before = kernels.launch_counts()["rope"]
        got = rope(x, sin, cos)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["rope"] == before + 1
        assert got.is_contiguous()
        _rope_close(got, rope_ref(x, sin, cos))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_rope_backward_is_the_kernel_with_minus_sin(dev, dtype):
    """Autograd through the op launches the kernel once more, rotating the
    cotangent by -theta: the plain version with -sin."""
    from repro_torch.kernels.rope import rope, rope_ref, rope_tables
    rng = np.random.default_rng(11)
    b, h, s, d = 2, 4, 160, 64
    x = _rand(rng, (b, s, h * d), dev, dtype=dtype).reshape(
        b, s, h, d).transpose(1, 2).detach().requires_grad_()
    g = _rand(rng, (b, h, s, d), dev, dtype=dtype)
    sin, cos = rope_tables(torch.arange(s, device=dev), d)
    before = kernels.launch_counts()["rope"]
    rope(x, sin, cos).backward(g)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rope"] == before + 2
    _rope_close(x.grad, rope_ref(g, -sin, cos))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [1024, 2048, 4096])
def test_fused_norm_keep_mask_is_bitwise_the_plain_one(dev, d, dtype):
    """With x = 1 and residual = 0 the new residual is the scale where a
    lane is kept and 0 where it is dropped: the kernel's hashed mask is bit
    for bit the plain version's, at several row offsets of the index."""
    from repro_torch.kernels.fused_norm import (dropout_keep_mask_ref,
                                                dropout_residual_layernorm)
    rows = 96
    ones = torch.ones(rows, d, device=dev, dtype=dtype)
    zeros = torch.zeros_like(ones)
    w = torch.ones(d, device=dev)
    for seed, p in ((7, 0.1), (-1, 0.5), (2 ** 31 - 1, 0.3)):
        _, new_res = dropout_residual_layernorm(ones, zeros, w, w, seed,
                                                dropout_p=p)
        torch.cuda.synchronize()
        keep = dropout_keep_mask_ref(seed, (rows, d), p, dev)
        assert torch.equal(new_res != 0, keep)
        assert torch.equal(new_res[keep].float(), torch.full(
            (int(keep.sum()),), 1.0 / (1.0 - p), device=dev).to(dtype).float())


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["w_fp32", "w_bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,d,p", [(256, 2048, 0.1), (37, 1000, 0.0),
                                      (64, 4096, 0.5)])
def test_fused_norm_kernel_matches_plain(dev, rows, d, p, dtype, wdtype):
    """Both outputs against the plain version: new_residual bit for bit
    (the same fp32 product and sum), normed within 1e-5 of its scale in
    fp32 (the row sums run in another order) and within that plus one ulp
    in bf16; a d that is no multiple of the block's 256 threads."""
    from repro_torch.kernels.fused_norm import (
        dropout_residual_layernorm, fused_dropout_residual_layernorm_ref)
    rng = np.random.default_rng(rows + d)
    x = _rand(rng, (rows, d), dev, dtype=dtype)
    r = _rand(rng, (rows, d), dev, dtype=dtype)
    w = (1 + 0.1 * _rand(rng, (d,), dev, dtype=torch.float32)).to(wdtype)
    b = _rand(rng, (d,), dev, 0.1, dtype=wdtype)
    before = kernels.launch_counts()["fused_norm"]
    out, new_res = dropout_residual_layernorm(x, r, w, b, 7, dropout_p=p)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_norm"] == before + 1
    want_out, want_res = fused_dropout_residual_layernorm_ref(
        x, r, w, b, 7, dropout_p=p)
    assert torch.equal(new_res, want_res)
    err = (out.double() - want_out.double()).abs()
    tol = 1e-5 * want_out.abs().max().item()
    if dtype == torch.bfloat16:
        tol = torch.maximum(_bf16_ulp(want_out.double()),
                            _bf16_ulp(out.double())) + tol
    assert (err <= tol).all(), err.max()
