"""The hand-written CUDA kernels against their plain versions, on the card,
at small shapes that reach the edges the model's main path does not: ragged
M, N and K tiles, a K that is no multiple of the K tile, head_dim 128,
for the forward GEMM every tile width and split of its mainloop (the
layernorm prologue with and without beta, silu, gelu and relu gated and
not among its chains), whisper-base's and bert-110m's main-path shapes,
layernorm rows with a large mean (which a one-pass variance would fail), its
MN-major weight tiles bit for bit through a permutation matrix, the decode
shapes (M 1-64 at K 8192) bitwise reproducible and row-independent,
windows, soft caps, ring wrap-around, empty rows and a ragged last split;
for the flash forward, groups 1-16, head_dim 128, windows, soft caps, cross
and ragged lengths and the training shape on the model's strided views (out
and lse bitwise across two calls, a view the TMA cannot read refused); for
the paged kernel, page sizes 16-128, null-page entries, a ragged row
tile of T > 1 query tokens, and bitwise equality with the contiguous kernel
over the gathered pages; for both decode kernels, sinks (fp32 and bf16),
two calls bitwise equal, CUDA-graph replays equal to eager calls (the
in-launch merge's tickets reset), one launch a call, a view the TMA cannot
read refused, the llama-1b main-path shapes and chatglm3-6b's (G 16 at
head_dim 128, T 1 and a 4-token verify), llama4-maverick's G 5 (verify rows
of 4 and 5 tokens bit for bit the serial steps) and G 20 (the many-row
body); the engines' decode steps
replayed from their CUDA graphs bit for bit the eager steps, with exact
launch counts; for RoPE, S 131 and 200 at
head_dim 64 and 128 on strided views, and a misaligned view (the scalar
branch) bit for bit the vector branch; for the fused norm, d 1000-4096,
the shared-memory branch at d 16384 and misaligned views; CUDA-graph
replays of both; for the backward kernels, every chain the GEMM
takes at ragged M, N and K, each tile width of the GEMM backward's
mainloop, its operand pass against the plain version, the llama-1b
training shapes, the forward's saved preacts against the rounded
accumulator, the flash backward at head_dim 128 with windows, soft caps,
strided views, groups 1-16 and the training shape (dk and dv bitwise across
two calls, a view the TMA cannot read refused), and autograd through both
ops; remat_policy 'dots' at llama-1b's width with exact launches, the
chunked cross entropy against the unchunked loss, a checkpoint of card
tensors restored bit for bit after an in-place step, and a decode step
through the forward GEMM's custom op replayed from its graph bit for bit;
the mixture of experts' two chains (the silu-gated up projection with no
prologue, the down projection with no epilogue) at mixtral-8x7b's smoke
and decode shapes, its experts against their plain versions, and a
mixtral-shaped engine's decode step past its window replayed bit for bit.

Marked ``cuda``: skipped on a machine without a CUDA card. On the card:

  python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

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
                                      gemm_fused_bwd, gemm_fused_ref,
                                      ln_rows_ref, rms_rows_ref)
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
# the backward also takes a bias without rope (dbias from the plain g), the
# layernorm prologue ("ln", "ln_beta": dgamma and dbeta) and every
# activation, gated or not (from the saved preacts)
BWD_CHAINS = dict(
    GEMM_CHAINS, bias=(dict(bias=True), False),
    ln_beta=(dict(), "ln_beta"),
    ln_beta_gelu=(dict(activation="gelu"), "ln_beta"),
    ln_relu=(dict(activation="relu"), "ln"),
    ln_geglu=(dict(activation="gelu", gate=True), "ln_beta"),
    ln_beta_residual=(dict(residual=True, scale=True), "ln_beta"),
    silu=(dict(activation="silu"), False),
    relu_gate=(dict(activation="relu", gate=True), False),
    bias_gelu_scale=(dict(bias=True, activation="gelu", scale=True), False))
# the forward also takes a rope head_dim under 16 (through its workspace),
# which its backward does not
FWD_CHAINS = dict(
    GEMM_CHAINS, rope_8=(dict(rope=True, head_dim=8), True),
    ln_beta=(dict(), "ln_beta"),
    ln_beta_gelu=(dict(activation="gelu"), "ln_beta"),
    ln_geglu=(dict(activation="gelu", gate=True), "ln"),
    gelu=(dict(activation="gelu"), False),
    relu=(dict(activation="relu"), False),
    silu=(dict(activation="silu"), False),
    relu_gate=(dict(activation="relu", gate=True), False),
    bias_gelu_residual=(dict(bias=True, activation="gelu", residual=True),
                        False))
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
        ln = norm in ("ln", "ln_beta")
        kw["prologue"] = Prologue(norm="layernorm" if ln else "rmsnorm",
                                  beta=norm == "ln_beta")
        kw["gamma"] = (1 + 0.1 * _rand(rng, (k,), dev)).to(torch.bfloat16)
        if norm == "ln_beta":
            kw["beta"] = _rand(rng, (k,), dev, 0.5)
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


def _normed(a, kw, stats):
    """A as the kernel's product reads it: normalised with the kernel's row
    statistics (rstd, or for layernorm mean and rstd), x rstd gamma or
    ((x - mean) rstd) gamma [+ beta] in fp32 rounded to bf16."""
    if "gamma" not in kw:
        return a
    x = a.float()
    if kw["prologue"].norm == "layernorm":
        x = x - stats[0][:, None]
        stats = stats[1]
    out = x * stats[:, None] * kw["gamma"].float()
    if kw.get("beta") is not None:
        out = out + kw["beta"].float()
    return out.to(a.dtype)


def _check_stats(a, kw, stats):
    """The kernel's row statistics against the plain row pass's: rstd (and
    the layernorm mean) within 1e-5 relative."""
    pro = kw["prologue"]
    if pro.norm == "layernorm":
        _, mean, rstd = ln_rows_ref(a, kw["gamma"], kw.get("beta"), pro.eps)
        assert stats.shape == (2, a.shape[0])
        torch.testing.assert_close(stats[0], mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(stats[1], rstd, rtol=1e-5, atol=0)
    else:
        _, rstd = rms_rows_ref(a, kw["gamma"], pro.eps)
        torch.testing.assert_close(stats, rstd, rtol=1e-5, atol=0)


def _fwd_launch(a, b, kw, plan=None, save_preact=False):
    """One launch of the forward kernel: (out, stats, preacts)."""
    ep = kw["epilogue"]
    pro = kw.get("prologue", Prologue())
    extra = {k: kw.get(k) for k in ("b2", "bias", "residual", "sin", "cos",
                                    "gamma", "beta")}
    return gemm_ops._launch(a, b, ep, scale=kw.get("scale"), eps=pro.eps,
                            layernorm=pro.norm == "layernorm",
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
    ragged, split 2 + 2 + 1; M = 200), against the plain version; an
    activation chain's saved preacts (one, or the gate's two) too."""
    n = 384 if FWD_CHAINS[chain][0].get("rope") else 136
    _, a, b, kw = _gemm_operands(dev, chain, 200, 264, n)
    save = gemm_ops.kernel_saves(kw["epilogue"]) > 0
    got, rstd, preacts = _fwd_launch(a, b, kw, (tile_n, splits), save)
    torch.cuda.synchronize()
    _close(got, gemm_fused_ref(a, b, **kw), 2 ** -6, 2e-2)
    for p, w in zip(preacts, (b, kw.get("b2"))):
        _close_to_rounded_product(p, _normed(a, kw, rstd), w)
    if "gamma" in kw:
        _check_stats(a, kw, rstd)


# whisper-base's and bert-110m's gemm_fused launches: (M, K, N, chain)
ENCDEC_SHAPES = {
    "whisper_enc_qk": (6000, 512, 1024, "ln_beta"),
    "whisper_enc_v": (6000, 512, 512, "ln_beta"),
    "whisper_enc_up_gelu": (6000, 512, 2048, "ln_beta_gelu"),
    "whisper_enc_down": (6000, 2048, 512, "residual_scale"),
    "whisper_decode_up_gelu": (4, 512, 2048, "ln_beta_gelu"),
    "whisper_decode_down": (4, 2048, 512, "residual_scale"),
    "whisper_geglu_up": (6000, 512, 2048, "ln_geglu"),
    "bert_qk": (4096, 768, 1536, "ln_beta"),
    "bert_up_gelu": (4096, 768, 3072, "ln_beta_gelu"),
    "bert_down": (4096, 3072, 768, "residual_scale"),
}


@pytest.mark.parametrize("case", sorted(ENCDEC_SHAPES))
def test_gemm_fused_at_the_encoder_shapes(dev, case):
    """The layernorm and gelu chains at the shapes whisper-base and bert run
    (decode's M 4 split over K), against the plain version, the row
    statistics too; two calls give the same bits."""
    m, k, n, chain = ENCDEC_SHAPES[case]
    _, a, b, kw = _gemm_operands(dev, chain, m, k, n)
    gate = kw["epilogue"].gate
    hd = kw["epilogue"].head_dim
    if m <= gemm_ops.TILE_ROWS:
        assert gemm_ops.plan_gemm(
            m, n, k, gemm_ops.sm_count(dev), gate=gate, head_dim=hd,
            act=kw["epilogue"].activation != "none")[1] > 1
    out, stats, _ = _fwd_launch(a, b, kw)
    again, _, _ = _fwd_launch(a, b, kw)
    torch.cuda.synchronize()
    _close(out, gemm_fused_ref(a, b, **kw), 2 ** -6, 2e-2)
    assert torch.equal(out, again)
    if "gamma" in kw:
        _check_stats(a, kw, stats)


@pytest.mark.parametrize("offset", [100.0, 1000.0])
@pytest.mark.parametrize("beta", [False, True])
def test_layernorm_rows_with_a_large_mean(dev, offset, beta):
    """Rows of x + offset (spread 1): the kernel's mean and rstd within
    1e-5 of the plain row pass and its output within the GEMM's tolerance;
    a one-pass E[x^2] - mean^2 in fp32 on the same rows is further than
    that from the plain rstd, so this would catch it."""
    rng = np.random.default_rng(int(offset) + beta)
    m, k, n = 256, 768, 512
    a = (_rand(rng, (m, k), dev).float() + offset).to(torch.bfloat16)
    b = _rand(rng, (k, n), dev, k ** -0.5)
    kw = {"epilogue": Epilogue(activation="gelu"),
          "prologue": Prologue(norm="layernorm", beta=beta),
          "gamma": (1 + 0.1 * _rand(rng, (k,), dev)).to(torch.bfloat16)}
    if beta:
        kw["beta"] = _rand(rng, (k,), dev, 0.5)
    out, stats, _ = _fwd_launch(a, b, kw)
    torch.cuda.synchronize()
    _check_stats(a, kw, stats)
    _close(out, gemm_fused_ref(a, b, **kw), 2 ** -6, 2e-2)
    x = a.float()
    one_pass = torch.rsqrt((x * x).mean(-1) - x.mean(-1) ** 2 + 1e-5)
    want = ln_rows_ref(a, kw["gamma"], kw.get("beta"), 1e-5)[2]
    assert ((one_pass - want).abs() > 1e-5 * want).any()


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


@pytest.mark.parametrize("m,k,n", [(4096, 4096, 2048), (1280, 3584, 4096),
                                   (200, 1000, 520)])
def test_gemm_fused_fp32_product_and_its_grads(dev, m, k, n):
    """``out_dtype=torch.float32`` (a row-parallel partial product, e.g. the
    split MLP's down at 2 and 4 ranks): the raw fp32 accumulators at one
    split, within fp32 rounding of the plain fp32 product (two calls the
    same bits), one launch; its backward through the bf16 transpose
    kernels from the rounded cotangent equals the bf16-output product's."""
    rng = np.random.default_rng(3)
    a = _rand(rng, (m, k), dev).requires_grad_(True)
    b = _rand(rng, (k, n), dev, std=k ** -0.5).requires_grad_(True)
    kernels.reset_launch_counts()
    out = gemm_fused(a, b, out_dtype=torch.float32)
    again = gemm_fused(a.detach(), b.detach(), out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert kernels.launch_counts()["gemm_fused"] == 2
    assert torch.equal(out, again)
    want = a.detach().float() @ b.detach().float()
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    g = _rand(rng, (m, n), dev)
    da, db = torch.autograd.grad(out, (a, b), g.float())
    a2, b2 = (t.detach().requires_grad_(True) for t in (a, b))
    da2, db2 = torch.autograd.grad(gemm_fused(a2, b2), (a2, b2), g)
    assert torch.equal(da, da2) and torch.equal(db, db2)


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


@pytest.mark.parametrize("case", ["causal_gqa", "ragged", "d128",
                                  "d128_window", "window", "softcap",
                                  "noncausal_cross", "mha", "group8",
                                  "group16_d128", "train"])
def test_flash_attention_fwd_kernel_matches_plain(dev, case):
    """The forward kernel against the plain version on q and k as strided
    views of one packed q|k buffer (where sq == skv) and v as a view of its
    own projection, as the model passes them: out within 2e-2 relative + 2%
    of its RMS (bf16, p rounded before p @ v, sums in another order), lse
    within 1e-4. Groups 1, 4, 8 and 16 (chatglm3-6b's, at d 128); "train"
    is llama-1b's training shape (B 4, H 32, Hkv 8, S 1024, d 64, causal).
    One launch a call."""
    q, k, v, kw = _attn_fwd_inputs(case, dev)
    before = kernels.launch_counts()["flash_attention_fwd"]
    out, lse = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_fwd"] == before + 1
    want, want_lse = flash_attention_fwd_ref(q, k, v, **kw)
    _close(out, want, 2e-2, 2e-2)
    _close(lse, want_lse, 1e-4, 1e-4)


@pytest.mark.parametrize("case", ["causal_gqa", "d128_window", "train"])
def test_flash_attention_fwd_is_reproducible(dev, case):
    """Two calls on the same inputs give out and lse bit for bit: the
    forward sums each row in a fixed order and has no atomics."""
    q, k, v, kw = _attn_fwd_inputs(case, dev)
    first = flash_attention_fwd(q, k, v, **kw)
    second = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_flash_attention_fwd_refuses_a_view_tma_cannot_read(dev):
    """A q view that starts 2 bytes into its buffer is refused before any
    launch (the TMA needs a 16-byte aligned start)."""
    q, k, v, kw = _attn_fwd_inputs("causal_gqa", dev)
    b, h, sq, d = q.shape
    buf = torch.zeros((b, h, sq, d + 8), dtype=q.dtype, device=dev)
    shifted = buf[..., 1:d + 1]
    shifted.copy_(q)
    before = kernels.launch_counts()["flash_attention_fwd"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_fwd(shifted, k, v, **kw)
    assert kernels.launch_counts()["flash_attention_fwd"] == before


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


def _paged_inputs(rng, dev, b, hkv, rows, d, page, mp, lengths):
    """A pool of b * mp + 1 pages, each row's needed pages in a seeded
    order and the rest of its table on the null page 0."""
    n_pages = b * mp + 1
    kp = _rand(rng, (n_pages, hkv, page, d), dev)
    vp = _rand(rng, (n_pages, hkv, page, d), dev)
    q = _rand(rng, (b, hkv, rows, d), dev)
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, mp), np.int32)
    for i, n in enumerate(lengths):
        need = -(-n // page)
        table[i, :need] = perm[i * mp:i * mp + need]
    pt = torch.from_numpy(table).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, pt, lens


# (kernel, q rows a kv head, T, key positions (slots, or 64-key pages
# times 64), lengths): a contiguous decode with a ring wrap and an empty
# row, a paged decode, a verify step of 4 tokens and a 32-token chunk, each
# short (one split: the output from registers) and long (several splits
# merged by the last block of each unit through the tickets)
DECODE_CALLS = {
    "contiguous": ("flash_decode", 4, 1, 296, [0, 400, 37]),
    "paged": ("flash_decode_paged", 4, 1, 384, [0, 65, 300]),
    "paged_verify_t4": ("flash_decode_paged", 16, 4, 384, [4, 68, 300]),
    "paged_chunk_t32": ("flash_decode_paged", 128, 32, 384, [32, 100, 300]),
    "contiguous_long": ("flash_decode", 4, 1, 2048, [0, 2100, 1500]),
    "paged_long": ("flash_decode_paged", 4, 1, 1536, [0, 700, 1536]),
    "paged_verify_long": ("flash_decode_paged", 16, 4, 1536, [4, 900, 1500]),
    "paged_chunk_long": ("flash_decode_paged", 128, 32, 1536,
                         [32, 1000, 1400]),
}


def _decode_call(case, dev, *, sinks=None):
    """(kernel(**kw), plain(**kw)) of one DECODE_CALLS case, and its rows."""
    name, rows, t, keys, lengths = DECODE_CALLS[case]
    b, hkv, d = 3, 2, 64
    rng = np.random.default_rng(11)
    if name == "flash_decode":
        slots = keys
        q = _rand(rng, (b, hkv, rows, d), dev)
        k = _rand(rng, (b, hkv, slots, d), dev)
        v = _rand(rng, (b, hkv, slots, d), dev)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)

        def kernel(**kw):
            return flash_decode(q, k, v, lens, **kw)

        def plain(sinks=None, **kw):
            o, m, l = decode_partials_ref(q, k, v, lens, scale=d ** -0.5,
                                          **kw)
            sk = None if sinks is None else sinks.float().reshape(hkv, 1,
                                                                  rows)
            return combine_splits(o, m, l, sinks=sk).to(q.dtype)
        return kernel, plain, hkv * rows
    q, kp, vp, pt, lens = _paged_inputs(rng, dev, b, hkv, rows, d, 64,
                                        keys // 64, lengths)

    def kernel(**kw):
        return flash_decode_paged(q, kp, vp, pt, lens, q_tokens=t, **kw)

    def plain(sinks=None, **kw):
        o, m, l = decode_partials_paged_ref(q, kp, vp, pt, lens,
                                            scale=d ** -0.5, q_tokens=t, **kw)
        sk = None if sinks is None else sinks.float().reshape(hkv, 1, rows)
        return combine_splits(o, m, l, sinks=sk).to(q.dtype)
    return kernel, plain, hkv * rows


@pytest.mark.parametrize("sink_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DECODE_CALLS))
def test_decode_kernels_with_sinks(dev, case, sink_dtype):
    """Sinks join the merge once, re-anchoring the max: against the plain
    partials and combine_splits; an empty row's mass lands on the sink and
    comes out as zeros."""
    kernel, plain, n = _decode_call(case, dev)
    rng = np.random.default_rng(12)
    sinks = _rand(rng, (n,), dev, std=2.0, dtype=getattr(torch, sink_dtype))
    for kw in ({}, {"window": 40}, {"softcap": 5.0}):
        got = kernel(sinks=sinks, **kw)
        want = plain(sinks=sinks, **kw)
        torch.cuda.synchronize()
        _close(got, want, 2e-2, 2e-2)
        if DECODE_CALLS[case][4][0] == 0:
            assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("case", sorted(DECODE_CALLS))
def test_decode_kernels_are_reproducible_and_count_one_launch(dev, case):
    """Two calls give the same bits (the merge reads the splits in index
    order), and each call counts one launch."""
    kernel, plain, _ = _decode_call(case, dev)
    name = DECODE_CALLS[case][0]
    before = kernels.launch_counts()[name]
    a = kernel(window=100)
    b = kernel(window=100)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 2
    assert torch.equal(a, b)
    _close(a, plain(window=100), 2e-2, 2e-2)


@pytest.mark.parametrize("case", sorted(DECODE_CALLS))
def test_decode_kernels_replay_from_a_cuda_graph(dev, case):
    """Replays of a captured call equal the eager call's bits: the last
    block of each unit leaves its ticket at 0 for the next replay."""
    kernel, _, _ = _decode_call(case, dev)
    want = kernel()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernel()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert torch.equal(kernel(), want)


def test_flash_decode_paged_equals_contiguous_bitwise_over_splits(dev):
    """As above over 24 pages (three splits a unit, merged by the last
    block): the same plan, tiles and merge give the same bits."""
    b, hkv, g, d, page, mp = 3, 8, 4, 64, 64, 24
    rng = np.random.default_rng(9)
    q, kp, vp, pt, lens = _paged_inputs(rng, dev, b, hkv, g, d, page, mp,
                                        [0, 700, 1536])
    for window in (None, 300):
        paged = flash_decode_paged(q, kp, vp, pt, lens, window=window)
        dense = flash_decode(q, gather_pages(kp, pt).contiguous(),
                             gather_pages(vp, pt).contiguous(), lens,
                             window=window)
        torch.cuda.synchronize()
        assert torch.equal(paged, dense)


def test_decode_kernels_refuse_a_view_tma_cannot_read(dev):
    """A cache or pool that starts 2 bytes into its buffer is refused before
    any launch (the TMA needs a 16-byte aligned start)."""
    kernels.reset_launch_counts()
    q = torch.zeros((1, 2, 4, 64), dtype=torch.bfloat16, device=dev)
    lens = torch.ones((1,), dtype=torch.int32, device=dev)
    buf = torch.zeros(2 * 128 * 64 + 1, dtype=torch.bfloat16, device=dev)
    shifted = buf[1:].view(1, 2, 128, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_decode(q, shifted, shifted, lens)
    pool = buf[1:].view(2, 2, 64, 64)
    pt = torch.ones((1, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_decode_paged(q, pool, pool, pt, lens)
    assert kernels.launch_counts()["flash_decode"] == 0
    assert kernels.launch_counts()["flash_decode_paged"] == 0


@pytest.mark.parametrize("shape", ["decode_step_b4_s296", "paged_decode_b8",
                                   "chunk_b1_t128", "verify_b8_t4"])
def test_decode_kernels_at_the_main_path_shapes(dev, shape):
    """llama-1b's shapes (Hkv 8, G 4, head_dim 64): the served decode step
    over a 296-slot cache, and the paged engine's decode, 128-token chunk
    and 4-token verify over 8 pages of 64, against the plain versions."""
    rng = np.random.default_rng(13)
    hkv, g, d = 8, 4, 64
    if shape == "decode_step_b4_s296":
        q = _rand(rng, (4, hkv, g, d), dev)
        k = _rand(rng, (4, hkv, 296, d), dev)
        v = _rand(rng, (4, hkv, 296, d), dev)
        lens = torch.tensor([287] * 4, dtype=torch.int32, device=dev)
        got = flash_decode(q, k, v, lens)
        o, m, l = decode_partials_ref(q, k, v, lens, scale=d ** -0.5)
    else:
        b, t, lengths = {"paged_decode_b8": (8, 1, [0, 1, 64, 65, 130, 257,
                                                    400, 512]),
                         "chunk_b1_t128": (1, 128, [320]),
                         "verify_b8_t4": (8, 4, [4, 64, 68, 130, 257, 300,
                                                 400, 512])}[shape]
        q, kp, vp, pt, lens = _paged_inputs(rng, dev, b, hkv, g * t, d, 64,
                                            8, lengths)
        got = flash_decode_paged(q, kp, vp, pt, lens, q_tokens=t)
        o, m, l = decode_partials_paged_ref(q, kp, vp, pt, lens,
                                            scale=d ** -0.5, q_tokens=t)
    want = combine_splits(o, m, l).to(q.dtype)
    torch.cuda.synchronize()
    _close(got, want, 2e-2, 2e-2)


@pytest.mark.parametrize("shape", ["decode_step_b4", "paged_decode_b8",
                                   "verify_b8_t4"])
def test_decode_kernels_at_chatglm3_shapes(dev, shape):
    """chatglm3-6b's decode shapes (Hkv 2, G 16, head_dim 128): 16 q rows a
    kv head at T 1 (the few-row body's limit, FEW_ROWS) and 64 at the
    4-token verify (two ROW_TILE units), against the plain versions."""
    rng = np.random.default_rng(14)
    hkv, g, d = 2, 16, 128
    if shape == "decode_step_b4":
        q = _rand(rng, (4, hkv, g, d), dev)
        k = _rand(rng, (4, hkv, 296, d), dev)
        v = _rand(rng, (4, hkv, 296, d), dev)
        lens = torch.tensor([287, 1, 130, 296], dtype=torch.int32,
                            device=dev)
        got = flash_decode(q, k, v, lens)
        o, m, l = decode_partials_ref(q, k, v, lens, scale=d ** -0.5)
    else:
        t = 4 if shape == "verify_b8_t4" else 1
        lengths = [4, 64, 68, 130, 257, 300, 400, 512] if t == 4 else \
            [0, 1, 64, 65, 130, 257, 400, 512]
        q, kp, vp, pt, lens = _paged_inputs(rng, dev, 8, hkv, g * t, d, 64,
                                            8, lengths)
        got = flash_decode_paged(q, kp, vp, pt, lens, q_tokens=t)
        o, m, l = decode_partials_paged_ref(q, kp, vp, pt, lens,
                                            scale=d ** -0.5, q_tokens=t)
    want = combine_splits(o, m, l).to(q.dtype)
    torch.cuda.synchronize()
    _close(got, want, 2e-2, 2e-2)


# ---------------------------------------------------------------------------
# The engines' decode steps replayed from CUDA graphs
# ---------------------------------------------------------------------------

def _small_model(dev):
    """A 2-layer llama at head_dim 64 (the kernels' width), seeded."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("llama-1b"), num_layers=2,
                              d_model=256, num_heads=4, num_kv_heads=2,
                              d_ff=512, vocab_size=512)
    model = build_model(cfg, mode="kernel", device=dev)
    return model, model.init(seed=3)


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


@pytest.mark.parametrize("engine", ["fixed", "paged"])
def test_engine_decode_step_replays_bitwise_the_eager_step(dev, engine):
    """After serving, a decode bucket holds a captured graph. Replayed on
    new inputs from a saved cache state it gives the eager step's logits
    and cache bit for bit, and adds to the launch counters exactly what the
    eager step launches."""
    from repro_torch.serve import Engine, PagedEngine, Request
    model, params = _small_model(dev)
    rng = np.random.default_rng(15)
    with torch.inference_mode():
        if engine == "fixed":
            eng = Engine(model, params, max_len=64)
            eng.generate(rng.integers(0, 512, (2, 20)), 6)
            entry = eng._buckets[("decode", 2)]
            inputs = dict(token=torch.tensor([[5], [7]], device=dev), pos=25)
            cache = entry.cache

            def eager(c):
                return model.decode_step(params, inputs["token"], c,
                                         inputs["pos"])[1]
        else:
            eng = PagedEngine(model, params, batch_slots=2, page_size=64,
                              max_pages_per_seq=2)
            for u in range(2):
                eng.submit(Request(u, rng.integers(0, 512, 30 + 9 * u)
                                   .astype(np.int32), 6))
            eng.run()
            (key, entry), = [(k, e) for k, e in eng._buckets.items()
                             if k == (2, 1)]
            table = torch.tensor([[1], [2]], dtype=torch.int32, device=dev)
            inputs = dict(token=torch.tensor([[5], [7]], device=dev),
                          page_table=table,
                          lengths=torch.tensor([33, 41], dtype=torch.int32,
                                               device=dev))
            cache = eng.cache

            def eager(c):
                return model.decode_step_paged(
                    params, inputs["token"], c, inputs["page_table"],
                    inputs["lengths"])[1]
        assert entry.graph is not None
        saved = _clone(cache)
        kernels.reset_launch_counts()
        replayed = entry(**inputs).clone()
        torch.cuda.synchronize()
        replay_counts = kernels.launch_counts()
        after_replay = _clone(cache)
        kernels.reset_launch_counts()
        want = eager(saved)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == replay_counts
        assert replay_counts["gemm_fused"] == 2 * model.cfg.num_layers
        assert torch.equal(replayed, want)
        for k in saved:
            assert torch.equal(after_replay[k], saved[k])


# ---------------------------------------------------------------------------
# The mixture of experts (mixtral-8x7b)
# ---------------------------------------------------------------------------

# an expert's two launches: (M, K, N, gated): mixtral's smoke width (d 64,
# d_ff 128) and its published one at a decode step's M 4 (split over K)
EXPERT_CHAINS = {"smoke_up": (24, 64, 128, True),
                 "smoke_down": (24, 128, 64, False),
                 "decode_up": (4, 4096, 14336, True),
                 "decode_down": (4, 14336, 4096, False)}


@pytest.mark.parametrize("case", sorted(EXPERT_CHAINS))
def test_gemm_fused_expert_chains_match_plain(dev, case):
    """The MoE's chains as ``models/moe.py`` calls them: the dual-output
    silu-gated up projection with no prologue and the down projection with
    no epilogue, one launch each, against the plain version; two calls
    bitwise equal."""
    m, k, n, gated = EXPERT_CHAINS[case]
    rng = np.random.default_rng(m + k)
    a, b = _rand(rng, (m, k), dev), _rand(rng, (k, n), dev, k ** -0.5)
    kw = {}
    if gated:
        kw = dict(epilogue=Epilogue(activation="silu", gate=True),
                  b2=_rand(rng, (k, n), dev, k ** -0.5))
    before = kernels.launch_counts()["gemm_fused"]
    got = gemm_fused(a, b, **kw)
    again = gemm_fused(a, b, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gemm_fused"] == before + 2
    assert torch.equal(got, again)
    _close(got, gemm_fused_ref(a, b, **kw), 2 ** -6, 2e-2)


def _moe_model(dev):
    """mixtral-8x7b's smoke config (4 experts top-2, window 32) at head_dim
    64 (the decode kernels' width), seeded."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True),
                              d_model=256, num_heads=4, num_kv_heads=2,
                              head_dim=64)
    model = build_model(cfg, mode="kernel", device=dev)
    return model, model.init(seed=5)


def test_moe_experts_match_their_plain_versions(dev):
    """Kernel mode's experts (2 launches an expert) on the card against the
    same call on CPU copies, which runs the plain versions of the
    launches."""
    from repro_torch.models import moe
    from repro_torch.models.common import tree_map
    model, params = _moe_model(dev)
    p = tree_map(lambda t: t[0], params["blocks"]["moe"])
    x = _rand(np.random.default_rng(8), (40, model.cfg.d_model), dev)
    kernels.reset_launch_counts()
    got = moe._expert_ffn_fused(model.cfg, p, x)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gemm_fused"] == \
        2 * model.cfg.moe.num_experts
    want = moe._expert_ffn_fused(model.cfg, tree_map(lambda t: t.cpu(), p),
                                 x.cpu())
    _close(got.cpu(), want, 2 ** -6, 2e-2)


@pytest.mark.parametrize("engine", ["fixed", "paged"])
def test_moe_decode_step_replays_bitwise_the_eager_step(dev, engine):
    """A mixtral-shaped model served past its 32-token window (a 32-slot
    ring; every page kept and masked by the window): the decode bucket's
    captured MoE step, replayed on new inputs from a saved cache state,
    gives the eager step's logits and cache bit for bit and launches 2 per
    expert and layer, as the eager step does."""
    from repro_torch.serve import Engine, PagedEngine, Request
    model, params = _moe_model(dev)
    rng = np.random.default_rng(16)
    with torch.inference_mode():
        if engine == "fixed":
            eng = Engine(model, params, max_len=64)
            eng.generate(rng.integers(0, 512, (2, 40)), 6)
            entry = eng._buckets[("decode", 2)]
            assert entry.cache["k"].shape[3] == model.cfg.attn_window
            inputs = dict(token=torch.tensor([[5], [7]], device=dev), pos=45)
            cache = entry.cache

            def eager(c):
                return model.decode_step(params, inputs["token"], c,
                                         inputs["pos"])[1]
        else:
            eng = PagedEngine(model, params, batch_slots=2, page_size=64,
                              max_pages_per_seq=2)
            for u in range(2):
                eng.submit(Request(u, rng.integers(0, 512, 40 + 9 * u)
                                   .astype(np.int32), 6))
            eng.run()
            (key, entry), = [(k, e) for k, e in eng._buckets.items()
                             if k == (2, 1)]
            table = torch.tensor([[1], [2]], dtype=torch.int32, device=dev)
            inputs = dict(token=torch.tensor([[5], [7]], device=dev),
                          page_table=table,
                          lengths=torch.tensor([45, 54], dtype=torch.int32,
                                               device=dev))
            cache = eng.cache

            def eager(c):
                return model.decode_step_paged(
                    params, inputs["token"], c, inputs["page_table"],
                    inputs["lengths"])[1]
        assert entry.graph is not None
        saved = _clone(cache)
        kernels.reset_launch_counts()
        replayed = entry(**inputs).clone()
        torch.cuda.synchronize()
        replay_counts = kernels.launch_counts()
        after_replay = _clone(cache)
        kernels.reset_launch_counts()
        want = eager(saved)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == replay_counts
        assert replay_counts["gemm_fused"] == \
            2 * model.cfg.moe.num_experts * model.cfg.num_layers
        assert torch.equal(replayed, want)
        for k in saved:
            assert torch.equal(after_replay[k], saved[k])


# ---------------------------------------------------------------------------
# Speculative decoding: verify rows, the verify graph, the self-draft engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pages,lengths", [
    (8, [4, 64, 68, 130, 257, 300, 400, 512]),
    (16, [900, 930, 960, 980, 1000, 1010, 1020, 1024])],
    ids=["one_split", "two_splits"])
def test_verify_rows_equal_serial_steps_bitwise(dev, pages, lengths):
    """llama-1b's verify shape (8 slots, Hkv 8, G 4, head_dim 64, 64-token
    pages, T 4): row t of the T = 4 call is the T = 1 call of that row's
    queries at length L - 3 + t bit for bit, over one split and over two
    merged in the launch (the split plan sees G x T = 16 rows a unit at
    both T, so it is the same plan; the T = 4 unit reads the tiles of its
    last token, which the earlier rows cannot see)."""
    rng = np.random.default_rng(31)
    b, hkv, g, d, t = 8, 8, 4, 64, 4
    q, kp, vp, pt, lens = _paged_inputs(rng, dev, b, hkv, g * t, d, 64,
                                        pages, lengths)
    # scores of a few units: a running max in log2 units does not round
    # back exactly, so a tile the row cannot see must rescale it by 1
    q = q * 8
    got = flash_decode_paged(q, kp, vp, pt, lens, q_tokens=t)
    got = got.view(b, hkv, g, t, d)
    for i in range(t):
        one = flash_decode_paged(
            q.view(b, hkv, g, t, d)[:, :, :, i].contiguous(), kp, vp, pt,
            lens - (t - 1) + i)
        torch.cuda.synchronize()
        assert torch.equal(got[:, :, :, i], one)


@pytest.mark.parametrize("t", [4, 5])
def test_verify_rows_equal_serial_steps_bitwise_at_gqa_group_5(dev, t):
    """llama4-maverick's verify shape (8 slots, Hkv 8, G 5, head_dim 128,
    64-token pages, one split): 20 and 25 rows a kv head take the few-row
    body of the 5-row serial step (the body goes by the group, not by G x
    T), so row t of the T-token call is the T = 1 call at length L - T + 1
    + t bit for bit."""
    rng = np.random.default_rng(32)
    b, hkv, g, d = 8, 8, 5, 128
    lengths = [4, 64, 68, 130, 257, 300, 400, 512]
    q, kp, vp, pt, lens = _paged_inputs(rng, dev, b, hkv, g * t, d, 64, 8,
                                        lengths)
    q = q * 8
    got = flash_decode_paged(q, kp, vp, pt, lens, q_tokens=t)
    got = got.view(b, hkv, g, t, d)
    for i in range(t):
        one = flash_decode_paged(
            q.view(b, hkv, g, t, d)[:, :, :, i].contiguous(), kp, vp, pt,
            lens - (t - 1) + i)
        torch.cuda.synchronize()
        assert torch.equal(got[:, :, :, i], one)


@pytest.mark.parametrize("g,t", [(5, 1), (5, 4), (5, 128), (20, 1), (20, 4)])
def test_decode_kernels_by_group(dev, g, t):
    """Both decode kernels at G 5 (llama4-maverick's 40 heads over 8; the
    few-row body, 16-row units that start inside a group at T > 1) and at
    G 20 (the many-row body, 32-row units), head_dim 128, against the
    plain versions; the contiguous kernel at T 1."""
    rng = np.random.default_rng(33)
    b, hkv, d = 3, 2, 128
    lengths = [t, 200, 500]
    q, kp, vp, pt, lens = _paged_inputs(rng, dev, b, hkv, g * t, d, 64, 8,
                                        lengths)
    got = flash_decode_paged(q, kp, vp, pt, lens, q_tokens=t)
    o, m, l = decode_partials_paged_ref(q, kp, vp, pt, lens, scale=d ** -0.5,
                                        q_tokens=t)
    torch.cuda.synchronize()
    _close(got, combine_splits(o, m, l).to(q.dtype), 2e-2, 2e-2)
    if t == 1:
        k = gather_pages(kp, pt).contiguous()
        v = gather_pages(vp, pt).contiguous()
        got = flash_decode(q, k, v, lens)
        o, m, l = decode_partials_ref(q, k, v, lens, scale=d ** -0.5)
        torch.cuda.synchronize()
        _close(got, combine_splits(o, m, l).to(q.dtype), 2e-2, 2e-2)


def test_verify_graph_replays_bitwise_its_eager_step(dev):
    """After a self-draft engine serves, its ("verify", 1) bucket holds a
    captured T = 4 step and its ("draft_decode", 1) bucket a T = 1 step
    over the draft's pools. Each, replayed on new inputs from saved pools,
    gives the eager step's logits and pools bit for bit and adds to the
    launch counters what the eager step launches."""
    from repro_torch.serve import PagedEngine, Request
    model, params = _small_model(dev)
    rng = np.random.default_rng(16)
    eng = PagedEngine(model, params, batch_slots=2, page_size=64,
                      max_pages_per_seq=2, draft_model=model,
                      draft_params=params, spec_tokens=4)
    with torch.inference_mode():
        for u in range(2):
            eng.submit(Request(u, rng.integers(0, 512, 30 + 9 * u)
                               .astype(np.int32), 9))
        eng.run()
        assert eng.report()["speculative"]["rounds"] > 0
        table = torch.tensor([[1], [2]], dtype=torch.int32, device=dev)
        lengths = torch.tensor([33, 41], dtype=torch.int32, device=dev)
        for key, pools, t in ((("verify", 1), eng.cache, 4),
                              (("draft_decode", 1), eng.draft_cache, 1)):
            entry = eng._buckets[key]
            assert entry.graph is not None
            token = torch.arange(2 * t, device=dev).reshape(2, t) * 7 + 5
            saved = _clone(pools)
            kernels.reset_launch_counts()
            replayed = entry(token=token, page_table=table,
                             lengths=lengths).clone()
            torch.cuda.synchronize()
            replay_counts = kernels.launch_counts()
            after = _clone(pools)
            kernels.reset_launch_counts()
            want = model.decode_step_paged(params, token, saved, table,
                                           lengths)[1]
            torch.cuda.synchronize()
            assert kernels.launch_counts() == replay_counts
            assert replay_counts["gemm_fused"] == 2 * model.cfg.num_layers
            assert replay_counts["flash_decode_paged"] == model.cfg.num_layers
            assert tuple(replayed.shape) == ((2, 4, 512) if t == 4
                                             else (2, 512))
            assert torch.equal(replayed, want)
            for k in saved:
                assert torch.equal(after[k], saved[k])


def test_spec_self_draft_engine_equals_the_plain_engine(dev):
    """A 2-layer llama at llama-1b's width (d_model 2048, 32/8 heads,
    d_ff 8192, the 128,256-word vocabulary), weights at std fan_in^-1/2:
    the self-draft engine (k 4) serves the plain PagedEngine's greedy
    streams, accepts every proposal and emits 4 tokens a round, its
    launches 2 fused GEMMs and one paged launch a layer for each of a
    round's 4 draft steps and its verify."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import PagedEngine, Request
    cfg = dataclasses.replace(get_config("llama-1b"), num_layers=2)
    model = build_model(cfg, mode="kernel", device=dev)
    params = model.init(seed=5)
    params["embed"] = params["embed"] * cfg.d_model ** -0.5 / params[
        "embed"].float().std()
    for leaf in ("attn", "mlp"):
        for name, w in params["blocks"][leaf].items():
            if w.dim() == 3:
                params["blocks"][leaf][name] = w * (
                    w.shape[-2] ** -0.5 / w.float().std())
    rng = np.random.default_rng(17)
    reqs = [Request(u, rng.integers(0, cfg.vocab_size, 40 + 17 * u)
                    .astype(np.int32), 24) for u in range(4)]

    def serve(eng):
        for r in reqs:
            eng.submit(r)
        with torch.inference_mode():
            kernels.reset_launch_counts()
            out = eng.run()
            torch.cuda.synchronize()
        return out, kernels.launch_counts()

    kw = dict(batch_slots=4, page_size=64, max_pages_per_seq=2)
    want, _ = serve(PagedEngine(model, params, **kw))
    eng = PagedEngine(model, params, draft_model=model, draft_params=params,
                      spec_tokens=4, **kw)
    got, counts = serve(eng)
    for r in reqs:
        np.testing.assert_array_equal(got[r.uid], want[r.uid])
    spec = eng.report()["speculative"]
    assert spec["accept_rate"] == 1.0 and spec["mean_tokens_per_round"] == 4
    layers, rounds = cfg.num_layers, spec["rounds"]
    assert counts["gemm_fused"] == 2 * layers * (4 * eng.prefills
                                                 + 5 * rounds)
    assert counts["flash_decode_paged"] == 5 * layers * rounds
    assert counts["flash_attention_fwd"] == 2 * layers * eng.prefills


def _nested_clone(cache):
    return {part: _clone(t) for part, t in cache.items()}


def test_whisper_engine_replays_bitwise_and_launches_exactly(dev):
    """A small whisper (2 + 2 layers, head_dim 64, 100 encoder frames: a
    ragged last key tile and split) served through Engine.generate with
    the encoder's input in extra_batch: the prefill launches 4 gemm_fused
    and 1 flash forward per encoder layer and 4 gemm_fused and 2 flash
    forwards per decoder layer, a step 2 gemm_fused and 2 flash_decode per
    decoder layer; a replayed step gives the eager step's logits and self
    cache bit for bit and leaves the cross cache as it was."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine
    cfg = dataclasses.replace(get_config("whisper-base", smoke=True),
                              d_model=256, num_heads=4, num_kv_heads=4,
                              head_dim=64, d_ff=512, encoder_seq=100)
    model = build_model(cfg, mode="kernel", device=dev)
    params = model.init(seed=3)
    rng = np.random.default_rng(16)
    emb = torch.from_numpy(rng.standard_normal((2, 100, 256)).astype(
        np.float32)).to(dev, torch.bfloat16)
    eng = Engine(model, params, max_len=64)
    prompts = rng.integers(0, 512, (2, 20))
    with torch.inference_mode():
        eng.generate(prompts, 6, extra_batch={"encoder_embeds": emb})
        kernels.reset_launch_counts()
        eng.generate(prompts, 6, extra_batch={"encoder_embeds": emb})
        counts = kernels.launch_counts()
        enc, dec, steps = cfg.encoder_layers, cfg.num_layers, 5
        assert counts["gemm_fused"] == 4 * enc + 4 * dec + 2 * dec * steps
        assert counts["flash_attention_fwd"] == enc + 2 * dec
        assert counts["flash_decode"] == 2 * dec * steps
        entry = eng._buckets[("decode", 2)]
        assert entry.graph is not None
        token = torch.tensor([[5], [7]], device=dev)
        saved = _nested_clone(entry.cache)
        kernels.reset_launch_counts()
        replayed = entry(token=token, pos=25).clone()
        torch.cuda.synchronize()
        replay_counts = kernels.launch_counts()
        after = _nested_clone(entry.cache)
        kernels.reset_launch_counts()
        want = model.decode_step(params, token, saved, 25)[1]
        torch.cuda.synchronize()
    assert kernels.launch_counts() == replay_counts
    assert torch.equal(replayed, want)
    for part in ("self", "cross"):
        for k in ("k", "v"):
            assert torch.equal(after[part][k], saved[part][k])


# ---------------------------------------------------------------------------
# The backward kernels
# ---------------------------------------------------------------------------

def _saved(a, b, kw):
    """The differentiated forward's launch: (out, stats, preacts)."""
    ep = kw["epilogue"]
    pro = kw.get("prologue", Prologue())
    extra = {k: kw.get(k) for k in ("b2", "bias", "residual", "sin", "cos",
                                    "gamma", "beta")}
    return gemm_forward(a, b, ep, pro, scale=kw.get("scale"),
                        out_dtype=torch.bfloat16,
                        save_preact=gemm_ops.kernel_saves(ep) > 0, **extra)


@pytest.mark.parametrize("m,k,n", [(200, 264, 384), (4, 136, 256),
                                   (130, 64, 128)])
@pytest.mark.parametrize("chain", sorted(BWD_CHAINS))
def test_gemm_bwd_kernels_match_plain(dev, chain, m, k, n):
    """dA (with the norm transpose, dgamma and dbeta) and dB (with dB2 and
    dbias) against their plain versions on the same g, preacts and row
    statistics: bf16 outputs within 2^-6 relative + 2% of their RMS; the
    fp32 dgamma and dbeta within 1e-3 relative + 1e-3 of their RMS (sums of
    the same products in another order); dbias, the same fp32 values
    summed, within 1e-4."""
    rng, a, b, kw = _gemm_operands(dev, chain, m, k, n)
    ep = kw["epilogue"]
    pro = kw.get("prologue", Prologue())
    _, rstd, preacts = _saved(a, b, kw)
    g = _rand(rng, (m, n), dev)
    ops = dict(epilogue=ep, prologue=pro, b2=kw.get("b2"),
               bias=kw.get("bias"), scale=kw.get("scale"), sin=kw.get("sin"),
               cos=kw.get("cos"), gamma=kw.get("gamma"), beta=kw.get("beta"),
               preacts=preacts)
    before = kernels.launch_counts()
    da, db, grads = gemm_fused_bwd(a, b, g, rstd=rstd, **ops)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["gemm_bwd_g"] == before["gemm_bwd_g"] + 1
    assert after["gemm_bwd_da"] == before["gemm_bwd_da"] + 1
    assert after["gemm_bwd_db"] == before["gemm_bwd_db"] + 1
    want_da, want_dgamma, want_dbeta = gemm_bwd_da_ref(a, b, g, rstd=rstd,
                                                       **ops)
    want_db, want_db2, want_dbias = gemm_bwd_db_ref(a, b, g, rstd=rstd, **ops)
    _close(da, want_da, 2 ** -6, 2e-2)
    _close(db, want_db, 2 ** -6, 2e-2)
    if ep.gate:
        _close(grads["b2"], want_db2, 2 ** -6, 2e-2)
    if ep.bias:
        _close(grads["bias"], want_dbias, 1e-4, 1e-4)
    if pro.norm != "none":
        _close(grads["gamma"], want_dgamma, 1e-3, 1e-3)
    if pro.beta:
        _close(grads["beta"], want_dbeta, 1e-3, 1e-3)
    assert ("beta" in grads) == pro.beta
    assert torch.equal(grads["residual"], g)


def _bwd_ops(dev, chain, m, k, n):
    rng, a, b, kw = _gemm_operands(dev, chain, m, k, n)
    _, rstd, preacts = _saved(a, b, kw)
    ops = dict(epilogue=kw["epilogue"],
               prologue=kw.get("prologue", Prologue()), b2=kw.get("b2"),
               bias=kw.get("bias"), scale=kw.get("scale"), sin=kw.get("sin"),
               cos=kw.get("cos"), gamma=kw.get("gamma"), beta=kw.get("beta"),
               preacts=preacts)
    return a, b, _rand(rng, (m, n), dev), rstd, ops


def _check_bwd(run, a, b, g, rstd, ops):
    """One BwdLaunch's outputs against the plain versions, at the
    tolerances of test_gemm_bwd_kernels_match_plain."""
    run.operand_pass()
    da, dgamma, dbeta = run.da()
    db, db2 = run.db()
    dbias = run.dbias()
    torch.cuda.synchronize()
    want_da, want_dgamma, want_dbeta = gemm_bwd_da_ref(a, b, g, rstd=rstd,
                                                       **ops)
    want_db, want_db2, want_dbias = gemm_bwd_db_ref(a, b, g, rstd=rstd, **ops)
    _close(da, want_da, 2 ** -6, 2e-2)
    _close(db, want_db, 2 ** -6, 2e-2)
    if db2 is not None:
        _close(db2, want_db2, 2 ** -6, 2e-2)
    if dbias is not None:
        _close(dbias, want_dbias, 1e-4, 1e-4)
    if dgamma is not None:
        _close(dgamma, want_dgamma, 1e-3, 1e-3)
    assert (dbeta is None) == (want_dbeta is None)
    if dbeta is not None:
        _close(dbeta, want_dbeta, 1e-3, 1e-3)


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


# the GEMM backward of whisper-base's and bert-110m's training layers: (M,
# K, N, chain); bert over 8 x 512 tokens, whisper's encoder over 4 x 1500
# frames, its decoder over 4 x 448 tokens
ENCODER_BWD_SHAPES = {
    "bert_qk": (4096, 768, 1536, "ln_beta"),
    "bert_up_gelu": (4096, 768, 3072, "ln_beta_gelu"),
    "bert_down": (4096, 3072, 768, "residual_scale"),
    "whisper_enc_v": (6000, 512, 512, "ln_beta"),
    "whisper_enc_up_gelu": (6000, 512, 2048, "ln_beta_gelu"),
    "whisper_dec_down": (1792, 2048, 512, "residual_scale"),
}


@pytest.mark.parametrize("case", sorted(ENCODER_BWD_SHAPES))
def test_gemm_bwd_at_the_encoder_shapes(dev, case):
    """The whole backward (operand pass, dA with the layernorm row pass,
    dB) of bert's and whisper's training GEMMs, the tile width picked per
    launch, against the plain versions at the forward's statistics."""
    m, k, n, chain = ENCODER_BWD_SHAPES[case]
    a, b, g, rstd, ops = _bwd_ops(dev, chain, m, k, n)
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


@pytest.mark.parametrize("arch", ["bert-110m", "whisper-base"])
def test_encoder_families_train_on_the_backward_kernels(dev, arch):
    """One loss and its grads of bert-110m (2 layers, 2 x 128 tokens) and
    whisper-base (1 + 1 layers, 2 x 64 tokens over 2 x 1500 frames) at
    published width, kernel mode, blocks recomputed: every GEMM runs its
    backward as the operand pass, dA and dB, every attention the flash
    backward (the cross projections are plain products), launches exact;
    the grads finite and the loss within 2e-2 of the plain bf16 path's."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, make_batch
    from repro_torch.models.common import tree_map
    from repro_torch.optim.optimizer import leaves
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=1 if arch == "whisper-base"
                              else 2, encoder_layers=1)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = make_batch(cfg, 2, 64 if arch == "whisper-base" else 128,
                       generator=gen)
    enc = cfg.encoder_layers if arch == "whisper-base" else 0
    dec = cfg.num_layers
    # per layer: 4 GEMMs (q|k, v, up, down) and its attentions, twice
    # (forward and recompute); the decoder's two attentions (self, cross)
    attn = enc + dec * (2 if arch == "whisper-base" else 1)
    want = {"gemm_fused": 8 * (enc + dec), "flash_attention_fwd": 2 * attn,
            "gemm_bwd_g": 4 * (enc + dec), "gemm_bwd_da": 4 * (enc + dec),
            "gemm_bwd_db": 4 * (enc + dec), "flash_attention_bwd": 2 * attn}
    losses = {}
    for mode in ("kernel", "reference"):
        model = build_model(cfg, mode=mode, device=dev)
        params = tree_map(lambda t: t.requires_grad_(),
                          model.init(seed=0, dtype="float32"))
        kernels.reset_launch_counts()
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves(params))
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        if mode == "kernel":
            assert counts == want
            assert all(bool(torch.isfinite(g).all()) for g in grads)
        else:
            assert not counts
        losses[mode] = float(loss)
    assert abs(losses["kernel"] - losses["reference"]) < 2e-2


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
    elif case == "group16_d128":   # chatglm3-6b: 32 heads over 2 kv heads
        h, hkv, d = 32, 2, 128
    elif case == "train":          # llama-1b's training shape
        b, h, hkv, sq, skv = 4, 32, 8, 1024, 1024
    elif case == "bert":           # bert-110m's 8 x 512, non-causal
        kw, b, h, hkv, sq, skv = {"causal": False}, 8, 12, 12, 512, 512
    elif case == "whisper_enc":    # 1500 frames: a ragged last key tile
        kw, b, h, hkv, sq, skv = {"causal": False}, 4, 8, 8, 1500, 1500
    elif case == "whisper_dec":    # the decoder's causal self attention
        b, h, hkv, sq, skv = 4, 8, 8, 448, 448
    elif case == "whisper_cross":  # 448 queries over 1500 frames
        kw, b, h, hkv, sq, skv = {"causal": False}, 4, 8, 8, 448, 1500
    return b, h, hkv, sq, skv, d, kw


def _attn_fwd_inputs(case, dev, rng=None):
    """q, k, v of a case as the model passes them: q and k strided views of
    one packed q|k buffer where sq == skv, v a view of its own projection."""
    b, h, hkv, sq, skv, d, kw = _attn_case(case)
    rng = rng or np.random.default_rng(5)
    if sq == skv:
        qk = _rand(rng, (b, sq, (h + hkv) * d), dev)
        q = qk[..., :h * d].reshape(b, sq, h, d).transpose(1, 2)
        k = qk[..., h * d:].reshape(b, sq, hkv, d).transpose(1, 2)
    else:
        q = _rand(rng, (b, h, sq, d), dev)
        k = _rand(rng, (b, hkv, skv, d), dev)
    v = _rand(rng, (b, skv, hkv * d), dev).reshape(b, skv, hkv, d
                                                    ).transpose(1, 2)
    return q, k, v, kw


def _attn_bwd_inputs(case, dev, seed=6):
    """q, k, v, out, lse, dO of a case: q, k and v as _attn_fwd_inputs
    makes them, dO the strided cotangent autograd hands over."""
    rng = np.random.default_rng(seed)
    q, k, v, kw = _attn_fwd_inputs(case, dev, rng)
    b, h, sq, d = q.shape
    do = _rand(rng, (b, sq, h, d), dev).transpose(1, 2)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    return (q, k, v, out, lse, do), kw


@pytest.mark.parametrize("case", ["causal_gqa", "ragged", "d128",
                                  "d128_window", "window", "softcap",
                                  "noncausal_cross", "mha", "group8",
                                  "group16_d128", "train", "bert",
                                  "whisper_enc", "whisper_dec",
                                  "whisper_cross"])
def test_flash_attention_bwd_kernel_matches_plain(dev, case):
    """The main kernel and the dq conversion against the plain version on
    the same q, k, v, out, lse and dO, q and k as strided views of one
    packed buffer and dO as the strided cotangent autograd hands over:
    within 2e-2 relative + 2% of each gradient's RMS (bf16 outputs, sums in
    another order). Groups 1, 4, 8 and 16 (chatglm3-6b's, at d 128);
    "train" is llama-1b's training shape (B 4, H 32, Hkv 8, S 1024, d 64,
    causal); "bert" and "whisper_*" the encoder families' training shapes
    (non-causal over 512 and 1500 keys, the decoder's causal 448, its cross
    attention of 448 queries over 1500 frames)."""
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
    projection output (the kernel's 16-byte vector branch), at S 131 and
    200 besides 256; the output is contiguous and counts one launch."""
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
    in bf16; d 1000, which fills no row group's registers exactly."""
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


def _misaligned(t, offset=1):
    """A copy of t in a fresh flat buffer starting `offset` elements in: a
    contiguous view whose pointer is not 16-byte aligned."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("d,s", [(128, 200), (64, 131)])
def test_rope_kernel_scalar_branch_on_a_misaligned_view(dev, d, s, dtype):
    """q as a transposed view of a projection output that starts one
    element into its buffer: no 16-byte vector is aligned, so the kernel
    moves single elements. It matches the plain version and gives the bits
    of the vector branch on the same values laid out aligned."""
    from repro_torch.kernels.rope import rope, rope_ref, rope_tables
    b, h = 2, 4
    rng = np.random.default_rng(d * s)
    q = _rand(rng, (b, s, h * d), dev, dtype=dtype)
    sin, cos = rope_tables(torch.arange(s, device=dev), d)
    aligned = q.reshape(b, s, h, d).transpose(1, 2)
    shifted = _misaligned(q).reshape(b, s, h, d).transpose(1, 2)
    assert aligned.data_ptr() % 16 == 0 and shifted.data_ptr() % 16
    before = kernels.launch_counts()["rope"]
    got = rope(shifted, sin, cos)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rope"] == before + 1
    _rope_close(got, rope_ref(shifted, sin, cos))
    assert torch.equal(got, rope(aligned, sin, cos))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_fused_norm_shared_memory_branch_at_d_16384(dev, dtype):
    """A row wider than the register instances (d 16384 > MAX_REG_D) goes
    through the same source's shared-memory kernel: one launch, outputs at
    the tolerances of the other cases."""
    from repro_torch.kernels.fused_norm import (
        dropout_residual_layernorm, fused_dropout_residual_layernorm_ref)
    rows, d = 12, 16384   # past the register rows' 8192
    rng = np.random.default_rng(16384)
    x = _rand(rng, (rows, d), dev, dtype=dtype)
    r = _rand(rng, (rows, d), dev, dtype=dtype)
    w = 1 + 0.1 * _rand(rng, (d,), dev, dtype=torch.float32)
    b = _rand(rng, (d,), dev, 0.1, dtype=torch.float32)
    before = kernels.launch_counts()["fused_norm"]
    got = dropout_residual_layernorm(x, r, w, b, 5, dropout_p=0.1)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_norm"] == before + 1
    _fused_norm_close(got, fused_dropout_residual_layernorm_ref(
        x, r, w, b, 5, dropout_p=0.1), dtype)


def _fused_norm_close(got, want, dtype):
    """new_residual bit for bit; normed within 1e-5 of its scale, plus one
    ulp in bf16 (the tolerance of test_fused_norm_kernel_matches_plain)."""
    out, new_res = got
    want_out, want_res = want
    assert torch.equal(new_res, want_res)
    err = (out.double() - want_out.double()).abs()
    tol = 1e-5 * want_out.abs().max().item()
    if dtype == torch.bfloat16:
        tol = torch.maximum(_bf16_ulp(want_out.double()),
                            _bf16_ulp(out.double())) + tol
    assert (err <= tol).all(), err.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,d", [(40, 2048), (37, 1000)])
def test_fused_norm_on_misaligned_views(dev, rows, d, dtype):
    """x and the residual as contiguous views one element into their
    buffers: the register kernel takes single elements instead of 16-byte
    vectors, with the same keep-mask and the same tolerances."""
    from repro_torch.kernels.fused_norm import (
        dropout_residual_layernorm, fused_dropout_residual_layernorm_ref)
    rng = np.random.default_rng(rows * d)
    x = _misaligned(_rand(rng, (rows, d), dev, dtype=dtype))
    r = _misaligned(_rand(rng, (rows, d), dev, dtype=dtype), 3)
    w = 1 + 0.1 * _rand(rng, (d,), dev, dtype=torch.float32)
    b = _rand(rng, (d,), dev, 0.1, dtype=torch.float32)
    assert x.data_ptr() % 16 and r.data_ptr() % 16
    before = kernels.launch_counts()["fused_norm"]
    got = dropout_residual_layernorm(x, r, w, b, -3, dropout_p=0.25)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_norm"] == before + 1
    _fused_norm_close(got, fused_dropout_residual_layernorm_ref(
        x, r, w, b, -3, dropout_p=0.25), dtype)


def _replays_equal_eager(call):
    """A captured call replayed from a CUDA graph twice gives the eager
    call's bits each time."""
    want = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for o, w in zip(out, want):
            assert torch.equal(o, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_rope_kernel_replays_from_a_cuda_graph(dev, dtype):
    from repro_torch.kernels.rope import rope, rope_tables
    b, h, s, d = 2, 8, 256, 64
    rng = np.random.default_rng(5)
    x = _rand(rng, (b, s, h * d), dev, dtype=dtype).reshape(
        b, s, h, d).transpose(1, 2)
    sin, cos = rope_tables(torch.arange(s, device=dev), d)
    _replays_equal_eager(lambda: (rope(x, sin, cos),))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_fused_norm_kernel_replays_from_a_cuda_graph(dev, dtype):
    from repro_torch.kernels.fused_norm import dropout_residual_layernorm
    rows, d = 300, 2048
    rng = np.random.default_rng(6)
    x = _rand(rng, (rows, d), dev, dtype=dtype)
    r = _rand(rng, (rows, d), dev, dtype=dtype)
    w = 1 + 0.1 * _rand(rng, (d,), dev, dtype=torch.float32)
    b = _rand(rng, (d,), dev, 0.1, dtype=torch.float32)
    _replays_equal_eager(lambda: dropout_residual_layernorm(
        x, r, w, b, 7, dropout_p=0.1))


# ---------------------------------------------------------------------------
# The trainer's leftovers: remat 'dots', the chunked cross entropy, the
# checkpoint from card tensors, the GEMM op in a captured decode step
# ---------------------------------------------------------------------------

def _llama_width(dev, mode="kernel", **kw):
    """llama-1b's published width at 2 layers, seeded fp32 masters."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    cfg = dataclasses.replace(get_config("llama-1b"), num_layers=2, **kw)
    model = build_model(cfg, mode=mode, device=dev)
    params = tree_map(lambda t: t.requires_grad_(),
                      model.init(seed=0, dtype="float32"))
    return model, params


def _train_batch(cfg, dev, batch=2, seq=256):
    from repro_torch.data import DataConfig, DataIterator
    return next(DataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=seq, global_batch=batch),
                             device=dev))


def test_dots_launches_exactly_at_llama_width(dev):
    """remat_policy 'dots' at llama-1b's width, kernel mode: per layer 4
    forward GEMMs (kept, not recomputed), 2 flash forwards (forward and
    recompute), 4 operand passes, 4 dA, 4 dB and the flash backward's 2
    launches; the loss bit for bit 'full''s, the grads within 2% of the
    largest entry of 'full''s (the flash backward reduce-adds dq in an
    order that varies between runs)."""
    from repro_torch.train import loss_and_grads
    got = {}
    for policy in ("full", "dots"):
        model, params = _llama_width(dev, remat_policy=policy)
        batch = _train_batch(model.cfg, dev)
        kernels.reset_launch_counts()
        loss, _, grads = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        got[policy] = (float(loss), grads, kernels.launch_counts())
    n = 2
    assert {k: v for k, v in got["dots"][2].items() if v} == {
        "gemm_fused": 4 * n, "flash_attention_fwd": 2 * n,
        "gemm_bwd_g": 4 * n, "gemm_bwd_da": 4 * n, "gemm_bwd_db": 4 * n,
        "flash_attention_bwd": 2 * n}
    assert got["full"][2]["gemm_fused"] == 8 * n
    assert got["dots"][0] == got["full"][0]
    for a, b in zip(got["dots"][1], got["full"][1]):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 2e-2 * b.abs().max()


@pytest.mark.parametrize("mode", ["reference", "kernel"])
def test_chunked_ce_matches_the_unchunked_loss(dev, mode):
    """ce_chunk 64 at llama-1b's width (2 layers, 2 x 256 tokens, vocab
    128,256) against the unchunked loss on the card: fp32 plain path, the
    loss within 1e-6 and every grad within 1e-5 of its largest entry; the
    kernel mode (bf16), the loss within 1e-4 and the grads within 2%."""
    from repro_torch.train import loss_and_grads
    dtype = "float32" if mode == "reference" else "bfloat16"
    got = {}
    for chunk in (0, 64):
        model, params = _llama_width(dev, mode, ce_chunk=chunk,
                                     compute_dtype=dtype)
        batch = _train_batch(model.cfg, dev)
        loss, _, grads = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        got[chunk] = (float(loss), grads)
    loss_tol, grad_tol = (1e-6, 1e-5) if mode == "reference" else (1e-4, 2e-2)
    assert abs(got[64][0] - got[0][0]) <= loss_tol * abs(got[0][0])
    for a, b in zip(got[64][1], got[0][1]):
        assert (a - b).abs().max() <= grad_tol * b.abs().max()


def test_async_checkpoint_of_card_tensors_restores_bitwise(dev, tmp_path):
    """A state on the card saved by AsyncCheckpointer, then at once updated
    in place by an AdamW step: the restored state (on the card) is the one
    at save() bit for bit."""
    from repro_torch.optim import AdamWConfig, adamw_update, constant_schedule
    from repro_torch.optim.optimizer import leaves, named_leaves
    from repro_torch.train import checkpoint, init_state
    model, params = _llama_width(dev)
    state = init_state(model, params=params)
    opt = AdamWConfig(schedule=constant_schedule(1e-2))

    def step():
        grads = [torch.randn_like(p) for p in leaves(state["params"])]
        adamw_update(opt, grads, state["opt"], state["params"])
        state["step"] += 1

    step()
    want = {k: v.detach().clone() if torch.is_tensor(v) else v
            for k, v in named_leaves(state)}
    ac = checkpoint.AsyncCheckpointer(str(tmp_path))
    ac.save(state, 1)
    step()
    ac.wait()
    restored, n = checkpoint.restore(str(tmp_path), state)
    assert n == 1
    for k, v in named_leaves(restored):
        if torch.is_tensor(v):
            assert v.device.type == "cuda" and torch.equal(v, want[k]), k
        else:
            assert v == want[k], k


def test_decode_graph_replays_the_gemm_op_bitwise(dev):
    """llama-1b's width, 2 layers: the forward GEMM is the custom op
    repro_torch::gemm_fused; a decode step captured by the Engine and
    replayed from a saved cache gives the eager step's logits and cache bit
    for bit, with the launches the eager step makes (2 GEMMs a layer)."""
    from repro_torch.serve import Engine
    model, _ = _llama_width(dev)
    params = model.init(seed=1)
    rng = np.random.default_rng(5)
    assert torch.ops.repro_torch.gemm_fused.default is not None
    with torch.inference_mode():
        eng = Engine(model, params, max_len=96)
        eng.generate(rng.integers(0, model.cfg.vocab_size, (2, 40)), 6)
        entry = eng._buckets[("decode", 2)]
        assert entry.graph is not None
        token = torch.tensor([[5], [7]], device=dev)
        saved = _clone(entry.cache)
        kernels.reset_launch_counts()
        replayed = entry(token=token, pos=45).clone()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        after = _clone(entry.cache)
        kernels.reset_launch_counts()
        want = model.decode_step(params, token, saved, 45)[1]
        torch.cuda.synchronize()
        assert kernels.launch_counts() == counts
        assert counts["gemm_fused"] == 2 * model.cfg.num_layers
        assert torch.equal(replayed, want)
        for k in saved:
            assert torch.equal(after[k], saved[k])
