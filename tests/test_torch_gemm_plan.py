"""The forward GEMM's host-side plan and row pass, checked without a card:
the plain versions of the rmsnorm and layernorm row passes against the JAX
prologues, the row pass's and the chain's constants parsed from the
``.cu``, an fp32 emulation of the layernorm row pass's sums (two passes,
the centred variance) against a one-pass E[x^2] - mean^2 on rows with a
large mean, and the planner that picks the kernel's tile width and split
count against the widths the kernel dispatches on."""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.gemm.prologue import Prologue as JaxPrologue
from repro_torch.kernels import _build
from repro_torch.kernels.gemm import (Epilogue, Prologue, ln_rows_ref, ops,
                                      rms_rows_ref)

H100_SMS = 132


@pytest.mark.parametrize("m,k", [(1, 64), (24, 128), (37, 2048)])
def test_row_pass_plain_version_is_the_jax_prologue(m, k):
    """rms_rows_ref's An is the reference's rmsnorm prologue rounded to bf16
    bit for bit, and within 1e-6 of it in fp32."""
    rng = np.random.default_rng(m + k)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, k).astype(np.float32)
    pro = JaxPrologue(norm="rmsnorm")
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32)):
        xt = torch.from_numpy(x).to(dtype)
        gt = torch.from_numpy(gamma).to(dtype)
        xj = jnp.asarray(xt.float().numpy()).astype(jdt)
        gj = jnp.asarray(gt.float().numpy()).astype(jnp.float32)
        want = pro.apply(xj.astype(jnp.float32), gamma=gj[None, :]).astype(jdt)
        got, rstd = rms_rows_ref(xt, gt, pro.eps)
        assert got.dtype == dtype and rstd.dtype == torch.float32
        want = np.asarray(want.astype(jnp.float32))
        if dtype == torch.bfloat16:
            assert np.array_equal(got.float().numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("beta", [False, True], ids=["no_beta", "beta"])
@pytest.mark.parametrize("m,k,offset", [(1, 64, 0.0), (24, 128, 0.0),
                                        (37, 512, 100.0), (6, 768, 100.0),
                                        (5, 2048, -30.0)])
def test_layernorm_row_pass_plain_version_is_the_jax_prologue(m, k, offset,
                                                              beta):
    """ln_rows_ref's An against the reference's layernorm prologue (with or
    without beta), rows centred on ``offset``. In fp32 within 1e-6
    relative plus 2^-20 (|offset| + 1): the two means, summed in another
    order, differ by a few ulps of the offset, which the centring passes
    on. In bf16 bit for bit at offset 0, and else within one bf16 ulp
    (2^-7 relative) plus the same absolute bound: that difference moves an
    entry across a rounding boundary now and then."""
    rng = np.random.default_rng(m + k)
    x = (offset + rng.standard_normal((m, k)) * 2).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, k).astype(np.float32)
    b = rng.standard_normal(k).astype(np.float32) if beta else None
    pro = JaxPrologue(norm="layernorm", beta=beta)
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32)):
        xt = torch.from_numpy(x).to(dtype)
        gt = torch.from_numpy(gamma).to(dtype)
        bt = torch.from_numpy(b).to(dtype) if beta else None
        xj = jnp.asarray(xt.float().numpy()).astype(jdt)
        kw = {"gamma": jnp.asarray(gt.float().numpy())[None, :]}
        if beta:
            kw["beta"] = jnp.asarray(bt.float().numpy())[None, :]
        want = pro.apply(xj.astype(jnp.float32), **kw).astype(jdt)
        got, mean, rstd = ln_rows_ref(xt, gt, bt, pro.eps)
        assert got.dtype == dtype and mean.dtype == rstd.dtype == torch.float32
        want = np.asarray(want.astype(jnp.float32))
        if dtype == torch.bfloat16 and offset == 0:
            assert np.array_equal(got.float().numpy(), want)
        elif dtype == torch.bfloat16:
            np.testing.assert_allclose(got.float().numpy(), want,
                                       rtol=2 ** -7,
                                       atol=2 ** -20 * (abs(offset) + 1))
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=2 ** -20 * (abs(offset) + 1))


def _enum(source: str, name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)", source).group(1))


GEMM_SOURCE = (_build.CSRC / "gemm_fused.cu").read_text()
# the row pass's block: one 8-element vector a thread, whole warps, at most
# ROW_THREADS (gemm_fused.cu row_threads)
ROW_THREADS = int(re.search(r"constexpr int ROW_THREADS = (\d+);",
                            GEMM_SOURCE).group(1))


def row_threads(k: int) -> int:
    return min(ROW_THREADS, -(-(k // 8) // 32) * 32)


def test_row_pass_and_chain_constants_are_the_kernels():
    """The row pass's block size (the .cu's formula, 256 threads at most)
    and the chain's flags and activation codes are the ones gemm_fused.cu
    (and the backward operand pass, which reads the same flags) defines."""
    source = GEMM_SOURCE
    assert ROW_THREADS == 256
    assert re.search(r"const int t = \(k / 8 \+ 31\) / 32 \* 32;", source)
    for k, want in ((8, 32), (64, 32), (264, 64), (512, 64), (768, 96),
                    (2048, 256), (8192, 256)):
        assert row_threads(k) == want
    flags = {"EP_SCALE": ops._EP_SCALE, "EP_BIAS": ops._EP_BIAS,
             "EP_ROPE": ops._EP_ROPE, "EP_GATE": ops._EP_GATE,
             "EP_RESIDUAL": ops._EP_RESIDUAL,
             "EP_ACT_SHIFT": ops._EP_ACT_SHIFT}
    bwd = (_build.CSRC / "gemm_bwd_g.cu").read_text()
    for name, value in flags.items():
        assert _enum(source, name) == value, name
        if name != "EP_ACT_SHIFT":
            assert _enum(bwd, name) == value, name
    for act, code in ops.ACT_CODES.items():
        assert _enum(source, f"ACT_{act.upper()}") == code, act
    ep = Epilogue(activation="gelu", gate=True, residual=True, scale=True)
    assert ops.chain_flags(ep) == (1 | 8 | 16 | 2 << 5)


def _block_sum(parts: np.ndarray) -> np.float32:
    """block_sum of gemm_fused.cu in fp32: each warp's lanes by xor
    shuffles, then the warps' sums the same way in warp 0."""
    def warp(v):
        v = v.copy()
        for off in (16, 8, 4, 2, 1):
            v = (v + v[np.arange(32) ^ off]).astype(np.float32)
        return v[0]
    sums = [warp(parts[w:w + 32]) for w in range(0, len(parts), 32)]
    lanes = np.zeros(32, np.float32)
    lanes[:len(sums)] = sums
    return warp(lanes)


def _thread_sums(values: np.ndarray, threads: int) -> np.ndarray:
    """Each thread's running fp32 sum over its 8-element vectors (vector t,
    t + threads, ...), in the kernel's order."""
    k = values.shape[0]
    out = np.zeros(threads, np.float32)
    for t in range(threads):
        acc = np.float32(0)
        for c in range(t * 8, k, threads * 8):
            for v in values[c:c + 8]:
                acc = np.float32(acc + v)
        out[t] = acc
    return out


@pytest.mark.parametrize("offset", [0.0, 100.0, 1000.0])
def test_layernorm_row_pass_sums_keep_the_variance(offset):
    """An fp32 emulation of the kernel's row pass at K 768 (96 threads):
    the mean, then the variance of the centred values, gives rstd within
    1e-5 of the float64 truth on bf16 rows centred anywhere; a one-pass
    E[x^2] - mean^2 in the same order is off by more than 1e-4 once the
    mean is 100 times the spread, which the reference's tolerance does not
    allow."""
    k, eps = 768, 1e-5
    rng = np.random.default_rng(11)
    x = torch.from_numpy((offset + rng.standard_normal(k)).astype(
        np.float32)).to(torch.bfloat16).float().numpy()
    threads = row_threads(k)
    mean = np.float32(_block_sum(_thread_sums(x, threads)) / np.float32(k))
    c = (x - mean).astype(np.float32)
    var2 = np.float32(_block_sum(_thread_sums(c * c, threads)) / np.float32(k))
    sq = np.float32(_block_sum(_thread_sums(x * x, threads)) / np.float32(k))
    var1 = np.float32(sq - mean * mean)
    x64 = x.astype(np.float64)
    truth = 1 / np.sqrt(x64.var() + eps)
    two_pass = 1 / np.sqrt(np.float64(var2) + eps)
    assert abs(two_pass / truth - 1) < 1e-5
    one_pass = 1 / np.sqrt(max(np.float64(var1), 0.0) + eps)
    if offset >= 100:
        assert abs(one_pass / truth - 1) > 1e-4
    _, want_mean, want_rstd = ln_rows_ref(torch.from_numpy(x)[None], torch.ones(k),
                                          None, eps)
    np.testing.assert_allclose(mean, want_mean.item(), rtol=1e-6)
    np.testing.assert_allclose(two_pass, want_rstd.item(), rtol=1e-5)


def test_plan_widths_are_the_kernels():
    """The widths the planner picks from are the ones gemm_fused.cu
    dispatches on; the rows and depth of a tile the mainloop's."""
    source = (_build.CSRC / "gemm_fused.cu").read_text()
    widths = sorted(int(w) for w in re.findall(r"case (\d+): err", source))
    assert tuple(widths) == ops.TILE_WIDTHS
    header = (_build.CSRC / "gemm_sm90.cuh").read_text()
    assert int(re.search(r"constexpr int BM = (\d+);", header).group(1)) \
        == ops.TILE_ROWS
    assert int(re.search(r"constexpr int BK = (\d+);", header).group(1)) \
        == ops.TILE_DEPTH


CHAINS = {"plain": (False, 0, False), "gate": (True, 0, True),
          "rope64": (False, 64, False), "rope128": (False, 128, False),
          "gelu": (False, 0, True)}


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("n,k", [(2048, 8192), (512, 2048), (2560, 2048),
                                 (136, 264)])
def test_plan_covers_every_m(chain, n, k):
    """For M 1-4096 the plan is a width the chain takes and a split count
    that leaves no split empty; it is the same on every call, and the same
    for every M of one tile row (a lone-slot replay and a full batch of
    decode run the same kernel); only one tile row splits."""
    gate, hd, act = CHAINS[chain]
    stages = -(-k // ops.TILE_DEPTH)
    small = ops.plan_gemm(1, n, k, H100_SMS, gate=gate, head_dim=hd,
                          act=act)
    for m in range(1, 4097):
        plan = ops.plan_gemm(m, n, k, H100_SMS, gate=gate, head_dim=hd,
                             act=act)
        assert plan == ops.plan_gemm(m, n, k, H100_SMS, gate=gate,
                                     head_dim=hd, act=act)
        width, splits = plan
        assert width in ops.tile_widths(gate, hd)
        assert not (act and not gate and width > 128)
        per = -(-stages // splits)
        assert 1 <= splits and (splits - 1) * per < stages
        if m <= ops.TILE_ROWS:
            assert plan == small
        else:
            assert splits == 1


@pytest.mark.parametrize("m,n,k,gate,hd,want", [
    (4, 2048, 8192, False, 0, (128, 8)),     # decode down: 16 tiles
    (4, 8192, 2048, True, 0, (128, 1)),      # decode up: 128 tiles
    (4, 2560, 2048, False, 64, (128, 6)),    # decode q|k + rope: 20 tiles
    (128, 2560, 2048, False, 64, (128, 6)),  # a 128-token prefill chunk
    (1024, 2560, 2048, False, 64, (128, 1)),  # prefill q|k: 160 tiles
    (1024, 512, 2048, False, 0, (64, 1)),    # prefill v: 64 tiles
    (1024, 2048, 8192, False, 0, (128, 1)),  # prefill down: 128 tiles
    (1024, 8192, 2048, True, 0, (256, 1)),   # prefill up: 512 tiles
    (4096, 2560, 2048, False, 64, (128, 1)),  # training q|k: rope, 640
    (4096, 512, 2048, False, 0, (128, 1)),   # training v: 128 tiles
    (4096, 2048, 8192, False, 0, (256, 1)),  # training down: 256 tiles
    (4096, 8192, 2048, True, 0, (256, 1)),   # training up: 2048 tiles
    # whisper-base and bert-110m: the gelu up projections (128-wide, the
    # non-gated activation's cap), whisper's q|k, a gated gelu (256 kept)
    (6000, 2048, 512, "gelu", 0, (128, 1)),
    (4096, 3072, 768, "gelu", 0, (128, 1)),
    (6000, 1024, 512, False, 0, (128, 1)),
    (6000, 2048, 512, "geglu", 0, (256, 1)),
])
def test_plan_on_an_h100(m, n, k, gate, hd, want):
    """The picks at the main paths' shapes, each the fastest of phase 3's
    sweep on an H100 or within 12% of it (prefill q|k + rope: 64 wide).
    ``gate`` "gelu" is a non-gated activation, "geglu" the gated one."""
    act = gate in ("gelu", "geglu")
    assert ops.plan_gemm(m, n, k, H100_SMS, gate=gate == "geglu" or gate
                         is True, head_dim=hd, act=act) == want


@pytest.mark.parametrize("gate,hd,want", [
    (False, 0, (64, 128, 256)), (True, 0, (128, 256)),
    (False, 64, (64, 128)), (False, 128, (128,)),
    (False, 8, (64, 128))])
def test_tile_widths_per_chain(gate, hd, want):
    assert ops.tile_widths(gate, hd) == want


def test_workspace_layout():
    """The gated chain's raw accumulator holds whole tiles of B's and B2's
    columns; a split or a rope head_dim under 16 goes through the
    workspace."""
    assert ops.raw_width(136, 128, True) == 3 * 128
    assert ops.raw_width(8192, 256, True) == 16384
    assert ops.raw_width(136, 64, False) == 136
    rope8, rope64 = (Epilogue(rope=True, head_dim=h) for h in (8, 64))
    assert ops.staged(rope8, 1) and not ops.staged(rope64, 1)
    assert ops.staged(Epilogue(), 2) and not ops.staged(Epilogue(), 1)


@pytest.mark.parametrize("chain", ["rmsnorm_swiglu", "layernorm_beta_gelu",
                                   "rope_bias", "residual_scale"])
def test_gemm_fused_op_passes_opcheck(chain):
    """The custom op ``repro_torch::gemm_fused`` (what ``_forward`` calls,
    and what remat 'dots' keeps): its schema, its fake implementation's
    shapes and types against the plain one's, and its dispatch under
    ``torch.library.opcheck``; the chain comes back from its flags."""
    g = torch.Generator().manual_seed(0)
    m, k, n, hd = 16, 32, 64, 16
    a, b, b2 = (torch.randn(s, generator=g)
                for s in ((m, k), (k, n), (k, n)))
    gamma, beta = torch.randn(k, generator=g), torch.randn(k, generator=g)
    bias, residual = torch.randn(n, generator=g), torch.randn(m, n,
                                                             generator=g)
    sin, cos = torch.randn(m, hd, generator=g), torch.randn(m, hd,
                                                            generator=g)
    ep, pro, kw = {
        "rmsnorm_swiglu": (Epilogue(activation="silu", gate=True),
                           Prologue(norm="rmsnorm"),
                           dict(b2=b2, gamma=gamma)),
        "layernorm_beta_gelu": (Epilogue(activation="gelu"),
                                Prologue(norm="layernorm", beta=True),
                                dict(gamma=gamma, beta=beta)),
        "rope_bias": (Epilogue(rope=True, head_dim=hd, bias=True),
                      Prologue(), dict(bias=bias, sin=sin, cos=cos)),
        "residual_scale": (Epilogue(residual=True, scale=True), Prologue(),
                           dict(residual=residual, scale=0.5)),
    }[chain]
    names = ("b2", "bias", "residual", "gamma", "beta", "sin", "cos")
    args = (a, b, *(kw.get(x) for x in names), ops.chain_flags(ep),
            ep.head_dim, pro.norm, pro.eps, kw.get("scale"), torch.float32,
            True)
    torch.library.opcheck(torch.ops.repro_torch.gemm_fused.default, args)
    assert ops._chain_of(ops.chain_flags(ep), ep.head_dim, pro.norm,
                         pro.eps, "beta" in kw) == (ep, pro)
