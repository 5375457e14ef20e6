"""The forward GEMM's host-side plan and row pass, checked without a card:
the plain version of the rmsnorm row pass against the JAX prologue, and
the planner that picks the kernel's tile width and split count against the
widths the kernel dispatches on."""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.gemm.prologue import Prologue as JaxPrologue
from repro_torch.kernels import _build
from repro_torch.kernels.gemm import Epilogue, ops, rms_rows_ref

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


CHAINS = {"plain": (False, 0), "gate": (True, 0), "rope64": (False, 64),
          "rope128": (False, 128)}


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("n,k", [(2048, 8192), (512, 2048), (2560, 2048),
                                 (136, 264)])
def test_plan_covers_every_m(chain, n, k):
    """For M 1-4096 the plan is a width the chain takes and a split count
    that leaves no split empty; it is the same on every call, and the same
    for every M of one tile row (a lone-slot replay and a full batch of
    decode run the same kernel); only one tile row splits."""
    gate, hd = CHAINS[chain]
    stages = -(-k // ops.TILE_DEPTH)
    small = ops.plan_gemm(1, n, k, H100_SMS, gate=gate, head_dim=hd)
    for m in range(1, 4097):
        plan = ops.plan_gemm(m, n, k, H100_SMS, gate=gate, head_dim=hd)
        assert plan == ops.plan_gemm(m, n, k, H100_SMS, gate=gate,
                                     head_dim=hd)
        width, splits = plan
        assert width in ops.tile_widths(gate, hd)
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
])
def test_plan_on_an_h100(m, n, k, gate, hd, want):
    """The picks at the main path's shapes, each the fastest of phase 3's
    sweep on an H100 or within 12% of it (prefill q|k + rope: 64 wide)."""
    assert ops.plan_gemm(m, n, k, H100_SMS, gate=gate, head_dim=hd) == want


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
