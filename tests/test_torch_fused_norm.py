"""The port's fused dropout + residual + layernorm op on the CPU against the
JAX reference: the lowbias32 hash and the keep-mask bit for bit, and the
op's two outputs against the reference's plain version and its Pallas
kernel in interpret mode, with the same numpy inputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.fused_norm import (dropout_residual_layernorm as
                                      j_dropout_residual_layernorm)
from repro.kernels.fused_norm import fused_dropout_residual_layernorm
from repro.kernels.fused_norm.kernel import (dropout_keep_mask as
                                             j_kernel_keep_mask)
from repro.kernels.fused_norm.ref import _lowbias32 as j_lowbias32
from repro.kernels.fused_norm.ref import dropout_keep_mask_ref as j_keep_mask

from repro_torch.kernels import dropout_residual_layernorm
from repro_torch.kernels.fused_norm import (
    dropout_keep_mask_ref, fused_dropout_residual_layernorm_ref, lowbias32)

SEEDS = [0, 7, 2 ** 31 - 1]


def _bf16_ulp(x):
    """One bf16 ulp of each entry of x (8 significant bits)."""
    _, e = np.frexp(np.abs(np.asarray(x, np.float64)))
    return np.ldexp(1.0, e - 8)


def test_lowbias32_is_the_references_bit_for_bit():
    """Random uint32 values, the ends of the range and every power of two:
    the int64 arithmetic wraps mod 2^32 exactly as jnp.uint32 does."""
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.integers(0, 2 ** 32, 4096, dtype=np.uint64),
        np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint64),
        (np.uint64(1) << np.arange(32, dtype=np.uint64))]).astype(np.uint32)
    want = np.asarray(j_lowbias32(jnp.asarray(vals)))
    got = lowbias32(torch.from_numpy(vals.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # a Python int goes through the same arithmetic
    assert lowbias32(int(vals[0])) == int(want[0])


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("seed", SEEDS)
def test_keep_mask_is_the_references_bit_for_bit(seed, p):
    shape = (96, 160)
    want = np.asarray(j_keep_mask(seed, shape, p))
    got = dropout_keep_mask_ref(seed, shape, p).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_keep_mask_index_wraps_mod_2_32():
    """Rows past 2^32 / d: the element index wraps mod 2^32, as the
    reference kernel's uint32 iota arithmetic does (rows 2^21 .. 2^21 + 3
    of a d = 2048 array start at index 2^32, where row 0 starts)."""
    d, row0 = 2048, 1 << 21
    want = np.asarray(j_kernel_keep_mask(7, row0, (4, d), 0.5))
    got = dropout_keep_mask_ref(7, (4, d), 0.5, row0=row0).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, dropout_keep_mask_ref(7, (4, d), 0.5).numpy())


def test_negative_seed_wraps_through_int32():
    """Seed -1 enters the Pallas kernel as int32 and is cast to uint32
    (0xFFFFFFFF); the port's op draws the same mask, so its outputs equal
    the interpret-mode kernel's. (The reference's plain version refuses a
    negative Python seed.) A seed outside int32 is refused."""
    x, r, w, b = _inputs((256, 128), "float32", seed=5)
    want = fused_dropout_residual_layernorm(
        jnp.asarray(x), jnp.asarray(r), jnp.asarray(w), jnp.asarray(b), -1,
        dropout_p=0.5, interpret=True)
    got = dropout_residual_layernorm(*map(torch.from_numpy, (x, r, w, b)),
                                     -1, dropout_p=0.5)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(
        dropout_keep_mask_ref(-1, (8, 8), 0.5).numpy(),
        dropout_keep_mask_ref(2 ** 32 - 1 - 2 ** 32, (8, 8), 0.5).numpy())
    with pytest.raises(ValueError, match="int32"):
        dropout_residual_layernorm(*map(torch.from_numpy, (x, r, w, b)),
                                   2 ** 31, dropout_p=0.5)


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[1])).astype(np.float32)
    b = (0.1 * rng.standard_normal(shape[1])).astype(np.float32)
    if dtype == "bfloat16":
        # inputs representable in bf16, so both sides start from one value
        x, r = (np.array(jnp.asarray(a).astype(jnp.bfloat16)
                           .astype(jnp.float32)) for a in (x, r))
    return x, r, w, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("shape", [(256, 128), (512, 256)], ids=str)
def test_op_matches_jax(shape, p, dtype):
    """normed and new_residual against the reference's plain version and
    its interpret-mode kernel: within 1e-5 in fp32; in bf16 within that
    fp32 difference plus one bf16 ulp (the two frameworks' row sums differ
    in order, which moves the fp32 result by up to the fp32 tolerance and
    its rounding to bf16 by at most one ulp; an output that cancels to
    ~1e-7 has an ulp far below the fp32 difference)."""
    x, r, w, b = _inputs(shape, dtype, seed=1)
    jdt = getattr(jnp, dtype)
    jargs = (jnp.asarray(x).astype(jdt), jnp.asarray(r).astype(jdt),
             jnp.asarray(w), jnp.asarray(b))
    wants = [j_dropout_residual_layernorm(*jargs, 7, dropout_p=p,
                                          mode="reference"),
             j_dropout_residual_layernorm(*jargs, 7, dropout_p=p,
                                          mode="pallas_interpret")]
    tdt = getattr(torch, dtype)
    got = dropout_residual_layernorm(
        torch.from_numpy(x).to(tdt), torch.from_numpy(r).to(tdt),
        torch.from_numpy(w), torch.from_numpy(b), 7, dropout_p=p)
    assert [g.dtype for g in got] == [tdt, tdt]
    got = [g.float().numpy() for g in got]
    for want in wants:
        for g, wnt in zip(got, want):
            wnt = np.asarray(wnt.astype(jnp.float32))
            if dtype == "float32":
                np.testing.assert_allclose(g, wnt, rtol=0, atol=1e-5)
            else:
                ulp = np.maximum(_bf16_ulp(wnt), _bf16_ulp(g))
                err = np.abs(g - wnt)
                assert (err <= ulp + 1e-5).all(), err.max()


def test_residual_output_is_the_dropped_sum_exactly():
    """new_residual is residual + where(keep, x / (1 - p), 0) with the
    scale rounded to fp32 once, bit for bit in fp32."""
    x, r, w, b = _inputs((64, 96), "float32", seed=2)
    _, new_res = fused_dropout_residual_layernorm_ref(
        *map(torch.from_numpy, (x, r, w, b)), 3, dropout_p=0.3)
    keep = dropout_keep_mask_ref(3, x.shape, 0.3).numpy()
    scale = np.float32(1.0 / (1.0 - 0.3))
    want = r + np.where(keep, x * scale, np.float32(0))
    np.testing.assert_array_equal(new_res.numpy(), want)


def test_op_checks_its_arguments():
    x = torch.zeros(4, 8)
    w = torch.ones(8)
    with pytest.raises(ValueError, match="residual"):
        dropout_residual_layernorm(x, torch.zeros(4, 7), w, w)
    with pytest.raises(ValueError, match="dropout_p"):
        dropout_residual_layernorm(x, x, w, w, dropout_p=1.0)
