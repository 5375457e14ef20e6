"""The attention ops at head_dim 256 (recurrentgemma-2b's) on the CPU: the
plain flash forward and the plain decode versions (contiguous ring and
paged pool) against the reference's Pallas kernels in interpret mode at a
small S, fp32 (same math, sums in another order: 1e-5); the plain flash
backward against the reference's backward kernels in interpret mode; the
wrappers take head_dim 256 (the backward's launch refuses 96), and a CPU
tensor's autograd runs the plain backward. Inputs are made with numpy from
a seed.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.policy import make_policy
from repro.kernels.attention import attention_decode as j_attention_decode
from repro.kernels.attention import (
    attention_decode_paged as j_attention_decode_paged)
from repro.kernels.attention.kernel_bwd import \
    flash_attention_bwd as j_flash_bwd
from repro.kernels.attention.kernel_fwd import \
    flash_attention_fwd as j_flash_fwd

from repro_torch.kernels.attention import (attention, attention_decode,
                                           attention_decode_paged,
                                           attention_ref,
                                           flash_attention_fwd)
from repro_torch.kernels.attention import backward, decode, ops

D = 256
TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_head_dim_256_is_in_the_kernels_sets():
    assert D in ops.HEAD_DIMS and D in decode.HEAD_DIMS
    assert D in backward.BWD_HEAD_DIMS


@pytest.mark.parametrize("case", ["mqa_window", "causal", "noncausal"])
def test_flash_fwd_plain_matches_the_jax_kernel(case):
    """out and lse of the plain version (what the CPU runs for the kernel)
    against the reference's _fwd_kernel in interpret mode, at S 256 with
    10 query heads over one kv head (recurrentgemma-2b's local blocks),
    windowed 128, or plainly causal or not."""
    b, h, hkv, s = 1, 10, 1, 256
    kw = {"mqa_window": dict(causal=True, window=128),
          "causal": dict(causal=True), "noncausal": dict(causal=False)}[case]
    if case != "mqa_window":
        h, hkv = 2, 2
    rng = np.random.default_rng(1)
    q, k, v = (_normal(rng, b, n, s, D) for n in (h, hkv, hkv))
    j_out, j_lse = j_flash_fwd(*map(jnp.asarray, (q, k, v)), interpret=True,
                               **kw)
    out, lse = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **TOL)
    np.testing.assert_allclose(
        attention(*map(torch.from_numpy, (q, k, v)), **kw).numpy(),
        attention_ref(*map(torch.from_numpy, (q, k, v)), **kw).numpy(),
        **TOL)


@pytest.mark.parametrize("window", [None, 100])
def test_decode_plain_matches_the_jax_kernel(window):
    """attention_decode at G 10 over one kv head, a 256-slot ring wrapped
    (lengths 300 and 97), against the reference's _decode_kernel in
    interpret mode."""
    b, hkv, g, slots = 2, 1, 10, 256
    rng = np.random.default_rng(2)
    q = _normal(rng, b, hkv * g, 1, D)
    k, v = (_normal(rng, b, hkv, slots, D) for _ in range(2))
    lens = np.array([300, 97], np.int32)
    pol = make_policy("attention_decode", block_m=g, block_n=64, block_k=D,
                      in_dtype="float32")
    want = j_attention_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lens), window=window, policy=pol,
                              mode="pallas_interpret")
    got = attention_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(lens),
                           window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t", [1, 4])
def test_decode_paged_plain_matches_the_jax_kernel(t):
    """attention_decode_paged at G 10, page 16, lengths not page multiples,
    1 and 4 query tokens, windowed 40, against the reference's
    _decode_kernel_paged in interpret mode."""
    b, hkv, g, page, mp = 2, 1, 10, 16, 8
    rng = np.random.default_rng(3)
    n_pages = b * mp + 1
    kp, vp = (_normal(rng, n_pages, hkv, page, D) for _ in range(2))
    q = _normal(rng, b, hkv * g, t, D)
    lens = np.array([45, 120], np.int32)
    table = np.zeros((b, mp), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    for i, n in enumerate(lens):
        need = -(-int(n) // page)
        table[i, :need] = perm[i * mp:i * mp + need]
    want = j_attention_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), window=40, mode="pallas_interpret")
    got = attention_decode_paged(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(lens), window=40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["mqa_window", "causal", "noncausal"])
def test_flash_bwd_plain_matches_the_jax_kernel(case):
    """The plain backward (what the CPU runs for the kernel) against the
    reference's _dq_kernel/_dkv_kernel in interpret mode at S 256, fp32,
    on the same q, k, v, out, lse and dO: 10 query heads over one kv head
    windowed 128 (the reference's per-query-head dk/dv summed over the
    group), or plainly causal or not; within 1e-5 of each gradient's
    largest entry."""
    b, h, hkv, s = 1, 10, 1, 256
    kw = {"mqa_window": dict(causal=True, window=128),
          "causal": dict(causal=True), "noncausal": dict(causal=False)}[case]
    if case != "mqa_window":
        h, hkv = 2, 2
    rng = np.random.default_rng(5)
    q, k, v, do = (_normal(rng, b, n, s, D) for n in (h, hkv, hkv, h))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = j_flash_fwd(jq, jk, jv, interpret=True, **kw)
    jdq, jdk, jdv = j_flash_bwd(jq, jk, jv, out, lse, jnp.asarray(do),
                                interpret=True, **kw)
    group = h // hkv
    want = [np.asarray(jdq)] + [
        np.asarray(x).reshape(b, hkv, group, s, D).sum(axis=2)
        for x in (jdk, jdv)]
    got = backward.flash_attention_bwd_ref(
        *(torch.from_numpy(np.asarray(x)) for x in (q, k, v, out, lse, do)),
        **kw)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), w_, rtol=0,
                                   atol=1e-5 * np.abs(w_).max())


def test_backward_kernel_refuses_head_dim_96():
    """The backward kernel's launch takes every head dim of the forward
    (64, 128, 256) and refuses head_dim 96 with ValueError before any
    allocation or launch."""
    y = torch.zeros((1, 2, 8, 96), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="head_dim 96"):
        backward.FlashBwdLaunch(y, y, y, y, lse, y, causal=True, window=None,
                                logit_scale=None, softcap=None)


def test_cpu_autograd_runs_the_plain_backward():
    """On CPU tensors the op's backward is the plain version at head_dim
    256: grads equal autograd through attention_ref within 1e-4."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(_normal(rng, 1, n, 40, D)).requires_grad_()
               for n in (2, 1, 1))
    attention(q, k, v, causal=True, window=16).square().sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    attention_ref(q, k, v, causal=True, window=16).square().sum().backward()
    for g, t in zip(got, (q, k, v)):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), rtol=1e-4,
                                   atol=1e-4)
