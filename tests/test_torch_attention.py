"""The port's attention ops on the CPU (the kernels' plain versions) against
the JAX reference: ``attention`` against ``attention_ref``;
``attention_decode`` against ``decode_ref`` and the Pallas split-KV decode
kernel in interpret mode. Inputs are made with numpy from a seed.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.policy import make_policy
from repro.kernels.attention import attention_decode as j_attention_decode
from repro.kernels.attention import attention_ref as j_attention_ref
from repro.kernels.attention import decode_ref as j_decode_ref

from repro_torch.kernels.attention import (BLOCK_KV, attention,
                                           attention_decode, attention_ref,
                                           combine_splits, decode_ref,
                                           flash_attention_fwd)

# fp32: same math, sums in another order. bf16: q/k/v are bf16 but scores
# and softmax run in fp32; the flash path rounds p to bf16 before p @ v
# (2^-8 relative per weight) and the output rounds to bf16.
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _qkv(seed, b, h, hkv, sq, skv, d, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    return ([jnp.asarray(x).astype(jdt) for x in (q, k, v)],
            [torch.from_numpy(x).to(tdt) for x in (q, k, v)])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["causal_gqa", "causal_mha", "window",
                                  "softcap", "noncausal"])
def test_attention_matches_jax(case, dtype):
    b, h, hkv, s, d = 2, 4, 2, 80, 32
    kw = {"causal": True}
    if case == "causal_mha":
        hkv = h
    elif case == "window":
        kw["window"] = 24
    elif case == "softcap":
        kw["softcap"] = 5.0
    elif case == "noncausal":
        kw = {"causal": False}
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, b, h, hkv, s, s, d, dtype)
    want = j_attention_ref(jq, jk, jv, **kw)
    got = attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dtype)
    # the port's own oracle (reference mode) agrees too
    _close(attention_ref(tq, tk, tv, **kw), want, dtype)


def test_flash_lse_and_strided_views():
    """lse = logsumexp of the masked scaled scores; q/k/v given as strided
    views of one packed projection, as the model passes them."""
    b, s, h, hkv, d = 2, 40, 4, 2, 16
    rng = np.random.default_rng(2)
    packed = torch.from_numpy(
        rng.standard_normal((b, s, (h + 2 * hkv) * d)).astype(np.float32))
    q = packed[..., : h * d].reshape(b, s, h, d).transpose(1, 2)
    k = packed[..., h * d:(h + hkv) * d].reshape(b, s, hkv, d).transpose(1, 2)
    v = packed[..., (h + hkv) * d:].reshape(b, s, hkv, d).transpose(1, 2)
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    want = j_attention_ref(*(jnp.asarray(x.contiguous().numpy())
                             for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    kk = k.repeat_interleave(h // hkv, dim=1)
    sc = (q @ kk.transpose(-1, -2)) * d ** -0.5
    sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(sc, dim=-1), rtol=1e-5,
                               atol=1e-5)


def test_attention_kernel_refuses_sinks():
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(NotImplementedError):
        attention(q, q, q, causal=True, sinks=torch.zeros(2))


def _decode_case(case, dtype, seed=3):
    b, h, hkv, slots, d = 3, 8, 2, 96, 32
    lengths = [40, 96, 7]
    window = None
    if case == "ring":
        lengths = [150, 96, 200]          # wraps the 96-slot ring
    elif case == "window":
        window, lengths = 20, [40, 96, 70]
    elif case == "ring_window":
        window, lengths = 30, [150, 96, 200]
    elif case == "empty_rows":
        lengths = [0, 33, 0]
    elif case == "ragged_split":
        slots, lengths = 100, [100, 65, 64]   # 100 = 64 + a masked tail
    (jq, jk, jv), (tq, tk, tv) = _qkv(seed, b, h, hkv, 1, slots, d, dtype)
    return (jq, jk, jv, jnp.asarray(lengths, jnp.int32)), \
        (tq, tk, tv, torch.tensor(lengths, dtype=torch.int32)), window


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["dense", "ring", "window", "ring_window",
                                  "empty_rows", "ragged_split"])
def test_attention_decode_matches_jax(case, dtype):
    (jq, jk, jv, jl), (tq, tk, tv, tl), window = _decode_case(case, dtype)
    b, h, _, d = tq.shape
    hkv, slots = tk.shape[1], tk.shape[2]
    got = attention_decode(tq, tk, tv, tl, window=window)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    want = j_decode_ref(jq.reshape(b, hkv, h // hkv, d), jk, jv, jl,
                        window=window).reshape(b, h, 1, d)
    _close(got, want, dtype)
    # the Pallas kernel in interpret mode, with a split that divides the
    # cache (the reference asserts it); the port's last split is ragged
    bkv = 4 if slots % 32 else 32
    pol = make_policy("attention_decode", block_m=h // hkv, block_n=bkv,
                      block_k=d, in_dtype=dtype)
    want_kernel = j_attention_decode(jq, jk, jv, jl, window=window,
                                     policy=pol, mode="pallas_interpret")
    _close(got, want_kernel, dtype)
    ref = decode_ref(tq.reshape(b, hkv, h // hkv, d), tk, tv, tl,
                     window=window).reshape(b, h, 1, d)
    _close(ref, want, dtype)
    if case == "empty_rows":
        assert float(got[0].abs().max()) == 0.0
        assert float(got[2].abs().max()) == 0.0
        assert float(got[1].abs().max()) > 0.0


def test_combine_splits_is_split_count_invariant():
    """The partials of one split of the whole cache and of many splits merge
    to the same output."""
    rng = np.random.default_rng(4)
    g, d, s = 4, 16, 3 * BLOCK_KV
    q = torch.from_numpy(rng.standard_normal((g, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32))
    sc = q @ k.T
    parts = []
    for lo in range(0, s, BLOCK_KV):
        blk = sc[:, lo:lo + BLOCK_KV]
        m = blk.amax(-1)
        p = torch.exp(blk - m[:, None])
        parts.append((p @ v[lo:lo + BLOCK_KV], m, p.sum(-1)))
    o, m, l = (torch.stack(x) for x in zip(*parts))
    whole = torch.softmax(sc, -1) @ v
    torch.testing.assert_close(combine_splits(o, m, l), whole, rtol=1e-5,
                               atol=1e-5)
