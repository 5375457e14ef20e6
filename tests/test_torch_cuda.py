"""The hand-written CUDA kernels against their plain versions, on the card,
at small shapes that reach the edges the model's main path does not: ragged
M, N and K tiles, a K that is no multiple of the K tile, head_dim 128,
windows, soft caps, ring wrap-around, empty rows and a ragged last split.

Marked ``cuda``: skipped on a machine without a CUDA card. On the card:

  python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.attention import (combine_splits,
                                           decode_partials_ref,
                                           flash_attention_fwd,
                                           flash_attention_fwd_ref,
                                           flash_decode)
from repro_torch.kernels.gemm import (Epilogue, Prologue, gemm_fused,
                                      gemm_fused_ref)

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
}


@pytest.mark.parametrize("m,k,n", [(4, 136, 256), (200, 264, 384),
                                   (1, 64, 128)])
@pytest.mark.parametrize("chain", sorted(GEMM_CHAINS))
def test_gemm_fused_kernel_matches_plain(dev, chain, m, k, n):
    ep_kw, norm = GEMM_CHAINS[chain]
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
    before = kernels.launch_counts()["gemm_fused"]
    got = gemm_fused(a, b, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gemm_fused"] == before + 1
    _close(got, gemm_fused_ref(a, b, **kw), 2 ** -6, 2e-2)


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
