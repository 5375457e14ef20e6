"""The port's RG-LRU block (``repro_torch.models.rglru``) against the
reference's (``repro.models.rglru``) on the CPU, in fp32, at width 64 and a
length that the chunk does not divide: the causal convolution, the gates
(fp32 and compute-type gate products), the scan with and without a chunk,
the full block, the prefill (its state equal to the forward's last) and a
run of decode steps equal to the forward. Both sides get the same weights
and inputs, made from a numpy seed; the tolerances are stated per test
(sums in another order: the doubling scan against JAX's associative scan,
the convolution's taps against ``conv_general_dilated``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.models import rglru as jr

from repro_torch.configs import get_config
from repro_torch.models import rglru as tr
from repro_torch.models.common import init_params

W, L, B, CHUNK = 64, 37, 2, 8


def _cfgs(**kw):
    """(JAX, port) configs: recurrentgemma-2b's smoke config in fp32 (width
    64), with ``kw`` replaced."""
    return tuple(dataclasses.replace(get("recurrentgemma-2b", smoke=True),
                                     compute_dtype="float32", **kw)
                 for get in (j_get_config, get_config))


def _params(seed=0):
    """The block's parameters as numpy, drawn from a seed: the
    projections at std 1/sqrt(fan_in), nonzero biases, Λ as the
    reference's init draws it (sigmoid(Λ) in [0.9, 0.999])."""
    rng = np.random.default_rng(seed)
    d, k = 64, 4

    def normal(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)
    u = rng.uniform(0.9, 0.999, W)
    return {"proj_x": normal(d, W), "proj_gate": normal(d, W),
            "conv_w": normal(W, k), "conv_b": normal(W) * 0.1,
            "w_a": normal(W, W), "b_a": normal(W) * 0.1,
            "w_i": normal(W, W), "b_i": normal(W) * 0.1,
            "lambda": np.log(u / (1 - u)).astype(np.float32),
            "proj_out": normal(W, d)}


def _sides(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def test_causal_conv_matches_the_reference():
    """fp32, within 1e-6 (four taps summed in another order)."""
    p = _params()
    x = _x((B, L, W))
    want = jr._causal_conv(jnp.asarray(x), jnp.asarray(p["conv_w"]),
                           jnp.asarray(p["conv_b"]))
    got = tr._causal_conv(torch.from_numpy(x), torch.from_numpy(p["conv_w"]),
                          torch.from_numpy(p["conv_b"]))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("f32_gates", [True, False])
def test_gates_match_the_reference(f32_gates):
    """log_a and the gated input, fp32 gate products or the compute type's
    (bf16 inputs here, so the bf16 products are exercised), within 1e-5."""
    (jcfg, tcfg) = _cfgs(rglru_f32_gates=f32_gates)
    jp, tp = _sides(_params())
    u = _x((B, L, W))
    if not f32_gates:
        ju = jnp.asarray(u).astype(jnp.bfloat16)
        tu = torch.from_numpy(u).to(torch.bfloat16)
    else:
        ju, tu = jnp.asarray(u), torch.from_numpy(u)
    want = jr._gates(jcfg, jp, ju)
    got = tr._gates(tcfg, tp, tu)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, np.asarray(w), 1e-5 if f32_gates else 2e-2)


@pytest.mark.parametrize("chunk", [0, CHUNK, 16])
@pytest.mark.parametrize("length", [L, 48])
def test_scan_matches_the_reference(chunk, length):
    """The doubling scan (chunk 0, or a chunk that does not divide the
    length) and the two-level scan (48 = 6 x 8 = 3 x 16) against the
    reference's, within 1e-5 relative."""
    rng = np.random.default_rng(2)
    log_a = -rng.uniform(0.0, 0.3, (B, length, W)).astype(np.float32)
    x = rng.standard_normal((B, length, W)).astype(np.float32)
    want = jr.rglru_scan(jnp.asarray(log_a), jnp.asarray(x), chunk=chunk)
    got = tr.rglru_scan(torch.from_numpy(log_a), torch.from_numpy(x),
                        chunk=chunk)
    _close(got, want, 1e-5)
    # the sequential recurrence, by hand
    h = np.zeros((B, W), np.float64)
    for t in range(length):
        h = np.exp(log_a[:, t].astype(np.float64)) * h + x[:, t]
        np.testing.assert_allclose(got[:, t].numpy(), h, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("chunk", [0, CHUNK])
def test_forward_matches_the_reference(chunk):
    """The full block at L 37 (the chunk does not divide it: one scan) and
    at 40 (five chunks of 8), within 1e-5."""
    jcfg, tcfg = _cfgs(rglru_chunk=chunk)
    jp, tp = _sides(_params())
    for length in (L, 40):
        x = _x((B, length, 64))
        want = jr.rglru_forward(jcfg, jp, jnp.asarray(x))
        got = tr.rglru_forward(tcfg, tp, torch.from_numpy(x))
        _close(got, want, 1e-5)


def test_prefill_matches_the_reference_and_the_forward():
    """The prefill's output equals the forward's bit for bit (the same
    scan), its state the reference's within 1e-5, and its h the scan's last
    state."""
    jcfg, tcfg = _cfgs()
    jp, tp = _sides(_params())
    x = _x((B, L, 64))
    jout, jstate = jr.rglru_prefill(jcfg, jp, jnp.asarray(x))
    out, state = tr.rglru_prefill(tcfg, tp, torch.from_numpy(x))
    assert torch.equal(out, tr.rglru_forward(tcfg, tp, torch.from_numpy(x)))
    _close(out, jout, 1e-5)
    for name in ("conv", "h"):
        assert tuple(state[name].shape) == tuple(jstate[name].shape)
        _close(state[name], jstate[name], 1e-5)
    assert state["h"].dtype == torch.float32


def test_decode_steps_equal_the_forward():
    """A prefill of 29 tokens, then 8 decode steps, each in place on the
    cache: the steps' outputs equal the forward's at those positions and
    the reference's steps, within 1e-5; the cache keeps its tensors."""
    jcfg, tcfg = _cfgs()
    jp, tp = _sides(_params())
    x = _x((B, L, 64))
    tx = torch.from_numpy(x)
    full = tr.rglru_forward(tcfg, tp, tx)
    _, state = tr.rglru_prefill(tcfg, tp, tx[:, :29])
    cache = tr.init_rglru_cache(tcfg, B, torch.float32, "cpu")
    assert cache["h"].dtype == torch.float32
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    for k in cache:
        cache[k].copy_(state[k])
    _, jcache = jr.rglru_prefill(jcfg, jp, jnp.asarray(x[:, :29]))
    for t in range(29, L):
        out = tr.rglru_decode_step(tcfg, tp, tx[:, t:t + 1], cache)
        jout, jcache = jr.rglru_decode_step(jcfg, jp, jnp.asarray(
            x[:, t:t + 1]), jcache)
        _close(out[:, 0], full[:, t], 1e-5)
        _close(out, jout, 1e-5)
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    _close(cache["h"], jcache["h"], 1e-5)


def test_lambda_init_draws_the_reference_range():
    """'lru_a' draws sigmoid(Λ) in [0.9, 0.999], as the reference's init."""
    defs = tr.rglru_defs(_cfgs()[1], "rec", stack=3)
    gen = torch.Generator().manual_seed(0)
    lam = init_params(defs, gen, "cpu")["rec"]["lambda"]
    a = torch.sigmoid(lam)
    assert lam.shape == (3, W)
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6


def test_defs_match_the_reference():
    """The block's parameter paths and shapes are the reference's."""
    jcfg, tcfg = _cfgs()
    want = {k: tuple(v.shape) for k, v in
            jr.rglru_defs(jcfg, "rec", stack=2).items()}
    assert {k: tuple(v.shape) for k, v in
            tr.rglru_defs(tcfg, "rec", stack=2).items()} == want
