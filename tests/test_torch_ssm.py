"""The port's Mamba2 SSD block (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) on the CPU, in fp32, at mamba2-130m's
smoke width (d_model 64, 4 heads of 32, d_state 16, chunk 16): the chunked
scan at lengths that are a multiple of the chunk, that are not, and that
are shorter than it, with and without an initial state, with one group and
with two; the causal convolution; the full block; the prefill (its state
and convolution tail); decode steps in place against the forward. Also the
port's own properties: the scan is independent of the chunk and equal to
the sequential recurrence in float64, and its backward through the masked
segment sums is finite and passes ``gradcheck`` in float64. Both sides get
the same weights and inputs, made from a numpy seed; the tolerances are
stated per test (fp32 sums in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.models import ssm as js

from repro_torch.configs import get_config
from repro_torch.models import ssm as ts

ARCH = "mamba2-130m"
B, L, CHUNK = 2, 37, 16


def _cfgs(**ssm_kw):
    """(JAX, port) configs: mamba2-130m's smoke config in fp32, its SSM
    config with ``ssm_kw`` replaced."""
    out = []
    for get in (j_get_config, get_config):
        cfg = get(ARCH, smoke=True)
        out.append(dataclasses.replace(
            cfg, compute_dtype="float32",
            ssm=dataclasses.replace(cfg.ssm, **ssm_kw)))
    return tuple(out)


def _params(cfg, seed=0):
    """The block's parameters as numpy, drawn from a seed: projections at
    std 1/sqrt(fan_in), nonzero conv and dt biases, a_log = log of decay
    rates in [1, 16] (so the heads decay at different rates), d_skip and
    the norm scale around 1."""
    rng = np.random.default_rng(seed)
    d_inner, n_heads, conv_dim, d_in_proj = ts.ssm_dims(cfg)
    d, k = cfg.d_model, cfg.ssm.d_conv

    def normal(*shape, std=None):
        std = 1 / np.sqrt(shape[0]) if std is None else std
        return (rng.standard_normal(shape) * std).astype(np.float32)
    return {"in_proj": normal(d, d_in_proj), "conv_w": normal(conv_dim, k,
                                                              std=0.5),
            "conv_b": normal(conv_dim, std=0.1),
            "a_log": np.log(rng.uniform(1, 16, n_heads)).astype(np.float32),
            "d_skip": 1 + normal(n_heads, std=0.1),
            "dt_bias": normal(n_heads, std=0.5),
            "norm_scale": 1 + normal(d_inner, std=0.1),
            "out_proj": normal(d_inner, d)}


def _sides(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _scan_inputs(length, groups, seed=2, heads=4, p=8, n=16):
    """x (B, L, H, P), a (B, L, H) log-decays in [-0.5, 0), b and c (B, L,
    G, N), and an initial state (B, H, P, N)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, length, heads, p)).astype(f),
            -rng.uniform(0.01, 0.5, (B, length, heads)).astype(f),
            rng.standard_normal((B, length, groups, n)).astype(f),
            rng.standard_normal((B, length, groups, n)).astype(f),
            rng.standard_normal((B, heads, p, n)).astype(f))


def _naive_scan(x, a, b, c, state):
    """The SSD recurrence token by token in float64: h_t = exp(a_t)
    h_{t-1} + x_t b_t^T, y_t = h_t c_t (each group's b, c shared by its
    heads)."""
    x, a, b, c = (np.asarray(t, np.float64) for t in (x, a, b, c))
    rep = x.shape[2] // b.shape[2]
    b, c = np.repeat(b, rep, axis=2), np.repeat(c, rep, axis=2)
    h = np.zeros(x.shape[:1] + x.shape[2:] + b.shape[-1:]) \
        if state is None else np.asarray(state, np.float64)
    ys = []
    for t in range(x.shape[1]):
        h = (np.exp(a[:, t])[..., None, None] * h
             + x[:, t][..., None] * b[:, t][:, :, None, :])
        ys.append(np.einsum("bhpn,bhn->bhp", h, c[:, t]))
    return np.stack(ys, axis=1), h


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("initial", [False, True], ids=["zero", "initial"])
@pytest.mark.parametrize("length", [48, L, 10],
                         ids=["multiple", "ragged", "below-chunk"])
def test_ssd_chunked_matches_the_reference(length, initial, groups):
    """y and the final state against the reference's ``ssd_chunked`` within
    1e-5 (and against the float64 recurrence within 1e-4): L 48 (three
    chunks of 16), 37 (a zero-padded tail), 10 (the chunk cut to L); from
    zero or from a given state; one group or two of two heads each."""
    x, a, b, c, s0 = _scan_inputs(length, groups)
    state = s0 if initial else None
    jy, jfinal = js.ssd_chunked(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
        CHUNK, initial_state=None if state is None else jnp.asarray(state))
    y, final = ts.ssd_chunked(
        torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b),
        torch.from_numpy(c), CHUNK,
        initial_state=None if state is None else torch.from_numpy(state))
    assert y.shape == (B, length, 4, 8) and y.dtype == torch.float32
    assert final.shape == (B, 4, 8, 16) and final.dtype == torch.float32
    _close(y, jy, 1e-5)
    _close(final, jfinal, 1e-5)
    ny, nfinal = _naive_scan(x, a, b, c, state)
    _close(y, ny, 1e-4)
    _close(final, nfinal, 1e-4)


def test_ssd_chunked_is_independent_of_the_chunk():
    """The state-space duality (the reference's
    tests/test_models.py::test_ssm_chunk_invariance, on the scan): chunks of
    4, 8, 16 and 64 (past L) give one result within 1e-5."""
    x, a, b, c, s0 = (torch.from_numpy(t) for t in _scan_inputs(40, 2))
    want = ts.ssd_chunked(x, a, b, c, 64, initial_state=s0)
    for chunk in (4, 8, 16):
        got = ts.ssd_chunked(x, a, b, c, chunk, initial_state=s0)
        for g, w in zip(got, want):
            _close(g, w, 1e-5)


def test_block_is_independent_of_the_chunk():
    """The full block at chunk 16 and 8 within 1e-5 (the reference's test
    holds its bf16 logits to 5e-2)."""
    _, tcfg = _cfgs()
    _, tcfg8 = _cfgs(chunk=8)
    _, tp = _sides(_params(tcfg))
    x = torch.from_numpy(_x((B, L, 64)))
    _close(ts.ssm_forward(tcfg8, tp, x), ts.ssm_forward(tcfg, tp, x), 1e-5)


def test_segsum_backward_is_finite_and_passes_gradcheck():
    """The masked segment sums put -inf above the diagonal before exp; the
    backward through the mask gives no NaN: ``gradcheck`` of the scan in
    float64 (a padded tail, two chunks, an initial state), and finite grads
    where every off-diagonal decay underflows to 0 in fp32 (a = -200)."""
    x, a, b, c, s0 = (torch.from_numpy(t).double().requires_grad_()
                      for t in _scan_inputs(7, 1, heads=2, p=2, n=3))

    def scan(x, a, b, c, s0):
        return ts.ssd_chunked(x, a, b, c, 4, initial_state=s0)
    assert torch.autograd.gradcheck(scan, (x, a, b, c, s0))
    seg = ts._segsum(torch.full((2, 5), -200.0, requires_grad=True))
    assert torch.isinf(seg).sum() == 2 * 10
    xs, a, b, c, _ = (torch.from_numpy(t).requires_grad_()
                      for t in _scan_inputs(12, 1))
    big = torch.full_like(a, -200.0).requires_grad_()
    y, final = ts.ssd_chunked(xs, big, b, c, 8)
    (y.sum() + final.sum()).backward()
    for t in (xs, big, b, c):
        assert torch.isfinite(t.grad).all()


def test_softplus_is_jaxs():
    """logaddexp(x, 0), as ``jax.nn.softplus`` (no threshold), within 1
    ulp over [-50, 100]."""
    x = np.linspace(-50, 100, 601).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = ts._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


def test_causal_conv_matches_the_reference():
    """The depthwise convolution as fp32 taps against the reference's
    ``conv_general_dilated``, within 1e-6."""
    jcfg, tcfg = _cfgs()
    p = _params(tcfg)
    x = _x((B, L, ts.ssm_dims(tcfg)[2]))
    want = js._causal_conv(jnp.asarray(x), jnp.asarray(p["conv_w"]),
                           jnp.asarray(p["conv_b"]))
    got = ts._causal_conv(torch.from_numpy(x), torch.from_numpy(p["conv_w"]),
                          torch.from_numpy(p["conv_b"]))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("groups", [1, 2])
def test_forward_matches_the_reference(groups):
    """The full block at L 37 (a ragged last chunk) and 48, one group or
    two, within 1e-5."""
    jcfg, tcfg = _cfgs(n_groups=groups)
    jp, tp = _sides(_params(tcfg))
    for length in (L, 48):
        x = _x((B, length, 64))
        want = js.ssm_forward(jcfg, jp, jnp.asarray(x))
        got = ts.ssm_forward(tcfg, tp, torch.from_numpy(x))
        _close(got, want, 1e-5)


@pytest.mark.parametrize("length", [L, 2])
def test_prefill_matches_the_reference_and_the_forward(length):
    """The prefill's output equals the forward's bit for bit; its output,
    state and convolution tail the reference's within 1e-5 (L 37); a 2-token
    prompt (shorter than the convolution's 3-input tail) zero-pads the
    tail, where the reference's tail would be 2 rows."""
    jcfg, tcfg = _cfgs()
    jp, tp = _sides(_params(tcfg))
    x = _x((B, length, 64))
    out, state = ts.ssm_prefill(tcfg, tp, torch.from_numpy(x))
    assert torch.equal(out, ts.ssm_forward(tcfg, tp, torch.from_numpy(x)))
    assert state["conv"].shape == (B, 3, ts.ssm_dims(tcfg)[2])
    assert state["state"].dtype == torch.float32
    jout, jstate = js.ssm_prefill(jcfg, jp, jnp.asarray(x))
    _close(out, jout, 1e-5)
    _close(state["state"], jstate["state"], 1e-5)
    if length >= 3:
        _close(state["conv"], jstate["conv"], 1e-5)
    else:
        assert not state["conv"][:, :3 - length].any()
        _close(state["conv"][:, 3 - length:], jstate["conv"], 1e-5)


def test_decode_steps_equal_the_forward():
    """A prefill of 29 tokens, then 8 decode steps, each in place on the
    cache: the steps' outputs equal the forward's at those positions and
    the reference's steps within 1e-5; the cache keeps its tensors."""
    jcfg, tcfg = _cfgs()
    jp, tp = _sides(_params(tcfg))
    x = _x((B, L, 64))
    tx = torch.from_numpy(x)
    full = ts.ssm_forward(tcfg, tp, tx)
    _, state = ts.ssm_prefill(tcfg, tp, tx[:, :29])
    cache = ts.init_ssm_cache(tcfg, B, torch.float32, "cpu")
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    for k in cache:
        cache[k].copy_(state[k])
    _, jcache = js.ssm_prefill(jcfg, jp, jnp.asarray(x[:, :29]))
    for t in range(29, L):
        out = ts.ssm_decode_step(tcfg, tp, tx[:, t:t + 1], cache)
        jout, jcache = js.ssm_decode_step(jcfg, jp, jnp.asarray(
            x[:, t:t + 1]), jcache)
        _close(out[:, 0], full[:, t], 1e-5)
        _close(out, jout, 1e-5)
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    _close(cache["state"], jcache["state"], 1e-5)
    _close(cache["conv"], jcache["conv"], 1e-5)


def _silu_in_fp32(x):
    """silu as the port computes it on any type: in fp32, rounded once.
    ``jax.nn.silu`` of a bf16 tensor rounds the logistic to bf16 before the
    product, and XLA's CPU logistic rounds differently from torch's sigmoid
    (28% of bf16 outputs differ on normal inputs), so the bf16 tests give
    the reference this silu to isolate the block's own rounding points."""
    return (x.astype(jnp.float32)
            * jax.nn.sigmoid(x.astype(jnp.float32))).astype(x.dtype)


def _bf16_sides(**ssm_kw):
    """(JAX config, port config, JAX params, port params) in bf16."""
    jcfg, tcfg = (dataclasses.replace(c, compute_dtype="bfloat16")
                  for c in _cfgs(**ssm_kw))
    p = _params(tcfg)
    return (jcfg, tcfg,
            {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p.items()},
            {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()})


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("length", [L, 48], ids=["ragged", "multiple"])
def test_full_sequence_rounds_as_the_reference_in_bf16(monkeypatch, length,
                                                       groups):
    """In bf16 the full-sequence paths (``ssm_forward`` and
    ``ssm_prefill``) round dt to x's type before ``x * dt``, add the skip
    term and gate in the compute type, as the reference's: against the
    reference run op by op (``jax.disable_jit``: XLA's fusions may keep
    bf16 intermediates in fp32) with the port's silu, at most 1% of the
    output's entries differ (fp32 sums in another order flip a rounding
    now and then; none at these inputs but 1 in 5,000), each by at most
    2 bf16 ulps of the output's max; the fp32 state's mean distance at
    most 1e-6 of its mean magnitude; the conv tail bit for bit. Moving any
    of the three rounding points makes 38-54% of the entries differ (the
    state's distance 5e-4 where dt's moves)."""
    monkeypatch.setattr(jax.nn, "silu", _silu_in_fp32)
    jcfg, tcfg, jp, tp = _bf16_sides(n_groups=groups)
    x = _x((B, length, 64))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    with jax.disable_jit():
        jx = jnp.asarray(x, jnp.bfloat16)
        want = np.asarray(js.ssm_forward(jcfg, jp, jx), np.float32)
        jout, jstate = js.ssm_prefill(jcfg, jp, jx)
    out, state = ts.ssm_prefill(tcfg, tp, tx)
    for got in (ts.ssm_forward(tcfg, tp, tx), out):
        assert got.dtype == torch.bfloat16
        diff = np.abs(got.float().numpy() - want)
        assert np.mean(diff > 0) <= 0.01
        assert diff.max() <= 2 * 2 ** -8 * np.abs(want).max()
    np.testing.assert_array_equal(np.asarray(jout, np.float32), want)
    jst = np.asarray(jstate["state"])
    assert (np.abs(state["state"].numpy() - jst).mean()
            <= 1e-6 * np.abs(jst).mean())
    np.testing.assert_array_equal(state["conv"].float().numpy(),
                                  np.asarray(jstate["conv"], np.float32))


def test_decode_rounds_as_the_reference_in_bf16():
    """In bf16 the decode step keeps the skip term in fp32 and rounds y
    once before the gate, as the reference's: one step from a prefilled
    state against the reference's within 2 bf16 ulps of the output's max
    (a rounding point moved would cost more)."""
    jcfg, tcfg, jp, tp = _bf16_sides()
    x = _x((B, 20, 64))
    _, jcache = js.ssm_prefill(jcfg, jp, jnp.asarray(x[:, :19],
                                                     jnp.bfloat16))
    cache = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16 if k == "conv" else torch.float32)
        for k, v in jcache.items()}
    want, _ = js.ssm_decode_step(jcfg, jp, jnp.asarray(x[:, 19:],
                                                       jnp.bfloat16), jcache)
    got = ts.ssm_decode_step(tcfg, tp, torch.from_numpy(x[:, 19:]).to(
        torch.bfloat16), cache)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 * 2 ** -8 * float(np.abs(want).max()))


def test_defs_match_the_reference():
    """The block's parameter paths, shapes and init kinds are the
    reference's."""
    jcfg, tcfg = _cfgs()
    want = {k: (tuple(v.shape), v.init, v.scale) for k, v in
            js.ssm_defs(jcfg, "ssm", stack=2).items()}
    assert {k: (tuple(v.shape), v.init, v.scale) for k, v in
            ts.ssm_defs(tcfg, "ssm", stack=2).items()} == want
    assert ts.ssm_dims(get_config(ARCH)) == (1536, 24, 1792, 3352)
