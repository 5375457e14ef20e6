"""The port's llama slice on the CPU against the JAX reference, at a small
width: forward, prefill and decode logits, the bf16 path anchored to an
fp32 truth, and the Engine/RequestQueue greedy token streams. Both sides
run the same weights: the reference's seeded params, converted with
params_from_numpy.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import RequestQueue as JRequestQueue

from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serve import Engine, Request, RequestQueue

SMALL = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             d_ff=256, vocab_size=512)
B, S, MAX_LEN, STEPS = 2, 12, 24, 4


def _cfgs(dtype):
    return (dataclasses.replace(j_get_config("llama-1b"), compute_dtype=dtype,
                                **SMALL),
            dataclasses.replace(get_config("llama-1b"), compute_dtype=dtype,
                                **SMALL))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs("float32")
    params = j_build_model(jcfg, mode="reference").init(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(0)
    return rng.integers(0, SMALL["vocab_size"], (B, S + STEPS)).astype(np.int32)


def _jax_logits(dtype, jparams, toks):
    """Teacher-forced logits of the JAX reference: prefill S tokens, then
    decode the given next tokens. Returns (prefill logits, [step logits],
    prefill cache)."""
    jcfg, _ = _cfgs(dtype)
    m = j_build_model(jcfg, mode="reference")
    cache, logits = m.prefill(jparams, jnp.asarray(toks[:, :S]),
                              m.init_cache(B, MAX_LEN))
    pre_cache = jax.tree.map(np.asarray, cache)
    steps = []
    for i in range(STEPS):
        cache, lg = m.decode_step(jparams, jnp.asarray(toks[:, S + i:S + i + 1]),
                                  cache, S + i)
        steps.append(np.asarray(lg, np.float32))
    return np.asarray(logits, np.float32), steps, pre_cache


def _port_logits(dtype, mode, np_params, toks):
    _, tcfg = _cfgs(dtype)
    m = build_model(tcfg, mode=mode, device="cpu")
    params = params_from_numpy(np_params, "cpu", getattr(torch, dtype))
    t = torch.from_numpy(toks).long()
    cache, logits = m.prefill(params, t[:, :S], m.init_cache(B, MAX_LEN))
    pre_cache = {k: v.float().numpy().copy() for k, v in cache.items()}
    steps = []
    for i in range(STEPS):
        cache, lg = m.decode_step(params, t[:, S + i:S + i + 1], cache, S + i)
        steps.append(lg.float().numpy())
    return logits.float().numpy(), steps, pre_cache


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_prefill_and_decode_logits_match_jax_f32(mode, weights, tokens):
    """fp32 on both sides; the residual stream reaches ~1e3 at this init, so
    the sums' different order shows at ~1e-5 of the logits' scale."""
    _, np_params = weights
    jpre, jsteps, jcache = _jax_logits("float32", weights[0], tokens)
    tpre, tsteps, tcache = _port_logits("float32", mode, np_params, tokens)
    scale = float(np.abs(jpre).max())
    np.testing.assert_allclose(tpre, jpre, rtol=0, atol=1e-4 * scale)
    for a, b in zip(tsteps, jsteps):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale)
    for key in ("k", "v"):
        c = float(np.abs(jcache[key]).max())
        np.testing.assert_allclose(tcache[key], jcache[key], rtol=0,
                                   atol=1e-5 * c)


@pytest.mark.parametrize("variant", ["published", "untied_bias_padded"])
@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_forward_logits_match_jax_f32(mode, variant, weights, tokens):
    """Full-sequence forward (every position's logits), fp32 on both sides,
    with the tolerance of the prefill test above. The second variant adds
    an untied head, q|k/v biases (random, so the rope+bias store is
    exercised) and a padded vocabulary whose columns are masked."""
    jparams, np_params = weights
    jcfg, tcfg = _cfgs("float32")
    if variant == "untied_bias_padded":
        extra = dict(tie_embeddings=False, qkv_bias=True, vocab_size=500,
                     vocab_pad_multiple=128)
        jcfg, tcfg = (dataclasses.replace(c, **extra) for c in (jcfg, tcfg))
        np_params = jax.tree.map(np.asarray, j_build_model(
            jcfg, mode="reference").init(jax.random.PRNGKey(1)))
        rng = np.random.default_rng(2)
        attn = np_params["blocks"]["attn"]
        for key in ("bqk", "bv"):
            attn[key] = rng.standard_normal(attn[key].shape).astype(np.float32)
        jparams = jax.tree.map(jnp.asarray, np_params)
        tokens = tokens % extra["vocab_size"]
    # the reference returns (logits, MoE aux loss); dense blocks have no aux
    want, _ = j_build_model(jcfg, mode="reference").forward(
        jparams, jnp.asarray(tokens))
    want = np.asarray(want, np.float32)
    got = build_model(tcfg, mode=mode, device="cpu").forward(
        params_from_numpy(np_params, "cpu", torch.float32),
        torch.from_numpy(tokens).long()).numpy()
    assert got.shape == want.shape == (B, S + STEPS, tcfg.padded_vocab())
    v = tcfg.vocab_size
    np.testing.assert_allclose(got[..., :v], want[..., :v], rtol=0,
                               atol=1e-4 * float(np.abs(want[..., :v]).max()))
    np.testing.assert_array_equal(got[..., v:], want[..., v:])


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_bf16_anchored_to_f32_truth(mode, weights, tokens):
    """bf16 rounds at other points in the two frameworks, so the port's bf16
    logits are held to the fp32 truth no worse than 2x the JAX bf16
    reference's error, + 1e-2 (the anchoring of tests/test_models.py)."""
    jparams, np_params = weights
    truth = _jax_logits("float32", jparams, tokens)
    jref = _jax_logits("bfloat16", jparams, tokens)
    port = _port_logits("bfloat16", mode, np_params, tokens)
    for t, r, p in zip([truth[0]] + truth[1], [jref[0]] + jref[1],
                       [port[0]] + port[1]):
        ref_err = float(np.abs(r - t).max())
        port_err = float(np.abs(p - t).max())
        assert np.isfinite(p).all()
        assert port_err <= 2.0 * ref_err + 1e-2, (port_err, ref_err)


def _requests(cls, n=5, seed=1):
    rng = np.random.default_rng(seed)
    return [cls(uid, rng.integers(0, SMALL["vocab_size"],
                                  rng.integers(6, 13)).astype(np.int32), 5)
            for uid in range(n)]


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_engine_greedy_streams_equal_jax_f32(mode, weights):
    """Greedy token streams through Engine + RequestQueue (bucketing, left
    padding, a forced partial batch) are identical to the JAX engine's."""
    jparams, np_params = weights
    jcfg, tcfg = _cfgs("float32")
    jq = JRequestQueue(JEngine(j_build_model(jcfg, mode="reference"), jparams,
                               max_len=20), 2, buckets=(12,))
    model = build_model(tcfg, mode=mode, device="cpu")
    tq = RequestQueue(Engine(model, params_from_numpy(np_params, "cpu",
                                                      torch.float32),
                             max_len=20), 2, buckets=(12,))
    for r in _requests(JRequest):
        jq.submit(r)
    for r in _requests(Request):
        tq.submit(r)
    assert tq.flush(force=True) == jq.flush(force=True) == 5
    assert sorted(tq.results) == sorted(jq.results)
    for uid in jq.results:
        np.testing.assert_array_equal(tq.results[uid], jq.results[uid])


def test_engine_sampling_is_seeded(weights):
    _, np_params = weights
    _, tcfg = _cfgs("float32")
    model = build_model(tcfg, mode="kernel", device="cpu")
    params = params_from_numpy(np_params, "cpu", torch.float32)
    outs = []
    for _ in range(2):
        q = RequestQueue(Engine(model, params, max_len=20), 2, buckets=(12,))
        for r in _requests(Request, n=2):
            q.submit(dataclasses.replace(r, temperature=1.0, seed=7))
        q.flush(force=True)
        outs.append(q.results)
    for uid in outs[0]:
        np.testing.assert_array_equal(outs[0][uid], outs[1][uid])
        assert (outs[0][uid] < SMALL["vocab_size"]).all()


def test_request_queue_duplicate_uid_warns(weights):
    _, np_params = weights
    _, tcfg = _cfgs("float32")
    model = build_model(tcfg, mode="reference", device="cpu")
    q = RequestQueue(Engine(model, params_from_numpy(np_params, "cpu",
                                                     torch.float32),
                            max_len=20), 1, buckets=(12,))
    r = _requests(Request, n=1)[0]
    q.submit(r)
    q.flush()
    q.submit(r)
    with pytest.warns(UserWarning, match="duplicate uid"):
        q.flush()
