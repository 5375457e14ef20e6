"""The port's greedy speculative decoding in PagedEngine on the CPU against
the JAX PagedEngine: a self-draft, a draft of other seeded weights, a
layer-skip draft (the target's embedding, final norm and first block) and
all fast paths stacked (prefix cache, chunked prefill, a draft), at
test_torch_paged's small llama and granite-8b's smoke config, in both
modes. Each run's greedy streams and ``report()["speculative"]`` equal the
JAX engine's, and its streams equal the port's plain PagedEngine's. Also
the bucket LRU with the draft and verify keys at ``max_cached_buckets=2``,
preemption under a verify block's headroom, submit's overshoot bound and
the refusals. Both sides run the reference's seeded params converted with
params_from_numpy; prompts come from numpy with a seed.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import jax
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.serve import PagedEngine as JPagedEngine
from repro.serve import Request as JRequest

from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serve import PagedEngine, Request

# the small llama-1b of tests/test_torch_paged.py
SMALL = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             d_ff=256, vocab_size=512)
K = 3
CAP = 2


def _cfgs(arch, **extra):
    """(JAX, port) configs in fp32: the small llama, or granite-8b's smoke
    config."""
    if arch == "llama":
        return tuple(dataclasses.replace(get("llama-1b"),
                                         compute_dtype="float32", **SMALL,
                                         **extra)
                     for get in (j_get_config, get_config))
    return tuple(dataclasses.replace(get(arch, smoke=True),
                                     compute_dtype="float32", **extra)
                 for get in (j_get_config, get_config))


@functools.lru_cache(maxsize=None)
def _np_params(arch, seed=0):
    jcfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, j_build_model(
        jcfg, mode="reference").init(jax.random.PRNGKey(seed)))


def _skip_params(params, layers=1):
    """The target's embedding, final norm and first ``layers`` blocks."""
    return {**params, "blocks": jax.tree.map(lambda x: x[:layers],
                                             params["blocks"])}


def _drafts(arch, draft):
    """(JAX draft config, its numpy params) of a draft kind."""
    jcfg, _ = _cfgs(arch)
    if draft == "self" or draft == "stacked":
        return jcfg, _np_params(arch)
    if draft == "other":
        return jcfg, _np_params(arch, 7)
    if draft == "skip":
        return dataclasses.replace(jcfg, num_layers=1), _skip_params(
            _np_params(arch))
    raise ValueError(draft)


def _requests(cls, arch, kind="mixed"):
    """Three prompts of 5-17 tokens (two sharing a 9-token prefix for the
    prefix cache), 5-11 new tokens; under ``"tight"`` two 4-token prompts
    and 10 new tokens each."""
    rng = np.random.default_rng(4)
    v = _cfgs(arch)[1].vocab_size
    if kind == "tight":
        return [cls(u, rng.integers(0, v, 4).astype(np.int32), 10)
                for u in range(2)]
    head = rng.integers(0, v, 9).astype(np.int32)
    prompts = [rng.integers(0, v, 5), np.concatenate([head, [1, 2, 3]]),
               np.concatenate([head, rng.integers(0, v, 8)])]
    return [cls(u, np.asarray(p, np.int32), (9, 6, 11)[u])
            for u, p in enumerate(prompts)]


ENGINE_KW = {
    "mixed": dict(batch_slots=2, page_size=8, max_pages_per_seq=4),
    # 5 usable pages of 4 tokens for two slots that grow to 4-5 pages each
    "tight": dict(batch_slots=2, page_size=4, max_pages_per_seq=6,
                  n_pages=6),
}
STACKED = dict(prefix_cache=True, chunk_tokens=8)


def _engine_kw(draft, kind, **extra):
    kw = dict(ENGINE_KW[kind], **extra)
    if draft == "stacked":
        kw.update(STACKED)
    return kw


@functools.lru_cache(maxsize=None)
def _jax_run(arch, draft, kind="mixed", cap=8):
    """The JAX engine's streams, report and bucket LRU."""
    jcfg, _ = _cfgs(arch)
    jm = j_build_model(jcfg, mode="reference")
    params = jax.tree.map(jax.numpy.asarray, _np_params(arch))
    dcfg, dparams = _drafts(arch, draft)
    eng = JPagedEngine(jm, params, draft_model=j_build_model(
        dcfg, mode="reference"), draft_params=jax.tree.map(
        jax.numpy.asarray, dparams), spec_tokens=K, max_cached_buckets=cap,
        **_engine_kw(draft, kind))
    for r in _requests(JRequest, arch, kind):
        eng.submit(r)
    return eng.run(), eng.report()


def _port_engine(arch, draft, mode, kind="mixed", **extra):
    _, tcfg = _cfgs(arch)
    model = build_model(tcfg, mode=mode, device="cpu")
    params = params_from_numpy(_np_params(arch), "cpu", torch.float32)
    kw = _engine_kw(draft, kind, **extra)
    if draft is None:
        return PagedEngine(model, params, **kw)
    dcfg, dparams = _drafts(arch, draft)
    dcfg = dataclasses.replace(tcfg, num_layers=dcfg.num_layers)
    return PagedEngine(model, params,
                       draft_model=build_model(dcfg, mode=mode, device="cpu"),
                       draft_params=params_from_numpy(dparams, "cpu",
                                                      torch.float32),
                       spec_tokens=K, **kw)


def _serve(engine, arch, kind="mixed"):
    for r in _requests(Request, arch, kind):
        engine.submit(r)
    return engine.run()


@functools.lru_cache(maxsize=None)
def _plain_streams(arch, mode, kind="mixed", stacked=False):
    return _serve(_port_engine(arch, None, mode, kind,
                               **(STACKED if stacked else {})), arch, kind)


def _assert_streams(got, want):
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])


@pytest.mark.parametrize("mode", ["kernel", "reference"])
@pytest.mark.parametrize("arch,draft", [
    ("llama", "self"), ("llama", "other"), ("llama", "skip"),
    ("llama", "stacked"), ("granite-8b", "self"), ("granite-8b", "other")])
def test_spec_streams_equal_jax_and_plain(arch, draft, mode):
    """Greedy streams and report()["speculative"] equal the JAX engine's;
    the streams equal the port's plain PagedEngine's (the target's greedy
    streams whatever the draft proposes); a self-draft accepts every
    proposal and emits k tokens a round."""
    want, jrep = _jax_run(arch, draft)
    eng = _port_engine(arch, draft, mode)
    got = _serve(eng, arch)
    rep = eng.report()
    _assert_streams(got, want)
    _assert_streams(got, _plain_streams(arch, mode,
                                        stacked=draft == "stacked"))
    spec = rep["speculative"]
    assert spec == jrep["speculative"]
    assert spec["k"] == K and spec["rounds"] > 0
    assert 1.0 <= spec["mean_tokens_per_round"] <= K
    if draft in ("self", "stacked"):
        assert spec["accept_rate"] == 1.0
        assert spec["mean_tokens_per_round"] == K
    else:
        assert spec["accept_rate"] < 1.0
    assert rep["decode_steps"] == 0
    assert rep["tokens_generated"] >= sum(
        r.max_new_tokens for r in _requests(Request, arch))
    held = rep.get("prefix_cache", {}).get("pages_held", 0)
    assert eng.alloc.free_pages == eng.n_pages - 1 - held
    if draft == "stacked":
        assert rep["prefix_cache"]["hits"] == jrep["prefix_cache"]["hits"] >= 1
        assert rep["chunked_prefill"] == jrep["chunked_prefill"]
        assert rep["chunked_prefill"]["chunks"] > 2


@pytest.mark.parametrize("draft", ["self", "stacked"])
def test_spec_bucket_lru_equals_jax(draft):
    """At max_cached_buckets=2 the draft and verify buckets compete with the
    prefill and chunk ones in the one LRU: report()["bucket_lru"] equal to
    the reference's, with evictions; with room for every bucket the cached
    keys are the reference's kinds, the verify and draft_* ones among
    them."""
    want, jrep = _jax_run("llama", draft, cap=CAP)
    eng = _port_engine("llama", draft, "kernel", max_cached_buckets=CAP)
    got = _serve(eng, "llama")
    lru = eng.report()["bucket_lru"]
    assert lru == jrep["bucket_lru"]
    assert lru["evictions"] > 0 and lru["hits"] > 0
    assert len(eng._buckets) <= CAP
    _assert_streams(got, want)
    wide = _port_engine("llama", draft, "kernel", max_cached_buckets=64)
    _serve(wide, "llama")
    kinds = {k[0] if isinstance(k[0], str) else "decode"
             for k in wide._buckets}
    first = "chunk" if draft == "stacked" else "prefill"
    assert kinds == {first, f"draft_{first}", "verify", "draft_decode"}
    assert wide.report()["bucket_lru"]["evictions"] == 0
    verify = next(v for k, v in wide._buckets.items() if k[0] == "verify")
    assert tuple(verify.buffers["token"].shape) == (2, K)


@pytest.mark.parametrize("draft", ["self", "other"])
def test_spec_preempts_under_a_verify_blocks_headroom(draft):
    """Two slots on a 5-page pool: growth reserves k positions a round, so
    the pool runs out earlier than for single-token decode and a slot is
    preempted (recompute); the streams still equal the JAX engine's and
    the plain engine's, with the reference's preemption count."""
    want, _ = _jax_run("llama", draft, "tight")
    eng = _port_engine("llama", draft, "kernel", "tight")
    got = _serve(eng, "llama", "tight")
    _assert_streams(got, want)
    _assert_streams(got, _plain_streams("llama", "kernel", "tight"))
    rep = eng.report()
    assert rep["preemptions"] > 0
    assert rep["preempted_uids"]
    assert eng.alloc.free_pages == eng.n_pages - 1


def test_spec_submit_bounds_the_overshoot():
    """A request takes prompt + new + k positions of its row: at the cap it
    is accepted, one past it refused, where the plain engine takes it."""
    eng = _port_engine("llama", "self", "kernel")
    cap = 4 * 8
    eng.submit(Request(0, np.arange(cap - 4 - K, dtype=np.int32), 4))
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(Request(1, np.arange(cap - 3 - K, dtype=np.int32), 4))
    _port_engine("llama", None, "kernel").submit(
        Request(1, np.arange(cap - 3 - K, dtype=np.int32), 4))


def test_spec_refusals():
    """The reference's refusals: sampled requests, an engine temperature,
    spec_tokens under 2, a draft of another vocabulary, a hybrid stack."""
    _, tcfg = _cfgs("llama")
    model = build_model(tcfg, mode="kernel", device="cpu")
    params = params_from_numpy(_np_params("llama"), "cpu", torch.float32)
    kw = dict(batch_slots=2, page_size=8, max_pages_per_seq=4,
              draft_model=model, draft_params=params)
    eng = PagedEngine(model, params, spec_tokens=2, **kw)
    with pytest.raises(ValueError, match="greedy"):
        eng.submit(Request(0, np.arange(4, dtype=np.int32), 2,
                           temperature=0.7))
    eng.submit(Request(1, np.arange(4, dtype=np.int32), 2, temperature=0.0))
    with pytest.raises(ValueError, match="temperature=0.0"):
        PagedEngine(model, params, temperature=0.5, spec_tokens=2, **kw)
    with pytest.raises(ValueError, match="spec_tokens"):
        PagedEngine(model, params, spec_tokens=1, **kw)
    other = build_model(dataclasses.replace(tcfg, vocab_size=256),
                        mode="kernel", device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        PagedEngine(model, params, spec_tokens=2,
                    **dict(kw, draft_model=other))
    hybrid = types.SimpleNamespace(cfg=dataclasses.replace(
        tcfg, block_pattern=("attn", "ssm")))
    with pytest.raises(ValueError, match="attention-only"):
        PagedEngine(hybrid, params, spec_tokens=2, **kw)
