"""The engines' bucket LRU and the decode step a CUDA graph captures, on the
CPU: ``bucket_lru`` hits, misses and evictions equal to the JAX engines'
on the same request streams at ``max_cached_buckets=2``; the decode step
at a position held in a device tensor (what a captured step reads) bit
for bit the step at a Python int, ring wrap included; and ``Engine``'s
per-batch caches reused across ``generate`` calls without changing the
streams. The graphs themselves are captured and replayed on the card
(``tests/test_torch_cuda.py``); on the CPU a decode bucket runs the eager
step over the same buffers.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.serve import Engine as JEngine
from repro.serve import PagedEngine as JPagedEngine
from repro.serve import Request as JRequest
from repro.serve import RequestQueue as JRequestQueue

from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serve import Engine, PagedEngine, Request, RequestQueue
from repro_torch.serve.engine import DecodeGraph

# the small llama-1b of tests/test_torch_serve.py
SMALL = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             d_ff=256, vocab_size=512)
CAP = 2


def _cfgs(**extra):
    return tuple(dataclasses.replace(get("llama-1b"), compute_dtype="float32",
                                     **SMALL, **extra)
                 for get in (j_get_config, get_config))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    params = j_build_model(jcfg, mode="reference").init(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _port(np_params, mode="kernel", **extra):
    return (build_model(_cfgs(**extra)[1], mode=mode, device="cpu"),
            params_from_numpy(np_params, "cpu", torch.float32))


# ---------------------------------------------------------------------------
# the LRU against the reference's
# ---------------------------------------------------------------------------

def _queue_requests(cls):
    """Prompts in three length buckets, so (batch, prompt_len) keys and the
    shared ("decode", 2) key compete for two entries."""
    rng = np.random.default_rng(5)
    lens = (5, 11, 15, 7, 16, 3, 12)
    return [cls(u, rng.integers(0, SMALL["vocab_size"], n).astype(np.int32),
                3) for u, n in enumerate(lens)]


def _serve_queue(engine, cls):
    """Two rounds of the stream through RequestQueue(engine), batch 2."""
    q = RequestQueue(engine, 2, buckets=(8, 12, 16)) if cls is Request \
        else JRequestQueue(engine, 2, buckets=(8, 12, 16))
    served = 0
    for round_ in range(2):
        for r in _queue_requests(cls):
            q.submit(dataclasses.replace(r, uid=r.uid + 10 * round_))
        served += q.flush(force=True)
    return served, q.results


def test_engine_bucket_lru_equals_jax(weights):
    """The same request stream through RequestQueue(Engine) on both sides
    at max_cached_buckets=2: the same hits, misses and evictions, at most 2
    live entries, and, against the port at the default cap (no eviction),
    the same greedy streams. (Against the JAX streams, request 4's last
    token is a tie of two logits within fp32 rounding at this seed; the
    streams' parity is tests/test_torch_serve.py's.)"""
    jparams, np_params = weights
    jeng = JEngine(j_build_model(_cfgs()[0], mode="reference"), jparams,
                   max_len=24, max_cached_buckets=CAP)
    model, params = _port(np_params)
    teng = Engine(model, params, max_len=24, max_cached_buckets=CAP)
    served, got = _serve_queue(teng, Request)
    assert served == _serve_queue(jeng, JRequest)[0] == 14
    assert teng.lru_stats == jeng.lru_stats
    assert teng.lru_stats["evictions"] > 0 and teng.lru_stats["hits"] > 0
    assert len(teng._buckets) <= CAP
    wide = Engine(model, params, max_len=24)
    _, want = _serve_queue(wide, Request)
    assert wide.lru_stats["evictions"] == 0
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])


PAGED_KW = {
    "plain": dict(batch_slots=2, page_size=4, max_pages_per_seq=8),
    "prefix_chunked": dict(batch_slots=2, page_size=4, max_pages_per_seq=8,
                           prefix_cache=True, chunk_tokens=8),
}


def _paged_requests(cls):
    """Prompts of several lengths (exact-length prefill keys) growing
    through page buckets 2, 4 and 8, two sharing an 8-token prefix."""
    rng = np.random.default_rng(6)
    v = SMALL["vocab_size"]
    head = rng.integers(0, v, 8).astype(np.int32)
    prompts = [rng.integers(0, v, 5), np.concatenate([head, [1, 2, 3]]),
               rng.integers(0, v, 9), np.concatenate([head, [4, 5]]),
               rng.integers(0, v, 3)]
    return [cls(u, np.asarray(p, np.int32), (14, 6, 9, 4, 12)[u])
            for u, p in enumerate(prompts)]


@pytest.mark.parametrize("kind", sorted(PAGED_KW))
def test_paged_engine_bucket_lru_equals_jax(kind, weights):
    """The same stream through PagedEngine on both sides at
    max_cached_buckets=2: report()["bucket_lru"] equal to the reference's,
    over decode (batch_slots, page_count) keys and ("prefill", S) or
    ("chunk", C) keys; the greedy streams equal."""
    jparams, np_params = weights
    jeng = JPagedEngine(j_build_model(_cfgs()[0], mode="reference"), jparams,
                        max_cached_buckets=CAP, **PAGED_KW[kind])
    model, params = _port(np_params)
    teng = PagedEngine(model, params, max_cached_buckets=CAP,
                       **PAGED_KW[kind])
    for r in _paged_requests(JRequest):
        jeng.submit(r)
    for r in _paged_requests(Request):
        teng.submit(r)
    want, got = jeng.run(), teng.run()
    lru = teng.report()["bucket_lru"]
    assert lru == jeng.report()["bucket_lru"]
    assert lru["evictions"] > 0 and lru["hits"] > 0
    assert len(teng._buckets) <= CAP
    assert {k[0] for k in teng._buckets if isinstance(k[0], str)} <= {
        "prefill", "chunk"}
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])


# ---------------------------------------------------------------------------
# the decode step at a device position
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 6], ids=["full", "ring"])
@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_device_position_decode_step_is_bitwise_the_int_path(mode, window,
                                                             weights):
    """lm_decode_step with the position as a one-element int64 tensor (the
    slot, the lengths and the rope tables derived on the device) gives the
    int path's logits and caches bit for bit, past the ring's wrap."""
    _, np_params = weights
    model, params = _port(np_params, mode, attn_window=window)
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, SMALL["vocab_size"], (2, 14)))
    caches = []
    for _ in range(2):
        cache, _ = model.prefill(params, toks[:, :5], model.init_cache(2, 16))
        caches.append(cache)
    for i in range(5, 13):
        tok = toks[:, i:i + 1]
        _, want = model.decode_step(params, tok, caches[0], i)
        _, got = model.decode_step(params, tok, caches[1],
                                   torch.tensor([i], dtype=torch.int64))
        assert torch.equal(got, want)
        for key in ("k", "v"):
            assert torch.equal(caches[1][key], caches[0][key])


def test_decode_graph_on_the_cpu_runs_the_eager_step():
    """On the CPU a bucket copies its inputs into its buffers and runs the
    step eagerly: no graph, no recorded launches."""
    seen = []

    def step(token, pos):
        seen.append((token.clone(), pos.clone()))
        return token.float() + pos

    g = DecodeGraph(step, {"token": torch.zeros((2, 1), dtype=torch.int64),
                           "pos": torch.zeros((1,), dtype=torch.int64)})
    out = g(token=np.array([[3], [4]]), pos=7)
    assert torch.equal(out, torch.tensor([[10.0], [11.0]]))
    out = g(token=torch.tensor([[1], [2]]), pos=9)
    assert torch.equal(out, torch.tensor([[10.0], [11.0]]))
    assert g.graph is None and g.launches == {}
    assert [int(p) for _, p in seen] == [7, 9]


# ---------------------------------------------------------------------------
# Engine's per-batch caches
# ---------------------------------------------------------------------------

def test_engine_reuses_its_cache_across_generate_calls(weights):
    """A second generate at the same batch decodes into the first call's
    cache (the ("decode", batch) entry's) over its stale slots, and gives
    the streams a fresh engine gives."""
    _, np_params = weights
    model, params = _port(np_params)
    rng = np.random.default_rng(8)
    first = rng.integers(0, SMALL["vocab_size"], (2, 12))
    second = rng.integers(0, SMALL["vocab_size"], (2, 7))
    eng = Engine(model, params, max_len=24)
    eng.generate(first, 10)
    cache = eng._buckets[("decode", 2)].cache
    got = eng.generate(second, 6).tokens
    assert eng._buckets[("decode", 2)].cache is cache
    assert eng.lru_stats == {"hits": 1, "misses": 3, "evictions": 0}
    want = Engine(model, params, max_len=24).generate(second, 6).tokens
    np.testing.assert_array_equal(got, want)
