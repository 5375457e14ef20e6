"""The port's ``ShardedPagedEngine`` (``serve/topology.py``) on the CPU
against the reference's: N ``PagedEngine`` hosts over one copy of the
weights behind one request surface, each request placed on the host with
the most free pages, then the fewest queued requests, then the lowest id.

On the same requests the two packages make the same placements, the same
``admissions_by_host`` and ``report`` aggregates, and the same greedy
streams: granite-8b's smoke config at the reference's seeded init, as the
reference's own ``TestShardedPagedEngine`` runs it, with requests that
arrive while the hosts already serve (so free pages, not only queue
lengths, decide) over pools that preempt, and three hosts with the
prefix cache and chunked prefill. Each host's streams and counters are a lone
``PagedEngine``'s fed the requests placed on it (also over llama4-maverick's
interleaved stack); the streams equal ``Engine.generate``'s; a duplicate
uid and a host count under 1 raise; the ``obs`` counter and span. fp32.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.serve import Request as JRequest
from repro.serve import ShardedPagedEngine as JShardedPagedEngine

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serve import (Engine, PagedEngine, Request,
                               ShardedPagedEngine)

ARCH = "granite-8b"
MODES = ("kernel", "reference")
AGGREGATES = ("steps", "admissions", "preemptions", "tokens_generated",
              "completed", "page_pool_size")
# name -> (engine keywords, requests, steps run before the second half of
# the requests arrives)
CASES = {
    "arrivals_preempting": (dict(n_hosts=2, batch_slots=2, page_size=8,
                                 max_pages_per_seq=4, n_pages=4), 6, 2),
    "three_hosts_fast_paths": (dict(n_hosts=3, batch_slots=2, page_size=8,
                                    max_pages_per_seq=4, prefix_cache=True,
                                    chunk_tokens=8), 7, 3),
}


def _cfgs():
    return tuple(dataclasses.replace(get(ARCH, smoke=True),
                                     compute_dtype="float32")
                 for get in (j_get_config, get_config))


@functools.lru_cache(maxsize=None)
def _np_params():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, j_build_model(
        jcfg, mode="reference").init(jax.random.PRNGKey(0)))


def _requests(cls, n, vocab, seed=1):
    """``n`` greedy requests of 7, 11 or 13 tokens (few lengths: the JAX
    engine compiles a prefill per length), 3-5 new; every third shares the
    first one's 8-token (one-page) head."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, 8).astype(np.int32)
    out = []
    for uid in range(n):
        prompt = rng.integers(0, vocab, int(rng.choice([7, 11]))).astype(
            np.int32)
        if uid % 3 == 0:
            prompt = np.concatenate([head, prompt[:5]])
        out.append(cls(uid, prompt, int(rng.integers(3, 6))))
    return out


def _drive(eng, reqs, early: int) -> dict:
    """Submit the first half, step ``early`` times, submit the rest (each
    placed by the hosts' loads at that moment), run to the end."""
    half = (len(reqs) + 1) // 2
    for r in reqs[:half]:
        eng.submit(r)
    for _ in range(early):
        eng.step()
    for r in reqs[half:]:
        eng.submit(r)
    return eng.run()


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    jcfg, _ = _cfgs()
    kw, n, early = CASES[case]
    model = j_build_model(jcfg, mode="reference")
    eng = JShardedPagedEngine(model, jax.tree.map(jnp.asarray, _np_params()),
                              **kw)
    results = _drive(eng, _requests(JRequest, n, jcfg.vocab_size), early)
    rep = eng.report()
    return ({uid: np.asarray(t) for uid, t in results.items()},
            {k: rep[k] for k in AGGREGATES + ("admissions_by_host",
                                              "placements")})


def _port_engine(case, mode):
    _, cfg = _cfgs()
    model = build_model(cfg, mode=mode, device="cpu")
    params = params_from_numpy(_np_params(), "cpu", torch.float32)
    return ShardedPagedEngine(model, params, **CASES[case][0]), model, params


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_placements_report_and_streams_equal_the_references(mode, case):
    """The same requests through both packages' sharded engines: the same
    host for every uid, the same admissions by host and report aggregates
    (steps, admissions, preemptions, tokens, completions, pool pages), and
    the same greedy streams."""
    _, cfg = _cfgs()
    eng, _, _ = _port_engine(case, mode)
    _, n, early = CASES[case]
    got = _drive(eng, _requests(Request, n, cfg.vocab_size), early)
    want, jrep = _jax_run(case)
    rep = eng.report()
    assert rep["placements"] == jrep["placements"]
    assert rep["admissions_by_host"] == jrep["admissions_by_host"]
    for k in AGGREGATES:
        assert rep[k] == jrep[k], k
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    assert rep["n_hosts"] == CASES[case][0]["n_hosts"]
    assert len(rep["per_host"]) == rep["n_hosts"]
    if case == "arrivals_preempting":
        assert rep["preemptions"] >= 1
        # the late half went by free pages: not every host got the same
        assert rep["admissions_by_host"] != [3, 3]


def _lone_equal(eng, reqs, model, params, kw):
    """Each host's streams and report equal a lone PagedEngine's fed the
    requests placed on that host, in their order."""
    for host, h in enumerate(eng.hosts):
        lone = PagedEngine(model, params, **kw)
        mine = [r for r in reqs if eng.placements[r.uid] == host]
        assert len(mine) == eng.admissions_by_host[host]
        for r in mine:
            lone.submit(r)
        got = lone.run()
        assert sorted(got) == sorted(h.results) == [r.uid for r in mine]
        for uid in got:
            np.testing.assert_array_equal(h.results[uid], got[uid])
        mine_rep, lone_rep = h.report(), lone.report()
        for k in AGGREGATES:
            if k != "steps":      # a host steps while the others have work
                assert mine_rep[k] == lone_rep[k], (host, k)


@pytest.mark.parametrize("mode", MODES)
def test_each_host_is_a_lone_engine(mode):
    """granite's smoke config, every request submitted before the first
    step (3 hosts: a least-loaded round robin)."""
    _, cfg = _cfgs()
    kw = dict(batch_slots=2, page_size=8, max_pages_per_seq=4)
    model = build_model(cfg, mode=mode, device="cpu")
    params = params_from_numpy(_np_params(), "cpu", torch.float32)
    eng = ShardedPagedEngine(model, params, n_hosts=3, **kw)
    reqs = _requests(Request, 7, cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert eng.admissions_by_host == [3, 2, 2]
    assert eng.placements == {r.uid: r.uid % 3 for r in reqs}
    _lone_equal(eng, reqs, model, params, kw)


@pytest.mark.parametrize("mode", MODES)
def test_each_host_is_a_lone_engine_on_maverick(mode):
    """llama4-maverick's interleaved stack (its smoke config, the port's
    seeded init), 8-token chunks, requests arriving mid-run: each host a
    lone PagedEngine, and the hosts share the one params tree."""
    cfg = dataclasses.replace(get_config("llama4-maverick-400b-a17b",
                                         smoke=True), compute_dtype="float32")
    kw = dict(batch_slots=2, page_size=8, max_pages_per_seq=4,
              chunk_tokens=8)
    model = build_model(cfg, mode=mode, device="cpu")
    params = model.init(seed=3)
    eng = ShardedPagedEngine(model, params, n_hosts=2, **kw)
    assert all(h.params is params for h in eng.hosts)
    reqs = _requests(Request, 6, cfg.vocab_size, seed=2)
    _drive(eng, reqs, 2)
    _lone_equal(eng, reqs, model, params, kw)


def test_streams_equal_the_engine():
    """As the reference's test_parity_with_single_engine: every request's
    stream equals ``Engine.generate`` of its prompt alone."""
    _, cfg = _cfgs()
    eng, model, params = _port_engine("arrivals_preempting", "reference")
    reqs = _requests(Request, 4, cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    results = eng.run()
    golden = Engine(model, params, max_len=64)
    for r in reqs:
        want = golden.generate(r.prompt[None, :], r.max_new_tokens).tokens[0]
        np.testing.assert_array_equal(results[r.uid], want)


def test_duplicate_uid_rejected():
    _, cfg = _cfgs()
    eng, _, _ = _port_engine("arrivals_preempting", "reference")
    (req,) = _requests(Request, 1, cfg.vocab_size)
    eng.submit(req)
    with pytest.raises(ValueError, match="already submitted"):
        eng.submit(req)
    assert eng.admissions_by_host == [1, 0]


@pytest.mark.parametrize("n_hosts", [0, -1])
def test_bad_host_count_rejected(n_hosts):
    _, cfg = _cfgs()
    model = build_model(cfg, mode="reference", device="cpu")
    with pytest.raises(ValueError, match="n_hosts"):
        ShardedPagedEngine(model, {}, n_hosts=n_hosts)


def test_obs_counter_and_span():
    """``sharded_engine.submitted`` counts the submissions and one
    ``sharded_engine.run`` span covers the run, as the reference's."""
    _, cfg = _cfgs()
    eng, _, _ = _port_engine("arrivals_preempting", "reference")
    with obs.capture() as cap:
        for r in _requests(Request, 4, cfg.vocab_size):
            eng.submit(r)
        eng.run()
    assert cap.counter("sharded_engine.submitted") == 4
    assert [s.name for s in cap.spans].count("sharded_engine.run") == 1
