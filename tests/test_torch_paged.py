"""The port's paged serving slice on the CPU against the JAX reference: the
paged KV cache (array ops, refcounted allocator, prefix trie), the paged
decode op (the kernel's plain version) against the Pallas kernel in
interpret mode, the paged LM functions (prefill, chunked prefill, 1- and
T-token decode) and PagedEngine's greedy streams (plain, preempted,
prefix-cached, chunked). Both sides run the same weights, the reference's
seeded params converted with params_from_numpy; inputs come from numpy
with a seed.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.kernels.attention import (
    attention_decode_paged as j_attention_decode_paged)
from repro.models import build_model as j_build_model
from repro.serve import PagedEngine as JPagedEngine
from repro.serve import Request as JRequest
from repro.serve import kv_cache as jkvc

from repro_torch.configs import get_config
from repro_torch.kernels.attention import attention_decode_paged
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serve import Engine, PagedEngine, Request
from repro_torch.serve import kv_cache as kvc

# the small llama-1b of tests/test_torch_serve.py
SMALL = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             d_ff=256, vocab_size=512)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(j_get_config("llama-1b"), compute_dtype=dtype,
                                **SMALL),
            dataclasses.replace(get_config("llama-1b"), compute_dtype=dtype,
                                **SMALL))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    params = j_build_model(jcfg, mode="reference").init(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _port(mode, np_params):
    _, tcfg = _cfgs()
    return (build_model(tcfg, mode=mode, device="cpu"),
            params_from_numpy(np_params, "cpu", torch.float32))


# ---------------------------------------------------------------------------
# paged KV cache: array ops and host bookkeeping
# ---------------------------------------------------------------------------

def _pool(n_pages=8, hkv=2, page=8, d=16):
    pool = kvc.init_page_pool(n_pages, hkv, page, d, torch.float32, "cpu")
    return pool["k_pages"], pool["v_pages"]


def test_append_crosses_page_boundary():
    rng = np.random.default_rng(0)
    k_pages, v_pages = _pool()
    pt = torch.tensor([[3, 5, 0, 0]], dtype=torch.int32)
    toks = [rng.standard_normal((1, 2, 1, 16)).astype(np.float32)
            for _ in range(12)]           # 12 tokens > one 8-slot page
    for i, t in enumerate(toks):
        kvc.append_paged_kv(k_pages, v_pages, torch.from_numpy(t),
                            torch.from_numpy(t), pt,
                            torch.tensor([i], dtype=torch.int32))
    got = kvc.gather_pages(k_pages, pt).numpy()           # (1, 2, 32, 16)
    np.testing.assert_array_equal(got[:, :, :12], np.concatenate(toks, 2))


def test_prefill_write_then_append_matches_dense():
    rng = np.random.default_rng(1)
    k_pages, v_pages = _pool()
    s_true = 11
    k = rng.standard_normal((1, 2, s_true, 16)).astype(np.float32)
    kvc.write_prefill_pages(k_pages, v_pages, torch.from_numpy(k),
                            torch.from_numpy(k), np.array([2, 6, 0, 0]))
    # 6 more tokens, one multi-token append starting mid-page 2 and
    # crossing into page 3
    pt = torch.tensor([[2, 6, 7, 0]], dtype=torch.int32)
    extra = rng.standard_normal((1, 2, 6, 16)).astype(np.float32)
    kvc.append_paged_kv(k_pages, v_pages, torch.from_numpy(extra),
                        torch.from_numpy(extra), pt,
                        torch.tensor([s_true], dtype=torch.int32))
    got = kvc.gather_pages(v_pages, pt).numpy()
    np.testing.assert_array_equal(got[:, :, : s_true + 6],
                                  np.concatenate([k, extra], axis=2))


def test_array_ops_match_jax_pools():
    """Multi-token appends (an inactive slot into the null page, a table
    index past the row clamped) and a chunked prefill write whose padded
    last page falls past the table give the reference's pools."""
    rng = np.random.default_rng(2)
    shape = (8, 2, 4, 16)
    kp0 = rng.standard_normal(shape).astype(np.float32)
    pt = np.array([[3, 5, 1], [0, 0, 0], [2, 4, 6]], np.int32)
    lens = np.array([5, 0, 10], np.int32)
    new = rng.standard_normal((3, 2, 3, 16)).astype(np.float32)
    chunk = rng.standard_normal((1, 2, 12, 16)).astype(np.float32)
    rows = np.array([7, 4, 6], np.int32)

    jk, jv = jkvc.append_paged_kv(jnp.asarray(kp0), jnp.asarray(kp0),
                                  jnp.asarray(new), jnp.asarray(new),
                                  jnp.asarray(pt), jnp.asarray(lens))
    jk, jv = jkvc.write_prefill_pages(jk, jv, jnp.asarray(chunk),
                                      jnp.asarray(chunk), jnp.asarray(rows),
                                      start_page=1)
    tk, tv = torch.from_numpy(kp0.copy()), torch.from_numpy(kp0.copy())
    kvc.append_paged_kv(tk, tv, torch.from_numpy(new), torch.from_numpy(new),
                        torch.from_numpy(pt), torch.from_numpy(lens))
    kvc.write_prefill_pages(tk, tv, torch.from_numpy(chunk),
                            torch.from_numpy(chunk), rows, start_page=1)
    # page 0 takes racing duplicate writes on both sides: not compared
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])
    np.testing.assert_array_equal(
        kvc.gather_pages(tk, torch.from_numpy(pt)).numpy()[[0, 2]],
        np.asarray(jkvc.gather_pages(jk, jnp.asarray(pt)))[[0, 2]])


def test_page_state_assign_and_release():
    state = kvc.init_page_state(3, 4)
    kvc.assign_slot(state, 1, [5, 2], 9)
    np.testing.assert_array_equal(state["page_table"][1], [5, 2, 0, 0])
    assert state["lengths"].tolist() == [0, 9, 0]
    kvc.release_slot(state, 1)
    assert not state["page_table"].any() and not state["lengths"].any()
    assert kvc.num_pages_needed(0, 8) == 1 and kvc.num_pages_needed(9, 8) == 2


def test_allocator_lifecycle():
    alloc = kvc.PageAllocator(5)          # pages 1..4 usable
    a = alloc.alloc(2)
    b = alloc.alloc(2)
    assert set(a) | set(b) == {1, 2, 3, 4}
    assert not alloc.can_alloc(1)
    with pytest.raises(MemoryError):
        alloc.alloc(1)
    alloc.free(a)
    assert alloc.can_alloc(2)
    with pytest.raises(ValueError):
        alloc.free(a)                     # double free
    with pytest.raises(ValueError):
        alloc.free([0])                   # the null page is not freeable


def test_retain_defers_free():
    alloc = kvc.PageAllocator(4)
    a, b_ = alloc.alloc(2)
    assert alloc.refcount(a) == 1
    assert alloc.retain(a) == 2
    alloc.free([a, b_])                   # drops one ref each
    assert alloc.refcount(a) == 1
    assert alloc.refcount(b_) == 0
    assert alloc.free_pages == 2
    alloc.free([a])
    assert alloc.free_pages == 3
    with pytest.raises(ValueError):
        alloc.free([a])
    with pytest.raises(ValueError):
        alloc.retain(b_)                  # retain of an unallocated page


@pytest.mark.parametrize("bad", [0, -1, 4])
def test_retain_rejects_invalid_ids(bad):
    alloc = kvc.PageAllocator(4)
    with pytest.raises(ValueError):
        alloc.retain(bad)


def test_prefix_match_stops_before_final_token():
    """COW rule: the page holding the final prompt token is never shared."""
    alloc = kvc.PageAllocator(8)
    trie = kvc.PrefixCache(page_size=4)
    toks = list(range(8))                 # exactly 2 full pages
    pages = alloc.alloc(2)
    trie.insert(toks, pages, alloc)
    assert trie.pages_held == 1           # (8-1)//4 = 1 shareable
    assert trie.match(toks, alloc) == pages[:1]
    alloc.free(pages[:1])
    assert trie.match(toks + [9], alloc) == pages[:1]
    alloc.free(pages[:1])
    pages3 = alloc.alloc(1)
    trie.insert(toks + [9], pages + pages3, alloc)
    got = trie.match(toks + [9, 10], alloc)
    assert got == pages
    alloc.free(got)


def test_prefix_divergent_tails_share_common_prefix_only():
    alloc = kvc.PageAllocator(16)
    trie = kvc.PrefixCache(page_size=4)
    a = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    b = [1, 2, 3, 4, 9, 9, 9, 9, 9]
    pa, pb = alloc.alloc(3), alloc.alloc(3)
    trie.insert(a, pa, alloc)
    trie.insert(b, pb, alloc)
    assert trie.pages_held == 3           # shared head + 2 tails
    got = trie.match([1, 2, 3, 4, 5, 6, 7, 8, 0, 0], alloc)
    assert got == pa[:2]
    alloc.free(got)


def test_prefix_evict_leaf_first_and_respects_refs():
    alloc = kvc.PageAllocator(8)
    trie = kvc.PrefixCache(page_size=2)
    toks = [1, 2, 3, 4, 5]                # two shareable pages
    pages = alloc.alloc(3)
    trie.insert(toks, pages, alloc)
    alloc.free(pages)                     # the inserting sequence retires
    held = trie.match(toks, alloc)        # an active borrower
    assert trie.evict(alloc, 2) == 0      # every page is referenced
    alloc.free(held)
    assert trie.evict(alloc, 1) == 1      # the leaf goes first
    assert trie.pages_held == 1
    assert alloc.refcount(pages[0]) == 1  # the interior node survives


# ---------------------------------------------------------------------------
# the paged decode op against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "window", "softcap", "sinks"])
@pytest.mark.parametrize("t", [1, 3])
def test_paged_decode_matches_jax_kernel(t, variant):
    """fp32 on both sides, the same sums in another order: atol 1e-5."""
    rng = np.random.default_rng(5)
    n_pages, hkv, page, d, h, b = 9, 2, 16, 32, 4, 2
    kp = rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32)
    q = rng.standard_normal((b, h, t, d)).astype(np.float32)
    pt = np.array([[3, 1, 7, 0], [2, 5, 0, 0]], np.int32)
    lens = np.array([55, 20], np.int32)   # lengths AFTER the t appends
    kw = {"window": dict(window=8), "softcap": dict(softcap=5.0),
          "sinks": dict(sinks=rng.standard_normal(h).astype(np.float32)),
          "plain": {}}[variant]
    want = np.asarray(j_attention_decode_paged(
        *(jnp.asarray(x) for x in (q, kp, vp, pt, lens)),
        **{k: jnp.asarray(v) if k == "sinks" else v for k, v in kw.items()},
        mode="pallas_interpret"))
    tkw = {k: torch.from_numpy(v) if k == "sinks" else v
           for k, v in kw.items()}
    for mode in ("kernel", "reference"):
        got = attention_decode_paged(
            *(torch.from_numpy(x) for x in (q, kp, vp, pt, lens)), **tkw,
            mode=mode)
        assert got.shape == (b, h, t, d)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_verify_rows_match_serial_single_token():
    """Row t of a T-token verify equals a 1-token decode at the same
    position, bit for bit (the oracle, as the reference checks it)."""
    rng = np.random.default_rng(6)
    n_pages, hkv, page, d, h, t = 6, 2, 8, 16, 4, 3
    kp = torch.from_numpy(rng.standard_normal(
        (n_pages, hkv, page, d)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal(
        (n_pages, hkv, page, d)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((1, h, t, d)).astype(np.float32))
    pt = torch.tensor([[2, 4, 1, 0]], dtype=torch.int32)
    multi = attention_decode_paged(q, kp, vp, pt,
                                   torch.tensor([14], dtype=torch.int32),
                                   mode="reference")
    for i in range(t):
        one = attention_decode_paged(q[:, :, i:i + 1], kp, vp, pt,
                                     torch.tensor([12 + i],
                                                  dtype=torch.int32),
                                     mode="reference")
        assert torch.equal(multi[:, :, i], one[:, :, 0])


# ---------------------------------------------------------------------------
# paged LM functions against the JAX model
# ---------------------------------------------------------------------------

PAGE, MP, N_PAGES = 8, 4, 12


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_paged_lm_functions_match_jax_f32(mode, weights):
    """Slot 0 prefills 11 tokens at exact length; slot 1 prefills 13 in two
    8-token chunks (the last one padded); then a 1-token decode and a
    3-token verify for both. Logits at every stage and the pools at the end
    match the reference's, fp32, within 1e-4 of the logits' scale."""
    jparams, np_params = weights
    jcfg, _ = _cfgs()
    jm = j_build_model(jcfg, mode="reference")
    tm, tparams = _port(mode, np_params)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, SMALL["vocab_size"], (2, 20)).astype(np.int32)
    pt = np.array([[3, 7, 0, 0], [5, 2, 9, 0]], np.int32)
    lens = np.array([11, 13], np.int32)

    jc = jm.init_paged_cache(2, N_PAGES, PAGE)
    tc = tm.init_paged_cache(2, N_PAGES, PAGE)
    stages = []
    jc, jl = jm.prefill_paged(jparams, jnp.asarray(toks[:1, :11]), jc,
                              jnp.asarray(pt[0]), 0, 11)
    tc, tl = tm.prefill_paged(tparams, torch.from_numpy(toks[:1, :11]).long(),
                              tc, pt[0], 0, 11)
    stages.append((jl, tl))
    for start in (0, 8):
        chunk = np.zeros((1, 8), np.int32)
        n = min(13, start + 8) - start
        chunk[0, :n] = toks[1, start:start + n]
        last = 13 - 1 - start if start + 8 >= 13 else 0
        jc, jl = jm.prefill_paged_chunk(jparams, jnp.asarray(chunk), jc,
                                        jnp.asarray(pt[1]), start, last)
        tc, tl = tm.prefill_paged_chunk(tparams,
                                        torch.from_numpy(chunk).long(), tc,
                                        pt[1], start, last)
        stages.append((jl, tl))
    for t in (1, 3):
        step = np.stack([toks[0, 11:11 + t], toks[1, 13:13 + t]])
        jc, jl = jm.decode_step_paged(jparams, jnp.asarray(step), jc,
                                      jnp.asarray(pt), jnp.asarray(lens))
        tc, tl = tm.decode_step_paged(tparams, torch.from_numpy(step).long(),
                                      tc, pt, lens)
        assert tuple(tl.shape) == ((2, SMALL["vocab_size"]) if t == 1 else
                                   (2, t, SMALL["vocab_size"]))
        stages.append((jl, tl))
        lens = lens + t
    scale = float(np.abs(np.asarray(stages[0][0])).max())
    for jl, tl in stages:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4 * scale)
    for key in ("k_pages", "v_pages"):
        want = np.asarray(jc[key])
        assert tc[key].shape == want.shape
        np.testing.assert_allclose(tc[key].numpy()[:, 1:], want[:, 1:],
                                   rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_paged_decode_equals_dense_bitwise(weights):
    """Reference mode inside the port: prefill + decode over pages gives
    the dense cache path's logits bit for bit, across a page boundary (the
    same batch, and a dense cache as long as the page table's span)."""
    _, np_params = weights
    model, params = _port("reference", np_params)
    prompt = torch.tensor([[5, 6, 7, 8, 9, 10]])
    page, mp = 4, 4
    dense = model.init_cache(1, page * mp)
    dense, dlog = model.prefill(params, prompt, dense)
    cache = model.init_paged_cache(1, 12, page)
    alloc = kvc.PageAllocator(12)
    state = kvc.init_page_state(1, mp)
    kvc.assign_slot(state, 0, alloc.alloc(2), 6)
    n_alloc = 2
    padded = torch.zeros((1, 8), dtype=torch.long)
    padded[0, :6] = prompt[0]
    cache, plog = model.prefill_paged(params, padded, cache,
                                      state["page_table"][0], 0, 6)
    assert torch.equal(dlog, plog)
    tok = torch.argmax(dlog, -1)[:, None]
    for i in range(5):
        if state["lengths"][0] + 1 > n_alloc * page:
            state["page_table"][0, n_alloc] = alloc.alloc(1)[0]
            n_alloc += 1
        dense, dlog = model.decode_step(params, tok, dense, 6 + i)
        cache, plog = model.decode_step_paged(params, tok, cache,
                                              state["page_table"],
                                              state["lengths"])
        state["lengths"][0] += 1
        assert torch.equal(dlog, plog)
        tok = torch.argmax(dlog, -1)[:, None]


# ---------------------------------------------------------------------------
# PagedEngine against the JAX PagedEngine and the port's own Engine
# ---------------------------------------------------------------------------

def _requests(cls, kind):
    rng = np.random.default_rng(4)
    v = SMALL["vocab_size"]
    if kind == "prefix_cache":
        head = rng.integers(0, v, 17).astype(np.int32)
        return [cls(u, np.concatenate([head, rng.integers(0, v, 3 + 2 * u)
                                       .astype(np.int32)]), 4)
                for u in range(3)]
    if kind == "preemption":
        return [cls(u, rng.integers(0, v, 4).astype(np.int32), 10)
                for u in range(2)]
    return [cls(u, rng.integers(0, v, (5, 12, 9)[u]).astype(np.int32),
                (4, 3, 5)[u]) for u in range(3)]


ENGINE_KW = {
    "plain": dict(batch_slots=2, page_size=8, max_pages_per_seq=4),
    "preemption": dict(batch_slots=2, page_size=4, max_pages_per_seq=4,
                       n_pages=5),
    "prefix_cache": dict(batch_slots=2, page_size=8, max_pages_per_seq=4,
                         prefix_cache=True),
    "chunked": dict(batch_slots=2, page_size=8, max_pages_per_seq=4,
                    chunk_tokens=8),
}


@pytest.mark.parametrize("kind", sorted(ENGINE_KW))
def test_paged_engine_greedy_streams_equal_jax_f32(kind, weights):
    """Greedy streams through continuous batching (with a forced
    preemption, a prefix-cache hit or interleaved 8-token chunks) equal
    the JAX PagedEngine's, and each equals the port's own fixed-batch
    Engine on the request alone."""
    jparams, np_params = weights
    jcfg, _ = _cfgs()
    jeng = JPagedEngine(j_build_model(jcfg, mode="reference"), jparams,
                        **ENGINE_KW[kind])
    model, params = _port("kernel", np_params)
    teng = PagedEngine(model, params, **ENGINE_KW[kind])
    for r in _requests(JRequest, kind):
        jeng.submit(r)
    for r in _requests(Request, kind):
        teng.submit(r)
    want, got = jeng.run(), teng.run()
    assert sorted(got) == sorted(want)
    fixed = Engine(model, params, max_len=64)
    for r in _requests(Request, kind):
        np.testing.assert_array_equal(got[r.uid], want[r.uid])
        alone = fixed.generate(r.prompt[None, :], r.max_new_tokens).tokens[0]
        np.testing.assert_array_equal(got[r.uid], alone)
    rep = teng.report()
    held = rep.get("prefix_cache", {}).get("pages_held", 0)
    assert teng.alloc.free_pages == teng.n_pages - 1 - held
    assert rep["completed"] == len(want)
    uids = {r.uid for r in _requests(Request, kind)}
    if kind == "preemption":
        assert rep["preemptions"] == jeng.preemptions > 0
        assert rep["preempted_uids"] and set(rep["preempted_uids"]) <= uids
    else:
        assert rep["preempted_uids"] == []
    if kind == "prefix_cache":
        assert rep["prefix_cache"]["hits"] == jeng.prefix.hits >= 1
        # the first request fills the trie; only later ones can hit it
        hit = set(rep["prefix_cache"]["hit_uids"])
        assert hit and hit <= uids - {0}
    if kind == "chunked":
        assert rep["chunked_prefill"]["chunks"] == jeng.chunks_prefilled > 2
        assert rep["prefills"] == 0
    else:
        assert rep["decode_steps"] > 0


@pytest.mark.parametrize("pages,bucket", [(1, 1), (2, 2), (3, 4), (4, 4),
                                          (5, 8), (8, 8), (9, 8)])
def test_page_bucket_is_capped_power_of_two(pages, bucket, weights):
    _, np_params = weights
    model, params = _port("kernel", np_params)
    eng = PagedEngine(model, params, batch_slots=2, page_size=8,
                      max_pages_per_seq=8)
    assert eng.page_bucket(pages) == bucket


def test_seeded_sampling_invariant_to_batchmates(weights):
    _, np_params = weights
    model, params = _port("kernel", np_params)

    def run_with(extra):
        eng = PagedEngine(model, params, batch_slots=2, page_size=8,
                          max_pages_per_seq=4)
        eng.submit(Request(0, np.arange(1, 7, dtype=np.int32), 5,
                           temperature=0.8, seed=123))
        for r in extra:
            eng.submit(r)
        return eng.run()[0]

    rng = np.random.default_rng(13)
    alone = run_with([])
    crowd = run_with([Request(9, rng.integers(0, SMALL["vocab_size"], 11)
                              .astype(np.int32), 7)])
    np.testing.assert_array_equal(alone, crowd)
    assert (alone < SMALL["vocab_size"]).all()


def test_seeded_sampling_survives_preemption(weights):
    _, np_params = weights
    model, params = _port("kernel", np_params)
    prompt = np.arange(1, 5, dtype=np.int32)
    big = PagedEngine(model, params, batch_slots=2, page_size=4,
                      max_pages_per_seq=6)
    big.submit(Request(0, prompt, 10, temperature=0.9, seed=42))
    want = big.run()[0]
    tight = PagedEngine(model, params, batch_slots=2, page_size=4,
                        max_pages_per_seq=6, n_pages=7)   # forces preempt
    tight.submit(Request(0, prompt, 10, temperature=0.9, seed=42))
    tight.submit(Request(1, np.random.default_rng(14).integers(
        0, SMALL["vocab_size"], 4).astype(np.int32), 10))
    got = tight.run()[0]
    assert tight.preemptions > 0
    np.testing.assert_array_equal(got, want)


def test_paged_engine_refuses_what_it_cannot_serve(weights):
    _, np_params = weights
    model, params = _port("kernel", np_params)
    spec = dict(draft_model=model, draft_params=params)
    with pytest.raises(ValueError, match="spec_tokens"):
        PagedEngine(model, params, spec_tokens=1, **spec)
    with pytest.raises(ValueError, match="temperature=0.0"):
        PagedEngine(model, params, temperature=0.5, spec_tokens=3, **spec)
    with pytest.raises(ValueError, match="multiple of page_size"):
        PagedEngine(model, params, page_size=8, chunk_tokens=12)
    eng = PagedEngine(model, params, batch_slots=2, page_size=4,
                      max_pages_per_seq=2)
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(Request(0, np.arange(6, dtype=np.int32), 3))
    if not torch.cuda.is_available():
        # the default device is the card: without one, nothing is built
        _, tcfg = _cfgs()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PagedEngine(build_model(tcfg), params)
