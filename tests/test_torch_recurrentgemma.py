"""recurrentgemma-2b in the port against the JAX reference on the CPU, at
its smoke config (3 layers: the ``blocks_{i}`` stacks of the pattern
('rg', 'rg', 'local')) and a 5-layer variant of it (the pattern does not
divide 5: per-layer ``layer_{i:03d}`` subtrees, the published 26-layer
layout), in fp32: the parameter trees and their conversion name for name;
forward, prefill and decode logits past the 32-token local window in both
modes (kernel mode also against the reference's interpret-mode kernels);
the port's prefill and decode against its own forward; the greedy streams
of ``Engine`` + ``RequestQueue`` (left padding) and ``PagedEngine``
(prompts ending mid-page, a preempting pool) equal to the JAX engines';
``PagedEngine``'s three refusals on a recurrent stack. Both sides run the
reference's seeded init, converted with ``params_from_numpy``.
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
from repro.models.lm import lm_param_defs as j_lm_param_defs
from repro.serve import Engine as JEngine
from repro.serve import PagedEngine as JPagedEngine
from repro.serve import Request as JRequest
from repro.serve import RequestQueue as JRequestQueue

from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.lm import layer_slots, lm_param_defs
from repro_torch.serve import Engine, PagedEngine, Request, RequestQueue

ARCH = "recurrentgemma-2b"
LAYERS = (3, 5)
MODES = ("kernel", "reference")
# a prompt past the smoke config's 32-token local window, then decode steps
B, S, STEPS, MAX_LEN = 2, 36, 4, 48
# the logits' tolerance against the JAX model, a fraction of their max abs.
# At 3 layers the reference's init draws each blocks_{i} weight at std
# 1/sqrt(1) (its fan_in is the leading dim, the stack's one group), so an
# 'rg' block's output reaches ~2e3 and any two fp32 runs of the block sit
# ~4e-5 of that apart (JAX's rglru_forward and the port's each 4.1e-5 of it
# from a float64 recurrence on the same weights); through the 40 positions
# the two packages' logits then differ by up to 1.2e-4 of their max. At 5
# layers (per-layer weights at std 1/8) they agree to 1e-6 of it.
REL = {3: 3e-4, 5: 1e-4}


def _cfgs(layers):
    return tuple(dataclasses.replace(get(ARCH, smoke=True),
                                     compute_dtype="float32",
                                     num_layers=layers)
                 for get in (j_get_config, get_config))


@functools.lru_cache(maxsize=None)
def _np_params(layers):
    jcfg, _ = _cfgs(layers)
    return jax.tree.map(np.asarray, j_build_model(
        jcfg, mode="reference").init(jax.random.PRNGKey(0)))


def _port_params(layers):
    return params_from_numpy(_np_params(layers), "cpu", torch.float32)


@functools.lru_cache(maxsize=None)
def _tokens():
    rng = np.random.default_rng(0)
    return rng.integers(0, 512, (B, S + STEPS)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_outputs(layers, mode="reference"):
    """{forward, prefill, steps}: the full-sequence logits, the prefill's
    last logits and the teacher-forced decode steps' logits."""
    jcfg, _ = _cfgs(layers)
    m = j_build_model(jcfg, mode=mode)
    params = jax.tree.map(jnp.asarray, _np_params(layers))
    toks = jnp.asarray(_tokens())
    out = {"forward": np.asarray(m.forward(params, toks)[0], np.float32)}
    cache, logits = m.prefill(params, toks[:, :S], m.init_cache(B, MAX_LEN))
    out["prefill"] = np.asarray(logits, np.float32)
    out["steps"] = []
    for i in range(STEPS):
        cache, lg = m.decode_step(params, toks[:, S + i:S + i + 1], cache,
                                  S + i)
        out["steps"].append(np.asarray(lg, np.float32))
    return out


@functools.lru_cache(maxsize=None)
def _port_outputs(layers, mode):
    _, tcfg = _cfgs(layers)
    m = build_model(tcfg, mode=mode, device="cpu")
    params = _port_params(layers)
    toks = torch.from_numpy(_tokens()).long()
    with torch.no_grad():
        out = {"forward": m.forward(params, toks).numpy()}
        cache, logits = m.prefill(params, toks[:, :S],
                                  m.init_cache(B, MAX_LEN))
        out["prefill"] = logits.numpy()
        out["steps"] = []
        for i in range(STEPS):
            cache, lg = m.decode_step(params, toks[:, S + i:S + i + 1],
                                      cache, S + i)
            out["steps"].append(lg.numpy())
    return out


def _assert_logits(got, want, rel):
    atol = rel * float(np.abs(want["forward"]).max())
    for key in ("forward", "prefill"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol)
    for g, w in zip(got["steps"], want["steps"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the config and the parameter layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
def test_config_is_the_references_field_for_field(smoke):
    """Every field of the port's config equal to the reference's, the
    RG-LRU config by its fields; the reference's ModelConfig has no field
    the port lacks that this model sets."""
    got, want = get_config(ARCH, smoke=smoke), j_get_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "rglru":
            g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert g == w, f.name
    assert got.head_dim == (16 if smoke else 256)


@pytest.mark.parametrize("layers", LAYERS + (26,))
def test_param_tree_is_the_references(layers):
    """The port's declarations have the reference's paths and shapes:
    blocks_0..2 stacks at 3 layers, layer_000.. at 5 and at the published
    26 (the published width too)."""
    if layers == 26:
        jcfg, tcfg = j_get_config(ARCH), get_config(ARCH)
    else:
        jcfg, tcfg = _cfgs(layers)
    want = {k: tuple(v.shape) for k, v in j_lm_param_defs(jcfg).items()}
    got = {k: tuple(v.shape) for k, v in lm_param_defs(tcfg).items()}
    assert got == want
    prefix = "blocks_" if layers == 3 else "layer_"
    assert all(k.startswith((prefix, "embed", "final_norm")) for k in got)
    kinds = [kind for kind, _, _ in layer_slots(tcfg)]
    assert kinds == [("rg", "rg", "local")[i % 3] for i in range(layers)]


@pytest.mark.parametrize("layers", LAYERS)
def test_params_carried_across_name_for_name(layers):
    """params_from_numpy keeps every leaf of both layouts, value for
    value."""
    np_params = _np_params(layers)
    tp = _port_params(layers)

    def walk(a, b, path=""):
        assert sorted(a) == sorted(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                assert torch.equal(b[k], torch.from_numpy(
                    np.array(a[k], np.float32))), f"{path}/{k}"
    walk(np_params, tp)


# ---------------------------------------------------------------------------
# logits, both modes, fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layers", LAYERS)
def test_logits_match_jax_f32(layers, mode):
    """Forward, prefill (36 tokens, past the 32-token window) and
    teacher-forced decode logits within REL of the logits' max abs of the
    JAX model's reference mode (the scans' sums in another order)."""
    _assert_logits(_port_outputs(layers, mode), _jax_outputs(layers),
                   REL[layers])


@pytest.mark.parametrize("layers", LAYERS)
def test_kernel_mode_matches_jax_interpret(layers):
    """Kernel mode (its kernels' plain versions on the CPU; the local
    block's rope-store q|k GEMM at the smoke's head_dim 16, rung 2 at the
    published 256, which the store cannot hold)
    against the JAX model's interpret-mode kernels, within REL of the
    logits' max."""
    _assert_logits(_port_outputs(layers, "kernel"),
                   _jax_outputs(layers, "pallas_interpret"), REL[layers])


def test_head_dim_256_takes_rung_2_as_the_reference():
    """The published head_dim 256 at the 5-layer smoke width (2 query
    heads over one kv head): the rope store cannot hold a head, so kernel
    mode's local blocks take rung 2 (the q|k and v norm-prologue GEMMs,
    then the RoPE op), as the reference's ladder falls back; forward and
    prefill (past the window) within 1e-4 of the logits' max of the JAX
    model's interpret-mode kernels."""
    from repro_torch.kernels.gemm import rope_store_fits
    assert not rope_store_fits(256)
    jcfg, tcfg = (dataclasses.replace(c, num_heads=2, head_dim=256)
                  for c in _cfgs(5))
    params = jax.tree.map(np.asarray, j_build_model(
        jcfg, mode="reference").init(jax.random.PRNGKey(1)))
    toks = _tokens()[:, :S]
    jm = j_build_model(jcfg, mode="pallas_interpret")
    jp = jax.tree.map(jnp.asarray, params)
    want = np.asarray(jm.forward(jp, jnp.asarray(toks))[0])
    _, jlast = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(B, MAX_LEN))
    m = build_model(tcfg, mode="kernel", device="cpu")
    tp = params_from_numpy(params, "cpu", torch.float32)
    with torch.no_grad():
        got = m.forward(tp, torch.from_numpy(toks).long()).numpy()
        _, last = m.prefill(tp, torch.from_numpy(toks).long(),
                            m.init_cache(B, MAX_LEN))
    atol = 1e-4 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layers", LAYERS)
def test_prefill_and_decode_match_the_forward(layers, mode):
    """The port's prefill and decode steps against its own forward, within
    1e-5 of the logits' max: the ring past the window and the recurrent
    state carried by the cache."""
    out = _port_outputs(layers, mode)
    atol = 1e-5 * float(np.abs(out["forward"]).max())
    np.testing.assert_allclose(out["prefill"], out["forward"][:, S - 1],
                               rtol=0, atol=atol)
    for i, lg in enumerate(out["steps"]):
        np.testing.assert_allclose(lg, out["forward"][:, S + i], rtol=0,
                                   atol=atol)


# ---------------------------------------------------------------------------
# greedy engine streams, fp32
# ---------------------------------------------------------------------------

# prompts of 5-37 tokens (not page multiples) at page 8; "preempting": a
# 9-page pool that two long requests outgrow
PAGED_KW = {
    "paged": dict(batch_slots=2, page_size=8, max_pages_per_seq=6),
    "preempting": dict(batch_slots=2, page_size=8, max_pages_per_seq=6,
                       n_pages=10),
}


def _requests(cls, kind):
    rng = np.random.default_rng(1)
    if kind == "fixed":
        lens = [33, 30, 37, 31, 35]
    elif kind == "paged":
        lens = [5, 13, 37, 21]
    else:
        lens = [30, 29]
    return [cls(uid, rng.integers(0, 512, n).astype(np.int32), 6)
            for uid, n in enumerate(lens)]


@functools.lru_cache(maxsize=None)
def _jax_streams(layers, engine):
    jcfg, _ = _cfgs(layers)
    model = j_build_model(jcfg, mode="reference")
    params = jax.tree.map(jnp.asarray, _np_params(layers))
    if engine == "fixed":
        q = JRequestQueue(JEngine(model, params, max_len=MAX_LEN), 2,
                          buckets=(40,))
        for r in _requests(JRequest, "fixed"):
            q.submit(r)
        q.flush(force=True)
        return q.results, None
    eng = JPagedEngine(model, params, **PAGED_KW[engine])
    for r in _requests(JRequest, engine):
        eng.submit(r)
    return eng.run(), eng.preemptions


@pytest.mark.parametrize("engine", ["fixed", "paged", "preempting"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layers", LAYERS)
def test_engine_greedy_streams_equal_jax_f32(layers, mode, engine):
    """Engine + RequestQueue (30-37-token prompts left-padded to 40, past
    the window, a forced partial batch) and PagedEngine (exact-length
    prefills of prompts ending mid-page; a pool small enough to preempt,
    whose re-prefill rebuilds the state) give the JAX engines' greedy
    streams."""
    _, tcfg = _cfgs(layers)
    model = build_model(tcfg, mode=mode, device="cpu")
    params = _port_params(layers)
    if engine == "fixed":
        q = RequestQueue(Engine(model, params, max_len=MAX_LEN), 2,
                         buckets=(40,))
        for r in _requests(Request, "fixed"):
            q.submit(r)
        q.flush(force=True)
        got = q.results
    else:
        eng = PagedEngine(model, params, **PAGED_KW[engine])
        for r in _requests(Request, engine):
            eng.submit(r)
        got = eng.run()
    want, preemptions = _jax_streams(layers, engine)
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    if engine == "preempting":
        assert eng.preemptions == preemptions > 0


def test_paged_engine_equals_the_fixed_engine():
    """The reference's regression (tests/test_decode.py
    test_recurrent_arch_parity): a 5-token prompt (a partial page) through
    PagedEngine gives the fixed-batch engine's tokens, so the pad
    positions never reach the recurrent state."""
    _, tcfg = _cfgs(3)
    model = build_model(tcfg, mode="reference", device="cpu")
    params = _port_params(3)
    eng = PagedEngine(model, params, batch_slots=2, page_size=8,
                      max_pages_per_seq=4)
    prompt = np.arange(1, 6, dtype=np.int32)
    eng.submit(Request(0, prompt, 6))
    got = eng.run()[0]
    want = Engine(model, params, max_len=32).generate(prompt[None, :],
                                                      6).tokens[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("what,match", [
    ("prefix_cache", "prefix caching shares position-addressable KV pages"),
    ("chunk_tokens", "chunked prefill re-enters the prompt mid-stream"),
    ("draft", "speculative verify needs an attention-only stack")])
def test_paged_engine_refuses_the_fast_paths(what, match):
    """A recurrent stack's state cannot be shared by prefix, re-entered by
    chunks or stepped k tokens at once: the reference's refusals, on both
    packages."""
    jcfg, tcfg = _cfgs(3)
    kw = {"prefix_cache": dict(prefix_cache=True),
          "chunk_tokens": dict(chunk_tokens=8)}.get(what, {})
    model = build_model(tcfg, mode="reference", device="cpu")
    params = _port_params(3)
    jmodel = j_build_model(jcfg, mode="reference")
    jparams = jax.tree.map(jnp.asarray, _np_params(3))
    if what == "draft":
        kw = dict(draft_model=model, draft_params=params, spec_tokens=4)
        jkw = dict(draft_model=jmodel, draft_params=jparams, spec_tokens=4)
    else:
        jkw = kw
    with pytest.raises(ValueError, match=match):
        PagedEngine(model, params, batch_slots=2, page_size=8, **kw)
    with pytest.raises(ValueError, match=match):
        JPagedEngine(jmodel, jparams, batch_slots=2, page_size=8, **jkw)


def test_serving_launcher_on_the_cpu(capsys):
    """launch/serve.py serves the smoke config on the CPU through the
    request queue, prompts past the 32-token window."""
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--prompt-len", "40", "--new-tokens", "4"])
    assert "served 3 requests (3 unique results)" in capsys.readouterr().out
