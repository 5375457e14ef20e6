"""mixtral-8x7b's mixture of experts in the port, on the CPU against the JAX
reference: the router (ids exactly, ties to the lower index), ``moe_dense``
in both modes, ``moe_forward``'s prenorm and dispatch, the parameter tree,
decode past the 32-token window of the smoke config through the ring
cache, and ``PagedEngine``'s fast paths (prefix cache, chunks, a
self-draft) over prompts longer than the window.

Both sides run the same numpy inputs; the model tests run the reference's
seeded init converted with ``params_from_numpy``. fp32 compute, so the
comparisons are of the algorithm: each tolerance is stated where it is
used.
"""
import contextlib
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import obs
from repro.configs import get_config as j_get_config
from repro.core import autotune
from repro.models import build_model as j_build_model
from repro.models import moe as j_moe
from repro.models.lm import lm_param_defs as j_lm_param_defs
from repro.serve import Engine as JEngine
from repro.serve import PagedEngine as JPagedEngine
from repro.serve import Request as JRequest

from repro_torch.configs import get_config
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, moe, params_from_numpy
from repro_torch.models.common import apply_prenorm
from repro_torch.models.lm import check_supported, lm_param_defs
from repro_torch.serve import Engine, PagedEngine, Request

ARCH = "mixtral-8x7b"
MODES = ("kernel", "reference")


def _cfgs():
    """(JAX, port) smoke configs in fp32: 2 layers, d 64, 4 experts top-2,
    d_ff 128, window 32."""
    return tuple(dataclasses.replace(get(ARCH, smoke=True),
                                     compute_dtype="float32")
                 for get in (j_get_config, get_config))


def _layer(d, f, e, scale, seed):
    """One MoE layer's numpy params {router, w_in, w_gate, w_out}."""
    rng = np.random.default_rng(seed)
    shapes = {"router": (d, e), "w_in": (e, d, f), "w_gate": (e, d, f),
              "w_out": (e, f, d)}
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _jnp(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

def _route_inputs(kind):
    """(x (T, D), router (D, E)). 'ties': small integers against dyadic
    weights, so every product and sum is exact in fp32 in any order; the
    router's columns 2 and 3 copy columns 0 and 1, so every row ties in
    pairs, and the zero rows tie all four experts. 'random': normal."""
    _, cfg = _cfgs()
    d, e, t = cfg.d_model, cfg.moe.num_experts, 48
    rng = np.random.default_rng(5)
    if kind == "random":
        return (rng.standard_normal((t, d)).astype(np.float32),
                rng.standard_normal((d, e)).astype(np.float32) * 0.3)
    x = rng.integers(-2, 3, (t, d)).astype(np.float32)
    x[::6] = 0.0
    half = rng.integers(-4, 5, (d, 2)).astype(np.float32) / 64.0
    return x, np.concatenate([half, half], axis=1)


@pytest.mark.parametrize("kind", ["ties", "random"])
def test_route_matches_jax(kind):
    """ids equal JAX's exactly (exact ties to the lower index, as
    ``jax.lax.top_k``); weights and aux within 1e-6."""
    jcfg, cfg = _cfgs()
    x, w = _route_inputs(kind)
    jw, jids, jaux = j_moe._route(jcfg, jnp.asarray(x), jnp.asarray(w))
    tw, tids, taux = moe._route(cfg, torch.from_numpy(x), torch.from_numpy(w))
    if kind == "ties":
        probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(w), -1)
        assert torch.equal(probs[:, :2], probs[:, 2:])
        assert (tids[::6] == torch.tensor([0, 1])).all()
        assert (tids[:, 0] < tids[:, 1]).all()
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# moe_dense, both modes
# ---------------------------------------------------------------------------

def test_moe_dense_reference_matches_jax():
    """The plain path against JAX's reference einsums at the smoke width
    (T 32): out within 1e-5 of its largest magnitude, aux within 1e-6."""
    jcfg, cfg = _cfgs()
    p = _layer(cfg.d_model, cfg.d_ff, cfg.moe.num_experts, 0.2, 1)
    x = np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    want, jaux = j_moe.moe_dense(jcfg, _jnp(p), jnp.asarray(x),
                                 mode="reference")
    got, aux = moe.moe_dense(cfg, _torch(p), torch.from_numpy(x),
                             mode="reference")
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)


@contextlib.contextmanager
def _jax_mlp_fused():
    """Pin the reference's 'mlp' fusion decision to the fused plan (its
    byte model decides per shape), so its expert FFN runs the interpret-mode
    gemm kernels; plans are memoised, so the caches are cleared."""
    orig = autotune.select_fusion

    def pinned(kind, shape, dtype="bfloat16", **kw):
        out = orig(kind, shape, dtype, **kw)
        return dict(out, plan="fused") if kind == "mlp" else out

    autotune.clear_policy_cache()
    autotune.select_fusion = pinned
    try:
        yield
    finally:
        autotune.select_fusion = orig
        autotune.clear_policy_cache()


# the reference test's shapes (tests/test_kernels.py,
# test_moe_dense_fused_matches_reference): 4 experts, d 128, d_ff 256, T 32
KCFG = types.SimpleNamespace(
    name="moe-kernel", mlp_act="swiglu", norm="rmsnorm",
    moe=types.SimpleNamespace(num_experts=4, top_k=2, capacity_factor=1.25,
                              impl="dense", shard="expert"))


@functools.lru_cache(maxsize=None)
def _kernel_case():
    p = _layer(128, 256, 4, 0.1, 3)
    x = np.random.default_rng(4).standard_normal((1, 32, 128)).astype(
        np.float32)
    with _jax_mlp_fused(), obs.capture() as cap:
        want, aux = j_moe.moe_dense(KCFG, _jnp(p), jnp.asarray(x),
                                    mode="pallas_interpret")
    chains = [e.chain for e in cap.launches if e.op == "gemm_fused"]
    return p, x, np.asarray(want), float(aux), chains


def test_kernel_mode_matches_jax_interpret():
    """The port's kernel mode (the plain versions of its launches on the
    CPU) against JAX's fused experts in interpret mode (8 gemm_fused
    launches), within the reference's own 3e-4; aux within 1e-6."""
    p, x, want, jaux, chains = _kernel_case()
    assert len(chains) == 8
    got, aux = moe.moe_dense(KCFG, _torch(p), torch.from_numpy(x),
                             mode="kernel")
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(float(aux), jaux, rtol=0, atol=1e-6)


def test_kernel_mode_launches_two_chains_per_expert(monkeypatch):
    """Per expert, in order: the dual-output silu-gated up-projection with
    no prologue, then the down-projection with no epilogue, each on the
    shared (T, D) tokens / the expert's (T, F) intermediate."""
    calls = []
    ref = gemm_ops.forward_ref

    def recording(a, b, epilogue, prologue, **kw):
        calls.append((tuple(a.shape), tuple(b.shape), epilogue.describe(),
                      prologue.describe(), kw["b2"] is not None))
        return ref(a, b, epilogue, prologue, **kw)

    monkeypatch.setattr(gemm_ops, "forward_ref", recording)
    p, x, *_ = _kernel_case()
    moe.moe_dense(KCFG, _torch(p), torch.from_numpy(x), mode="kernel")
    up = ((32, 128), (128, 256), gemm_ops.Epilogue(
        activation="silu", gate=True).describe(), "none", True)
    down = ((32, 256), (256, 128), "none", "none", False)
    assert calls == [up, down] * 4


@pytest.mark.parametrize("mode", MODES)
def test_moe_forward_prenorm_is_the_norm_then_dense(mode):
    """``moe_forward(prenorm=)`` equals the standalone norm followed by
    ``moe_dense``, bit for bit: the normed tokens feed the router and the
    experts alike."""
    _, cfg = _cfgs()
    p = _torch(_layer(cfg.d_model, cfg.d_ff, cfg.moe.num_experts, 0.2, 6))
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)).astype(
        np.float32))
    scale = torch.from_numpy(rng.standard_normal(cfg.d_model).astype(
        np.float32))
    got, aux = moe.moe_forward(cfg, p, x, mode=mode, prenorm=(scale, None))
    want, waux = moe.moe_dense(cfg, p, apply_prenorm(cfg, x, (scale, None)),
                               mode=mode)
    assert torch.equal(got, want) and torch.equal(aux, waux)


@pytest.mark.parametrize("impl", ["ep", "tp"])
def test_distributed_impls_raise(impl):
    """ep and tp without a mesh: refused, naming the mesh they need (with
    one they run, tests/test_torch_distributed.py)."""
    _, cfg = _cfgs()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           impl=impl))
    p = _torch(_layer(cfg.d_model, cfg.d_ff, cfg.moe.num_experts, 0.2, 6))
    with pytest.raises(NotImplementedError, match="needs a device mesh"):
        moe.moe_forward(cfg, p, torch.zeros((1, 2, cfg.d_model)))


def test_mixed_block_pattern_is_refused():
    """A mixed pattern is refused only for a block kind the port does not
    run: the interleaved ('attn', 'moe') layout (llama4-maverick's) is
    accepted, as is ('moe', 'attn'); ('attn', 'xattn') still raises, and
    'moe' blocks still need cfg.moe."""
    _, cfg = _cfgs()
    for pattern in (("attn", "moe"), ("moe", "attn")):
        check_supported(dataclasses.replace(cfg, block_pattern=pattern))
    with pytest.raises(NotImplementedError, match="xattn"):
        check_supported(dataclasses.replace(cfg,
                                            block_pattern=("attn", "xattn")))
    with pytest.raises(ValueError, match="need cfg.moe"):
        check_supported(dataclasses.replace(cfg, moe=None,
                                            block_pattern=("attn", "moe")))


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
def test_param_tree_is_the_references(smoke):
    """The port's parameter declarations have the reference's paths and
    shapes: blocks/moe/{router, w_in, w_gate, w_out} with a leading layer
    axis, and no blocks/mlp."""
    jdefs = j_lm_param_defs(j_get_config(ARCH, smoke=smoke))
    defs = lm_param_defs(get_config(ARCH, smoke=smoke))
    assert {k: tuple(v.shape) for k, v in defs.items()} == \
        {k: tuple(v.shape) for k, v in jdefs.items()}
    assert not any(k.startswith("blocks/mlp") for k in defs)


# ---------------------------------------------------------------------------
# decode past the window through the ring cache
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _np_params():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, j_build_model(
        jcfg, mode="reference").init(jax.random.PRNGKey(0)))


RING_S, RING_DECODE = 48, 4   # a 44-token prefill, then 4 decode steps


@functools.lru_cache(maxsize=None)
def _ring_tokens():
    _, cfg = _cfgs()
    return np.random.default_rng(11).integers(
        0, cfg.vocab_size, (1, RING_S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_ring():
    jcfg, _ = _cfgs()
    m = j_build_model(jcfg, mode="reference")
    params = jax.tree.map(jnp.asarray, _np_params())
    toks = jnp.asarray(_ring_tokens())
    p = RING_S - RING_DECODE
    cache, lg = m.prefill(params, toks[:, :p], m.init_cache(1, jcfg.max_seq_len))
    out = [np.asarray(lg)]
    for i in range(p, RING_S):
        cache, lg = m.decode_step(params, toks[:, i:i + 1], cache, i)
        out.append(np.asarray(lg))
    return out


@pytest.mark.parametrize("mode", MODES)
def test_decode_past_the_window_matches_jax(mode):
    """Mixtral's smoke config (window 32) with a 32-slot ring: a 44-token
    prefill wraps it, then 4 decode steps; each step's logits within 1e-4
    of their largest magnitude of JAX's and of the port's own full-sequence
    windowed forward at that position."""
    _, cfg = _cfgs()
    m = build_model(cfg, mode=mode, device="cpu")
    params = params_from_numpy(_np_params(), "cpu", torch.float32)
    toks = torch.from_numpy(_ring_tokens()).long()
    p = RING_S - RING_DECODE
    want = _jax_ring()
    with torch.no_grad():
        full = m.forward(params, toks)[0].numpy()
        cache = m.init_cache(1, cfg.max_seq_len)
        assert cache["k"].shape[3] == cfg.attn_window == 32
        cache, lg = m.prefill(params, toks[:, :p], cache)
        got = [lg.numpy()]
        for i in range(p, RING_S):
            cache, lg = m.decode_step(params, toks[:, i:i + 1], cache, i)
            got.append(lg.numpy())
    atol = 1e-4 * float(np.abs(full).max())
    for j, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
        np.testing.assert_allclose(g[0], full[p - 1 + j], rtol=0, atol=atol)


@pytest.mark.parametrize("mode", MODES)
def test_decode_at_a_device_position_is_the_int_one(mode):
    """The decode step at a one-element int64 position (what a captured
    step reads) gives the int position's bits, MoE FFN and ring included."""
    _, cfg = _cfgs()
    m = build_model(cfg, mode=mode, device="cpu")
    params = params_from_numpy(_np_params(), "cpu", torch.float32)
    toks = torch.from_numpy(_ring_tokens()).long()
    with torch.no_grad():
        cache, _ = m.prefill(params, toks[:, :40], m.init_cache(1, 64))
        c2 = {k: v.clone() for k, v in cache.items()}
        _, a = m.decode_step(params, toks[:, 40:41], cache, 40)
        _, b = m.decode_step(params, toks[:, 40:41], c2,
                             torch.tensor([40], dtype=torch.int64))
    assert torch.equal(a, b)
    assert all(torch.equal(cache[k], c2[k]) for k in cache)


# ---------------------------------------------------------------------------
# PagedEngine's fast paths over prompts longer than the window
# ---------------------------------------------------------------------------

# 3 requests sharing a 33-token head (4 full pages), 38-40 prompt tokens,
# 5 new: every stream crosses the 32-token window
PREFIX, NEW = 33, 5
PAGED = dict(batch_slots=2, page_size=8, max_pages_per_seq=8)
FAST = {"prefix": dict(prefix_cache=True), "chunks": dict(chunk_tokens=8),
        "self_draft": dict(spec_tokens=3)}


def _shared_prefix(cls):
    _, cfg = _cfgs()
    rng = np.random.default_rng(0)
    head = rng.integers(0, cfg.vocab_size, PREFIX).astype(np.int32)
    return [cls(uid, np.concatenate(
        [head, rng.integers(0, cfg.vocab_size, 5 + uid).astype(np.int32)]),
        NEW) for uid in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_streams(path):
    """The JAX PagedEngine's streams on fast path ``path`` and the JAX
    Engine's (one request at a time, a 64-token cache: a 32-slot ring)."""
    jcfg, _ = _cfgs()
    model = j_build_model(jcfg, mode="reference")
    params = jax.tree.map(jnp.asarray, _np_params())
    kw = dict(FAST[path])
    if path == "self_draft":
        kw.update(draft_model=model, draft_params=params)
    eng = JPagedEngine(model, params, **PAGED, **kw)
    reqs = _shared_prefix(JRequest)
    for r in reqs:
        eng.submit(r)
    fixed = JEngine(model, params, max_len=64)
    dense = {r.uid: np.asarray(fixed.generate(
        r.prompt[None, :], r.max_new_tokens).tokens[0]) for r in reqs}
    return eng.run(), dense


@pytest.mark.parametrize("path", list(FAST))
@pytest.mark.parametrize("mode", MODES)
def test_paged_fast_paths_equal_the_engines(mode, path):
    """The port's PagedEngine with a prefix cache, 8-token chunks or a
    self-draft (k 3) gives the port's Engine's greedy streams and both JAX
    engines'."""
    _, cfg = _cfgs()
    model = build_model(cfg, mode=mode, device="cpu")
    params = params_from_numpy(_np_params(), "cpu", torch.float32)
    kw = dict(FAST[path])
    if path == "self_draft":
        kw.update(draft_model=model, draft_params=params)
    eng = PagedEngine(model, params, **PAGED, **kw)
    reqs = _shared_prefix(Request)
    for r in reqs:
        eng.submit(r)
    got = eng.run()
    fixed = Engine(model, params, max_len=64)
    jpaged, jdense = _jax_streams(path)
    for r in reqs:
        dense = fixed.generate(r.prompt[None, :], r.max_new_tokens).tokens[0]
        assert len(got[r.uid]) > cfg.attn_window
        np.testing.assert_array_equal(got[r.uid], dense)
        np.testing.assert_array_equal(got[r.uid], jpaged[r.uid])
        np.testing.assert_array_equal(got[r.uid], jdense[r.uid])
    rep = eng.report()
    if path == "prefix":
        assert rep["prefix_cache"]["hits"] >= 1
    if path == "chunks":
        assert eng.chunks_prefilled >= 5
    if path == "self_draft":
        assert rep["speculative"]["rounds"] >= 1


def test_serving_cli_serves_mixtral_past_its_window(capsys):
    """``launch/serve.py --arch mixtral-8x7b`` on the CPU (the smoke
    config): prompts of 24-48 tokens and 8 new, past the 32-token window,
    every request answered."""
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "4",
                       "--prompt-len", "48", "--new-tokens", "8"])
    assert "served 4 requests (4 unique results)" in capsys.readouterr().out
