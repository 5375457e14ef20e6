"""llama4-maverick-400b-a17b in the port, on the CPU against the JAX
reference: the interleaved ('attn', 'moe') stack (layer 2i attention with
the dense SwiGLU MLP, layer 2i + 1 attention with the top-1 MoE) at the
smoke config (d 64, 4 heads over 2, 8 experts top-1, d_ff 128) in both of
its layouts, 2 layers (the ``blocks_0``/``blocks_1`` stacks) and 3 (the
``layer_{i:03d}`` subtrees): the parameter trees, ``params_from_numpy`` of
the reference's init, the router's ids at top-1 (ties included), the
logits of the forward, the prefill and decode steps, ``lm_loss`` with its
load-balancing term and every leaf's grad against ``jax.grad`` in both
modes, the training levers on the mixed layout, the kernel launches by
block kind, the plain experts' cast to the tokens' type, and the greedy
streams of ``Engine`` + ``RequestQueue`` and ``PagedEngine`` (chunks too)
against the JAX engines.

The port's kernel mode is held to the reference's ``pallas_interpret``
with its fusion decisions pinned to the fused plans the port always runs
(the QKV chain with the rope store and the SwiGLU MLP, the experts'
too). Both sides run the same numpy weights: each matrix at std
fan_in^-1/2 over its input dim (the reference's own init reads a stack's
leading dim as fan_in, std 1 at 2 layers); the reference's own init only
where its conversion is the point. fp32 compute, so the comparisons are
of the algorithm: each tolerance is stated where it is used.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.core import autotune
from repro.models import build_model as j_build_model
from repro.models import moe as j_moe
from repro.models.lm import lm_param_defs as j_lm_param_defs
from repro.serve import Engine as JEngine
from repro.serve import PagedEngine as JPagedEngine
from repro.serve import Request as JRequest
from repro.serve import RequestQueue as JRequestQueue

from repro_torch import data as tdata
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.models import build_model, lm, moe, params_from_numpy
from repro_torch.models.common import (cast_params, init_params, nest,
                                       tree_map)
from repro_torch.optim.optimizer import named_leaves
from repro_torch.serve import Engine, PagedEngine, Request, RequestQueue
from repro_torch.train import loss_and_grads

ARCH = "llama4-maverick-400b-a17b"
MODES = {"kernel": "pallas_interpret", "reference": "reference"}
LAYERS = (2, 3)
# the loss's batch; the logits' B x (S + STEPS) tokens, S prefilled
B, S, STEPS, MAX_LEN = 2, 12, 4, 24


def _cfgs(layers=2):
    """(JAX, port) smoke configs in fp32 at ``layers`` layers."""
    return tuple(dataclasses.replace(get(ARCH, smoke=True),
                                     compute_dtype="float32",
                                     num_layers=layers)
                 for get in (j_get_config, get_config))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": v})
    return out


@functools.lru_cache(maxsize=None)
def _np_params(layers):
    """The reference's tree, ones and zeros by its init kinds, each matrix
    at std fan_in^-1/2 over its input dim, from a numpy seed."""
    rng = np.random.default_rng(layers)
    flat = {}
    for path, d in sorted(j_lm_param_defs(_cfgs(layers)[0]).items()):
        if d.init == "ones":
            flat[path] = np.ones(d.shape, np.float32)
        elif d.init == "zeros":
            flat[path] = np.zeros(d.shape, np.float32)
        else:
            fan_in = d.shape[-1] if path == "embed" else d.shape[-2]
            flat[path] = (rng.standard_normal(d.shape)
                          / np.sqrt(fan_in)).astype(np.float32)
    return nest(flat)


@functools.lru_cache(maxsize=None)
def _tokens():
    return np.random.default_rng(0).integers(
        0, _cfgs()[1].vocab_size, (B, S + STEPS)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _np_batch():
    return tdata.batch_at(tdata.DataConfig(
        vocab_size=_cfgs()[1].vocab_size, seq_len=32, global_batch=B), 0)


@contextlib.contextmanager
def _jax_fused():
    """Pin the reference's fusion decisions to the fused plans the port's
    kernel mode runs (the QKV chain, with or without the rope store, and
    the SwiGLU MLP, the experts' too), so its interpret-mode GEMM kernels
    run forward and backward; plans are memoised, so the caches are
    cleared."""
    orig = autotune.select_fusion

    def pinned(kind, shape, dtype="bfloat16", **kw):
        out = orig(kind, shape, dtype, **kw)
        return (dict(out, plan="fused") if kind in ("qkv", "qkv_rope", "mlp")
                else out)

    autotune.clear_policy_cache()
    autotune.select_fusion = pinned
    try:
        yield
    finally:
        autotune.select_fusion = orig
        autotune.clear_policy_cache()


def _ctx(jmode):
    return _jax_fused() if jmode != "reference" else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# the parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [2, 3, 48])
def test_param_tree_is_the_references(layers):
    """The port's declarations have the reference's paths and shapes: at an
    even depth one stack per pattern position, the dense MLP's under
    ``blocks_0`` and the MoE's under ``blocks_1``; at an odd depth one
    subtree per layer, the MoE in the odd ones."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=layers < 48),
                              num_layers=layers)
    jcfg = dataclasses.replace(j_get_config(ARCH, smoke=layers < 48),
                               num_layers=layers)
    defs = lm.lm_param_defs(cfg)
    assert {k: tuple(v.shape) for k, v in defs.items()} == \
        {k: tuple(v.shape) for k, v in j_lm_param_defs(jcfg).items()}
    if layers % 2 == 0:
        assert defs["blocks_1/moe/w_in"].shape[:2] == (
            layers // 2, cfg.moe.num_experts)
        assert "blocks_0/mlp/w_in" in defs and "blocks_0/moe/w_in" not in defs
    else:
        assert [lm.layer_slots(cfg)[i][0] for i in range(3)] == \
            ["attn", "moe", "attn"]
        assert "layer_001/moe/router" in defs and "layer_002/mlp/w_in" in defs
    assert "lm_head" in defs     # untied


@functools.lru_cache(maxsize=None)
def _jax_init(layers):
    jcfg, _ = _cfgs(layers)
    return jax.tree.map(np.asarray, j_build_model(
        jcfg, mode="reference").init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("layers", LAYERS)
def test_params_from_numpy_carries_the_reference_init(layers):
    """The reference's seeded init converts leaf for leaf, bit for bit, in
    either layout, and the port's plain forward on it gives the JAX
    model's logits within 1e-4 of their largest magnitude."""
    jcfg, cfg = _cfgs(layers)
    jp = _jax_init(layers)
    tp = params_from_numpy(jp, "cpu", torch.float32)
    flat = _flat(jp)
    assert sorted(p for p, _ in named_leaves(tp)) == sorted(flat)
    for path, leaf in named_leaves(tp):
        assert np.array_equal(leaf.numpy(), flat[path]), path
    toks = _tokens()
    want = np.asarray(jax.jit(j_build_model(jcfg, mode="reference").forward)(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(toks))[0])
    with torch.no_grad():
        got = build_model(cfg, mode="reference", device="cpu").forward(
            tp, torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# the router at top-1
# ---------------------------------------------------------------------------

def _route_inputs(kind):
    """(x (T, D), router (D, E)). 'ties': small integers against dyadic
    weights, every product and sum exact in fp32; the router's columns
    4-7 copy columns 0-3, so every row's best expert ties with its copy,
    and the zero rows tie all eight. 'random': normal."""
    _, cfg = _cfgs()
    d, e, t = cfg.d_model, cfg.moe.num_experts, 48
    rng = np.random.default_rng(5)
    if kind == "random":
        return (rng.standard_normal((t, d)).astype(np.float32),
                rng.standard_normal((d, e)).astype(np.float32) * 0.3)
    x = rng.integers(-2, 3, (t, d)).astype(np.float32)
    x[::6] = 0.0
    half = rng.integers(-4, 5, (d, e // 2)).astype(np.float32) / 64.0
    return x, np.concatenate([half, half], axis=1)


@pytest.mark.parametrize("kind", ["ties", "random"])
def test_route_top1_matches_jax(kind):
    """One expert a token: ids equal JAX's exactly (an exact tie to the
    lower index, as ``jax.lax.top_k``), each weight exactly 1 after the
    renormalisation, aux within 1e-6."""
    jcfg, cfg = _cfgs()
    x, w = _route_inputs(kind)
    jw, jids, jaux = j_moe._route(jcfg, jnp.asarray(x), jnp.asarray(w))
    tw, tids, taux = moe._route(cfg, torch.from_numpy(x), torch.from_numpy(w))
    assert tids.shape == (x.shape[0], 1)
    if kind == "ties":
        assert (tids[::6] == 0).all()
        assert (tids < cfg.moe.num_experts // 2).all()
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert torch.equal(tw, torch.ones_like(tw))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# logits: forward, prefill, decode steps
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_logits(layers, jmode):
    jcfg, _ = _cfgs(layers)
    params = jax.tree.map(jnp.asarray, _np_params(layers))
    toks = jnp.asarray(_tokens())
    with _ctx(jmode):
        m = j_build_model(jcfg, mode=jmode)
        out = {"forward": np.asarray(jax.jit(m.forward)(params, toks)[0])}
        cache, lg = jax.jit(m.prefill)(params, toks[:, :S],
                                       m.init_cache(B, MAX_LEN))
        out["prefill"] = np.asarray(lg)
        out["steps"] = []
        step = jax.jit(m.decode_step)       # one compile, a traced position
        for i in range(STEPS):
            cache, lg = step(params, toks[:, S + i:S + i + 1], cache,
                             jnp.int32(S + i))
            out["steps"].append(np.asarray(lg))
    return out


@pytest.mark.parametrize("layers", LAYERS)
@pytest.mark.parametrize("mode", list(MODES))
def test_logits_match_jax(mode, layers):
    """The full-sequence logits, the prefill's last logits and 4
    teacher-forced decode steps' within 1e-4 of the logits' largest
    magnitude of the JAX model's (kernel mode against its interpret-mode
    kernels)."""
    _, cfg = _cfgs(layers)
    want = _jax_logits(layers, MODES[mode])
    m = build_model(cfg, mode=mode, device="cpu")
    params = params_from_numpy(_np_params(layers), "cpu", torch.float32)
    toks = torch.from_numpy(_tokens()).long()
    with torch.no_grad():
        got = {"forward": m.forward(params, toks).numpy()}
        cache, lg = m.prefill(params, toks[:, :S], m.init_cache(B, MAX_LEN))
        got["prefill"] = lg.numpy()
        steps = []
        for i in range(STEPS):
            cache, lg = m.decode_step(params, toks[:, S + i:S + i + 1],
                                      cache, S + i)
            steps.append(lg.numpy())
    atol = 1e-4 * float(np.abs(want["forward"]).max())
    for key in ("forward", "prefill"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol)
    for g, w in zip(steps, want["steps"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# lm_loss with aux, and every leaf's grad
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_loss_grads(layers, jmode):
    jcfg, _ = _cfgs(layers)
    params = jax.tree.map(jnp.asarray, _np_params(layers))
    batch = {k: jnp.asarray(v) for k, v in _np_batch().items()}
    with _ctx(jmode):
        model = j_build_model(jcfg, mode=jmode)
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            model.loss, has_aux=True))(params, batch)
    return (float(loss), float(metrics["aux"]),
            {k: np.asarray(v, np.float32) for k, v in _flat(grads).items()})


def _port_loss_grads(cfg, mode, layers):
    model = build_model(cfg, mode=mode, device="cpu")
    params = tree_map(lambda t: t.requires_grad_(), params_from_numpy(
        _np_params(layers), "cpu", torch.float32))
    batch = {k: torch.from_numpy(v).to(torch.float32 if k == "loss_mask"
                                       else torch.int64)
             for k, v in _np_batch().items()}
    loss, metrics, grads = loss_and_grads(model, params, batch)
    return (float(loss), float(metrics["aux"]),
            {p: g.float().numpy() for (p, _), g
             in zip(named_leaves(params), grads)})


@pytest.mark.parametrize("layers", LAYERS)
@pytest.mark.parametrize("mode", list(MODES))
def test_lm_loss_and_grads_match_jax(mode, layers):
    """fp32 masters cast in the forward, remat 'full' on both sides: the
    loss within 1e-5 relative, its load-balancing term (summed over the MoE
    layers only) within 1e-6, every leaf's grad, the dense MLP's, the
    router's and each stacked expert leaf's, within 1e-4 of its largest
    entry (kernel mode against jax.grad through the interpret-mode GEMM
    kernels)."""
    _, cfg = _cfgs(layers)
    jloss, jaux, jgrads = _jax_loss_grads(layers, MODES[mode])
    tloss, taux, tgrads = _port_loss_grads(cfg, mode, layers)
    assert jaux > 0.5        # E * sum(f_e p_e) over the one MoE layer, ~1
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=0, atol=1e-6)
    assert sorted(tgrads) == sorted(jgrads)
    assert any("/moe/w_out" in k for k in tgrads)
    assert any("/mlp/w_out" in k for k in tgrads)
    for k, want in jgrads.items():
        assert np.abs(want).max() > 0, k
        err = np.abs(tgrads[k] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (k, err)


@functools.lru_cache(maxsize=None)
def _port_default(layers):
    _, cfg = _cfgs(layers)
    return _port_loss_grads(cfg, "kernel", layers)


LEVERS = {"remat_none": dict(remat_policy="none"),
          "remat_dots": dict(remat_policy="dots"),
          "ce_chunk": dict(ce_chunk=8)}


@pytest.mark.parametrize("layers", LAYERS)
@pytest.mark.parametrize("lever", list(LEVERS))
def test_training_levers_run_the_mixed_layout(lever, layers):
    """``remat_policy`` "none" and "dots" compute remat "full"'s loss, aux
    and grads on the interleaved stack bit for bit (the same products; only
    what is kept differs); ``ce_chunk`` 8 of the 32 positions within 1e-6
    relative (loss) and 1e-5 of each leaf's largest grad (the cross entropy
    summed by chunks)."""
    _, cfg = _cfgs(layers)
    loss, aux, grads = _port_loss_grads(
        dataclasses.replace(cfg, **LEVERS[lever]), "kernel", layers)
    wloss, waux, wgrads = _port_default(layers)
    assert aux == waux
    if lever == "ce_chunk":
        np.testing.assert_allclose(loss, wloss, rtol=1e-6)
        for k, want in wgrads.items():
            err = np.abs(grads[k] - want).max()
            assert err <= 1e-5 * np.abs(want).max(), (k, err)
        return
    assert loss == wloss
    for k, want in wgrads.items():
        assert np.array_equal(grads[k], want), k


# ---------------------------------------------------------------------------
# kernel launches by block kind, and the plain experts' cast
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", LAYERS)
def test_kernel_mode_runs_each_block_kind(layers):
    """One kernel-mode forward journals, per attention + MLP layer, 4
    ``gemm_fused`` (q|k + rope, v, the SwiGLU up, the down) and per MoE
    layer 2 + 2E (q|k + rope, v, each expert's up and down), and one flash
    forward per layer."""
    _, cfg = _cfgs(layers)
    m = build_model(cfg, mode="kernel", device="cpu")
    params = params_from_numpy(_np_params(layers), "cpu", torch.float32)
    kinds = [kind for kind, _, _ in lm.layer_slots(cfg)]
    assert kinds == ["attn", "moe", "attn"][:layers]
    with torch.no_grad(), obs.capture() as cap:
        m.forward(params, torch.from_numpy(_tokens()).long())
    e = cfg.moe.num_experts
    want = sum(2 + (2 * e if k == "moe" else 2) for k in kinds)
    assert cap.count("gemm_fused") == want
    assert cap.count("attention_fwd") == layers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_experts_cast_to_the_tokens_type(dtype):
    """The plain expert FFN on fp32 tokens over bf16 experts equals it over
    the experts upcast beforehand, bit for bit (the cast of one expert at a
    time is exact: the fp32 truth over the serving copy); where the types
    agree the cast changes nothing."""
    _, cfg = _cfgs()
    p = {k: v[0] for k, v in params_from_numpy(
        _np_params(2)["blocks_1"]["moe"], "cpu", torch.bfloat16).items()}
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (6, cfg.d_model)).astype(np.float32)).to(dtype)
    got = moe._expert_ffn(cfg, p, x)
    want = moe._expert_ffn(cfg, tree_map(lambda t: t.to(dtype), p), x)
    assert got.dtype == dtype and torch.equal(got, want)
    if dtype == torch.float32:
        with pytest.raises(RuntimeError):
            x @ p["w_in"][0]          # what the cast keeps from happening


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_init_casts_leaf_by_leaf(dtype):
    """``Model.init`` casts each leaf as soon as it is drawn (so the
    published config's stacked experts never exist in fp32 all at once):
    the same numbers as drawing the whole fp32 tree and casting it after."""
    _, cfg = _cfgs()
    model = build_model(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                        mode="kernel", device="cpu")
    got = model.init(seed=5, dtype=dtype)
    whole = init_params(model.defs, torch.Generator().manual_seed(5), "cpu")
    want = cast_params(whole, dtype)
    assert [p for p, _ in named_leaves(got)] == \
        [p for p, _ in named_leaves(want)]
    for (path, g), (_, w) in zip(named_leaves(got), named_leaves(want)):
        assert g.dtype == dtype and torch.equal(g, w), path


# ---------------------------------------------------------------------------
# greedy engine streams
# ---------------------------------------------------------------------------

PAGED_KW = {"paged": dict(batch_slots=2, page_size=8, max_pages_per_seq=4),
            "paged_chunked": dict(batch_slots=2, page_size=8,
                                  max_pages_per_seq=4, chunk_tokens=8)}


def _requests(cls, n):
    rng = np.random.default_rng(1)
    v = _cfgs()[1].vocab_size
    return [cls(uid, rng.integers(0, v, int(rng.integers(6, 13)))
                .astype(np.int32), 5) for uid in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_streams(engine):
    jcfg, _ = _cfgs()
    model = j_build_model(jcfg, mode="reference")
    params = jax.tree.map(jnp.asarray, _np_params(2))
    if engine == "fixed":
        q = JRequestQueue(JEngine(model, params, max_len=20), 2,
                          buckets=(12,))
        for r in _requests(JRequest, 5):
            q.submit(r)
        q.flush(force=True)
        return q.results
    eng = JPagedEngine(model, params, **PAGED_KW[engine])
    for r in _requests(JRequest, 3):
        eng.submit(r)
    return eng.run()


@pytest.mark.parametrize("engine", ["fixed", "paged", "paged_chunked"])
@pytest.mark.parametrize("mode", list(MODES))
def test_engine_greedy_streams_equal_jax(mode, engine):
    """Engine + RequestQueue (bucketing, left padding, a forced partial
    batch) and PagedEngine (exact-length or 8-token chunked prefill) over
    the interleaved stack give the JAX engines' greedy streams."""
    _, cfg = _cfgs()
    model = build_model(cfg, mode=mode, device="cpu")
    params = params_from_numpy(_np_params(2), "cpu", torch.float32)
    if engine == "fixed":
        q = RequestQueue(Engine(model, params, max_len=20), 2, buckets=(12,))
        for r in _requests(Request, 5):
            q.submit(r)
        q.flush(force=True)
        got = q.results
    else:
        eng = PagedEngine(model, params, **PAGED_KW[engine])
        for r in _requests(Request, 3):
            eng.submit(r)
        got = eng.run()
        if engine == "paged_chunked":
            assert eng.chunks_prefilled >= 3
    want = _jax_streams(engine)
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])


FAST = {"prefix": dict(prefix_cache=True), "self_draft": dict(spec_tokens=3)}


@pytest.mark.parametrize("path", list(FAST))
@pytest.mark.parametrize("mode", list(MODES))
def test_paged_fast_paths_equal_jax(mode, path):
    """The interleaved stack is attention-only, so PagedEngine's fast paths
    take it: with the prefix cache or a self-draft (k 3) the greedy streams
    are the JAX PagedEngine's."""
    _, cfg = _cfgs()
    model = build_model(cfg, mode=mode, device="cpu")
    params = params_from_numpy(_np_params(2), "cpu", torch.float32)
    kw = dict(FAST[path])
    if path == "self_draft":
        kw.update(draft_model=model, draft_params=params)
    eng = PagedEngine(model, params, **PAGED_KW["paged"], **kw)
    for r in _requests(Request, 3):
        eng.submit(r)
    got = eng.run()
    want = _jax_streams("paged")
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    if path == "self_draft":
        rep = eng.report()["speculative"]
        assert rep["rounds"] >= 1 and rep["accept_rate"] == 1.0
