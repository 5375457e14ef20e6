"""mamba2-130m in the port against the JAX reference on the CPU, at its
smoke config (2 layers: d_model 64, 4 heads of 32, d_state 16, chunk 16,
the ``blocks`` stack) and a 3-layer variant, in fp32: the parameter trees
and their conversion name for name; forward, prefill and decode logits in
both modes past two chunks, in fp32 and in bf16 (the bf16 rounding
points); the port's prefill and decode against its own
forward; the greedy streams of ``Engine`` + ``RequestQueue`` (left
padding) and ``PagedEngine`` (prompts ending mid-page, a preempting pool)
equal to the JAX engines'; ``PagedEngine``'s three refusals on an SSM
stack; ``lm_loss`` and every leaf's grad against ``jax.grad``; the serving
and training launchers. Both sides run the reference's seeded init,
converted with ``params_from_numpy``, and numpy-seeded tokens.
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
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.common import tree_map
from repro_torch.models.lm import check_supported, layer_slots, lm_param_defs
from repro_torch.optim.optimizer import named_leaves
from repro_torch.serve import Engine, PagedEngine, Request, RequestQueue
from repro_torch.train import loss_and_grads

ARCH = "mamba2-130m"
LAYERS = (2, 3)
MODES = ("kernel", "reference")
# a prompt of two chunks and a ragged third, then decode steps
B, S, STEPS, MAX_LEN = 2, 36, 4, 48
# the logits' tolerance against the JAX model, a fraction of their max abs
# (fp32 sums in another order: the two packages' logits sit 1e-5 of it
# apart)
REL = 1e-4


def _cfgs(layers, dtype="float32"):
    return tuple(dataclasses.replace(get(ARCH, smoke=True),
                                     compute_dtype=dtype, num_layers=layers)
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


def _silu_in_fp32(x):
    """silu as the port computes it: in fp32, rounded once (see
    ``test_logits_round_as_the_reference_in_bf16``)."""
    return (x.astype(jnp.float32)
            * jax.nn.sigmoid(x.astype(jnp.float32))).astype(x.dtype)


@functools.lru_cache(maxsize=None)
def _jax_outputs(layers, dtype="float32"):
    """{forward, prefill, steps}: the full-sequence logits, the prefill's
    last logits and the teacher-forced decode steps' logits. In bf16 the
    parameters are cast to bf16 and the model runs op by op with the
    port's silu."""
    if dtype == "float32":
        return _jax_run(layers, dtype)
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jax.nn, "silu", _silu_in_fp32)
        return _jax_run(layers, dtype)


def _jax_run(layers, dtype):
    jcfg, _ = _cfgs(layers, dtype)
    m = j_build_model(jcfg, mode="reference")
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype),
                          _np_params(layers))
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
def _port_outputs(layers, mode, dtype="float32"):
    _, tcfg = _cfgs(layers, dtype)
    m = build_model(tcfg, mode=mode, device="cpu")
    params = params_from_numpy(_np_params(layers), "cpu",
                               getattr(torch, dtype))
    toks = torch.from_numpy(_tokens()).long()
    with torch.no_grad():
        out = {"forward": m.forward(params, toks).float().numpy()}
        cache, logits = m.prefill(params, toks[:, :S],
                                  m.init_cache(B, MAX_LEN))
        out["prefill"] = logits.float().numpy()
        out["steps"] = []
        for i in range(STEPS):
            cache, lg = m.decode_step(params, toks[:, S + i:S + i + 1],
                                      cache, S + i)
            out["steps"].append(lg.float().numpy())
    return out


# ---------------------------------------------------------------------------
# the config and the parameter layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", LAYERS + (24,))
def test_param_tree_is_the_references(layers):
    """The port's declarations have the reference's paths and shapes: the
    ``blocks`` stack of 'ssm' blocks, each its mixer and ln1 only (no MLP,
    no ln2), at the smoke width and at the published 24 layers."""
    if layers == 24:
        jcfg, tcfg = j_get_config(ARCH), get_config(ARCH)
    else:
        jcfg, tcfg = _cfgs(layers)
    want = {k: tuple(v.shape) for k, v in j_lm_param_defs(jcfg).items()}
    got = {k: tuple(v.shape) for k, v in lm_param_defs(tcfg).items()}
    assert got == want
    assert not any("mlp" in k or "ln2" in k for k in got)
    assert [kind for kind, _, _ in layer_slots(tcfg)] == ["ssm"] * layers
    check_supported(tcfg)


@pytest.mark.parametrize("layers", LAYERS)
def test_params_carried_across_name_for_name(layers):
    """params_from_numpy keeps every leaf, value for value."""
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
    """Forward, prefill (36 tokens: two chunks of 16 and a ragged third)
    and teacher-forced decode logits within REL of the logits' max abs of
    the JAX model's. Kernel mode runs no kernel on this stack (the SSD
    block is plain, as the reference's), so both modes are one path."""
    want, got = _jax_outputs(layers), _port_outputs(layers, mode)
    atol = REL * float(np.abs(want["forward"]).max())
    for key in ("forward", "prefill"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol)
    for g, w in zip(got["steps"], want["steps"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layers", LAYERS)
def test_logits_round_as_the_reference_in_bf16(layers, mode):
    """In bf16, the forward's logits, and the prefill's and decode steps'
    together, against the JAX model's with bf16 parameters, run op by op
    (``jax.disable_jit``: XLA's fusions may keep bf16 intermediates in
    fp32) and given the port's silu (fp32, rounded once: ``jax.nn.silu``
    of a bf16 tensor rounds the logistic first, and XLA's CPU logistic
    rounds differently from torch's sigmoid): in each group at most a
    quarter of the rows further than 0.1 bf16 ulp of the group's max from
    the reference's (a rare flip of a hidden rounding: 4 of 80 forward
    rows at 2 layers, 1 at 3), and every entry within 2 ulps. Moving
    one of the block's rounding points (dt before ``x * dt``, the gate,
    decode's skip term or y's rounding) moves every row of the path that
    runs it (1.5-18 ulps)."""
    want = _jax_outputs(layers, "bfloat16")
    got = _port_outputs(layers, mode, "bfloat16")
    for key in ("forward", "decode"):
        if key == "forward":
            g, w = got["forward"], want["forward"]
        else:
            g, w = (np.concatenate([o["prefill"]] + o["steps"])
                    for o in (got, want))
        g, w = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
        ulp = 2 ** -8 * float(np.abs(w).max())
        rows = np.abs(g - w).max(axis=-1)
        assert np.mean(rows > 0.1 * ulp) <= 0.25, key
        assert rows.max() <= 2 * ulp, key


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layers", LAYERS)
def test_prefill_and_decode_match_the_forward(layers, mode):
    """The port's prefill and decode steps against its own forward, within
    1e-5 of the logits' max: the state the cache carries is the scan's."""
    out = _port_outputs(layers, mode)
    atol = 1e-5 * float(np.abs(out["forward"]).max())
    np.testing.assert_allclose(out["prefill"], out["forward"][:, S - 1],
                               rtol=0, atol=atol)
    for i, lg in enumerate(out["steps"]):
        np.testing.assert_allclose(lg, out["forward"][:, S + i], rtol=0,
                                   atol=atol)


def test_decode_cache_is_the_same_size_at_any_length():
    """The SSM stack's cache is {"conv", "state"} per layer, the same
    tensors whatever ``max_len``: the decode state does not grow."""
    _, tcfg = _cfgs(2)
    m = build_model(tcfg, mode="reference", device="cpu")
    small, large = m.init_cache(B, 16), m.init_cache(B, 1 << 16)
    assert sorted(small) == ["conv", "state"]
    for k in small:
        assert small[k].shape == large[k].shape
    assert small["state"].shape == (2, B, 4, 32, 16)
    assert small["state"].dtype == torch.float32


# ---------------------------------------------------------------------------
# grads, fp32
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": v})
    return out


def _batch():
    toks = _tokens()
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(layers):
    jcfg, _ = _cfgs(layers)
    model = j_build_model(jcfg, mode="reference")
    params = jax.tree.map(jnp.asarray, _np_params(layers))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    (loss, _), grads = jax.value_and_grad(model.loss, has_aux=True)(
        params, batch)
    return float(loss), {k: np.asarray(v, np.float32)
                         for k, v in _flat(grads).items()}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layers", LAYERS)
def test_lm_loss_and_grads_match_jax(layers, mode):
    """fp32 masters cast in the forward, remat 'full' on both sides: the
    loss within 1e-5 relative, every leaf's grad (the in and out
    projections, the conv filter and bias, a_log, dt_bias, d_skip, the
    gate's norm scale, ln1, the tied embedding's two uses summed) within
    1e-4 of its largest entry."""
    _, cfg = _cfgs(layers)
    model = build_model(cfg, mode=mode, device="cpu")
    params = tree_map(lambda t: t.requires_grad_(), _port_params(layers))
    batch = {k: torch.from_numpy(v).long() for k, v in _batch().items()}
    loss, _, grads = loss_and_grads(model, params, batch)
    jloss, jgrads = _jax_loss_grads(layers)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    got = {p: g.numpy() for (p, _), g in zip(named_leaves(params), grads)}
    assert sorted(got) == sorted(jgrads)
    for k, w_ in jgrads.items():
        assert np.abs(w_).max() > 0, k
        err = np.abs(got[k] - w_).max()
        assert err <= 1e-4 * np.abs(w_).max(), (k, err)


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
    lens = {"fixed": [33, 30, 37, 31, 35], "paged": [5, 13, 37, 21],
            "preempting": [30, 29]}[kind]
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
    """Engine + RequestQueue (30-37-token prompts left-padded to 40, the
    pads run through the state as in the reference's engine, a forced
    partial batch) and PagedEngine (exact-length prefills of prompts
    ending mid-page; a pool small enough to preempt, whose re-prefill
    rebuilds the state) give the JAX engines' greedy streams."""
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
    positions never reach the SSM state."""
    _, tcfg = _cfgs(2)
    model = build_model(tcfg, mode="reference", device="cpu")
    params = _port_params(2)
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
    """An SSM stack's state cannot be shared by prefix, re-entered by
    chunks or stepped k tokens at once: the reference's refusals
    (tests/test_serve_fastpath.py), on both packages."""
    jcfg, tcfg = _cfgs(2)
    kw = {"prefix_cache": dict(prefix_cache=True),
          "chunk_tokens": dict(chunk_tokens=8)}.get(what, {})
    model = build_model(tcfg, mode="reference", device="cpu")
    params = _port_params(2)
    jmodel = j_build_model(jcfg, mode="reference")
    jparams = jax.tree.map(jnp.asarray, _np_params(2))
    if what == "draft":
        kw = dict(draft_model=model, draft_params=params, spec_tokens=4)
        jkw = dict(draft_model=jmodel, draft_params=jparams, spec_tokens=4)
    else:
        jkw = kw
    with pytest.raises(ValueError, match=match):
        PagedEngine(model, params, batch_slots=2, page_size=8, **kw)
    with pytest.raises(ValueError, match=match):
        JPagedEngine(jmodel, jparams, batch_slots=2, page_size=8, **jkw)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_serving_launcher_on_the_cpu(capsys):
    """launch/serve.py serves the smoke config on the CPU through the
    request queue, prompts past two chunks."""
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--prompt-len", "40", "--new-tokens", "4"])
    assert "served 3 requests (3 unique results)" in capsys.readouterr().out


def test_training_launcher_on_the_cpu(capsys):
    """launch/train.py --arch mamba2-130m --smoke trains 2 steps on the
    LM pipeline's batches on the CPU."""
    res = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--steps", "2", "--batch", "2", "--seq", "40"])
    out = capsys.readouterr().out
    assert "[train] finished: 2 steps" in out
    assert ", 2 layers, 2 x 40 tokens a step on cpu" in out
    assert np.isfinite(res.losses).all()
