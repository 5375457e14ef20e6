"""The four dense decoder configs of the reference's registry beside llama
(granite-8b, qwen2-72b, minicpm-2b, chatglm3-6b) and mixtral-8x7b's
mixture of experts in the port, on the CPU
against the JAX reference at each ``SMOKE_CONFIG``: the configs field for
field (mamba2-130m's, internvl2-2b's and llama4-maverick's too, and
maverick's published parameter count); forward, prefill and decode
logits and ``.loss`` in both modes; the greedy streams of ``Engine`` +
``RequestQueue`` and ``PagedEngine``.
Both sides run the same weights: the reference's seeded init converted
with ``params_from_numpy``, with random nonzero q|k/v biases where the
config has them. Also the QKV ladder's fallback from rung 1 where the rope
store cannot hold a head (minicpm's smoke head_dim 24) against the JAX
model in interpret mode, and ``.loss`` of llama-100m.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.serve import Engine as JEngine
from repro.serve import PagedEngine as JPagedEngine
from repro.serve import Request as JRequest
from repro.serve import RequestQueue as JRequestQueue

from repro_torch.configs import ModelConfig, get_config
from repro_torch.kernels.gemm import rope_store_fits
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.lm import lm_param_defs
from repro_torch.serve import Engine, PagedEngine, Request, RequestQueue

ARCHS = ("granite-8b", "qwen2-72b", "minicpm-2b", "chatglm3-6b",
         "mixtral-8x7b")
MODES = ("kernel", "reference")
B, S, STEPS, MAX_LEN = 2, 12, 4, 24


def _cfgs(arch):
    """(JAX, port) configs: the smoke config in fp32, except llama-100m
    (no smoke variant), cut to 2 layers at its published width."""
    if arch == "llama-100m":
        return tuple(dataclasses.replace(get(arch), num_layers=2,
                                         compute_dtype="float32")
                     for get in (j_get_config, get_config))
    return tuple(dataclasses.replace(get(arch, smoke=True),
                                     compute_dtype="float32")
                 for get in (j_get_config, get_config))


@functools.lru_cache(maxsize=None)
def _np_params(arch):
    """The reference's seeded init as numpy, q|k/v biases drawn nonzero."""
    jcfg, _ = _cfgs(arch)
    params = jax.tree.map(np.asarray, j_build_model(
        jcfg, mode="reference").init(jax.random.PRNGKey(0)))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(3)
        attn = params["blocks"]["attn"]
        for key in ("bqk", "bv"):
            attn[key] = rng.standard_normal(attn[key].shape).astype(
                np.float32)
    return params


@functools.lru_cache(maxsize=None)
def _tokens(arch):
    rng = np.random.default_rng(0)
    return rng.integers(0, _cfgs(arch)[1].vocab_size,
                        (B, S + STEPS)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_outputs(arch, mode="reference"):
    """{forward, prefill, steps, loss} of the JAX model: the full-sequence
    logits, the prefill's last logits, the teacher-forced decode steps'
    logits and the loss of next-token targets."""
    jcfg, _ = _cfgs(arch)
    m = j_build_model(jcfg, mode=mode)
    params = jax.tree.map(jnp.asarray, _np_params(arch))
    toks = jnp.asarray(_tokens(arch))
    out = {"forward": np.asarray(m.forward(params, toks)[0], np.float32)}
    cache, logits = m.prefill(params, toks[:, :S], m.init_cache(B, MAX_LEN))
    out["prefill"] = np.asarray(logits, np.float32)
    steps = []
    for i in range(STEPS):
        cache, lg = m.decode_step(params, toks[:, S + i:S + i + 1], cache,
                                  S + i)
        steps.append(np.asarray(lg, np.float32))
    out["steps"] = steps
    loss, _ = m.loss(params, {"inputs": toks[:, :-1], "targets": toks[:, 1:]})
    out["loss"] = float(loss)
    return out


def _port_outputs(arch, mode):
    _, tcfg = _cfgs(arch)
    m = build_model(tcfg, mode=mode, device="cpu")
    params = params_from_numpy(_np_params(arch), "cpu", torch.float32)
    toks = torch.from_numpy(_tokens(arch)).long()
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
        loss, _ = m.loss(params, {"inputs": toks[:, :-1],
                                  "targets": toks[:, 1:]})
        out["loss"] = float(loss)
    return out


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def _same_fields(got, want):
    """Every field of the port's config equal to the reference's; ``moe``
    and ``ssm`` (each package's own class) compared by their fields."""
    for f in dataclasses.fields(ModelConfig):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name in ("moe", "ssm") and g is not None and w is not None:
            g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert g == w, f.name


@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
@pytest.mark.parametrize("arch", ARCHS + ("mamba2-130m", "internvl2-2b",
                                          "llama4-maverick-400b-a17b"))
def test_config_is_the_references_field_for_field(arch, smoke):
    got = get_config(arch, smoke=smoke)
    _same_fields(got, j_get_config(arch, smoke=smoke))
    assert got.name.endswith("-smoke") == smoke


@pytest.mark.parametrize("arch", ["llama-100m", "llama-1b"])
def test_llama_ids_return_their_one_config(arch):
    assert get_config(arch, smoke=True) is get_config(arch)
    _same_fields(get_config(arch), j_get_config(arch, smoke=True))


def test_unregistered_arch_raises():
    with pytest.raises(KeyError, match="llama4-scout-17b-16e"):
        # an id neither package registers
        get_config("llama4-scout-17b-16e")


def test_maverick_parameter_count_in_the_references_range():
    """llama4-maverick's published config counts 3e11-5e11 parameters (the
    reference's range, ``tests/test_models.py``), summed from the port's
    declarations without allocating any."""
    n = sum(math.prod(d.shape)
            for d in lm_param_defs(get_config(
                "llama4-maverick-400b-a17b")).values())
    assert 3e11 < n < 5e11, n


# ---------------------------------------------------------------------------
# the QKV ladder's rung-1 fallback (the reference's fused_project_qkv_rope
# returns None where the rope store does not fit; the caller takes rung 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim,fits", [(64, True), (128, True),
                                           (16, True), (8, True),
                                           (24, False), (80, False),
                                           (96, False), (6, False)])
def test_rope_store_fits_whole_heads_only(head_dim, fits):
    assert rope_store_fits(head_dim) == fits


@pytest.mark.parametrize("what", ["forward", "prefill"])
def test_minicpm_smoke_kernel_mode_matches_jax_interpret(what):
    """minicpm-2b's smoke head_dim 24 does not divide the rope store's
    tile: the port's kernel mode takes rung 2, as the JAX model does, and
    matches its interpret-mode kernels within 1e-4 of the logits' max."""
    assert not rope_store_fits(_cfgs("minicpm-2b")[1].head_dim)
    want = _jax_outputs("minicpm-2b", "pallas_interpret")[what]
    got = _port_outputs("minicpm-2b", "kernel")[what]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# logits and loss, both modes, fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS + ("llama-100m",))
def test_logits_and_loss_match_jax_f32(arch, mode):
    """Forward, prefill and teacher-forced decode logits within 1e-4 of the
    logits' max abs, and the loss within 1e-5 relative."""
    want, got = _jax_outputs(arch), _port_outputs(arch, mode)
    atol = 1e-4 * float(np.abs(want["forward"]).max())
    for key in ("forward", "prefill"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol)
    for g, w in zip(got["steps"], want["steps"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


# ---------------------------------------------------------------------------
# greedy engine streams, fp32
# ---------------------------------------------------------------------------

PAGED_KW = {"paged": dict(batch_slots=2, page_size=8, max_pages_per_seq=4),
            "paged_chunked": dict(batch_slots=2, page_size=8,
                                  max_pages_per_seq=4, chunk_tokens=8)}


def _requests(cls, arch, n):
    rng = np.random.default_rng(1)
    v = _cfgs(arch)[1].vocab_size
    return [cls(uid, rng.integers(0, v, int(rng.integers(6, 13)))
                .astype(np.int32), 5) for uid in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_streams(arch, engine):
    jcfg, _ = _cfgs(arch)
    model = j_build_model(jcfg, mode="reference")
    params = jax.tree.map(jnp.asarray, _np_params(arch))
    if engine == "fixed":
        q = JRequestQueue(JEngine(model, params, max_len=20), 2,
                          buckets=(12,))
        for r in _requests(JRequest, arch, 5):
            q.submit(r)
        q.flush(force=True)
        return q.results
    eng = JPagedEngine(model, params, **PAGED_KW[engine])
    for r in _requests(JRequest, arch, 3):
        eng.submit(r)
    return eng.run()


@pytest.mark.parametrize("engine", ["fixed", "paged", "paged_chunked"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_streams_equal_jax_f32(arch, mode, engine):
    """Engine + RequestQueue (bucketing, left padding, a forced partial
    batch) and PagedEngine (exact-length or 8-token chunked prefill) give
    the JAX engines' greedy streams."""
    _, tcfg = _cfgs(arch)
    model = build_model(tcfg, mode=mode, device="cpu")
    params = params_from_numpy(_np_params(arch), "cpu", torch.float32)
    if engine == "fixed":
        q = RequestQueue(Engine(model, params, max_len=20), 2, buckets=(12,))
        for r in _requests(Request, arch, 5):
            q.submit(r)
        q.flush(force=True)
        got = q.results
    else:
        eng = PagedEngine(model, params, **PAGED_KW[engine])
        for r in _requests(Request, arch, 3):
            eng.submit(r)
        got = eng.run()
    want = _jax_streams(arch, engine)
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
